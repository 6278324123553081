"""torch port: the h1_push_crate configuration against the benchmark's plain
reference (`benchmark/reference/`, plain PyTorch, frozen copies of the
pipeline, the H1 env's PD map and reward stack, and the planner's update),
on the CPU in float64.  It imports no JAX.

The env is the benchmark configuration's (`benchmark/configs/
h1_push_crate_n8192.json`: its scene, its env fields), in float64, on
seeded perturbed states where every contact kind is active and most
contacts couple the robot's and the crate's trees (`h1_crate_states`), and
seeded random actions:

- `env_step`: one env step of the port (the PD map, the fused substep's
  plain form, the reward and termination stack) against the reference's
  (PD map, pipeline, reward stack): qpos, qvel, reward, done and every info
  field;
- `fused_plain`: the kernel's plain form (`dynamics/fused.py`) against the
  reference pipeline, at B=4, the PD torques as the control;
- `reverse_once`: one `MBDPI.reverse_once` with injected noise at N=8,
  Hsample 4, Hnode 2 against the reference's candidates, rollouts, softmax
  and update: the mean rewards, the weights and the new plan.

Tolerance, 1e-10 of each quantity's scale (at least 1): both sides compute
the same equations in float64, in other orders (the fused form's unrolled
chains against the pipeline's batched ops, its LDL against the reference's
dense solves); the gaps read 1e-16 to 1.2e-14 here, and 1e-10 leaves room
for another machine's reduction orders.  A wrong term shows far above it: a
1 % change of the position anchor's weight, the smallest term here, moves
the reward by 1.4e-5.  The rollouts'
mean rewards are held in units of their spread (the softmax's scale), as
the benchmark holds them.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import envs as ref_envs
from benchmark.reference import model as ref_model
from benchmark.reference import pipeline as ref_pipeline
from benchmark.reference.planner import Planner
from torch_port_helpers import h1_crate_states
from tpu_dialmpc_torch.envs.base import LeanEnvState, LeanPipelineState
from tpu_dialmpc_torch.envs.registry import get_env
from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "h1_push_crate_n8192.json").read_text())
F64 = torch.float64
TOL = 1e-10
CASES = ("env_step", "fused_plain", "reverse_once")


def _both(n_substeps):
    """(the port's env in float64, the reference's env) for the config."""
    cfg = dict(CONFIG["env"], scene=str(ROOT / CONFIG["env"]["scene"]), n_substeps=n_substeps)
    env = get_env(CONFIG["task"], device="cpu", **dict(cfg, dtype="float64"))
    ref = ref_envs.H1(cfg, ref_model.load_model(cfg["scene"]), "cpu", F64)
    return env, ref


def _gap(got, want):
    got, want = torch.as_tensor(got, dtype=F64), torch.as_tensor(want, dtype=F64)
    scale = max(1.0, float(want.abs().max()))
    return float((got - want).abs().max()) / scale


def _states(env, n, seed):
    rng = np.random.default_rng(seed)
    qpos, qvel = h1_crate_states(env.model, rng, n)
    ws = rng.normal(scale=0.2, size=(n, env.model.nv))
    action = rng.uniform(-1.0, 1.0, size=(n, env.model.nu))
    return [torch.as_tensor(a, dtype=F64) for a in (qpos, qvel, ws, action)], rng


def _info(env, n, rng):
    """The reset state's info for n rows, each at its own step of the
    command ramp and gait, its position target moved."""
    info = env.reset().info
    rows = {f.name: getattr(info, f.name).expand((n,) + tuple(getattr(info, f.name).shape))
            .clone() for f in dataclasses.fields(info)}
    rows["step"] = torch.as_tensor(rng.integers(0, 80, n), dtype=rows["step"].dtype)
    rows["pos_tar"] = rows["pos_tar"] + torch.as_tensor(rng.normal(scale=0.1, size=(n, 3)),
                                                         dtype=F64)
    return type(info)(**rows), rows


def _env_step():
    env, ref = _both(n_substeps=2)
    (qpos, qvel, ws, action), rng = _states(env, 4, seed=11)
    info, rows = _info(env, 4, rng)
    q, v, _, _, _, reward, done, info2, _ = env._step_batch(qpos, qvel, ws, info, action)
    rq, rv, _, rr, rd, rinfo = ref.step(qpos, qvel, ws, dict(rows), action)
    assert torch.equal(done, rd)
    gaps = {"qpos": _gap(q, rq), "qvel": _gap(v, rv), "reward": _gap(reward, rr)}
    for f in dataclasses.fields(info2):
        got, want = getattr(info2, f.name), rinfo[f.name]
        if got.dtype in (torch.bool, torch.int32, torch.int64):
            assert torch.equal(got, want.to(got.dtype)), f.name
        else:
            gaps[f.name] = _gap(got, want)
    return gaps


def _fused_plain():
    env, ref = _both(n_substeps=2)
    (qpos, qvel, ws, action), _ = _states(env, 4, seed=12)
    ctrl = env._ctrl_batch(action, qpos, qvel)
    q, v, w, _ = env.fused_step(qpos, qvel, ws, ctrl)
    ps = ref_pipeline.step(ref.model, type("S", (), dict(qpos=qpos, qvel=qvel,
                                                          qacc_warmstart=ws)), ctrl, 2)
    return {"qpos": _gap(q, ps.qpos), "qvel": _gap(v, ps.qvel), "ws": _gap(w, ps.qacc_warmstart)}


def _reverse_once():
    env, ref = _both(n_substeps=1)
    planner = dict(CONFIG["planner"], Nsample=8, Hsample=4, Hnode=2)
    args = DialConfig(**{k: planner[k] for k in ("Nsample", "Hsample", "Hnode", "Ndiffuse",
                                                  "temp_sample", "horizon_diffuse_factor",
                                                  "traj_diffuse_factor", "ctrl_dt",
                                                  "update_method", "spline_mode",
                                                  "score_std")})
    mb = MBDPI(args, env, capture=False)
    P = Planner(planner, "cpu", F64)
    (qpos, qvel, ws, _), rng = _states(env, 5, seed=13)
    state = env.reset()
    info = state.info
    row = 4  # a standing sample, its crate just out of reach
    state = LeanEnvState(pipeline=LeanPipelineState(qpos=qpos[row], qvel=qvel[row],
                                                    qacc_warmstart=ws[row]),
                         obs=None, reward=None, done=None, info=info)
    Y = torch.as_tensor(rng.uniform(-0.5, 0.5, (3, env.action_size)), dtype=F64)
    noise = torch.as_tensor(rng.normal(size=(8, 3, env.action_size)), dtype=F64)
    Ybar, out = mb.reverse_once(state, None, Y, mb._const(("improve", 0), F64), noise=noise)
    C = P.candidates(Y, noise, 0)
    us = P.node2u(C)
    B = us.shape[0]
    q, v, w = (x.expand(B, -1) for x in (qpos[row], qvel[row], ws[row]))
    rows = {f.name: getattr(info, f.name).expand((B,) + tuple(getattr(info, f.name).shape))
            for f in dataclasses.fields(info)}
    total = 0.0
    for t in range(us.shape[1]):
        q, v, w, r, _, rows = ref.step(q, v, w, rows, us[:, t])
        total = total + r
    mean = total / us.shape[1]
    weights, Y_ref = P.update(mean, C)
    return {"rews": float((out.rews - mean).abs().max()) / float(mean.std()),
            "weights": _gap(out.weights, weights), "plan": _gap(Ybar, Y_ref)}


@pytest.mark.parametrize("case", CASES)
def test_h1_push_crate_holds_to_the_reference(case):
    gaps = {"env_step": _env_step, "fused_plain": _fused_plain,
            "reverse_once": _reverse_once}[case]()
    assert gaps and all(g <= TOL for g in gaps.values()), gaps
