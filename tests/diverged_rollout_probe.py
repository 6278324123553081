"""Where the engine departs from MuJoCo: a diagnostic of a gate's closed loop.

Two steps, one on the card and one on the CPU:

    # on the card: a gate's quick lane through the port's planner, recording
    # the executed trajectory and the first rollout whose rewards are not
    # finite (its start state and controls)
    python tests/diverged_rollout_probe.py find --gate go2_trot --out probe.npz

    # on the CPU (the JAX package and mujoco installed): that rollout's
    # blow-up substep by substep in the port's physics pipeline, the JAX
    # package's pipeline and MuJoCo's mj_step, all float64; and every
    # executed control step of the trajectory stepped again by the port's
    # float64 pipeline and by mj_step from the recorded state
    JAX_PLATFORMS=cpu python tests/diverged_rollout_probe.py compare probe.npz

The stand-in MJCF (tests/assets) is the scene MuJoCo steps; it is what the
port's model files were exported from.  The substep comparison steps the
control step whose reward is the rollout's first non-finite one.
"""

from __future__ import annotations

import argparse
import os
import sys
import types
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def find(gate: str, out: str) -> int:
    import torch

    from tpu_dialmpc_torch import quality as q
    from tpu_dialmpc_torch.planner import dial, runner

    found, runs = {}, []
    scan, rollout = runner.run_scan, dial.MBDPI.rollout_us_batch
    step = {"calls": 0}

    def hooked(self, state, us):
        rews = rollout(self, state, us)
        step["calls"] += 1
        bad = ~torch.isfinite(rews).all(dim=1)
        if bool(bad.any()) and not found:
            i = int(bad.nonzero()[0, 0])
            ps = state.pipeline
            found.update(
                bad_qpos0=ps.qpos.cpu().numpy(), bad_qvel0=ps.qvel.cpu().numpy(),
                bad_ws0=ps.qacc_warmstart.cpu().numpy(), bad_us=us[i].cpu().numpy(),
                bad_rews=rews[i].cpu().numpy(), bad_call=step["calls"],
                n_bad=int(bad.sum()))
            print(f"[find] rollout call {step['calls']}: {int(bad.sum())} of {len(bad)} "
                  f"candidates with non-finite rewards, first at horizon step "
                  f"{int((~torch.isfinite(rews[i])).nonzero()[0, 0])}")
        return rews

    dial.MBDPI.rollout_us_batch = hooked
    runner.run_scan = lambda *a, **kw: runs.append(scan(*a, **kw)) or runs[-1]
    try:
        r = q.run_gate(gate, quick=True)
    finally:
        dial.MBDPI.rollout_us_batch, runner.run_scan = rollout, scan
    res = runs[0]

    def host(x):
        return x.detach().cpu().numpy()

    np.savez(out, task=q.GATES[gate].task, qpos=host(res.qpos),
             qvel=host(res.qvel), us=host(res.us), qpos0=host(res.qpos0),
             qvel0=host(res.qvel0), **found)
    print(f"[find] {gate}: passed={r['passed']}; metrics {r['metrics']}; "
          f"{'a diverged rollout saved' if found else 'no rollout diverged'}; wrote {out}")
    return 0


def _port_env(task):
    from tpu_dialmpc_torch.envs import get_env

    return get_env(task, device="cpu", fused="off", dtype="float64")


def _mujoco(env):
    import mujoco

    from tpu_dialmpc_torch.dynamics import assets

    m = assets.host_mj_model(env)
    m.opt.timestep = env.model.timestep
    return mujoco, m, mujoco.MjData(m)


def _t(x):
    import torch

    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def compare_blowup(data) -> None:
    """The diverged rollout, substep by substep: port, JAX, MuJoCo."""
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from tpu_dialmpc.dynamics import pipeline as jpipe
    from tpu_dialmpc.envs import registry as jregistry
    from tpu_dialmpc_torch.dynamics import pipeline as tpipe

    task = str(data["task"])
    env = _port_env(task)
    jm = jregistry.get_env(task).model
    mujoco, m, md = _mujoco(env)
    rews = data["bad_rews"]
    k = int(np.argmax(~np.isfinite(rews)))
    qpos, qvel, ws = _t(data["bad_qpos0"])[None], _t(data["bad_qvel0"])[None], _t(
        data["bad_ws0"])[None]
    us = _t(data["bad_us"])
    for t in range(k):  # the control steps before the first non-finite reward's
        ctrl = env._ctrl_batch(us[t:t + 1], qpos, qvel)
        ps = tpipe.step(env.model, types.SimpleNamespace(qpos=qpos, qvel=qvel, qacc_warmstart=ws),
                        ctrl, env.config.n_substeps)
        qpos, qvel, ws = ps.qpos, ps.qvel, ps.qacc_warmstart
    ctrl = env._ctrl_batch(us[k:k + 1], qpos, qvel)
    print(f"[compare] {task}: rollout rewards {np.round(rews[:k + 1], 4).tolist()}; horizon "
          f"step {k} from torso z {qpos[0, 2].item():.4f}, |qvel| max {qvel.abs().max().item():.4f}, "
          f"|ctrl| max {ctrl.abs().max().item():.3f}; mujoco solver {int(m.opt.solver)}, "
          f"iterations {m.opt.iterations}, ls_iterations {m.opt.ls_iterations}")
    md.qpos[:], md.qvel[:], md.qacc_warmstart[:] = qpos[0].numpy(), qvel[0].numpy(), ws[0].numpy()
    md.ctrl[:] = ctrl[0].numpy()
    js = jpipe.init(jm, jnp.asarray(qpos[0].numpy()), jnp.asarray(qvel[0].numpy()))
    js = js._replace(qacc_warmstart=jnp.asarray(ws[0].numpy()))
    for s in range(env.config.n_substeps):
        ps = tpipe.step(env.model, types.SimpleNamespace(qpos=qpos, qvel=qvel, qacc_warmstart=ws),
                        ctrl, 1)
        qpos, qvel, ws = ps.qpos, ps.qvel, ps.qacc_warmstart
        js = jpipe.step(jm, js, jnp.asarray(ctrl[0].numpy()), 1)
        mujoco.mj_step(m, md)
        jq = np.asarray(js.qvel)
        print(f"[compare] substep {s}: |qvel| max port {qvel.abs().max().item():.4g}, JAX "
              f"{np.abs(jq).max():.4g}, mujoco {np.abs(md.qvel).max():.4g}; port - JAX "
              f"{np.abs(qvel[0].numpy() - jq).max():.3g}")


def compare_trajectory(data) -> None:
    """Every executed control step again, from the recorded state: the
    port's float64 pipeline against mj_step and against the card."""
    from tpu_dialmpc_torch.dynamics import pipeline as tpipe

    env = _port_env(str(data["task"]))
    mujoco, m, md = _mujoco(env)
    qp = np.concatenate([data["qpos0"][None], data["qpos"][:-1]])
    qv = np.concatenate([data["qvel0"][None], data["qvel"][:-1]])
    d_mj, d_card = [], []
    for t in range(len(data["us"])):
        q, v = _t(qp[t:t + 1]), _t(qv[t:t + 1])
        ctrl = env._ctrl_batch(_t(data["us"][t:t + 1]), q, v)
        ps = tpipe.step(env.model, types.SimpleNamespace(qpos=q, qvel=v,
                                                         qacc_warmstart=v.new_zeros(v.shape)),
                        ctrl, env.config.n_substeps)
        mujoco.mj_resetData(m, md)
        md.qpos[:], md.qvel[:], md.ctrl[:] = qp[t], qv[t], ctrl[0].numpy()
        for _ in range(env.config.n_substeps):
            mujoco.mj_step(m, md)
        d_mj.append(np.abs(ps.qvel[0].numpy() - md.qvel).max())
        d_card.append(np.abs(ps.qvel[0].numpy() - data["qvel"][t]).max())
    z = data["qpos"][:, 2]
    print(f"[compare] {len(d_mj)} executed steps, max |Δqvel| per step (rad/s or m/s): port "
          f"float64 vs mj_step median {np.median(d_mj):.4g}, max {np.max(d_mj):.4g}; vs the "
          f"card's recorded step median {np.median(d_card):.3g}, max {np.max(d_card):.3g}; torso "
          f"z first below 0.18 m at step {int(np.argmax(z < 0.18)) if (z < 0.18).any() else -1}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    f = sub.add_parser("find")
    f.add_argument("--gate", default="go2_trot")
    f.add_argument("--out", required=True)
    c = sub.add_parser("compare")
    c.add_argument("file")
    args = p.parse_args(argv)
    if args.cmd == "find":
        return find(args.gate, args.out)
    # the stand-in MJCF for mujoco and the JAX package alike
    os.environ["TPU_DIALMPC_ASSETS"] = str(ROOT / "tests" / "assets")
    with np.load(args.file) as f:
        data = {k: f[k] for k in f.files}
    if "bad_us" in data:
        compare_blowup(data)
    compare_trajectory(data)
    return 0


if __name__ == "__main__":
    sys.exit(main())
