"""torch port, around the physics pipeline, on the CPU and without JAX:
`LeggedEnv.full_state` (the reset state, from the fused substep's plain
forward stages) against `pipeline.init`; the runner and the CLI's `replay`
and `env-test` off the fused path; `TelemetryStream.emit`; the checkpoint's
generator device.

Tolerance: full_state and pipeline.init compute the same forward
kinematics and velocities in two op orders: 1e-12 in float64."""

import contextlib
import dataclasses
import io
import json
import time

import numpy as np
import pytest
import torch

from torch_port_helpers import use_eager_graphs
from tpu_dialmpc_torch import checkpoint
from tpu_dialmpc_torch.cli import main as tcli
from tpu_dialmpc_torch.dynamics import pipeline
from tpu_dialmpc_torch.envs import dial_defaults, get_env
from tpu_dialmpc_torch.envs.base import LeanEnvState
from tpu_dialmpc_torch.planner import dial as tdial
from tpu_dialmpc_torch.planner import runner
from tpu_dialmpc_torch.telemetry import TelemetryStream

DERIVED = ("xpos", "xquat", "site_xpos", "subtree_com", "cvel", "qfrc_actuator")


@pytest.mark.parametrize("task,scene", [("go2_stand", None), ("h1_push_crate", None),
                                        ("go2_trot_position", None),
                                        ("go2_stand", "go2_pair_kinds")])
def test_full_state_equals_pipeline_init(task, scene):
    """The reset state's derived fields (LeggedEnv.full_state, which reset
    and checkpoint.load use) are pipeline.init's, at the reset state and at
    a moved one."""
    kw = dict(scene=scene) if scene else {}
    env = get_env(task, device="cpu", dtype="float64", **kw)
    reset = env.reset()
    ps = reset.pipeline
    rng = np.random.default_rng(0)
    moved = env.full_state(ps.qpos + torch.as_tensor(rng.normal(scale=0.05, size=ps.qpos.shape)),
                           torch.as_tensor(rng.normal(scale=0.3, size=ps.qvel.shape)),
                           ps.qacc_warmstart, reset.info, reset.reward, reset.done)
    for state in (reset, moved):
        want = pipeline.init(env.model, state.pipeline.qpos, state.pipeline.qvel)
        for f in DERIVED:
            np.testing.assert_allclose(getattr(state.pipeline, f).numpy(),
                                       getattr(want, f).numpy(), rtol=0, atol=1e-12,
                                       err_msg=f)
        assert torch.equal(want.qacc_warmstart, torch.zeros_like(want.qvel))
        assert state.pipeline.efc_force is None and want.efc_force.shape[0] > 0


def test_run_off_the_fused_path_executes_with_env_step(monkeypatch):
    """runner.run on a fused="off" env executes with step_lean on the
    pipeline and carries its LeanEnvState, captured (each env step a unit,
    through the CPU stand-in for a CUDA graph) as eagerly: the same
    rewards, qpos, qvel and executed controls."""
    env = get_env("go2_stand", device="cpu", n_substeps=1, fused="off")
    cfg = tdial.DialConfig(**dict(dial_defaults("go2_stand"), Nsample=4, Hsample=2, Hnode=1))
    eager = runner.run(env, cfg, n_steps=3, capture=False)
    use_eager_graphs(monkeypatch.setattr)
    res = runner.run(env, cfg, n_steps=3)
    assert res.captured and not eager.captured
    assert isinstance(res.final_state, LeanEnvState)
    for f in ("rewards", "qpos", "qvel", "us"):
        assert torch.equal(getattr(res, f), getattr(eager, f)), f
    assert torch.isfinite(res.rewards).all() and res.qpos.shape == (3, env.model.nq)


def _cli(*argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert tcli.main(list(argv)) == 0
    return out.getvalue()


def test_cli_replay_and_env_test_on_the_cpu(tmp_path):
    """`run --out` on the fused path, its trajectory replayed through env.step
    (the pipeline) from the saved start state; `env-test` with zero
    actions."""
    small = ["--device", "cpu", "--substeps", "1"]
    _cli("run", "--task", "go2_stand", "--nsample", "4", "--hsample", "2", "--n-steps", "3",
         "--out", str(tmp_path / "o.npz"), *small)
    out = _cli("replay", "--task", "go2_stand", "--trajectory", str(tmp_path / "o.npz"), *small)
    line = out.strip().splitlines()[-1]
    assert line.startswith("replayed 3 steps; final qpos drift ")
    # float32 on both paths, two factorisations: close, not equal
    assert float(line.rsplit(" ", 1)[1]) < 1e-3
    out = _cli("env-test", "--task", "h1_walk", "--n-steps", "4", *small)
    lines = out.strip().splitlines()
    assert lines[0].startswith("step 0: z=") and lines[-1].startswith("final qpos[:7]: ")
    with pytest.raises(SystemExit):  # replay needs its trajectory
        tcli.main(["replay", "--device", "cpu"])


def test_telemetry_emit_writes_records_as_given(tmp_path):
    """The JAX test_telemetry.py cases: `emit` writes any dict as one JSONL
    line, through the Python writer and through the native sink; a full
    queue drops rather than blocks, and counts what it dropped."""
    for backend in ("python", "native"):
        path = tmp_path / f"{backend}.jsonl"
        with TelemetryStream(str(path), backend=backend) as s:
            for i in range(5):
                s.emit({"t": i, "v": i * 2.0})
            time.sleep(0.3)
        assert s.backend == backend
        assert [json.loads(line) for line in path.read_text().splitlines()] == [
            {"t": i, "v": i * 2.0} for i in range(5)]
    s = TelemetryStream(str(tmp_path / "d.jsonl"), maxsize=2, backend="python")
    for i in range(1000):
        s.emit({"t": i})  # must never block the control loop
    s.close()
    assert s.dropped + len(s.records) == 1000


def test_checkpoint_names_its_generator_device_and_refuses_another(tmp_path):
    """meta's generator_device is the generator's device type; a checkpoint
    whose generator lived on another device type raises on load instead of
    loading foreign bytes (the card's side: tests/test_torch_cuda.py)."""
    env = get_env("go2_stand", device="cpu", n_substeps=1)
    cfg = tdial.DialConfig(**dict(dial_defaults("go2_stand"), Nsample=4, Hsample=2, Hnode=1))
    path = str(tmp_path / "ck.npz")
    gen = torch.Generator().manual_seed(3)
    checkpoint.save(path, env.reset(), torch.zeros(2, 12), gen, cfg, 0)
    with np.load(path) as data:
        meta = json.loads(str(data["meta"]))
        entries = {k: data[k] for k in data.files}
    assert meta["generator_device"] == "cpu"
    assert checkpoint.load(path, env)[4] == 0
    entries["meta"] = json.dumps(dict(meta, generator_device="cuda"))
    np.savez(path, **entries)
    with pytest.raises(ValueError, match="saved on 'cuda' and cannot resume on 'cpu'"):
        checkpoint.load(path, env)
    assert dataclasses.asdict(cfg) == meta["dial"]
