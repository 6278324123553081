"""torch port, the closed-loop entry point on the CPU: `planner/runner.py`
(`run` with checkpoints, resume, retries and telemetry; `run_scan`),
`checkpoint.py`, `telemetry/stream.py` and `cli/main.py`'s `run`.

The runs are go2_stand at a tiny width (Nsample=4, Hsample=2, Hnode=1, one
substep, one annealing iteration per step), on the plain substep chain.
Equalities are bit for bit (`torch.equal`): a resumed, retried or bare-loop
run draws the same noise in the same order from the same generator state
and repeats the same float32 arithmetic.  Against the JAX package: the
checkpoint's entry names, the telemetry records' keys, `_build`'s resolved
configs and `--out`'s keys, which are exact; the telemetry values to 1e-6
(float32 statistics summed in two orders).
"""

import argparse
import dataclasses
import json
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_port_helpers import use_standin_assets
from tpu_dialmpc_torch import checkpoint
from tpu_dialmpc_torch.cli import main as tcli
from tpu_dialmpc_torch.envs import get_env
from tpu_dialmpc_torch.planner import runner
from tpu_dialmpc_torch.planner.dial import DialConfig
from tpu_dialmpc_torch.telemetry import TelemetryStream

ROOT = Path(__file__).resolve().parents[1]
CFG = DialConfig(Nsample=4, Hsample=2, Hnode=1, Ndiffuse=1, Ndiffuse_init=1, n_steps=6, seed=3)
OUT_KEYS = {"rewards", "qpos", "qvel", "us", "dones", "qpos0", "qvel0", "warmstart0", "dt"}


@pytest.fixture(scope="module")
def env():
    return get_env("go2_stand", device="cpu", n_substeps=1)


@pytest.fixture(scope="module")
def clean(env):
    return runner.run(env, CFG)


def _same_records(got, want, steps=slice(None)):
    for f in ("rewards", "dones", "qpos", "qvel", "us"):
        assert torch.equal(getattr(got, f), getattr(want, f)[steps]), f


def test_run_scan_equals_run(env, clean):
    res = runner.run_scan(env, CFG)
    _same_records(res, clean)
    assert torch.equal(res.final_Y0, clean.final_Y0)
    assert torch.equal(res.qpos0, clean.qpos0) and torch.equal(res.warmstart0, clean.warmstart0)
    assert bool(torch.isfinite(res.rewards).all()) and res.qpos.shape == (6, env.model.nq)


def test_resume_from_a_step_2_checkpoint_equals_the_uninterrupted_run(env, clean, tmp_path):
    ck = str(tmp_path / "ck.npz")
    first = runner.run(env, CFG, n_steps=2, checkpoint_path=ck)
    _same_records(first, clean, slice(0, 2))
    state, Y0, generator, cfg, step = checkpoint.load(ck, env)
    assert step == 2 and cfg == CFG
    res = runner.run(env, cfg, resume=(state, Y0, generator, step))
    _same_records(res, clean, slice(2, 6))
    assert torch.equal(res.final_Y0, clean.final_Y0)
    # the resumed run starts from the checkpoint's state, warmstart included
    assert torch.equal(res.qpos0, clean.qpos[1]) and torch.equal(res.warmstart0, state.pipeline.qacc_warmstart)
    with pytest.raises(ValueError):  # a checkpoint written at the end of its run
        runner.run(env, cfg, n_steps=2, resume=(state, Y0, generator, step))


def _flaky(monkeypatch, fail_at):
    """Make the control step raise once, at its call number `fail_at` (0-based)."""
    calls = {"n": 0, "raised": False}
    orig = runner.make_control_step

    def flaky(mbdpi, n_diffuse):
        fn = orig(mbdpi, n_diffuse)

        def wrapped(state, Y0, generator):
            calls["n"] += 1
            if calls["n"] == fail_at + 1 and not calls["raised"]:
                calls["raised"] = True
                raise RuntimeError("injected fault")
            return fn(state, Y0, generator)

        return wrapped

    monkeypatch.setattr(runner, "make_control_step", flaky)
    return calls


def test_fault_at_step_3_is_retried_from_the_last_checkpoint(env, clean, tmp_path, monkeypatch):
    calls = _flaky(monkeypatch, fail_at=3)
    res = runner.run(env, CFG, checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=2,
                     max_retries=1)
    assert calls["raised"] and calls["n"] == 6 + 2  # steps 2 and 3 replayed
    _same_records(res, clean)
    assert torch.equal(res.final_Y0, clean.final_Y0)


def test_fault_without_retries_raises(env, tmp_path, monkeypatch):
    _flaky(monkeypatch, fail_at=3)
    with pytest.raises(RuntimeError, match="injected fault"):
        runner.run(env, CFG, checkpoint_path=str(tmp_path / "ck.npz"), checkpoint_every=2)


def test_checkpoint_entries_are_the_jax_files_and_roundtrip(env, clean, tmp_path):
    """The JAX checkpoint's entry names, but its PRNG keys are the port's
    own: `key` is the generator's state and `info_rng` the randomize_tasks
    seed `info_seed`; loading gives back the saved state, Y0 and generator, and the
    derived fields of the forward stages `reset` uses."""
    import jax
    import jax.numpy as jnp

    from tpu_dialmpc import checkpoint as jcheckpoint
    from tpu_dialmpc.envs.base import LeanEnvState, LeanPipelineState, StateInfo as JInfo
    from tpu_dialmpc.planner.dial import DialConfig as JDialConfig

    state = clean.final_state
    jstate = LeanEnvState(
        pipeline=LeanPipelineState(*(jnp.asarray(getattr(state.pipeline, f).numpy())
                                     for f in ("qpos", "qvel", "qacc_warmstart"))),
        obs=jnp.asarray(state.obs.numpy()), reward=jnp.asarray(state.reward.numpy()),
        done=jnp.asarray(state.done.numpy()),
        info=JInfo(rng=jax.random.PRNGKey(0), **{f.name: jnp.asarray(getattr(state.info, f.name).numpy())
                                                 for f in dataclasses.fields(state.info)
                                                 if f.name != "seed"}),
    )
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jcheckpoint.save(jpath, jstate, jnp.asarray(clean.final_Y0.numpy()), jax.random.PRNGKey(1),
                     JDialConfig(**dataclasses.asdict(CFG)), 6)
    gen = torch.Generator().manual_seed(11)
    torch.randn(5, generator=gen)
    checkpoint.save(tpath, state, clean.final_Y0, gen, CFG, 6)
    with np.load(jpath) as j, np.load(tpath) as t:
        assert set(t.files) - {"generator", "info_seed"} == set(j.files) - {"key", "info_rng"}
        meta = json.loads(str(t["meta"]))
        # the port's own meta entry: the generator's device type
        assert meta.pop("generator_device") == "cpu"
        assert meta == json.loads(str(j["meta"]))
        for name in set(t.files) - {"generator", "meta", "info_seed"}:
            np.testing.assert_array_equal(t[name], j[name], err_msg=name)

    loaded, Y0, gen2, cfg, step = checkpoint.load(tpath, env)
    assert (cfg, step) == (CFG, 6) and torch.equal(Y0, clean.final_Y0)
    assert torch.equal(torch.randn(7, generator=gen2), torch.randn(7, generator=gen))
    for f in ("qpos", "qvel", "qacc_warmstart"):
        assert torch.equal(getattr(loaded.pipeline, f), getattr(state.pipeline, f)), f
    for f in dataclasses.fields(state.info):
        assert torch.equal(getattr(loaded.info, f.name), getattr(state.info, f.name)), f.name
    # a reset state saved and loaded: the same derived fields and obs as reset's
    reset = env.reset()
    checkpoint.save(tpath, reset, Y0, gen, CFG, 0)
    again = checkpoint.load(tpath, env)[0]
    for f in dataclasses.fields(reset.pipeline):
        a, b = getattr(again.pipeline, f.name), getattr(reset.pipeline, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name  # efc_force: None
    assert torch.equal(again.obs, reset.obs)


def _infos(diag, rng):
    """A control step's stacked infos of two annealing iterations, in torch
    and as numpy for the JAX stream; with diag_states' weighted states or
    the (1, 1) placeholders."""
    T, nq, nv = 3, 19, 18
    arrays = dict(rews=rng.normal(size=(2, 5)), ess=rng.uniform(1, 5, 2),
                  entropy=rng.uniform(0, 1, 2))
    shapes = dict(qbar=(T, nq), qdbar=(T, nv), xbar=(T, 3)) if diag else dict(
        qbar=(1, 1), qdbar=(1, 1), xbar=(1, 1))
    arrays.update({k: rng.normal(size=(2,) + s) if diag else np.zeros((2,) + s)
                   for k, s in shapes.items()})
    arrays = {k: v.astype(np.float32) for k, v in arrays.items()}
    return (types.SimpleNamespace(**{k: torch.as_tensor(v) for k, v in arrays.items()}),
            types.SimpleNamespace(**arrays))


@pytest.mark.parametrize("diag", [False, True])
def test_telemetry_records_carry_the_jax_keys(clean, diag):
    from tpu_dialmpc.telemetry import TelemetryStream as JStream

    state = clean.final_state
    jstate = types.SimpleNamespace(
        reward=state.reward.numpy(), done=state.done.numpy(),
        pipeline=types.SimpleNamespace(qpos=state.pipeline.qpos.numpy()))
    tinfos, jinfos = _infos(diag, np.random.default_rng(int(diag)))
    with TelemetryStream() as ts, JStream() as js:
        ts.emit_step(4, state, tinfos)
        ts.emit_step(5, state, None)
        js.emit_step(4, jstate, jinfos)
        deadline = time.time() + 10
        while len(ts.records) < 2 and time.time() < deadline:
            time.sleep(0.01)
    (got, got_none), (want,) = ts.records, js.records
    assert list(got) == list(want)  # the same keys in the same order
    assert ("xbar_end" in got) == diag
    for k in want:
        if k != "time":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6, err_msg=k)
    assert got_none["t"] == 5 and got_none["ess"] is None and got_none["rew_std"] is None


def test_telemetry_stream_drops_rather_than_blocks(clean, tmp_path, monkeypatch):
    """With the writer stuck on its first record, emits return at once and
    the records past the queue's room are dropped and counted."""
    release = threading.Event()
    orig = TelemetryStream._write

    def stuck(self, rec):
        release.wait(timeout=30)
        orig(self, rec)

    monkeypatch.setattr(TelemetryStream, "_write", stuck)
    path = tmp_path / "t.jsonl"
    stream = TelemetryStream(str(path), maxsize=3)
    try:
        t0 = time.perf_counter()
        for t in range(20):
            stream.emit_step(t, clean.final_state, None)
        assert time.perf_counter() - t0 < 5.0
        assert stream.dropped >= 20 - 3 - 1
    finally:
        release.set()
        stream.close()
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == 20 - stream.dropped and lines[0]["t"] == 0
    with pytest.raises(ValueError):  # the backends are "auto", "native" and "python"
        TelemetryStream(backend="ring")


def _ns(**kw):
    base = dict(task="go2_stand", config=None, nsample=None, hsample=None, n_steps=None,
                substeps=None, device="cpu")
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("flags", [
    dict(task="go2_trot_position", nsample=64),
    dict(task="h1_loco", hsample=16, n_steps=7, substeps=2),
    dict(config=str(ROOT / "configs" / "h1_walk.yaml")),
    dict(config=str(ROOT / "configs" / "h1_walk.yaml"), nsample=32, substeps=1),
], ids=["position", "h1_loco_flags", "h1_walk_yaml", "h1_walk_yaml_and_flags"])
def test_build_resolves_the_configs_of_the_jax_build(monkeypatch, flags):
    """registry defaults < YAML < flags, as the JAX CLI's `_build`."""
    from tpu_dialmpc.cli.main import _build as jbuild

    use_standin_assets(monkeypatch)
    jenv, jdial, jtask = jbuild(_ns(**flags))
    tenv, tdial, ttask = tcli._build(_ns(**flags))
    assert ttask == jtask and dataclasses.asdict(tdial) == dataclasses.asdict(jdial)
    jc, tc = dataclasses.asdict(jenv.config), dataclasses.asdict(tenv.config)
    assert {k: tc[k] for k in jc if k in tc} == {k: jc[k] for k in jc if k in tc}
    assert str(tenv.device) == "cpu"


def test_cli_run_writes_the_jax_out_keys_resumes_and_scans(tmp_path, capsys):
    """`run --out` writes the JAX CLI's keys; a run resumed from a checkpoint
    and a `--scan` run equal the uninterrupted run bit for bit; telemetry
    writes one record per step; `--scan` refuses the host loop's options."""
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("task: go2_stand\nenv: {n_substeps: 1}\n"
                   "dial: {Nsample: 4, Hsample: 2, Hnode: 1, Ndiffuse: 1, Ndiffuse_init: 1}\n")
    base = ["run", "--device", "cpu", "--config", str(cfg)]

    def run(*extra):
        assert tcli.main(base + list(extra)) == 0
        return capsys.readouterr().out

    out = run("--n-steps", "4", "--out", str(tmp_path / "full.npz"),
              "--telemetry", str(tmp_path / "t.jsonl"))
    assert "task=go2_stand steps=4 wall=" in out and "average reward: " in out
    run("--n-steps", "2", "--checkpoint", str(tmp_path / "ck.npz"))
    out = run("--resume", str(tmp_path / "ck.npz"), "--n-steps", "4",
              "--out", str(tmp_path / "resumed.npz"))
    assert f"resumed from {tmp_path / 'ck.npz'} at step 2" in out
    run("--n-steps", "4", "--scan", "--out", str(tmp_path / "scan.npz"))
    with np.load(tmp_path / "full.npz") as full, np.load(tmp_path / "resumed.npz") as resumed, \
            np.load(tmp_path / "scan.npz") as scan:
        assert set(full.files) == set(resumed.files) == set(scan.files) == OUT_KEYS
        for k in ("rewards", "qpos", "us"):
            np.testing.assert_array_equal(resumed[k], full[k][2:], err_msg=k)
            np.testing.assert_array_equal(scan[k], full[k], err_msg=k)
        np.testing.assert_array_equal(resumed["qpos0"], full["qpos"][1])
        assert float(full["dt"]) == 0.0025
    records = [json.loads(line) for line in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert [r["t"] for r in records] == [0, 1, 2, 3]
    with pytest.raises(SystemExit):
        tcli.main(base + ["--scan", "--checkpoint", str(tmp_path / "x.npz")])
