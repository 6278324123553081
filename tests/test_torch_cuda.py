"""torch port, the fused substep kernel on the card, for the Go2 stand-in
(plane-sphere contacts), the crate stand-in (all six contact kinds), the
H1 push-crate stand-in (all six kinds, and contact rows that couple the
robot's and the crate's kinematic trees), the Go2 position stand-in (the
servos' affine-bias branch) and the arms-fixed H1 (h1_loco); the physics
pipeline's step on the card without a host synchronisation; a CPU
checkpoint refused on the card; the profiler's fp32 microbench kernel and
the measured roof; the sharded planner on one NCCL rank; a quality gate's
run on the card: marked `cuda`, and each test skips without a CUDA device.

It imports neither jax nor the JAX package, so it runs where only PyTorch is
installed; `--noconftest` keeps pytest from loading tests/conftest.py, which
sets jax up for the JAX package's tests:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: the kernel follows the plain version's op order with the same
rounding (nvcc -fmad=false, the same CUDA math library), so on the card the
two agree to 1e-6 of each output's scale; a wrong formula shows up at 1e-3
and above.
"""

import numpy as np
import pytest
import torch

from torch_port_helpers import (
    CRATE_NPZ,
    H1_NPZ,
    PORT_NPZ,
    crate_states,
    h1_crate_states,
    h1_floor_states,
    near_home_states,
    servo_clamps,
    servo_states,
)
from tpu_dialmpc_torch.dynamics import fused, fused_cuda
from tpu_dialmpc_torch.dynamics.model import load_model

pytestmark = pytest.mark.cuda

SPEC = fused.DerivedSpec(torso_body=1)  # "base"


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def model():
    return load_model(str(PORT_NPZ))


@pytest.fixture(scope="module")
def crate_model():
    return load_model(str(CRATE_NPZ))


@pytest.fixture(scope="module")
def h1_model():
    return load_model(str(H1_NPZ))


def _inputs(model, B, seed, device):
    rng = np.random.default_rng(seed)
    qpos, qvel, _ = near_home_states(model, rng, B, scale_q=0.05, scale_v=0.2)
    arrays = (qpos, qvel, np.zeros((B, model.nv)), rng.uniform(-10, 10, (B, model.nu)))
    return [torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
            for a in arrays]


@pytest.mark.parametrize("B,n_substeps", [(1, 8), (257, 8), (2049, 1)])
def test_kernel_matches_plain_on_card(card, model, B, n_substeps):
    fs = fused_cuda.FusedStep(model, n_substeps, SPEC)
    args = _inputs(model, B, B, card)
    out = fs(*args)
    ref = fs.plain(*args)
    torch.cuda.synchronize()
    assert fs.launches == 1
    for o, r in zip(out, ref):
        assert o.shape == r.shape and bool(torch.isfinite(o).all())
        assert (o - r).abs().max().item() <= 1e-6 * max(1.0, r.abs().max().item())


def test_empty_batch_launches_nothing(card, model):
    fs = fused_cuda.FusedStep(model, 1, SPEC)
    out = fs(*_inputs(model, 0, 0, card))
    assert fs.launches == 0
    assert [tuple(o.shape) for o in out] == [
        (0, model.nq), (0, model.nv), (0, model.nv), (0, fused.derived_size(model, SPEC))
    ]


@pytest.mark.parametrize("case", ["float64", "strided", "wrong_width"])
def test_wrapper_rejects_what_the_kernel_does_not_take(card, model, case):
    fs = fused_cuda.FusedStep(model, 1, SPEC)
    args = _inputs(model, 4, 0, card)
    if case == "float64":
        args[1], error = args[1].double(), TypeError
    elif case == "strided":
        args[0], error = torch.cat([args[0], args[0]], dim=1)[:, ::2], ValueError
    else:
        args[3], error = args[3][:, :-1].contiguous(), ValueError
    with pytest.raises(error):
        fs(*args)
    assert fs.launches == 0


@pytest.mark.parametrize("B", [12, 2049])
def test_crate_kernel_matches_plain_on_card(card, crate_model, B):
    """The crate build: 8 substeps on a batch where every contact kind has
    an active contact."""
    m = crate_model
    rng = np.random.default_rng(B)
    qpos, qvel = crate_states(m, rng, B)
    arrays = (qpos, qvel, np.zeros((B, m.nv)), rng.uniform(-10, 10, (B, m.nu)))
    args = [torch.as_tensor(a, dtype=torch.float32, device=card).contiguous() for a in arrays]
    active = fused.active_contacts(m, args[0])
    assert len(active) == 6 and all(n > 0 for n in active.values()), active
    fs = fused_cuda.FusedStep(m, 8, SPEC)
    out = fs(*args)
    ref = fs.plain(*args)
    torch.cuda.synchronize()
    assert fs.launches == 1
    for o, r in zip(out, ref):
        assert o.shape == r.shape and bool(torch.isfinite(o).all())
        assert (o - r).abs().max().item() <= 1e-6 * max(1.0, r.abs().max().item())


@pytest.mark.parametrize("B", [1, 2049])
def test_h1_kernel_matches_plain_on_card(card, h1_model, B):
    """The H1 push-crate build (nv=26, cross-tree cliques and fill-in in the
    Newton Hessian, the crate's slide joint): 8 substeps, with contacts
    that couple the two trees active; at B=2049 every kind too, at B=1 the
    sample that leans its torso's corners into the crate."""
    m = h1_model
    rng = np.random.default_rng(B)
    qpos, qvel = h1_crate_states(m, rng, max(B, 10))
    rows = slice(4, 5) if B == 1 else slice(0, B)
    arrays = (qpos[rows], qvel[rows], np.zeros((B, m.nv)), rng.uniform(-10, 10, (B, m.nu)))
    args = [torch.as_tensor(a, dtype=torch.float32, device=card).contiguous() for a in arrays]
    assert fused.active_two_tree_contacts(m, args[0]) > 0
    if B > 1:
        active = fused.active_contacts(m, args[0])
        assert len(active) == 6 and all(n > 0 for n in active.values()), active
    fs = fused_cuda.FusedStep(m, 8, fused.DerivedSpec(torso_body=m.body_names.index("pelvis")))
    out = fs(*args)
    ref = fs.plain(*args)
    torch.cuda.synchronize()
    assert fs.launches == 1
    for o, r in zip(out, ref):
        assert o.shape == r.shape and bool(torch.isfinite(o).all())
        assert (o - r).abs().max().item() <= 1e-6 * max(1.0, r.abs().max().item())


def _scene_inputs(m, scene, B, seed, device):
    """Inputs for the launch-shape compares: near home on go2_force; on the
    crate models the states that touch every contact kind (and on H1 the
    slots that span both trees); at B=1 a state in contact."""
    rng = np.random.default_rng(seed)
    if scene == "go2_force":
        return _inputs(m, B, seed, device)
    states, row, n_min = ((crate_states, 1, 6) if scene == "go2_force_crate"
                          else (h1_crate_states, 4, 10))
    qpos, qvel = states(m, rng, max(B, n_min))
    rows = slice(row, row + 1) if B == 1 else slice(0, B)
    arrays = (qpos[rows], qvel[rows], np.zeros((B, m.nv)), rng.uniform(-10, 10, (B, m.nu)))
    return [torch.as_tensor(a, dtype=torch.float32, device=device).contiguous() for a in arrays]


@pytest.mark.parametrize("scene,batch", [
    ("go2_force", "one"), ("go2_force", "partial"),
    ("go2_force_crate", "one"), ("go2_force_crate", "partial"),
    ("h1_push_crate", "one"), ("h1_push_crate", "partial"), ("h1_push_crate", 8192),
])
def test_launch_shapes_match_plain_on_card(card, scene, batch):
    """The warp-per-sample launch: one sample (one warp of one block), a
    batch of 2049 or more that leaves the last block partly filled, and on
    H1 8192 samples, several waves of blocks; 8 substeps each."""
    m = load_model(str(PORT_NPZ.with_name(f"{scene}.npz")))
    spec = fused.DerivedSpec(torso_body=m.body_names.index("pelvis" if scene.startswith("h1")
                                                           else "base"))
    fs = fused_cuda.FusedStep(m, 8, spec)
    spb = fused_cuda.launch_config(fused_cuda.pack_model(m, fs.meta, spec)[0])[1]
    if batch == "one":
        B = 1
    elif batch == "partial":
        B = next(b for b in range(2049, 2049 + 8) if b % spb)
        assert spb > 1, "with one sample per block no block is partly filled"
    else:
        B = batch
    args = _scene_inputs(m, scene, B, B, card)
    out = fs(*args)
    ref = fs.plain(*args)
    torch.cuda.synchronize()
    assert fs.launches == 1
    for o, r in zip(out, ref):
        assert o.shape == r.shape and bool(torch.isfinite(o).all())
        assert (o - r).abs().max().item() <= 1e-6 * max(1.0, r.abs().max().item())


@pytest.mark.parametrize("scene", ["go2_position", "h1_loco"])
def test_new_scene_kernels_bit_equal_to_plain_on_card(card, scene):
    """B=2049, 8 substeps, equal to the bit: the position servos with their
    ctrl and force clamps binding for some samples (the affine-bias branch),
    and the arms-fixed H1 with every contact kind of its scene active."""
    m = load_model(str(PORT_NPZ.with_name(f"{scene}.npz")))
    rng = np.random.default_rng(7)
    B = 2049
    if scene == "go2_position":
        arrays = servo_states(m, rng, B)
        clamped_ctrl, clamped_force, bias = servo_clamps(m, *arrays[:2], arrays[3])
        assert clamped_ctrl > 0 and clamped_force > 0 and bias > 1.0
        torso = "base"
    else:
        qpos, qvel = h1_floor_states(m, rng, B)
        arrays = (qpos, qvel, np.zeros((B, m.nv)), rng.uniform(-10, 10, (B, m.nu)))
        torso = "pelvis"
    args = [torch.as_tensor(a, dtype=torch.float32, device=card).contiguous() for a in arrays]
    if scene == "h1_loco":
        active = fused.active_contacts(m, args[0])
        assert len(active) == 3 and all(n > 0 for n in active.values()), active
    fs = fused_cuda.FusedStep(m, 8, fused.DerivedSpec(
        torso_body=m.body_names.index(torso), want_sites=True, want_qfrc_actuator=True))
    out = fs(*args)
    ref = fs.plain(*args)
    torch.cuda.synchronize()
    assert fs.launches == 1
    for o, r in zip(out, ref):
        assert bool(torch.isfinite(o).all()) and torch.equal(o, r)


def test_pipeline_step_on_the_card_makes_no_host_sync(card):
    """A warm pipeline.step (8 substeps, B=64) on the card: no
    synchronising call inside the step's range of the profiler's trace
    (torch's sync debug mode raises on one too; the profiler synchronises
    the device on its own when it stops), no copy between host and device
    in the trace, and finite results."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpu_dialmpc_torch.dynamics import pipeline
    from tpu_dialmpc_torch.envs.base import LeanPipelineState

    m = load_model(str(PORT_NPZ.with_name("go2_force_crate.npz")))
    qpos, qvel = crate_states(m, np.random.default_rng(0), 64)
    args = [torch.as_tensor(a, dtype=torch.float32, device=card) for a in
            (qpos, qvel, np.zeros_like(qvel), np.random.default_rng(1).uniform(-10, 10, (64, m.nu)))]
    state = LeanPipelineState(*args[:3])
    pipeline.step(m, state, args[3], 8)  # builds the model's device constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function("pipeline.step"):
                out = pipeline.step(m, state, args[3], 8)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    events = prof.events()
    window = next(ev.time_range for ev in events
                  if ev.name == "pipeline.step" and str(ev.device_type).endswith("CPU"))
    syncs = [ev.name for ev in events if "Synchronize" in ev.name
             and window.start <= ev.time_range.start <= window.end]
    copies = [ev.name for ev in events if "HtoD" in ev.name or "DtoH" in ev.name]
    assert not syncs and not copies, (syncs, copies)
    assert bool(torch.isfinite(out.qpos).all()) and out.efc_force.shape[0] == 64


def test_cpu_checkpoint_refuses_to_resume_on_the_card(card, tmp_path):
    """A checkpoint written with a CPU generator raises on a CUDA env, and
    names the devices, instead of loading a CPU generator's bytes into a
    CUDA generator."""
    from tpu_dialmpc_torch import checkpoint
    from tpu_dialmpc_torch.envs import dial_defaults, get_env
    from tpu_dialmpc_torch.planner.dial import DialConfig

    cfg = DialConfig(**dict(dial_defaults("go2_stand"), Nsample=4, Hsample=2, Hnode=1))
    cpu_env = get_env("go2_stand", device="cpu")
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, cpu_env.reset(), torch.zeros(2, 12), torch.Generator().manual_seed(0),
                    cfg, 0)
    with pytest.raises(ValueError, match="saved on 'cpu' and cannot resume on 'cuda'"):
        checkpoint.load(path, get_env("go2_stand", device=card))


def test_fp32_peak_kernel_matches_plain_on_card(card):
    """The profiler's fp32 microbench (csrc/fp32_peak.cu) against its plain
    version on the same inputs: 1e-5 relative (the plain version rounds a
    float64 multiply-add to float32 once per step, as the FMA does; a rare
    tie rounds twice); one step fewer moves the result by ~2.4e-4."""
    from tpu_dialmpc_torch.telemetry import profile as prof

    chain = prof.FmaChain()
    x0, a, b = prof.fp32_peak_inputs(card, n=3000)
    got = chain(x0, a, b, 256)
    want = chain.plain(x0, a, b, 256)
    torch.cuda.synchronize()
    assert chain.launches == 1 and got.shape == (3000,) and bool(torch.isfinite(got).all())
    assert ((got - want).abs() / want.abs()).max().item() <= 1e-5
    fewer = chain.plain(x0, a, b, 255)
    assert ((got - fewer).abs() / want.abs()).min().item() > 1e-4
    with pytest.raises(TypeError):
        chain(x0.double(), a, b, 8)
    assert chain.launches == 1


def test_profile_microbenchmarks_on_card(card):
    """The measured roof is positive and within 5 % of the H100's data sheet
    (67 TFLOP/s fp32, 3.35 TB/s) or below it."""
    from tpu_dialmpc_torch.telemetry import profile as prof

    peak, hbm = prof.fp32_peak_ops_per_sec(), prof.hbm_copy_bytes_per_sec()
    assert 0 < peak <= 1.05 * 67e12 and 0 < hbm <= 1.05 * 3.35e12


def test_sharded_planner_one_nccl_rank_matches_mbdpi_on_card(card):
    """ShardedMBDPI in a one-rank NCCL group (spawned), go2_stand at N64/H4,
    8 substeps: Ybar and weights against MBDPI on the same inputs, injected
    and from the shared generator (1e-5: float32, another summation order);
    one fused launch per horizon step."""
    import torch_shard_ranks as ranks
    from tpu_dialmpc_torch.shard import distributed

    [out] = distributed.run_group(ranks.card_reverse_once, 1, ((64, 4, 2, 8),), backend="nccl",
                                  device=card, timeout_s=300)
    assert out["backend"] == "nccl" and out["block"] == (0, 64)
    assert out["host_calls"]["c10d::allreduce_"][0] == 5  # score_std="sample"
    for how in ("injected", "generator"):
        o = out[how]
        assert np.abs(o["Ybar"] - o["single_Ybar"]).max() <= 1e-5
        assert np.abs(o["weights"] - o["single_weights"]).max() <= 1e-5 * o["single_weights"].max()
        assert o["launches"] == 4 + 1


def test_run_gate_on_card(card, monkeypatch):
    """run_gate on the card (its default device) for go2_jump's quick lane at
    N64/H2/Hnode1, 3 steps, 8 substeps: the card's name in the result, one
    fused launch per horizon step and per executed step, finite metrics,
    and the flight metrics of the card's float64 FK equal to the CPU's."""
    import dataclasses

    import tpu_dialmpc_torch.envs as envs_mod
    from tpu_dialmpc_torch import quality as q
    from tpu_dialmpc_torch.planner import runner

    made, runs, get, scan = [], [], envs_mod.get_env, runner.run_scan
    monkeypatch.setattr(envs_mod, "get_env", lambda *a, **kw: made.append(get(*a, **kw))
                        or made[-1])
    monkeypatch.setattr(runner, "run_scan", lambda *a, **kw: runs.append(scan(*a, **kw))
                        or runs[-1])
    monkeypatch.setitem(q.GATES, "go2_jump", dataclasses.replace(
        q.GATES["go2_jump"], dial=dict(Nsample=64, Hsample=2, Hnode=1), quick_n_steps=3))
    r = q.run_gate("go2_jump", quick=True)
    assert r["device"] == torch.cuda.get_device_name(0) and r["n_steps"] == 3
    assert all(np.isfinite(v) for v in r["metrics"].values())
    horizon = 3
    first = 1 * horizon + (1 + 10 * horizon)
    assert made[0].fused_step.launches == first + 2 * (1 + 2 * horizon)
    qpos = runs[0].qpos
    assert qpos.device.type == "cuda"
    cpu_env = get("go2_jump", device="cpu")
    cpu = q._flight_metrics(cpu_env, qpos.cpu())
    assert cpu == {k: r["metrics"][k] for k in cpu}
    diff = (q.foot_positions(made[0], qpos).cpu() - q.foot_positions(cpu_env, qpos.cpu())).abs()
    assert diff.max().item() <= 1e-9
