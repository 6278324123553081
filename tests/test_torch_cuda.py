"""torch port, the fused substep kernel on the card, for the Go2 stand-in
(plane-sphere contacts), the crate stand-in (all six contact kinds), the
H1 push-crate stand-in (all six kinds, and contact rows that couple the
robot's and the crate's kinematic trees), the Go2 position stand-in (the
servos' affine-bias branch) and the arms-fixed H1 (h1_loco); the physics
pipeline's step on the card without a host synchronisation; a CPU
checkpoint refused on the card; the profiler's fp32 microbench kernel and
the measured roof; the sharded planner on one NCCL rank; a quality gate's
run on the card; the tracer's device spans inside CUDA graphs (timing events
replayed in a graph against the profiler's record of the kernel they
bracket, the nodes of the captured control step with the tracer off and on
and of its traced second graph, `rollout/physics` against the profiler's
B=2049 kernel records); the Go2 env step's two kernels against their plain
version on the card, in a captured rollout and in the captured control
step; the kernel's wave counter in a replay of H1's captured control step;
the crate build right after the H1 build has filled shared memory, and a
first launch on a non-blocking stream right after the model's upload:
marked `cuda`, and each test skips without a CUDA device.

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
    EVENT_RECORD,
    H1_NPZ,
    PORT_NPZ,
    crate_states,
    fused_kernel_records,
    go2_env_inputs,
    graph_node_types,
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


def _crate_args(m, B, seed, device):
    rng = np.random.default_rng(seed)
    qpos, qvel = crate_states(m, rng, B)
    arrays = (qpos, qvel, np.zeros((B, m.nv)), rng.uniform(-10, 10, (B, m.nu)))
    return [torch.as_tensor(a, dtype=torch.float32, device=device).contiguous() for a in arrays]


def test_crate_kernel_bit_equal_to_plain_after_another_build_on_card(card, crate_model,
                                                                      h1_model):
    """The crate build (four samples, 54 KB of shared memory a block) right
    after the H1 build has filled every SM's shared memory with its own
    layout: a read of a byte that the launch did not write would take H1's
    values, and the outputs would not equal the plain version's."""
    rng = np.random.default_rng(0)
    qpos, qvel = h1_crate_states(h1_model, rng, 8193)
    h1_args = [torch.as_tensor(a, dtype=torch.float32, device=card).contiguous()
               for a in (qpos, qvel, np.zeros_like(qvel),
                         rng.uniform(-10, 10, (8193, h1_model.nu)))]
    h1 = fused_cuda.FusedStep(h1_model, 8, fused.DerivedSpec(
        torso_body=h1_model.body_names.index("pelvis")))
    fs = fused_cuda.FusedStep(crate_model, 8, SPEC)
    args = _crate_args(crate_model, 2049, 3, card)
    fs.library(card)
    h1(*h1_args)
    out = fs(*args)
    ref = fs.plain(*args)
    torch.cuda.synchronize()
    assert (h1.launches, fs.launches) == (1, 1)
    for o, r in zip(out, ref):
        assert bool(torch.isfinite(o).all()) and torch.equal(o, r)


def test_a_first_launch_on_another_stream_reads_the_uploaded_model_on_card(
        card, crate_model, tmp_path):
    """The model's upload has landed when it returns.  A library of its own
    (a separate module, whose model can be zeroed without touching other
    tests') first holds a zero model; then, while a 1 GiB copy from host
    memory keeps the copy engine busy, the true model is uploaded and the
    kernel launched at once on a non-blocking stream, which does not wait
    for the copies of the legacy default stream: it must read the true
    model.  Were the upload to return before its copies land, the outputs
    would differ from the plain version's in every trial (H100: finite,
    but not equal)."""
    m = crate_model
    fs = fused_cuda.FusedStep(m, 8, SPEC)
    _, blob, tables = fused_cuda.pack_model(m, fs.meta, fs.spec)
    lib, _, _ = fused_cuda.build_library(m, fs.meta, fs.spec, out_dir=tmp_path)
    args = _crate_args(m, 2049, 4, card)
    ref = fs.plain(*args)
    outs = (torch.empty((2049, m.nq), device=card), torch.empty((2049, m.nv), device=card),
            torch.empty((2049, m.nv), device=card), torch.empty((2049, fs.nd), device=card))
    big = torch.empty(1 << 28, pin_memory=True)
    copy, run = torch.cuda.Stream(card), torch.cuda.Stream(card)
    for _ in range(3):
        lib.upload(bytes(len(blob)), bytes(len(tables)))
        torch.cuda.synchronize()
        for o in outs:
            o.fill_(0.0)
        with torch.cuda.stream(copy):
            big.to(card, non_blocking=True)
        lib.upload(blob, tables)
        with torch.cuda.device(card):
            assert lib.launch(8, *args, outs, run.cuda_stream) == 0
        torch.cuda.synchronize()
        for o, r in zip(outs, ref):
            assert bool(torch.isfinite(o).all()) and torch.equal(o, r)


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
    elif batch == "partial":  # with one sample a block, 2049 blocks of one
        B = next((b for b in range(2049, 2049 + 8) if b % spb), 2049)
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


@pytest.mark.parametrize("scene", [
    "go2_force", "go2_force_crate", "go2_position", "h1_walk", "h1_loco", "h1_push_crate",
    "tests/assets/unitree_h1/mjx_scene_h1_2_walk.xml",
    "tests/assets/pairs/mjx_scene_pair_kinds_fused.xml",
])
def test_the_card_holds_the_samples_of_the_launch_config_on_card(card, scene):
    """Every stand-in build: the samples a wave holds (`lib.resident`) are
    the runtime's occupancy on every SM and `samples_per_sm` at the build's
    shared memory and ptxas' registers, which do not bind on H1's build;
    ptxas spills nothing in the fused kernel; the H1 push-crate build holds
    16 samples an SM (B=8193 in 4 waves), and go2_force's B=2049 launch is
    one wave."""
    from tpu_dialmpc_torch.dynamics.model import load_scene

    root = PORT_NPZ.parents[2]
    m = (load_scene(str(root / scene)) if scene.endswith(".xml")
         else load_model(str(PORT_NPZ.with_name(f"{scene}.npz"))))
    torso = "pelvis" if "h1" in scene else "base"
    spec = fused.DerivedSpec(torso_body=m.body_names.index(torso), want_sites=True,
                             want_qfrc_actuator=True)
    fs = fused_cuda.FusedStep(m, 8, spec)
    lib = fs.library(card)
    info = lib.launch_info()
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    nbytes, spb = fused_cuda.launch_config(fused_cuda.pack_model(m, fs.meta, spec)[0])
    use = fused_cuda.ptxas_usage(fs.build_log)
    assert use["registers"] > 0, fs.build_log
    assert use["spill_stores"] == use["spill_loads"] == 0, use
    assert lib.resident == info["blocks_per_sm"] * info["samples_per_block"] * sms
    assert lib.resident == fused_cuda.samples_per_sm(nbytes, spb, use["registers"]) * sms
    if scene == "h1_push_crate":
        assert info["bytes_per_sample"] <= 14336
        assert lib.resident == fused_cuda.samples_per_sm(nbytes, spb) * sms == 16 * 132
        assert fused_cuda.waves(8193, lib.resident) == 4
    if scene == "go2_force":
        assert fused_cuda.waves(2049, lib.resident) == 1


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
    one fused launch per horizon step.  The planner captures on NCCL: a
    replayed call launches one graph and calls no all-reduce from the host,
    its outputs and bytes all-reduced equal the eager sharded planner's,
    whose call makes the 5 all-reduces."""
    import torch_shard_ranks as ranks
    from tpu_dialmpc_torch.shard import distributed

    [out] = distributed.run_group(ranks.card_reverse_once, 1, ((64, 4, 2, 8),), backend="nccl",
                                  device=card, timeout_s=300)
    assert out["backend"] == "nccl" and out["block"] == (0, 64) and out["captured"]
    assert out["eager_host_calls"]["c10d::allreduce_"][0] == 5  # score_std="sample"
    assert "c10d::allreduce_" not in out["host_calls"]
    assert out["host_calls"]["cudaGraphLaunch"][0] == 1
    for how in ranks.SHARD_HOWS:
        o = out[how]
        assert np.abs(o["Ybar"] - o["single_Ybar"]).max() <= 1e-5
        assert np.abs(o["weights"] - o["single_weights"]).max() <= 1e-5 * o["single_weights"].max()
        assert o["launches"] == 4 + 1
        assert np.array_equal(o["Ybar"], o["eager_Ybar"])
        assert np.array_equal(o["weights"], o["eager_weights"])
        assert o["reduced_bytes"] == o["eager_reduced_bytes"] > 0


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


# ----------------------------------------------------------------------
# the tracer's device spans in CUDA graphs (telemetry/spans.py)
@pytest.fixture
def tracer():
    from tpu_dialmpc_torch.telemetry import spans

    spans.reset()
    spans.enable()
    yield spans
    spans.disable()
    spans.reset()


def test_timing_events_replay_inside_a_graph_on_card(card, model):
    """The probe the tracer rests on: two external timing events captured
    around one fused-kernel launch (B=2049, 8 substeps) become event-record
    nodes, and after a replay their elapsed time brackets the profiler's
    record of that launch: no shorter, and longer by at most 50 us, the
    graph's scheduling of the two event nodes and the kernel."""
    fs = fused_cuda.FusedStep(model, 8, SPEC)
    args = _inputs(model, 2049, 3, card)
    fs(*args)  # builds and loads the kernel
    stream, graph = torch.cuda.Stream(card), torch.cuda.CUDAGraph(keep_graph=True)
    e0, e1 = (torch.cuda.Event(enable_timing=True, external=True) for _ in range(2))
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.graph(graph, stream=stream):
        e0.record()
        fs(*args)
        e1.record()
    graph.instantiate()
    assert graph_node_types(graph).get(EVENT_RECORD) == 2
    graph.replay()
    (record,) = fused_kernel_records(graph.replay)
    ms, kernel_ms = e0.elapsed_time(e1), record[1] * 1e-6
    print(f"[probe] events {ms:.4f} ms, profiler record {kernel_ms:.4f} ms")
    assert kernel_ms > 0.1 and kernel_ms <= ms <= kernel_ms + 0.05


def _captured_step(card, cfg, tracer_on, task="go2_stand"):
    from tpu_dialmpc_torch.envs.registry import get_env
    from tpu_dialmpc_torch.envs.base import to_lean
    from tpu_dialmpc_torch.planner.dial import MBDPI
    from tpu_dialmpc_torch.planner.runner import make_control_step
    from tpu_dialmpc_torch.telemetry import spans

    (spans.enable if tracer_on else spans.disable)()
    env = get_env(task, device=card, n_substeps=8)
    mb = MBDPI(cfg, env, capture=True)
    step = make_control_step(mb, cfg.Ndiffuse)
    state = to_lean(env.reset())
    Y = torch.zeros((cfg.Hnode + 1, env.action_size), device=card)
    gen = torch.Generator(device=card).manual_seed(4)
    for _ in range(3):  # eager, capture, replay
        state, Y, _ = step(state, Y, gen)
    (unit,) = mb.graphs.units.values()
    return unit, lambda: step(state, Y, gen)


def test_tracer_adds_only_its_event_nodes_to_the_captured_step_on_card(card):
    """go2_stand at N64/H4/Hnode2: the captured control step's graph holds
    no event-record node, node for node the same with the tracer off and
    on; the traced second graph holds those nodes and one event-record node
    per mark the spans recorded.  The set-up spans: each kernel library's
    load once (the fused kernel's and the Go2 env kernels'), the capture's
    two spans equal to `capture_s` and `instantiate_s` (the traced graph's
    capture is not set-up)."""
    from tpu_dialmpc_torch.planner.dial import DialConfig
    from tpu_dialmpc_torch.telemetry import spans

    cfg = DialConfig(Nsample=64, Hsample=4, Hnode=2, Ndiffuse=2, seed=1)
    try:
        spans.reset()
        off, _ = _captured_step(card, cfg, False)
        assert off.owned is None and spans.summary() == {}
        spans.reset()
        on, _ = _captured_step(card, cfg, True)
        got = spans.summary()
    finally:
        spans.disable()
        spans.reset()
    kinds_off = graph_node_types(off.graph.graph)
    assert EVENT_RECORD not in kinds_off and off.traced is None
    assert graph_node_types(on.graph.graph) == kinds_off
    kinds_traced = graph_node_types(on.traced.graph)
    n_marks = len(on.owned.marks)
    assert kinds_traced.pop(EVENT_RECORD) == n_marks == 5 + 2 + 2 * (2 + 1 + 4 * 5 + 2)
    assert kinds_traced == kinds_off
    assert got["setup/kernel"]["count"] == got["setup/first_call"]["count"] == 1
    assert got["setup/env_kernels"]["count"] == 1
    assert got["setup/capture"]["host_s"] == on.graph.capture_s
    assert got["setup/instantiate"]["host_s"] == on.graph.instantiate_s
    assert got["graph/replay"]["count"] == 2


def test_rollout_physics_span_equals_the_kernel_records_on_card(card, tracer):
    """go2_stand at N2048/H4/Hnode2, 8 substeps, one replay of the captured
    control step's traced graph under the profiler: the `rollout/physics`
    spans' device time equals the profiler's records of the B=2049 launches
    (all but the step's first, the executed B=1 one) within 3 %, and the
    top-level device spans cover the replay's device time within 2 %."""
    from tpu_dialmpc_torch.planner.dial import DialConfig

    cfg = DialConfig(Nsample=2048, Hsample=4, Hnode=2, Ndiffuse=2, seed=1)
    unit, step = _captured_step(card, cfg, True)
    tracer.collect()
    tracer.reset()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    replay = unit.traced.replay

    def timed():
        e0.record()
        replay()
        e1.record()

    unit.traced.replay = timed
    records = fused_kernel_records(step)
    assert tracer.collect() == 0
    got = tracer.summary()
    assert len(records) == 1 + 2 * 5
    kernels_s = sum(d for _, d in records[1:]) * 1e-9
    physics_s = got["rollout/physics"]["device_s"]
    print(f"[spans] rollout/physics {physics_s * 1e3:.4f} ms, B=2049 records "
          f"{kernels_s * 1e3:.4f} ms")
    assert abs(physics_s / kernels_s - 1) <= 0.03
    top = sum(s["device_s"] for p, s in got.items() if "device_s" in s and "/" not in p)
    whole = 1e-3 * e0.elapsed_time(e1)
    print(f"[spans] top-level spans {top * 1e3:.4f} ms, the replay {whole * 1e3:.4f} ms")
    assert top <= whole and top >= 0.98 * whole


GO2_CONFIGS = {  # tests/test_torch_go2_env_kernel.py's configs, at the registry's settings
    "go2_stand": {},
    "go2_trot_position": {},
    "go2_crate_climb": {},
    "go2_turn": dict(energy_weight=0.5, yaw_mode="eigen"),
    "go2_trot": dict(randomize_tasks=True),
}


def _close(got, want):
    """Equal for integers and bools; floats within 1e-6 of the output's
    scale (the module's tolerance): PyTorch's CUDA ops sum the feet and a
    vector's components as a tree and contract products into FMAs where
    the kernel, built with -fmad=false, keeps the plain version's order and
    roundings, so a few outputs differ in their last bits."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if not got.is_floating_point():
        return torch.equal(got, want)
    scale = max(1.0, want.abs().max().item()) if want.numel() else 1.0
    return (got - want).abs().max().item() <= 1e-6 * scale if want.numel() else True


@pytest.mark.parametrize("B", [1, 2049])
@pytest.mark.parametrize("task", sorted(GO2_CONFIGS))
def test_go2_env_kernels_match_plain_on_card(card, task, B):
    """go2_ctrl and go2_post_physics on CUDA tensors (float32, the rollout's
    layouts: info broadcast with stride 0, the reward inputs views of one
    row block) against `_ctrl_batch_plain` and `_post_physics_plain` on the
    same tensors: `done`, `step` and `last_contact` equal, floats within
    `_close`'s bound; one launch each."""
    import dataclasses

    from tpu_dialmpc_torch.envs.base import StateInfo
    from tpu_dialmpc_torch.envs.registry import get_env

    env = get_env(task, device=card, **GO2_CONFIGS[task])
    args, info, action = go2_env_inputs(env, B, seed=B, broadcast_info=B > 1, device=card)
    assert B == 1 or info.pos_tar.stride(0) == 0
    want = env._ctrl_batch_plain(action, args["qpos"], args["qvel"])
    got = env._ctrl_batch(action, args["qpos"], args["qvel"])
    r0, d0, i0 = env._post_physics_plain(**args, info=info)
    r1, d1, i1 = env._post_physics(**args, info=info, ctrl=got)
    torch.cuda.synchronize()
    kernels = env._env_kernels
    assert kernels.ctrl_launches == kernels.post_physics_launches == 1
    gaps = {"ctrl": (got - want).abs().max().item(), "reward": (r1 - r0).abs().max().item()}
    print(f"[go2 env kernels] {task} B={B} exact ctrl {torch.equal(got, want)} "
          f"reward {torch.equal(r1, r0)} gaps {gaps}")
    assert _close(got, want) and _close(r1, r0) and torch.equal(d1, d0)
    for f in dataclasses.fields(StateInfo):
        assert _close(getattr(i1, f.name), getattr(i0, f.name)), f.name


def test_captured_rollout_launches_the_go2_kernels_on_card(card):
    """A `rollout_batch` (go2_stand, B=257, T=6) captured in a CUDA graph:
    the capture launches each env kernel once per horizon step, and the
    replay's rewards equal the eager rollout's to the bit."""
    from tpu_dialmpc_torch.envs.registry import get_env

    env = get_env("go2_stand", device=card, n_substeps=8)
    state = env.reset()
    gen = torch.Generator(device=card).manual_seed(7)
    us = torch.rand((257, 6, env.action_size), generator=gen, device=card) * 2 - 1
    eager = env.rollout_batch(state, us)
    kernels = env._env_kernels
    before = (kernels.ctrl_launches, kernels.post_physics_launches, env.fused_step.launches)
    assert before == (6, 6, 6)
    stream, graph = torch.cuda.Stream(card), torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(card))
    with torch.cuda.graph(graph, stream=stream):
        out = env.rollout_batch(state, us)
    assert (kernels.ctrl_launches, kernels.post_physics_launches) == (12, 12)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)


def test_control_step_counts_the_go2_kernels_on_card(card):
    """go2_stand at N64/H4/Hnode2, Ndiffuse 2, the control step captured
    whole: each replay adds 2 x (H + 1) + 1 = 11 launches to each env
    kernel's counter, as to the fused kernel's (`launch_counters`), and
    as many waves to the fused kernel's (B=65 fits one)."""
    from tpu_dialmpc_torch.planner.dial import DialConfig

    cfg = DialConfig(Nsample=64, Hsample=4, Hnode=2, Ndiffuse=2, seed=1)
    unit, step = _captured_step(card, cfg, False)
    env = unit.owner.mbdpi.env
    names = {id(env.fused_step): "fused", id(env._env_kernels): "env"}
    before = [getattr(o, n) for o, n in unit.counters]
    step()
    torch.cuda.synchronize()
    added = {f"{names[id(o)]}.{n}": getattr(o, n) - b
             for (o, n), b in zip(unit.counters, before)}
    assert added == {"fused.launches": 11, "fused.waves": 11, "env.ctrl_launches": 11,
                     "env.post_physics_launches": 11}


def test_control_step_counts_the_kernel_waves_on_card(card):
    """h1_push_crate at N4096/H4/Hnode2, Ndiffuse 2, the control step
    captured whole: the card holds the blocks per SM the runtime's
    occupancy reports on every SM at once, so each of the 10 rollout
    launches at B=4097 takes ceil(4097 / resident) waves and the executed
    step's one; a replay adds exactly that to `FusedStep.waves`."""
    from tpu_dialmpc_torch.planner.dial import DialConfig

    cfg = DialConfig(Nsample=4096, Hsample=4, Hnode=2, Ndiffuse=2, seed=1)
    unit, step = _captured_step(card, cfg, False, task="h1_push_crate")
    fs = unit.owner.mbdpi.env.fused_step
    lib = fs.library(card)
    info = lib.launch_info()
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    assert lib.resident == info["blocks_per_sm"] * info["samples_per_block"] * sms
    per_step = 2 * 5 * fused_cuda.waves(4097, lib.resident) + 1
    assert per_step > 2 * 5 + 1  # more than one wave a rollout launch
    launches, waves = fs.launches, fs.waves
    step()
    torch.cuda.synchronize()
    assert (fs.launches - launches, fs.waves - waves) == (11, per_step)
