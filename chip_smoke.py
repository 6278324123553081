#!/usr/bin/env python3
"""Chip smoke test of the torch port (tpu_dialmpc_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's paths through the entry points a user calls
(`get_env`, `MBDPI`, `make_control_step`, and the CLI's `run`), each at its
task's full planner width with 8 substeps per control, after building that
model's substep kernel from the sources in this checkout and holding it
against its plain PyTorch version on the card:

- go2_stand on the Go2 stand-in scene (plane-sphere contacts), Nsample=2048,
  Hsample=20, Hnode=5: the reference benchmark workload;
- go2_crate_climb on the crate stand-in scene (all six contact kinds),
  Nsample=2048, Hsample=25, Hnode=5;
- h1_push_crate on the H1 humanoid stand-in with a crate on its own slide
  joint (all six kinds, and contact rows that couple the robot's and the
  crate's kinematic trees), Nsample=2048, Hsample=32, Hnode=8;
- go2_trot_position on the Go2 position stand-in (12 position servos: the
  kernel's affine-bias actuator branch), Nsample=2048, Hsample=20, Hnode=5;
- h1_walk and h1_loco (the arms-fixed H1, 11 motors) on their crate-free
  stand-ins, Nsample=2048, Hsample=32, Hnode=8.

All six kernels are built first, in parallel (one nvcc each).  Phases, for
each path (each prints its lines; any failure exits non-zero with no
result), after the card as nvidia-smi reports its name and power limit:
  1. the kernel build for this model, with ptxas' register, stack and spill
     lines and the launch shape (bytes of shared memory per sample, samples
     per block, resident blocks per SM);
  2. kernel vs plain version on the same inputs, B=2049 and B=1, 8
     substeps; on the models with more than plane-sphere contacts, inputs
     that touch every contact kind of the scene (and on the push-crate H1,
     slots that span both trees), counted, printed and checked; on the
     servo model, how often its ctrl and force clamps bind and the size of
     the bias terms, checked nonzero; the kernel's time per call at B=2049
     and B=1 and the plain version's at B=2049, on the first four paths
     also at B=8192 (the JAX package's bench timed h1_push_crate at
     N8192); the kernel's bound (the plain substep's fp32 operations,
     fused.count_ops, at 67 TFLOP/s) and its share of the measured time;
  3. the main path: reset, the reverse warm start, 3 control steps, with the
     kernel's launch count checked, then timings: on the first four paths
     5 timed `reverse_once` and
     control steps and a torch.profiler window over 3 and 2 of them, after
     a pre-roll of spin kernels that is left out of the counts (wall
     ms, device busy ms and idle share, the fused kernel's device ms and
     launches, the trace's count of them held against the launch counter,
     the counted launches with no device record,
     the other kernels', and the host's cudaStreamSynchronize calls and
     wait; wall includes the profiler's own cost); on h1_walk and
     h1_loco one timed `reverse_once` and control step; and the path's wall
     seconds.
Last, [small]: on each of the first four paths, a small reverse_once
(N64/H4/Hnode2) through the kernel and through the plain substep chain,
the same injected noise, on the crate tasks from a state at the crate; the
four run at once, each in a spawned process (the plain chain is
host-bound, seconds per horizon step), while this process runs [quality].
After go2_trot_position, the [cli] phase runs the CLI's `run` on it at full
width: 6 steps with telemetry and a trajectory file, 3 steps with a
checkpoint and a resume to 6, and `--scan`, each with its launch count
checked, the resumed and scanned trajectories bit-equal to the host loop's;
and one `reverse_once` with diag_states, whose Ybar must equal the plain
one's to the bit.
After the six paths, the physics pipeline (`dynamics/pipeline.py`, the JAX
package's XLA path as batched PyTorch ops, which has no kernel of its own):
  - [physics] `pipeline.step` at B=2049, 1 and 8 substeps, on the go2_force,
    Go2 crate, H1 push-crate and go2_position models, with the inputs their
    kernel compares use, held against the same call on the CPU in float64
    and against the fused kernel on the card; its time per call;
  - [physics go2_pair_kinds] the pair-kinds scene, which only the pipeline
    runs (sphere-sphere, sphere-capsule, capsule-capsule), card against CPU
    float64, with the active contacts of every kind counted;
  - [physics no-syncs] a profiler window over a warm `pipeline.step`: no
    synchronising call and no host-device copy, and its kernels per substep;
  - [xla-path go2_stand] go2_stand with fused="off" at full width: one
    timed `reverse_once` under injected noise held against the fused
    path's, and one timed control step executed by `env.step`;
  - [xla-path compat_q1] the chained-candidate planner at a small width,
    card against CPU float64;
  - [cli] `replay` of the [cli] phase's trajectory through `env.step`, and
    `env-test` for 20 steps.
Then the single-device tools:
  - [profile] the CLI's `profile` on go2_stand at full width (N2048/H20/sub8):
    the four phase times, the fused kernel's roofline, the measured fp32
    peak (the FMA-chain kernel, csrc/fp32_peak.cu, whose launches in this
    run are counted) and memory rate, each checked against 1.05 x the data
    sheet's, and a profiler trace of one reverse_once that must hold
    fused-kernel records; then the microbench kernel against its plain
    version at the run's shape, and both timed;
  - [ik] the feet IK on the card against its CPU float64 result;
  - [native] a 6-step CLI `run` with telemetry through the native sink and
    through the Python writer: the same records;
  - [randomize] go2_stand with randomize_tasks at full width from a state at
    step 498, 3 control steps: every candidate's command and the executed
    one equal at step 500, the CPU's draw for the same seed;
  - [cost_dial] a pendulum swing-up on the card against the CPU (float64,
    the same draws), and one timed LeggedRobot `improve` (256 samples,
    H=20, 3 levels).
Then the sample-parallel planner (`shard/`) and its measuring entry points,
each rank a process spawned by `shard.distributed.run_group`:
  - [shard nccl-1] go2_stand at full width through `ShardedMBDPI` in a
    one-rank NCCL group: one `reverse_once` under injected noise and one
    from the shared generator, each against `MBDPI` on the same inputs
    (Ybar max abs diff and weights over the largest weight, 1e-5), the
    fused launches of each (Hsample+1), and both planners timed;
  - [shard gloo-2] the same on two gloo ranks sharing the card (NCCL refuses
    two ranks on one device), 1025 candidates each: the ranks equal to the
    bit, each against MBDPI, each rank's launches and time;
  - [scaling] the CLI's `scaling` (one row: one card), then
    `collective_overhead_report` with two gloo ranks on the card at the same
    width, and `predicted_efficiency_rows` from the two;
  - [bench] the CLI's `bench --full` at N2048/H20/sub8: the three rows of
    the JAX package's benchmark schema, by name, finite, positive, on cuda,
    written with the card's name and power limit (`--out`,
    build/smoke_bench/BENCH_TORCH_LAST_GOOD.json).
Then [quality]: the quality harness (`tpu_dialmpc_torch.quality.main`) in
this process, the quick lane of go2_trot (the go2_force kernel) and go2_jump
(the crate build, the crate parked at x=30) at full width (N2048/H20/Hnode5,
8 substeps, 150 control steps each): the artifact's keys, platform and card,
every metric finite, each gate's fused launches equal to
`expected_launches(cfg, 150)`, and go2_jump's foot-site metrics recomputed
on the CPU in float64 equal to the card's (the same flight and on-crate
counts, site positions within 1e-9 m).  A gate check that fails is a
result (the thresholds were set on the published scenes, these are
stand-ins): it is printed as passed=False and does not fail the run.
go2_jump's kernel is built with the others at the start.  [small]'s
processes (above) run beside [quality] and are checked after it.
The last two lines are the kernels' JSON record and the result JSON.
It needs a CUDA device and the repository around it; it never runs on a CPU.
"""

import contextlib
import json
import shutil
import statistics
import subprocess
import sys
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from typing import Callable, NamedTuple, Optional

ROOT = Path(__file__).resolve().parent
N_SUBSTEPS = 8
CRATE_FACE_X = 0.79  # Go2: the base 0.2 m before the crate's face at x = 1.3 - 0.31
# The kernel follows the plain version's op order with the same rounding
# (nvcc -fmad=false, the same CUDA math library), so the two agree to the last
# bit on the card; 1e-6 of each output's scale leaves room for a last-bit
# difference in a library function and is far below the >=1e-3 error a wrong
# formula gives.
REL_TOL = 1e-6
# the H100 SXM's fp32 rate outside the tensor cores, at its 700 W limit
# (NVIDIA's data sheet): the kernel's arithmetic bounds it, not its bytes
FP32_FLOPS = 67e12


class SmokeError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def near_home_inputs(model, B, seed, device):
    """Home keyframe with perturbed joints and velocities, zero warmstart,
    random torques within the motors' range."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(model.key_qpos["home"]), (B, 1))
    qpos[:, 7:] += rng.normal(scale=0.05, size=(B, model.nq - 7))
    qvel = rng.normal(scale=0.2, size=(B, model.nv))
    ws = np.zeros((B, model.nv))
    ctrl = rng.uniform(-10.0, 10.0, size=(B, model.nu))
    return [torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
            for a in (qpos, qvel, ws, ctrl)]


def _inputs_from(states, model, B, seed, device, row, n_min):
    """Rows of `states(model, rng, n)` as kernel inputs: zero warmstart,
    random torques within the motors' range; at B=1 the row `row`."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    n = max(B, n_min)
    qpos, qvel = states(model, rng, n)
    ws = np.zeros((n, model.nv))
    ctrl = rng.uniform(-10.0, 10.0, size=(n, model.nu))
    rows = slice(row, row + 1) if B == 1 else slice(0, B)
    return [torch.as_tensor(a[rows], dtype=torch.float32, device=device).contiguous()
            for a in (qpos, qvel, ws, ctrl)]


def crate_inputs(model, B, seed, device):
    """Go2 crate-scene inputs that touch every contact kind (see
    tests/torch_port_helpers.py:crate_states).  At B=1: the sample that
    leads with its torso into the crate's face (plane-sphere, capsule-box
    and box-box contacts)."""
    from torch_port_helpers import crate_states

    return _inputs_from(crate_states, model, B, seed, device, row=1, n_min=6)


def h1_crate_inputs(model, B, seed, device):
    """H1 push-crate inputs that touch every contact kind, most of them
    between the robot and the crate (see
    tests/torch_port_helpers.py:h1_crate_states).  At B=1: the first sample
    that leans its torso's corners into the crate (box-box, both trees)."""
    from torch_port_helpers import h1_crate_states

    return _inputs_from(h1_crate_states, model, B, seed, device, row=4, n_min=10)


def servo_inputs(model, B, seed, device):
    """Go2 position-servo inputs: near-home states and joint targets about
    each sample's joints, so the servos' ctrl and force clamps bind for some
    samples and not for others (see tests/torch_port_helpers.py:servo_states)."""
    import numpy as np
    import torch

    from torch_port_helpers import servo_states

    return [torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
            for a in servo_states(model, np.random.default_rng(seed), B)]


def h1_floor_inputs(model, B, seed, device):
    """Crate-free H1 inputs that touch every contact kind of the scene, all
    against the floor (tests/torch_port_helpers.py:h1_floor_states).  At
    B=1: a sample on its back, the torso box's corner in the floor."""
    from torch_port_helpers import h1_floor_states

    return _inputs_from(h1_floor_states, model, B, seed, device, row=7, n_min=10)


def go2_at_crate(qpos):
    qpos[0] = CRATE_FACE_X


def h1_at_crate(qpos):
    from torch_port_helpers import H1_CRATE_AT_HANDS

    qpos[26] = H1_CRATE_AT_HANDS


class SmokePath(NamedTuple):
    task: str
    scene: str  # the model file its kernel is built for
    width: tuple  # its full width (Nsample, Hsample, Hnode, n_substeps)
    inputs: Callable  # (model, B, seed, device) -> kernel inputs for the compare
    at_crate: Optional[Callable]  # moves the reset qpos to the crate, in place
    big_batch: Optional[int]  # a larger batch the kernel is also timed at
    # [small]'s reverse_once against the plain chain, 5 timed repetitions
    # and the profile window; else one timed reverse_once and control step
    full: bool = True


PATHS = (
    SmokePath("go2_stand", "go2_force", (2048, 20, 5, 8), near_home_inputs, None, 8192),
    SmokePath("go2_crate_climb", "go2_force_crate", (2048, 25, 5, 8), crate_inputs,
              go2_at_crate, 8192),
    # the JAX package's bench timed h1_push_crate at N2048/H32 and N8192/H32
    SmokePath("h1_push_crate", "h1_push_crate", (2048, 32, 8, 8), h1_crate_inputs,
              h1_at_crate, 8192),
    SmokePath("go2_trot_position", "go2_position", (2048, 20, 5, 8), servo_inputs, None, 8192),
    SmokePath("h1_walk", "h1_walk", (2048, 32, 8, 8), h1_floor_inputs, None, None, full=False),
    SmokePath("h1_loco", "h1_loco", (2048, 32, 8, 8), h1_floor_inputs, None, None, full=False),
)
CLI_TASK = "go2_trot_position"


def cuda_ms(fn, reps):
    """Mean device ms per call of fn over reps calls, CUDA events."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_card():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    print(line)  # as nvidia-smi gives it: name, power limit
    return line


def phase_build_all(envs):
    """Every path's kernel and the fp32 microbench, built at once: one nvcc
    process per model and one for fp32_peak.cu."""
    from tpu_dialmpc_torch.dynamics import _build
    from tpu_dialmpc_torch.telemetry import profile as prof

    t0 = time.perf_counter()
    jobs = [e.fused_step.compile for e in envs] + [lambda: _build.build(prof.FmaChain.SOURCE, {})]
    with ThreadPoolExecutor(len(jobs)) as pool:
        list(pool.map(lambda job: job(), jobs))
    print(f"[build] {len(envs)} builds of fused_step.cu and fp32_peak.cu for sm_90a in "
          f"parallel: {time.perf_counter() - t0:.2f} s")


def phase_build(env, device, tag):
    t0 = time.perf_counter()
    lib = env.fused_step.library(device)
    secs = time.perf_counter() - t0
    print(f"[build {tag}] fused_step.cu for sm_90a: {secs:.2f} s (load + model upload)")
    for line in (env.fused_step.build_log or "").splitlines():
        if any(k in line for k in ("registers", "spill", "stack frame")):
            print(f"[build {tag}] {line.strip()}")
    info = lib.launch_info()
    print(f"[build {tag}] one warp per sample: {info['bytes_per_sample']} bytes of shared memory "
          f"per sample, {info['samples_per_block']} samples per block, "
          f"{info['blocks_per_sm']} blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)")
    check(info["blocks_per_sm"] > 0, "the kernel's block does not fit an SM")
    return secs


def bound_ms(B, ops):
    """The least time for B samples x N_SUBSTEPS substeps of `ops` fp32
    operations each, at the card's fp32 rate."""
    return B * N_SUBSTEPS * ops / FP32_FLOPS * 1e3


def phase_compare(env, path, device, tag):
    """Kernel vs plain version on the card; returns (max abs err, kernel ms
    per batch size timed, plain ms at B=2049).  On a model with more than
    plane-sphere contacts the inputs touch every contact kind, and at
    B=2049 every kind must have active contacts, and so must the slots that
    span two trees where the model has any."""
    import torch

    from tpu_dialmpc_torch.dynamics import fused

    from torch_port_helpers import servo_clamps

    fs = env.fused_step
    crate = len(env.model.pairs) > 1
    two_trees = any(fused.spans_two_trees(env.model, s) for s in fs.meta.contact_slots)
    servos = bool(env.model.actuator_biasprm.any())
    names = ("qpos", "qvel", "warmstart", "derived")
    worst, ms = 0.0, {}
    for B, seed in ((2049, 0), (1, 1)):
        args = path.inputs(env.model, B, seed, device)
        if servos:
            n_ctrl, n_force, bias = servo_clamps(
                env.model, *(a.cpu().numpy() for a in (args[0], args[1], args[3])))
            print(f"[compare {tag}] B={B} servos (affine bias): max |b1 q + b2 qdot| "
                  f"{bias:.3f} N m; ctrl clamped {n_ctrl}, force clamped {n_force} of "
                  f"{B * env.model.nu}")
            check(bias > 0.0, f"B={B}: the servos' bias terms are 0, the affine branch is not live")
            if B > 1:
                check(n_ctrl > 0 and n_force > 0, f"B={B}: a servo clamp never binds")
        if crate:
            active = fused.active_contacts(env.model, args[0])
            line = ", ".join(f"{KIND_NAMES[k]} {n}" for k, n in active.items())
            if two_trees:
                crossing = fused.active_two_tree_contacts(env.model, args[0])
                line += f"; in slots that span both trees {crossing}"
            print(f"[compare {tag}] B={B} active contacts per kind: {line}")
            if B > 1:
                check(all(n > 0 for n in active.values()),
                      f"B={B}: a contact kind has no active contact, the compare proves nothing")
                check(not two_trees or crossing > 0,
                      f"B={B}: no active contact couples two trees, the compare proves nothing")
        got = fs(*args)
        if B > 1:  # the plain version takes tens of seconds per call: time this one
            out = []
            plain_ms = cuda_ms(lambda: out.append(fs.plain(*args)), 1)
            want = out[0]
        else:
            want = fs.plain(*args)
        for _ in range(3):
            fs(*args)
        ms[B] = cuda_ms(lambda: fs(*args), 20)
        torch.cuda.synchronize()
        for name, g, w in zip(names, got, want):
            check(g.shape == w.shape, f"B={B} {name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
            check(bool(torch.isfinite(g).all()), f"B={B} {name}: non-finite kernel output")
            err = (g - w).abs().max().item()
            tol = REL_TOL * max(1.0, w.abs().max().item())
            worst = max(worst, err)
            print(f"[compare {tag}] B={B} n_substeps={N_SUBSTEPS} {name}: max abs diff "
                  f"{err:.3e} (tolerance {tol:.3e})")
            check(err <= tol, f"kernel disagrees with the plain version: B={B} {name}")
    print(f"[compare {tag}] time per call: kernel {ms[2049]:.3f} ms at B=2049 "
          f"({ms[1]:.3f} ms at B=1), plain PyTorch {plain_ms:.1f} ms at B=2049")
    if path.big_batch:
        args = path.inputs(env.model, path.big_batch, 2, device)
        for _ in range(2):
            fs(*args)
        ms[path.big_batch] = cuda_ms(lambda: fs(*args), 10)
        print(f"[compare {tag}] B={path.big_batch} time per call: kernel "
              f"{ms[path.big_batch]:.3f} ms")
    return worst, ms, plain_ms


def phase_bound(env, ms, tag):
    """The kernel's bound from the plain substep's arithmetic
    (fused.count_ops), and its share of the measured time, per batch timed;
    returns (ops per substep, bound ms at B=2049)."""
    from tpu_dialmpc_torch.dynamics import fused

    ops = fused.count_ops(env.model, env.fused_step.spec)
    for B in sorted(b for b in ms if b > 1):
        bound = bound_ms(B, ops)
        print(f"[bound {tag}] B={B}: {ops} fp32 ops per sample and substep x {B} x "
              f"{N_SUBSTEPS} / {FP32_FLOPS / 1e12:.0f} TFLOP/s = bound_ms {bound:.4f}; "
              f"kernel {ms[B]:.3f} ms, share {bound / ms[B]:.5f}")
    return ops, bound_ms(2049, ops)


class _PlainSubsteps:
    """The plain substep chain where an env expects its FusedStep."""

    def __init__(self, fs):
        self.spec = fs.spec
        self.plain = fs.plain

    def __call__(self, *args):
        return self.plain(*args)


KIND_NAMES = {(0, 2): "plane-sphere", (0, 3): "plane-capsule", (0, 6): "plane-box",
              (2, 6): "sphere-box", (3, 6): "capsule-box", (6, 6): "box-box"}


def make_env(task, scene, width, device):
    from tpu_dialmpc_torch.envs import dial_defaults, get_env
    from tpu_dialmpc_torch.planner.dial import DialConfig

    env = get_env(task, device=device)
    cfg = DialConfig(**dial_defaults(task))
    check(env.config.scene == scene, f"{task} does not run on {scene}")
    check((cfg.Nsample, cfg.Hsample, cfg.Hnode, env.config.n_substeps) == width,
          f"{task} is not at the full planner width {width}")
    return env, cfg


def expected_launches(cfg, n_steps, t0=0):
    """Kernel launches of `n_steps` control steps: the reverse warm start
    (Ndiffuse-1 reverse_once), the first step (one B=1 step, Ndiffuse_init
    reverse_once), the rest (one B=1 step, Ndiffuse reverse_once each);
    from step t0 > 0 (a resume) no warm start or first step."""
    horizon = cfg.Hsample + 1
    first = (cfg.Ndiffuse - 1) * horizon + (1 + cfg.Ndiffuse_init * horizon)
    return (first if t0 == 0 else 0) + (n_steps - max(t0, 1)) * (1 + cfg.Ndiffuse * horizon)


def run_main_path(env, cfg, device, task, envs):
    import torch

    from tpu_dialmpc_torch.envs.base import to_lean
    from tpu_dialmpc_torch.planner.dial import MBDPI
    from tpu_dialmpc_torch.planner.runner import make_control_step

    mbdpi = MBDPI(cfg, env)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    step_init = make_control_step(mbdpi, cfg.Ndiffuse_init)
    step_rest = make_control_step(mbdpi, cfg.Ndiffuse)
    n_steps = 3
    horizon = cfg.Hsample + 1
    expected = expected_launches(cfg, n_steps)

    for e in envs:  # every count to 0 just before this path
        e.fused_step.launches = 0
    state = to_lean(env.reset())
    Y0 = torch.zeros((cfg.Hnode + 1, env.action_size), dtype=torch.float32, device=device)
    Y0 = mbdpi.reverse(state, Y0, gen)
    rewards = []
    for t in range(n_steps):
        state, Y0, infos = (step_init if t == 0 else step_rest)(state, Y0, gen)
        rewards.append(state.reward)
        check(bool(torch.isfinite(infos.rews).all()), f"step {t}: non-finite rollout rewards")
    torch.cuda.synchronize()
    launches = env.fused_step.launches
    others = [e.fused_step.launches for e in envs if e is not env]

    rewards = torch.stack(rewards)
    quat = state.pipeline.qpos[3:7]
    up_z = (1.0 - 2.0 * (quat[1] ** 2 + quat[2] ** 2)).item()
    print(f"[main {task}] N{cfg.Nsample}/H{cfg.Hsample}/Hnode{cfg.Hnode}/sub"
          f"{env.config.n_substeps}: reset, reverse, {n_steps} control steps; rewards "
          f"{[round(r, 5) for r in rewards.tolist()]}, torso z "
          f"{state.pipeline.qpos[2].item():.4f}, up·z {up_z:.4f}")
    check(bool(torch.isfinite(rewards).all()), "non-finite executed rewards")
    check(bool(torch.isfinite(Y0).all()) and Y0.shape == (cfg.Hnode + 1, env.action_size),
          "Ybar is non-finite or misshapen")
    check(up_z > 0.5 and not bool(state.done), "the torso did not stay upright")
    print(f"[main {task}] kernel launches: {launches} (expected {expected} = "
          f"{cfg.Ndiffuse - 1}x{horizon} + (1 + {cfg.Ndiffuse_init}x{horizon}) + "
          f"{n_steps - 1}x(1 + {cfg.Ndiffuse}x{horizon})); other models' kernels: {others}")
    check(launches == expected, "the main path did not launch the kernel as expected")
    check(not any(others), "the main path launched another model's kernel")
    return mbdpi, state, Y0, gen, step_rest, launches


def small_against_plain(env, cfg, path, device):
    """One small reverse_once through the kernel and through the plain
    substep chain, same card, same injected noise; on the crate tasks from
    a state at the crate, so the rollouts meet it.  Returns (name, max abs
    diff, tolerance) for the rewards and Ybar."""
    import dataclasses

    import torch

    from tpu_dialmpc_torch.envs.base import to_lean
    from tpu_dialmpc_torch.planner.dial import MBDPI

    small = dataclasses.replace(cfg, Nsample=64, Hsample=4, Hnode=2)
    ref_env = type(env)(env.config, device=device)
    ref_env._fused_step = _PlainSubsteps(env.fused_step)
    noise = torch.randn((small.Nsample, small.Hnode + 1, env.action_size),
                        generator=torch.Generator(device=device).manual_seed(5),
                        device=device)
    out = []
    for e in (env, ref_env):
        mb = MBDPI(small, e)
        Y = torch.zeros((small.Hnode + 1, e.action_size), device=device)
        scale = torch.as_tensor(mb.sigma_control, dtype=torch.float32, device=device)
        start = to_lean(e.reset())
        if path.at_crate is not None:
            qpos = start.pipeline.qpos.clone()
            path.at_crate(qpos)
            start = dataclasses.replace(
                start, pipeline=dataclasses.replace(start.pipeline, qpos=qpos))
        out.append(mb.reverse_once(start, None, Y, scale, noise=noise))
    (kY, kinfo), (pY, pinfo) = out
    torch.cuda.synchronize()
    return [(name, (a - b).abs().max().item(), REL_TOL * max(1.0, b.abs().max().item()))
            for name, a, b in (("rews", kinfo.rews, pinfo.rews), ("Ybar", kY, pY))]


def _small_in_child(i):
    """[small] for PATHS[i], in a spawned process: its own env on the card
    (the kernel loads from the parent's build)."""
    import torch

    sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
    device = torch.device("cuda", 0)
    path = PATHS[i]
    env, cfg = make_env(path.task, path.scene, path.width, device)
    return path.task, small_against_plain(env, cfg, path, device)


class SmallRun(NamedTuple):
    pool: ProcessPoolExecutor
    futures: list
    t0: float


def start_small_against_plain() -> SmallRun:
    """[small] on every full path at once, one spawned process each, left
    running: `finish_small_against_plain` collects and checks them."""
    idx = [i for i, path in enumerate(PATHS) if path.full]
    pool = ProcessPoolExecutor(len(idx), mp_context=multiprocessing.get_context("spawn"))
    return SmallRun(pool, [pool.submit(_small_in_child, i) for i in idx], time.perf_counter())


def stop_small(run: SmallRun):
    """Every [small] process stopped."""
    procs = list(run.pool._processes.values())
    run.pool.shutdown(wait=False, cancel_futures=True)
    for proc in procs:
        proc.kill()
        proc.join()


def finish_small_against_plain(run: SmallRun, timeout_s=900):
    """[small]'s results, each checked; every process is stopped before this
    returns."""
    try:
        results = [f.result(timeout=max(1.0, timeout_s - (time.perf_counter() - run.t0)))
                   for f in run.futures]
    except Exception as e:  # a child's failed check or traceback, or the timeout
        raise SmokeError(f"[small] a check process failed: {type(e).__name__}: {e}") from e
    finally:
        stop_small(run)
    for task, rows in results:
        for name, err, tol in rows:
            print(f"[small {task}] reverse_once (N64/H4/Hnode2) kernel vs plain {name}: "
                  f"max abs diff {err:.3e} (tolerance {tol:.3e})")
            check(err <= tol, f"{task}: small reverse_once disagrees with the plain chain: {name}")
    print(f"[time small] {len(results)} paths at once, each in its own process: wall "
          f"{time.perf_counter() - run.t0:.1f} s")


# the profile window's pre-roll: spin kernels (torch.cuda._sleep, ATen's
# `spin_kernel`) of about 20 us each, launched and waited for before the
# window counts anything
PREROLL_LAUNCHES = 256
PREROLL_CYCLES = 40_000


def _profile_window(fn, n, fused_step, preroll=PREROLL_LAUNCHES):
    """fn() n times under torch.profiler: where the window's time went.  The
    trace's count of fused-kernel records is held against the launch
    counter: a record lost from the trace is reported, with the window's
    kernel launches that have no device record and where they fall.

    The launches at the start of a trace can miss their CUPTI device record
    (PERF.md section 5).  So the window opens with `preroll` spin kernels
    and a synchronize: they take that loss, and the spin kernels and all
    that precedes the synchronize are left out of every count."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(preroll):
            torch.cuda._sleep(PREROLL_CYCLES)
        torch.cuda.synchronize()
        launched = fused_step.launches
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launched = fused_step.launches - launched
    kernels, syncs = [], []
    for ev in prof.key_averages():
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = ev.self_cuda_time_total
        if ev.key == "cudaStreamSynchronize":
            syncs.append((ev.count, ev.cpu_time_total / 1e3))
        elif (dev > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA")
              and "spin_kernel" not in ev.key):
            kernels.append((ev.key, ev.count, dev / 1e3))
    fused = [k for k in kernels if "fused_step_kernel" in k[0]]
    others = [k for k in kernels if "fused_step_kernel" not in k[0]]
    busy = sum(k[2] for k in kernels)
    traced = sum(k[1] for k in fused)
    raw = list(prof.profiler.kineto_results.events())
    on_device = {e.correlation_id() for e in raw if not str(e.device_type()).endswith("CPU")}
    lost = [e for e in raw if "LaunchKernel" in e.name() and e.correlation_id() not in on_device]
    start = min(e.start_ns() for e in raw)
    # the window's counted part begins where the pre-roll's synchronize ends
    counted = min((e.end_ns() for e in raw if e.name() == "cudaDeviceSynchronize"),
                  default=start) if preroll else start
    lost_counted = [e for e in lost if e.start_ns() >= counted]
    if traced != launched or lost_counted:
        print(f"[profile] the trace holds {traced} of the window's {launched} fused-kernel "
              f"launches ({sum('fused_step_kernel' in e.name() for e in raw)} raw device "
              f"records); {len(lost)} kernel launches have no device record, "
              f"{len(lost) - len(lost_counted)} of them in the pre-roll of {preroll}, at "
              f"{[round((e.start_ns() - start) / 1e6, 3) for e in lost[:8]]} ms into the "
              f"{(max(e.end_ns() for e in raw) - start) / 1e6:.1f} ms window (counted from "
              f"{(counted - start) / 1e6:.3f} ms)")
    # one record lost per window was seen on the card before the pre-roll
    # (PERF.md section 5): it undercounts device time by one kernel call, and
    # no more is accepted
    check(launched - 1 <= traced <= launched,
          f"the profile window traced {traced} fused-kernel launches of the {launched} made")
    return {
        "calls": n, "wall_ms": wall, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall,
        "fused_ms": sum(k[2] for k in fused), "fused_launches": launched,
        "fused_traced": traced, "untraced_launches": len(lost_counted),
        "other_kernels": sum(k[1] for k in others), "other_ms": sum(k[2] for k in others),
        "stream_syncs": sum(s[0] for s in syncs), "sync_wait_ms": sum(s[1] for s in syncs),
    }


def time_main_path(mbdpi, state, Y0, gen, step_rest, cfg, device, task, full):
    """Median wall ms of `reverse_once` and of a control step (5 timed
    repetitions and the profile window, or one of each)."""
    import torch

    scale = torch.as_tensor(mbdpi.sigma_control, dtype=torch.float32, device=device)
    reps = 5 if full else 1

    def timed(fn, reps):
        fn()  # warm-up
        out = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(out)

    ro_ms = timed(lambda: mbdpi.reverse_once(state, gen, Y0, scale), reps)
    cs_ms = timed(lambda: step_rest(state, Y0, gen), reps)
    print(f"[time {task}] median ms per reverse_once: {ro_ms:.2f}; per control step "
          f"(step + shift + {cfg.Ndiffuse} reverse_once): {cs_ms:.2f} ({reps} timed)")
    if not full:
        return ro_ms, cs_ms
    for name, fn, n in (("reverse_once", lambda: mbdpi.reverse_once(state, gen, Y0, scale), 3),
                        ("control_step", lambda: step_rest(state, Y0, gen), 2)):
        window = _profile_window(fn, n, mbdpi.env.fused_step)
        print(f"[profile {task}] {name}: {json.dumps(window)}")
    return ro_ms, cs_ms


@contextlib.contextmanager
def recording_envs():
    """Every env `get_env` builds inside the block, in a list: entry points
    build their own envs, and a kernel's launches are counted on its env."""
    import tpu_dialmpc_torch.envs as envs_mod

    made, get_env = [], envs_mod.get_env

    def recording_get_env(*args, **kw):
        made.append(get_env(*args, **kw))
        return made[-1]

    envs_mod.get_env = recording_get_env
    try:
        yield made
    finally:
        envs_mod.get_env = get_env


OUT_KEYS = {"rewards", "qpos", "qvel", "us", "dones", "qpos0", "qvel0", "warmstart0", "dt"}
RECORD_KEYS = ["t", "time", "reward", "done", "z", "ess", "entropy", "rew_mean", "rew_max",
               "rew_std"]


def phase_cli(cfg):
    """The CLI's `run` on CLI_TASK at its full width, on the card: a 6-step
    run with telemetry and a trajectory file, a 3-step run with a
    checkpoint, its resume to 6 steps, and `--scan`; each run's launches
    against the formula, the resumed and scanned trajectories bit-equal to
    the 6-step run's.  Returns (host loop s, --scan s) for the 6 steps."""
    import numpy as np

    from tpu_dialmpc_torch.cli import main as cli

    out = ROOT / "build" / "smoke_cli"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)

    def run(expected, *flags):
        argv = ["run", "--task", CLI_TASK, *flags]
        print(f"[cli] main({argv})", flush=True)
        t0 = time.perf_counter()
        check(cli.main(argv) == 0, f"the CLI run {flags} failed")
        secs = time.perf_counter() - t0
        launches = made[-1].fused_step.launches
        print(f"[cli] {secs:.2f} s; kernel launches {launches} (expected {expected})")
        check(launches == expected, "the CLI run did not launch the kernel as expected")
        return secs

    with recording_envs() as made:  # the env each run builds, for its launch count
        loop_s = run(expected_launches(cfg, 6), "--n-steps", "6",
                     "--telemetry", str(out / "t.jsonl"), "--out", str(out / "full.npz"))
        run(expected_launches(cfg, 3), "--n-steps", "3", "--checkpoint", str(out / "ck.npz"))
        run(expected_launches(cfg, 6, t0=3), "--resume", str(out / "ck.npz"), "--n-steps", "6",
            "--out", str(out / "resumed.npz"))
        scan_s = run(expected_launches(cfg, 6), "--scan", "--n-steps", "6",
                     "--out", str(out / "scan.npz"))

    records = [json.loads(line) for line in (out / "t.jsonl").read_text().splitlines()]
    print(f"[cli] telemetry: {len(records)} records, keys {list(records[0]) if records else []}")
    check(len(records) == 6 and [r["t"] for r in records] == list(range(6)),
          "telemetry did not write one record per step")
    check(all(list(r) == RECORD_KEYS for r in records), "telemetry records lack the JAX keys")
    with np.load(out / "full.npz") as full, np.load(out / "resumed.npz") as resumed, \
            np.load(out / "scan.npz") as scan:
        for name, data in (("full", full), ("resumed", resumed), ("scan", scan)):
            check(set(data.files) == OUT_KEYS, f"{name}.npz has keys {sorted(data.files)}")
        check(bool(np.isfinite(full["rewards"]).all()), "non-finite rewards in the CLI run")
        print(f"[cli] rewards {full['rewards'].round(5).tolist()}, "
              f"torso z {float(full['qpos'][-1, 2]):.4f}")
        for k in ("rewards", "qpos", "us"):
            diff = np.abs(resumed[k] - full[k][3:]).max()
            print(f"[cli] resumed from step 3 vs the 6-step run, steps 3-5 {k}: max abs diff {diff}")
            check(np.array_equal(resumed[k], full[k][3:]), f"the resumed run's {k} differ")
        for k in ("rewards", "dones", "qpos", "qvel", "us"):
            diff = np.abs(scan[k].astype(np.float64) - full[k]).max()
            print(f"[cli] --scan vs the host loop {k}: max abs diff {diff}")
            check(np.array_equal(scan[k], full[k]), f"--scan's {k} differ from the host loop's")
    print(f"[cli] 6 steps at N{cfg.Nsample}/H{cfg.Hsample}: host loop with telemetry "
          f"{loop_s:.2f} s, --scan {scan_s:.2f} s (each with its env's set-up)")
    return loop_s, scan_s


def phase_diag(env, cfg, device):
    """One full-width reverse_once with diag_states and one without, from
    the same generator state: the same Ybar to the bit, and finite weighted
    states of the right shapes."""
    import dataclasses

    import torch

    from tpu_dialmpc_torch.envs.base import to_lean
    from tpu_dialmpc_torch.planner.dial import MBDPI

    state = to_lean(env.reset())
    Y = torch.zeros((cfg.Hnode + 1, env.action_size), device=device)
    gen = torch.Generator(device=device).manual_seed(11)
    start = gen.get_state()
    out = []
    for diag in (True, False):
        mb = MBDPI(dataclasses.replace(cfg, diag_states=diag), env)
        scale = torch.as_tensor(mb.sigma_control, dtype=torch.float32, device=device)
        gen.set_state(start)
        out.append(mb.reverse_once(state, gen, Y, scale))
    (dY, dinfo), (pY, pinfo) = out
    torch.cuda.synchronize()
    T = cfg.Hsample + 1
    shapes = {f: tuple(getattr(dinfo, f).shape) for f in ("qbar", "qdbar", "xbar")}
    print(f"[diag] reverse_once with diag_states: Ybar max abs diff from the plain one "
          f"{(dY - pY).abs().max().item()}; {shapes}; xbar[-1] {dinfo.xbar[-1].tolist()}")
    check(torch.equal(dY, pY) and torch.equal(dinfo.weights, pinfo.weights),
          "diag_states changed the planner's update")
    check(shapes == {"qbar": (T, env.model.nq), "qdbar": (T, env.model.nv), "xbar": (T, 3)},
          "diag_states' weighted states are misshapen")
    check(all(bool(torch.isfinite(getattr(dinfo, f)).all()) for f in shapes),
          "non-finite weighted states")


# ----------------------------------------------------------------------
# The physics pipeline (dynamics/pipeline.py, the JAX package's XLA path):
# batched PyTorch ops, no kernel of its own.
# ----------------------------------------------------------------------

# Float32 on the card against float64 on the CPU, or against the fused
# kernel (another factorisation of the same system): per sample, the largest
# error of a field.  The median sample must be within tests/test_fused.py's
# float32 tolerances (10x after 8 substeps) and 99 % of the samples within
# 2e-2 of their own scale.  The rest are the truncated Newton solve's
# branches (the warm-start and done tests) that float32 rounding tips:
# a few samples jump, while a wrong formula moves every sample by 1e-3 and
# more.
PHYSICS_TOL = {"qpos": 2e-5, "qvel": 5e-4, "site_xpos": 2e-5, "torso_xquat": 2e-5,
               "torso_cvel": 1e-3, "qfrc_actuator": 1e-4}
P99_TOL = 2e-2
REF_STRIDE = 8  # the CPU float64 reference takes every 8th sample (257 of 2049)
PHYSICS_MODELS = (("go2_force", "near-home"), ("go2_force_crate", "every kind active"),
                  ("h1_push_crate", "every kind active, two trees"),
                  ("go2_position", "servo clamps binding"))
NEW_KINDS = {(2, 2): "sphere-sphere", (2, 3): "sphere-capsule", (3, 3): "capsule-capsule"}


def _sample_errors(got, want):
    """(per-sample max abs error, per-sample error over max(1, scale))."""
    g = got.detach().double().reshape(got.shape[0], -1).cpu()
    w = want.detach().double().reshape(want.shape[0], -1).cpu()
    e = (g - w).abs().max(1).values
    return e, e / w.abs().max(1).values.clamp(min=1.0)


def hold_physics(tag, got, want, n_substeps):
    """Check got against want field by field (dicts of (B, ...) tensors)
    under PHYSICS_TOL; print each field's median and p99 errors."""
    import torch

    for name, tol in PHYSICS_TOL.items():
        g = got[name]
        check(bool(torch.isfinite(g).all()), f"{tag} {name}: non-finite output")
        e, rel = _sample_errors(g, want[name])
        med, p99 = e.median().item(), torch.quantile(rel, 0.99).item()
        tol = tol * (10.0 if n_substeps > 1 else 1.0)
        print(f"{tag} {name}: per-sample max abs error median {med:.2e} (tolerance {tol:.0e}), "
              f"p99 of relative {p99:.2e} (tolerance {P99_TOL:.0e}), max {e.max().item():.2e}")
        check(med <= tol and p99 <= P99_TOL, f"{tag} {name} disagrees")


def _named(env, ps):
    """A pipeline state's reward inputs and physics, by name."""
    return dict(qpos=ps.qpos, qvel=ps.qvel, **env._derived(ps))


def phase_physics(env, inputs, device, what):
    """pipeline.step at B=2049 on the card, 1 and 8 substeps: against the
    same call on the CPU in float64 (every REF_STRIDE-th sample) and
    against the fused kernel on the card; the card's time per call."""
    import torch

    from tpu_dialmpc_torch.dynamics import fused, pipeline
    from tpu_dialmpc_torch.dynamics.fused_cuda import FusedStep
    from tpu_dialmpc_torch.envs.base import LeanPipelineState

    m = env.model
    tag = f"[physics {env.config.scene}]"
    args = inputs(m, 2049, 0, device)
    state = LeanPipelineState(*args[:3])
    sub = [a[::REF_STRIDE].cpu().double() for a in args]
    ref_state = LeanPipelineState(*sub[:3])
    print(f"{tag} B=2049, {what}; the CPU float64 reference on {sub[0].shape[0]} of them")
    for n in (1, N_SUBSTEPS):
        card = pipeline.step(m, state, args[3], n)
        ref = pipeline.step(m, ref_state, sub[3], n)
        fs = env.fused_step if n == N_SUBSTEPS else FusedStep(m, n, env.fused_step.spec)
        q, v, _, der = fs(*args)
        kernel = dict(qpos=q, qvel=v, **fused.split_derived(m, fs.spec, der))
        got = _named(env, card)
        hold_physics(f"{tag} n_substeps={n} card float32 vs CPU float64:",
                     {k: x[::REF_STRIDE] for k, x in got.items()}, _named(env, ref), n)
        hold_physics(f"{tag} n_substeps={n} pipeline vs fused kernel, card:", got, kernel, n)
    ms = cuda_ms(lambda: pipeline.step(m, state, args[3], N_SUBSTEPS), 2)
    print(f"{tag} pipeline.step, {N_SUBSTEPS} substeps at B=2049: {ms:.1f} ms per call "
          f"(the fused kernel: see [compare {env.config.scene}])")
    return ms


def phase_pair_kinds(device):
    """The pair-kinds scene (the Go2 robot, a free ball and two free sticks),
    which only the physics pipeline runs: B=2049 on the card against the CPU
    in float64, with the active contacts of every kind counted; each of the
    three kinds the fused substep lacks must have some."""
    import numpy as np
    import torch

    from torch_port_helpers import pair_kinds_states
    from tpu_dialmpc_torch.dynamics import collision, fused, kinematics, pipeline
    from tpu_dialmpc_torch.envs import get_env
    from tpu_dialmpc_torch.envs.base import LeanPipelineState

    env = get_env("go2_stand", device=device, scene="go2_pair_kinds")
    m = env.model
    check(not env.on_fused_path and not fused.supported(m),
          "the pair-kinds model is not on the physics pipeline")
    rng = np.random.default_rng(0)
    qpos, qvel = pair_kinds_states(m, rng, 2049)
    args = [torch.as_tensor(a, dtype=torch.float32, device=device) for a in
            (qpos, qvel, np.zeros_like(qvel), rng.uniform(-10.0, 10.0, (2049, m.nu)))]
    dist = collision.collide(m, kinematics.kinematics(m, args[0])).dist
    active = (dist < torch.as_tensor(collision.contact_params(m).includemargin,
                                     dtype=dist.dtype, device=device)).sum(0).tolist()
    counts, k = {}, 0
    for kind in sorted(m.pairs):
        n = m.pairs[kind].geom1.shape[0] * m.pairs[kind].ncon
        counts[kind] = int(sum(active[k:k + n]))
        k += n
    print("[physics go2_pair_kinds] B=2049 active contacts per kind: " + ", ".join(
        f"{NEW_KINDS.get(kind, KIND_NAMES.get(kind))} {n}" for kind, n in counts.items()))
    check(all(counts.get(kind, 0) > 0 for kind in NEW_KINDS),
          "a pair kind the fused substep lacks has no active contact")
    sub = [a[::REF_STRIDE].cpu().double() for a in args]
    for n in (1, N_SUBSTEPS):
        card = pipeline.step(m, LeanPipelineState(*args[:3]), args[3], n)
        ref = pipeline.step(m, LeanPipelineState(*sub[:3]), sub[3], n)
        got = _named(env, card)
        hold_physics(f"[physics go2_pair_kinds] n_substeps={n} card float32 vs CPU float64:",
                     {k: x[::REF_STRIDE] for k, x in got.items()}, _named(env, ref), n)


def phase_no_syncs(env, device):
    """One torch.profiler window over a warm pipeline.step (8 substeps,
    B=2049): no host synchronisation and no host-to-device copy; the device
    kernels it launches per substep."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from tpu_dialmpc_torch.dynamics import pipeline
    from tpu_dialmpc_torch.envs.base import LeanPipelineState

    m = env.model
    args = near_home_inputs(m, 2049, 3, device)
    state = LeanPipelineState(*args[:3])
    pipeline.step(m, state, args[3], N_SUBSTEPS)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function("pipeline.step"):
            pipeline.step(m, state, args[3], N_SUBSTEPS)
        torch.cuda.synchronize()  # after the step's range: the window's end
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.events()
    window = next(ev.time_range for ev in events
                  if ev.name == "pipeline.step" and str(ev.device_type).endswith("CPU"))
    syncs = [ev.name for ev in events if "Synchronize" in ev.name
             and window.start <= ev.time_range.start <= window.end]
    copies = [ev.name for ev in events if "HtoD" in ev.name or "DtoH" in ev.name]
    kernels = [ev for ev in events if str(ev.device_type).endswith("CUDA")
               and ev.name != "pipeline.step"]
    device_ms = sum(ev.time_range.elapsed_us() for ev in kernels) / 1e3
    n = len(kernels)
    print(f"[physics no-syncs] warm pipeline.step, {N_SUBSTEPS} substeps at B=2049 on "
          f"{env.config.scene}: {len(syncs)} synchronising calls in the step's range "
          f"{sorted(set(syncs))}, {len(copies)} host-device copies in the window; {n} device "
          f"kernels ({n / N_SUBSTEPS:.0f} per substep), {device_ms:.1f} ms of device time in "
          f"{wall_ms:.1f} ms of wall (idle {1.0 - device_ms / wall_ms:.3f}; wall includes the "
          f"profiler's own cost)")
    check(not syncs and not copies, "pipeline.step synchronises with the host")
    check(n > 0, "the profiler recorded no device kernel")
    return n / N_SUBSTEPS


def phase_xla_path(fused_env, device, all_envs):
    """go2_stand with fused="off" at full width (Nsample=2048, Hsample=20,
    Hnode=5, 8 substeps) through get_env, MBDPI and make_control_step:
    reset, one timed reverse_once with injected noise, its rewards (2049,
    21) and Ybar held against the fused path's on the same noise and state;
    then one timed control step (Ndiffuse=2, executed by env.step).  The 10-iteration warm start (`reverse`, Ndiffuse_init=10)
    is skipped: ten more reverse_once of several seconds each on this path
    would not fit the script's time limit, and it adds no code path."""
    import torch

    from tpu_dialmpc_torch.envs import dial_defaults, get_env
    from tpu_dialmpc_torch.envs.base import to_lean
    from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI
    from tpu_dialmpc_torch.planner.runner import make_control_step

    t0 = time.perf_counter()
    env = get_env("go2_stand", device=device, fused="off")
    cfg = DialConfig(**dial_defaults("go2_stand"))
    check((cfg.Nsample, cfg.Hsample, cfg.Hnode, env.config.n_substeps) == (2048, 20, 5, 8),
          "go2_stand is not at its full width")
    check(not env.on_fused_path, "fused='off' did not pick the physics pipeline")
    for e in all_envs:  # every count to 0 just before this path
        e.fused_step.launches = 0
    mb, fmb = MBDPI(cfg, env), MBDPI(cfg, fused_env)
    state = env.reset()
    Y = torch.zeros((cfg.Hnode + 1, env.action_size), device=device)
    scale = torch.as_tensor(mb.sigma_control, dtype=torch.float32, device=device)
    noise = torch.randn((cfg.Nsample, cfg.Hnode + 1, env.action_size), device=device,
                        generator=torch.Generator(device=device).manual_seed(21))
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, out

    def reverse_once():
        # reverse_once's own steps, so that its reward matrix can be held too
        all_Y0s = mb._candidates(None, Y, scale, noise)
        rewss = mb.rollout_us_batch(state, mb.node2u(all_Y0s))
        return all_Y0s, rewss, mb._score_update(rewss, all_Y0s, scale)[0]

    ro_ms, (all_Y0s, rewss, Ybar) = timed(reverse_once)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    cs_ms, (state2, Y2, _) = timed(lambda: make_control_step(mb, cfg.Ndiffuse)(state, Ybar, gen))
    launched = [e.fused_step.launches for e in all_envs]
    check(env._fused_step is None and not any(launched),
          f"the fused='off' path launched the fused kernel: {launched}")
    check(bool(torch.isfinite(Y2).all()) and state2.pipeline.efc_force is not None,
          "the control step did not execute through env.step")

    # the fused path's rollouts of the same candidates from the same state
    frewss = fmb.rollout_us_batch(to_lean(fused_env.reset()), mb.node2u(all_Y0s))
    fYbar, _ = fmb._score_update(frewss, all_Y0s, scale)
    e, rel = _sample_errors(rewss, frewss)
    med, p99 = e.median().item(), torch.quantile(rel, 0.99).item()
    dY = (Ybar - fYbar).abs().max().item()
    print(f"[xla-path go2_stand] reverse_once, rewards {tuple(rewss.shape)} against the fused "
          f"path's: per-candidate max abs error median {med:.2e} (tolerance 1e-3), p99 of "
          f"relative {p99:.2e} (tolerance {P99_TOL:.0e}), max {e.max().item():.2e}; Ybar max abs "
          f"diff {dY:.2e} (tolerance 5e-2: the softmax divides reward gaps by std x temp)")
    check(bool(torch.isfinite(rewss).all()) and bool(torch.isfinite(Ybar).all()),
          "non-finite rewards or Ybar on the physics pipeline")
    check(med <= 1e-3 and p99 <= P99_TOL and dY <= 5e-2,
          "the physics pipeline's reverse_once disagrees with the fused path's")
    wall = time.perf_counter() - t0
    print(f"[xla-path go2_stand] N{cfg.Nsample}/H{cfg.Hsample}/Hnode{cfg.Hnode}/sub"
          f"{env.config.n_substeps} on the physics pipeline: reverse_once {ro_ms:.1f} ms, control "
          f"step (env.step + shift + {cfg.Ndiffuse} reverse_once) {cs_ms:.1f} ms; reward after "
          f"the step {state2.reward.item():.5f}; path wall {wall:.1f} s")
    return ro_ms, cs_ms


def phase_compat(device):
    """compat_q1 (reference quirk Q1) at Nsample=8, Hsample=4: the candidates
    chained one after another through env.step, on the card in float32
    against the CPU in float64.  The path is sequential over candidates by
    design (a parity fixture, not for production): at full width it would
    be 2049 x 21 sequential env.steps, so it runs small here."""
    import dataclasses

    import torch

    from tpu_dialmpc_torch.envs import dial_defaults, get_env
    from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI

    cfg = DialConfig(**dict(dial_defaults("go2_stand"), Nsample=8, Hsample=4, compat_q1=True))
    noise = 0.2 * torch.randn((cfg.Nsample, cfg.Hnode + 1, 12),
                              generator=torch.Generator().manual_seed(8), dtype=torch.float64)
    out = []
    for dev, dtype in ((device, "float32"), ("cpu", "float64")):
        env = get_env("go2_stand", device=dev, dtype=dtype)
        mb = MBDPI(cfg, env)
        t0 = time.perf_counter()
        Y = torch.zeros((cfg.Hnode + 1, 12), dtype=env._dtype, device=dev)
        scale = torch.as_tensor(mb.sigma_control, dtype=env._dtype, device=dev)
        res = mb.reverse_once_compat(env.reset(), None, Y, scale, noise=noise.to(dev, env._dtype))
        out.append((res, time.perf_counter() - t0))
    ((Y32, i32, p32), s32), ((Y64, i64, p64), s64) = out
    drew = (i32.rews.double().cpu() - i64.rews).abs().max().item()
    dq = (p32[0].double().cpu() - p64[0]).abs().max().item()
    dY = (Y32.double().cpu() - Y64).abs().max().item()
    print(f"[xla-path compat_q1] N{cfg.Nsample}/H{cfg.Hsample}, {cfg.Nsample + 1} candidates x "
          f"{cfg.Hsample + 1} chained env.steps: card {s32:.1f} s, CPU float64 {s64:.1f} s; "
          f"mean rewards max abs diff {drew:.2e} (tolerance 1e-3), final chained qpos {dq:.2e} "
          f"(tolerance 1e-2), Ybar {dY:.2e} (tolerance 5e-2)")
    check(drew <= 1e-3 and dq <= 1e-2 and dY <= 5e-2, "compat_q1 on the card disagrees with the CPU")


def phase_cli_physics():
    """The CLI's `replay` of the [cli] phase's trajectory (the fused path's)
    through env.step on the physics pipeline, on the card, and `env-test`
    for 20 steps."""
    import contextlib
    import io
    import math

    from tpu_dialmpc_torch.cli import main as cli

    def run(*argv):
        buf = io.StringIO()
        print(f"[cli] main({list(argv)})", flush=True)
        with contextlib.redirect_stdout(buf):
            rc = cli.main(list(argv))
        for line in buf.getvalue().splitlines():
            print(f"[cli]   {line}")
        check(rc == 0, f"the CLI {argv[0]} failed")
        return buf.getvalue().splitlines()

    lines = run("replay", "--task", CLI_TASK, "--trajectory",
                str(ROOT / "build" / "smoke_cli" / "full.npz"))
    drift = float(lines[-1].rsplit(" ", 1)[1])
    check(math.isfinite(drift), "the replay's qpos drift is not finite")
    lines = run("env-test", "--task", CLI_TASK, "--n-steps", "20")
    check(lines[-1].startswith("final qpos[:7]:"), "env-test did not finish")
    return drift


# ----------------------------------------------------------------------
# The single-device tools: the profiler (with the fp32 microbench kernel),
# IK, the native telemetry sink, randomize_tasks and the cost-based planner.
# ----------------------------------------------------------------------

H100_HBM = 3.35e12  # the data sheet's memory rate (its fp32 rate: FP32_FLOPS)
PEAK_REL_TOL = 1e-5  # the plain chain rounds a float64 multiply-add once per step


def _cli_lines(tag, argv):
    """cli.main(argv) in this process; its printed lines, echoed."""
    import contextlib
    import io

    from tpu_dialmpc_torch.cli import main as cli

    buf = io.StringIO()
    print(f"{tag} main({argv})", flush=True)
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    for line in buf.getvalue().splitlines():
        print(f"{tag}   {line}")
    check(rc == 0, f"{tag} the CLI {argv[0]} failed")
    return buf.getvalue().splitlines()


def phase_profile(device):
    """The CLI's `profile` at go2_stand's full width, with the microbench's
    launch count set to 0 just before and read just after; then the
    microbench kernel against its plain version at the same shape.
    Returns the kernel's JSON record."""
    import torch

    from tpu_dialmpc_torch.telemetry import profile as prof

    out = ROOT / "build" / "smoke_profile"
    shutil.rmtree(out, ignore_errors=True)
    prof.fp32_peak_ops_per_sec.cache_clear()
    prof.hbm_copy_bytes_per_sec.cache_clear()
    prof.FMA_CHAIN.launches = 0
    t0 = time.perf_counter()
    lines = _cli_lines("[profile]", ["profile", "--task", "go2_stand", "--out", str(out)])
    launches = prof.FMA_CHAIN.launches
    wall = time.perf_counter() - t0
    phases = dict(line.strip().split(": ") for line in lines[1:5])
    check(set(phases) == {"reverse_once_ms", "sample_spline_ms", "rollout_ms",
                          "score_update_ms"}, "profile printed other phases")
    check("fused kernel roofline:" in lines, "profile printed no roofline")
    roof = dict(line.strip().split(": ", 1) for line in
                lines[lines.index("fused kernel roofline:") + 1:] if line.startswith("  "))
    check(0.0 < float(roof["fraction_of_roof"]) <= 1.0, "the roofline's fraction is not in (0, 1]")
    peak, hbm = prof.fp32_peak_ops_per_sec(), prof.hbm_copy_bytes_per_sec()  # cached: no launch
    print(f"[profile] measured fp32 peak {peak / 1e12:.3f} T ops/s ({peak / FP32_FLOPS:.4f} of the "
          f"data sheet's 67 TFLOP/s), memory rate {hbm / 1e12:.3f} TB/s ({hbm / H100_HBM:.4f} of "
          f"3.35 TB/s); fp32_peak launches {launches}; phase wall {wall:.1f} s")
    check(0.0 < peak <= 1.05 * FP32_FLOPS, "the measured fp32 peak is above the card's")
    check(0.0 < hbm <= 1.05 * H100_HBM, "the measured memory rate is above the card's")
    check(launches > 0, "the profile did not launch the fp32_peak kernel")
    events = json.loads((out / "trace.json").read_text())["traceEvents"]
    fused_records = [ev for ev in events if "fused_step_kernel" in ev.get("name", "")
                     and ev.get("cat") == "kernel"]
    print(f"[profile] trace of one reverse_once (21 horizon steps, one launch each): "
          f"{len(events)} events, {len(fused_records)} fused-kernel records")
    check(len(fused_records) > 0, "the profile's trace holds no fused-kernel record")

    # the microbench kernel against its plain version, at the run's shape
    x0, a, b = prof.fp32_peak_inputs(device)
    n, k = x0.shape[0], prof.PEAK_STEPS
    got = prof.FMA_CHAIN(x0, a, b, k)
    want = []
    plain_ms = cuda_ms(lambda: want.append(prof.FMA_CHAIN.plain(x0, a, b, k)), 1)
    err = ((got - want[0]).abs() / want[0].abs()).max().item()
    check(bool(torch.isfinite(got).all()), "non-finite microbench output")
    ms = cuda_ms(lambda: prof.FMA_CHAIN.launch(x0, a, b, k), 20)
    bound = prof.FMA_CHAIN.ops(n, k) / FP32_FLOPS * 1e3
    print(f"[profile] fp32_peak n={n} k={k}: kernel vs plain max relative diff {err:.3e} "
          f"(tolerance {PEAK_REL_TOL:.0e}); kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, bound "
          f"{bound:.4f} ms ({prof.FMA_CHAIN.ops(n, k):.4e} fp32 ops at 67 TFLOP/s), share "
          f"{bound / ms:.4f}")
    check(err <= PEAK_REL_TOL, "the fp32_peak kernel disagrees with its plain version")
    return {
        "name": "fp32_peak",
        "route": "cuda",
        "source": "tpu_dialmpc_torch/csrc/fp32_peak.cu",
        "replaces": "tpu_dialmpc/telemetry/profile.py:106",
        "launches": launches,
        "max_abs_err": (got - want[0]).abs().max().item(),
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "operations",
        "share": bound / ms,
        "library_ms": None,  # no PyTorch call computes a dependent FMA chain
        "measured_peak_ops_per_sec": peak,
        "measured_hbm_bytes_per_sec": hbm,
    }, phases, roof


def phase_ik(device):
    """The feet IK (base 3 cm down) on the card in float32 against the CPU
    in float64."""
    from tpu_dialmpc_torch.envs import get_env
    from tpu_dialmpc_torch.tools import ik

    offset = [0.0, 0.0, -0.03]
    q, res = ik.solve_feet_ik(get_env("go2_stand", device=device), offset)
    q64, res64 = ik.solve_feet_ik(get_env("go2_stand", device="cpu", dtype="float64"), offset)
    diff = (q.double().cpu() - q64).abs().max().item()
    print(f"[ik] go2_stand base dz -0.03: residual {float(res):.2e} m on the card (CPU float64 "
          f"{float(res64):.2e} m); joint angles max abs diff from the CPU {diff:.2e} rad "
          f"(tolerance 1e-4)")
    check(float(res) < 1e-4 and diff < 1e-4, "the IK on the card disagrees with the CPU")


def phase_native(cfg):
    """A 6-step CLI run with telemetry through the native sink, and the same
    run through the Python writer: the same records."""
    out = ROOT / "build" / "smoke_native"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    records = {}
    for backend in ("native", "python"):
        path = out / f"{backend}.jsonl"
        _cli_lines("[native]", ["run", "--task", CLI_TASK, "--n-steps", "6", "--telemetry",
                                str(path), "--telemetry-backend", backend])
        records[backend] = [json.loads(line) for line in path.read_text().splitlines()]
    same = all({k: v for k, v in a.items() if k != "time"} ==
               {k: v for k, v in b.items() if k != "time"}
               for a, b in zip(records["native"], records["python"]))
    print(f"[native] N{cfg.Nsample}/H{cfg.Hsample}, 6 steps: native sink "
          f"{len(records['native'])} records, Python writer {len(records['python'])}; the same "
          f"values (time aside): {same}")
    check(len(records["native"]) == len(records["python"]) == 6 and same,
          "the native sink and the Python writer wrote other records")


def phase_randomize(device):
    """go2_stand with randomize_tasks at full width from a state at step 498:
    3 control steps; at step 500 every rollout candidate's command and the
    executed step's are the seed's draw, which the CPU draws too."""
    import dataclasses

    import torch

    from tpu_dialmpc_torch.envs import dial_defaults, get_env
    from tpu_dialmpc_torch.envs.base import to_lean
    from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI
    from tpu_dialmpc_torch.planner.runner import make_control_step

    env = get_env("go2_stand", device=device, randomize_tasks=True)
    cfg = DialConfig(**dial_defaults("go2_stand"))
    mb = MBDPI(cfg, env)
    gen = torch.Generator(device=device).manual_seed(7)
    state = to_lean(env.reset(gen))
    state = dataclasses.replace(state, info=dataclasses.replace(
        state.info, step=torch.tensor(498, dtype=torch.int32, device=device)))
    seen = {}  # batch size -> the commands at step 500 of every _post_physics call
    post = env._post_physics

    def recording(**kw):
        reward, done, info2 = post(**kw)
        at = kw["info"].step == 500
        if bool(at.any()):
            seen.setdefault(at.shape[0], []).append(
                torch.cat([info2.vel_tar[at], info2.ang_vel_tar[at]], dim=-1))
        return reward, done, info2

    env._post_physics = recording
    step = make_control_step(mb, cfg.Ndiffuse)
    Y = torch.zeros((cfg.Hnode + 1, env.action_size), device=device)
    t0 = time.perf_counter()
    for _ in range(3):
        state, Y, infos = step(state, Y, gen)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    vel, ang = env.sample_command(state.info.seed.cpu(), torch.tensor(500))
    want = torch.cat([vel, ang]).to(device)
    cand = torch.cat(seen.get(cfg.Nsample + 1, []))
    executed = torch.cat(seen.get(1, []))
    print(f"[randomize] N{cfg.Nsample}/H{cfg.Hsample}, 3 control steps from step 498 "
          f"({wall:.2f} s): step-500 commands of {cand.shape[0]} candidates and "
          f"{executed.shape[0]} executed step(s); the draw {want.tolist()}; final step "
          f"{int(state.info.step)}, reward {state.reward.item():.5f}")
    # the rollouts of the first two control steps' 2 x Ndiffuse iterations
    # pass step 500; the third control step executes it
    check(cand.shape[0] == 2 * cfg.Ndiffuse * (cfg.Nsample + 1) and executed.shape[0] == 1,
          "the rollouts or the executed step did not reach step 500")
    check(bool((cand == want).all()) and bool((executed == want).all()),
          "the candidates' and the executed command differ at the redraw")
    check(bool(torch.isfinite(Y).all()), "non-finite plan under randomize_tasks")


def phase_cost_dial(device):
    """The pendulum swing-up on the card against the CPU (float64, the same
    CPU generator's draws), and one LeggedRobot improve at 256 samples, H=20,
    3 levels on the card, timed."""
    import torch

    from tpu_dialmpc_torch.planner.cost_dial import CostDialConfig, CostDialMPC
    from tpu_dialmpc_torch.systems import InvertedPendulum, LeggedRobot

    cfg = CostDialConfig(horizon=20, steps=60, diffusion_levels=3, num_samples=128)
    runs = []
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        res = CostDialMPC(InvertedPendulum(device=dev, dtype=torch.float64), cfg).run(
            [0.0, 0.0], generator=torch.Generator().manual_seed(0))
        runs.append((res.trajectory.cpu(), time.perf_counter() - t0))
    (card, s_card), (cpu, s_cpu) = runs
    diff = (card - cpu).abs().max().item()
    theta, theta_dot = card[-1].tolist()
    print(f"[cost_dial] pendulum swing-up, 60 steps x 3 levels x 128 samples: card {s_card:.2f} s, "
          f"CPU {s_cpu:.2f} s; trajectory max abs diff {diff:.2e} (tolerance 1e-5); final "
          f"(theta, theta_dot) ({theta:.4f}, {theta_dot:.4f}), target (pi, 0)")
    check(diff <= 1e-5, "the pendulum run on the card disagrees with the CPU's")
    check(abs(theta - 3.141592653589793) < 0.35, "the pendulum did not swing up")

    legged = LeggedRobot(device=device)
    mpc = CostDialMPC(legged, CostDialConfig(horizon=20, diffusion_levels=3, num_samples=256))
    x0 = legged.target_state.clone()
    zero = torch.zeros((20, legged.control_dim), device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    mpc.improve(x0, zero, gen)  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq = mpc.improve(x0, zero, gen)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    c0, c1 = (mpc._rollout_cost(x0, s[None])[0].item() for s in (zero, seq))
    print(f"[cost_dial] LeggedRobot (go2_force) improve, 256 samples x H20 x 3 levels "
          f"(60 batched pipeline.step): {ms:.1f} ms; rollout cost {c0:.4f} -> {c1:.4f}")
    check(bool(torch.isfinite(seq).all()), "non-finite LeggedRobot plan")
    return ms


# ----------------------------------------------------------------------
# the sample-parallel planner (tpu_dialmpc_torch/shard/) and the two
# measuring entry points, scaling and bench

SHARD_WIDTH = (2048, 20, 5, 8)  # go2_stand's full width
SHARD_TOL = 1e-5  # Ybar max abs diff, weights max abs diff over the largest weight


def _hold_sharded(tag, outs, horizon):
    """Every rank against the single-device planner, the ranks against each
    other to the bit, and each rank's launches per reverse_once."""
    import numpy as np

    for how in ("injected", "generator"):
        for rank, out in enumerate(outs):
            o = out[how]
            dy = float(np.abs(o["Ybar"] - o["single_Ybar"]).max())
            dw = float(np.abs(o["weights"] - o["single_weights"]).max() / o["single_weights"].max())
            print(f"[{tag}] rank {rank} ({out['backend']}, samples {out['block'][0]}-"
                  f"{out['block'][1] - 1} + the anchor) {how}: Ybar max abs diff from MBDPI "
                  f"{dy:.3e}, weights {dw:.3e} of the largest (tolerance {SHARD_TOL:.0e}); "
                  f"fused launches {o['launches']} (expected {horizon})")
            check(bool(np.isfinite(o["Ybar"]).all()), f"{tag}: non-finite Ybar")
            check(dy <= SHARD_TOL and dw <= SHARD_TOL, f"{tag}: the sharded planner disagrees "
                  "with MBDPI")
            check(o["launches"] == horizon, f"{tag}: a rank did not launch the kernel once per "
                  "horizon step")
        if len(outs) > 1:
            same = all(np.array_equal(out[how]["Ybar"], outs[0][how]["Ybar"])
                       and np.array_equal(out[how]["weights"], outs[0][how]["weights"])
                       for out in outs)
            print(f"[{tag}] {how}: the ranks' Ybar and weights equal to the bit: {same}")
            check(same, f"{tag}: the ranks disagree")


def phase_shard():
    """go2_stand at full width through ShardedMBDPI: one rank of NCCL, then
    two gloo ranks sharing the card (NCCL refuses two ranks on one device),
    each rank a spawned process.  Timed in turns: on one rank against
    MBDPI, on two against MBDPI at each rank's block size (the same
    rollouts, no collective).  Returns (NCCL ranks' ms by planner, gloo
    ranks' ms by planner, each rank's launches per reverse_once)."""
    import torch_shard_ranks as ranks
    from tpu_dialmpc_torch.shard import distributed

    horizon = SHARD_WIDTH[1] + 1
    groups = {}
    for tag, world, backend, compare in (("shard nccl-1", 1, "nccl", ("single",)),
                                         ("shard gloo-2", 2, "gloo", ("block",))):
        t0 = time.perf_counter()
        outs = distributed.run_group(ranks.card_reverse_once, world, (SHARD_WIDTH, 7, compare),
                                     backend=backend, device="cuda:0", timeout_s=300)
        _hold_sharded(tag, outs, horizon)
        check(all(o["backend"] == backend for o in outs), f"{tag}: the group is not {backend}")
        for rank, o in enumerate(outs):
            calls = ", ".join(f"{k} x{c} ({ms:.2f} ms host)" for k, (c, ms) in
                              sorted(o["host_calls"].items()))
            print(f"[{tag}] rank {rank}: median ms per reverse_once (7 calls in turns): "
                  f"{json.dumps({k: round(v, 2) for k, v in o['ms'].items()})}; one sharded "
                  f"call's {calls}")
            check(o["host_calls"].get("c10d::allreduce_", (0,))[0] > 0,
                  f"{tag}: the sharded call made no all-reduce")
        print(f"[{tag}] N{SHARD_WIDTH[0]}/H{SHARD_WIDTH[1]}/Hnode{SHARD_WIDTH[2]}/sub"
              f"{SHARD_WIDTH[3]}; phase wall {time.perf_counter() - t0:.1f} s")
        groups[tag] = outs
    nccl, gloo = groups["shard nccl-1"], groups["shard gloo-2"]
    launches = [o["injected"]["launches"] for o in nccl + gloo]
    return nccl[0]["ms"], gloo[0]["ms"], launches


def phase_scaling(device):
    """The CLI's `scaling` on the card (one row: one card), the collective
    overhead of two gloo ranks sharing the card at go2_stand's full width,
    and the predicted rows from both.  Returns (row, overhead)."""
    from tpu_dialmpc_torch.shard import scaling

    with recording_envs() as made:
        lines = _cli_lines("[scaling]", ["scaling", "--task", "go2_stand"])
    rows = [json.loads(line) for line in lines]
    launches = sum(e.fused_step.launches for e in made)
    print(f"[scaling] fused launches of the CLI's scaling: {launches}")
    check(len(rows) == 1 and rows[0]["devices"] == 1, "scaling gave other rows than one card's")
    check(rows[0]["ms_per_iteration"] > 0 and rows[0]["efficiency_vs_linear"] == 1.0,
          "scaling's row is malformed")
    check(launches > 0, "the CLI's scaling did not launch the fused kernel")
    n, h, hnode, _ = SHARD_WIDTH
    over = scaling.collective_overhead_report(task="go2_stand", nsample=n, hsample=h, hnode=hnode,
                                              n_devices=2, device=device)
    print(f"[scaling] collective_overhead_report: {json.dumps(over)}")
    check(over["unsharded_ms"] > 0 and over["sharded_ms"] > 0, "the overhead report is malformed")
    check(over["port_payload_bytes_per_iteration"] > over["payload_bytes_per_iteration"],
          "the sharded ranks reduced fewer bytes than the update's partials")
    # the port's payload: what the ranks all-reduced, not the JAX formula's
    for r in scaling.predicted_efficiency_rows(rows[0]["ms_per_iteration"],
                                               over["port_payload_bytes_per_iteration"]):
        print(f"[scaling] predicted: {json.dumps(r)}")
    return rows[0], over


BENCH_METRICS = ("go2_stand_reverse_once_ms_N2048_H20_sub8",
                 "go2_stand_control_step_ms_N2048_H20_sub8_d2",
                 "go2_stand_fused_rollout_vpu_roofline_N2048")


def phase_bench():
    """The CLI's `bench --full` on go2_stand at N2048/H20/sub8: the three
    rows of the JAX package's schema, by name, finite and positive, on the
    card.  Returns the rows."""
    import math

    with recording_envs() as made:
        out = ROOT / "build" / "smoke_bench" / "BENCH_TORCH_LAST_GOOD.json"
        out.parent.mkdir(parents=True, exist_ok=True)
        lines = _cli_lines("[bench]", ["bench", "--task", "go2_stand", "--iters", "3", "--full",
                                       "--out", str(out)])
    line = json.loads(lines[-2])
    written = json.loads(out.read_text())
    check({k: written[k] for k in line} == line and written["device"] and written["measured_at"],
          "bench --out wrote another line than it printed")
    rows = [line] + line.get("extra", [])
    launches = sum(e.fused_step.launches for e in made)
    print(f"[bench] metrics {[r['metric'] for r in rows]}; fused launches {launches}")
    check(tuple(r["metric"] for r in rows) == BENCH_METRICS, "bench's metric names differ")
    for r in rows:
        check(math.isfinite(r["value"]) and r["value"] > 0, f"{r['metric']}: value {r['value']}")
        check(r["platform"] == "cuda", f"{r['metric']}: platform {r['platform']}")
    check(launches > 0, "bench did not launch the fused kernel")
    return rows


QUALITY_GATES = ("go2_trot", "go2_jump")
QUALITY_STEPS = 150  # the quick lane
# a gate's result: the JAX run_gate's keys, then the card's name and limit
GATE_KEYS = ["gate", "task", "n_steps", "lane", "seed", "measured_at", "wall_s", "metrics",
             "joint_graze_rates", "checks", "passed", "recorded", "device", "power_limit"]
FK_TOL = 1e-9  # m: float64 FK on the card against the CPU


@contextlib.contextmanager
def recording_runs():
    """Every result `runner.run_scan` returns inside the block, in a list."""
    from tpu_dialmpc_torch.planner import runner

    made, run_scan = [], runner.run_scan

    def recording_run_scan(*args, **kw):
        made.append(run_scan(*args, **kw))
        return made[-1]

    runner.run_scan = recording_run_scan
    try:
        yield made
    finally:
        runner.run_scan = run_scan


def phase_quality(card, device, all_envs):
    """The quality harness's quick lane of go2_trot and go2_jump at full
    width, in this process (it reuses the kernels built at the start): the
    artifact, each gate's launches against `expected_launches`, and
    go2_jump's FK metrics recomputed on the CPU.  Returns (artifact,
    launches per gate)."""
    import math

    import torch

    from tpu_dialmpc_torch import quality
    from tpu_dialmpc_torch.envs import get_env
    from tpu_dialmpc_torch.planner.dial import DialConfig

    out = ROOT / "build" / "smoke_quality" / "QUALITY_TORCH_QUICK.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.unlink(missing_ok=True)
    argv = ["--quick", "--gates", *QUALITY_GATES, "--out", str(out)]
    print(f"[quality] quality.main({argv})", flush=True)
    for e in all_envs:  # every count to 0 just before this path
        e.fused_step.launches = 0
    t0 = time.perf_counter()
    with recording_envs() as made, recording_runs() as runs:
        rc = quality.main(argv)
    wall = time.perf_counter() - t0
    check(not any(e.fused_step.launches for e in all_envs),
          "the gates launched another path's kernel")
    doc = json.loads(out.read_text())
    name, limit = (x.strip() for x in card.rsplit(",", 1))
    check((doc["platform"], doc["device"], doc["power_limit"]) == ("cuda", name, limit),
          f"the artifact's card is {doc['platform']}, {doc['device']}, {doc['power_limit']}")
    check(rc == (0 if doc["all_passed"] else 1), f"quality.main returned {rc}")
    check([g["gate"] for g in doc["gates"]] == list(QUALITY_GATES), "the artifact's gates differ")
    check(len(made) == len(runs) == len(QUALITY_GATES), "one env and one run per gate expected")
    launches = {}
    for g, env, res in zip(doc["gates"], made, runs):
        gate = quality.GATES[g["gate"]]
        cfg = DialConfig(Hsample=gate.dial["Hsample"], Hnode=gate.dial["Hnode"], Nsample=2048,
                         Ndiffuse=2, Ndiffuse_init=10)
        expected = expected_launches(cfg, QUALITY_STEPS)
        launches[g["gate"]] = env.fused_step.launches
        check(list(g) == GATE_KEYS, f"{g['gate']}: keys {list(g)}")
        check((g["lane"], g["n_steps"], g["device"], g["power_limit"]) ==
              ("quick", QUALITY_STEPS, name, limit), f"{g['gate']}: lane, steps or card")
        check(env.on_fused_path and env.config.n_substeps == N_SUBSTEPS,
              f"{g['gate']} did not run the fused kernel at {N_SUBSTEPS} substeps")
        check(tuple(res.qpos.shape) == (QUALITY_STEPS, env.model.nq), f"{g['gate']}: qpos shape")
        bad = [k for k, v in g["metrics"].items() if not math.isfinite(v)]
        check(not bad, f"{g['gate']}: non-finite metrics {bad}")
        check(all(math.isfinite(c["measured"]) for c in g["checks"]), f"{g['gate']}: checks")
        print(f"[quality {g['gate']}] N2048/H{cfg.Hsample}/Hnode{cfg.Hnode}/sub"
              f"{env.config.n_substeps} on {env.config.scene}, {QUALITY_STEPS} steps: "
              f"passed={g['passed']}, wall {g['wall_s']} s; fused launches "
              f"{launches[g['gate']]} (expected {expected})")
        print(f"[quality {g['gate']}] metrics {json.dumps(g['metrics'])}")
        for c in g["checks"]:
            print(f"[quality {g['gate']}]   {c['metric']} {c['measured']:.4f} {c['op']} "
                  f"{c['threshold']}: passed={c['passed']}")
        check(launches[g["gate"]] == expected, f"{g['gate']}: the kernel's launches differ")

    # go2_jump's foot-site metrics: float64 FK on the card against the CPU
    jump = dict(zip(QUALITY_GATES, zip(made, runs)))["go2_jump"]
    jump_metrics = doc["gates"][QUALITY_GATES.index("go2_jump")]["metrics"]
    qpos = jump[1].qpos
    cpu_jump = get_env("go2_jump", device="cpu")
    sites = quality.foot_positions(jump[0], qpos)
    check(sites.device.type == "cuda" and sites.dtype == torch.float64, "FK not on the card")
    err = (sites.cpu() - quality.foot_positions(cpu_jump, qpos.cpu())).abs().max().item()
    flight_cpu = quality._flight_metrics(cpu_jump, qpos.cpu())
    climb_card = quality._climb_metrics(get_env("go2_crate_climb", device=device), qpos)
    climb_cpu = quality._climb_metrics(get_env("go2_crate_climb", device="cpu"), qpos.cpu())
    print(f"[quality go2_jump] float64 FK of the trajectory's feet, card vs CPU: max abs diff "
          f"{err:.3e} m (tolerance {FK_TOL:.0e}); flight metrics on the CPU {flight_cpu}; "
          f"on-crate metrics (go2_crate_climb's crate) card {climb_card}, CPU {climb_cpu}")
    check(err <= FK_TOL, "the card's FK disagrees with the CPU's")
    check(flight_cpu == {k: jump_metrics[k] for k in flight_cpu},
          "the flight metrics differ between the card and the CPU")
    check(climb_card == climb_cpu, "the on-crate metrics differ between the card and the CPU")
    print(f"[quality] {len(doc['gates'])} gates, all passed: {doc['all_passed']}; phase wall "
          f"{wall:.1f} s")
    print(f"[quality] artifact {json.dumps(doc)}")
    return doc, launches


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not all((ROOT / f).is_file() for f in ("tpu_dialmpc_torch/csrc/fused_step.cu",
                                               "tests/torch_port_helpers.py")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(1, str(ROOT / "tests"))
    device = torch.device("cuda", 0)

    records, summary = [], []
    t_start = time.perf_counter()
    try:
        card = phase_card()
        envs = [(path,) + make_env(path.task, path.scene, path.width, device) for path in PATHS]
        all_envs = [env for _, env, _ in envs]
        from tpu_dialmpc_torch.envs import get_env

        # the [quality] phase's go2_jump: the crate scene with the crate at
        # x=30, another build of the crate model
        phase_build_all(all_envs + [get_env("go2_jump", device=device)])
        for path, env, cfg in envs:
            t0 = time.perf_counter()
            task, scene = path.task, path.scene
            phase_build(env, device, scene)
            max_err, ms, plain_ms = phase_compare(env, path, device, scene)
            ops, bound = phase_bound(env, ms, scene)
            mbdpi, state, Y0, gen, step_rest, launches = run_main_path(
                env, cfg, device, task, all_envs)
            ro_ms, cs_ms = time_main_path(mbdpi, state, Y0, gen, step_rest, cfg, device, task,
                                          path.full)
            print(f"[time {task}] path wall {time.perf_counter() - t0:.1f} s")
            summary.append(f"{task} reverse_once {ro_ms:.2f} ms, control step {cs_ms:.2f} ms, "
                           f"fused_step[{scene}] {ms[2049]:.3f} ms vs plain {plain_ms:.1f} ms, "
                           f"bound {bound:.4f} ms")
            if task == CLI_TASK:
                t0 = time.perf_counter()
                loop_s, scan_s = phase_cli(cfg)
                phase_diag(env, cfg, device)
                print(f"[time cli] phase wall {time.perf_counter() - t0:.1f} s")
                summary.append(f"cli run 6 steps {loop_s:.2f} s, --scan {scan_s:.2f} s")
            records.append({
                "name": f"fused_step[{scene}]",
                "route": "cuda",
                "source": "tpu_dialmpc_torch/csrc/fused_step.cu",
                "replaces": "tpu_dialmpc/dynamics/fused.py:1440",
                "launches": launches,
                "max_abs_err": max_err,
                "ms": ms[2049],
                "plain_ms": plain_ms,
                "bound_ms": bound,
                "bound_by": "operations",
                "share": bound / ms[2049],
                "library_ms": None,  # no PyTorch call computes this function
                "ops_per_substep": ops,
            })
        t0 = time.perf_counter()
        by_scene = {path.scene: (path, env) for path, env, _ in envs}
        physics_ms = {}
        for scene, what in PHYSICS_MODELS:
            path, env = by_scene[scene]
            physics_ms[scene] = phase_physics(env, path.inputs, device, what)
        phase_pair_kinds(device)
        per_substep = phase_no_syncs(by_scene["go2_force"][1], device)
        ro_ms, cs_ms = phase_xla_path(by_scene["go2_force"][1], device, all_envs)
        phase_compat(device)
        drift = phase_cli_physics()
        print(f"[time physics] the physics pipeline's phases: wall {time.perf_counter() - t0:.1f} s")
        summary.append("physics pipeline, 8 substeps at B=2049: " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in physics_ms.items())
            + f", {per_substep:.0f} kernels per substep; go2_stand fused='off' reverse_once "
            f"{ro_ms:.1f} ms, control step {cs_ms:.1f} ms; replay drift {drift:.3e}")
        t0 = time.perf_counter()
        record, phases, roof = phase_profile(device)
        records.append(record)
        phase_ik(device)
        phase_native(next(cfg for path, _, cfg in envs if path.task == CLI_TASK))
        phase_randomize(device)
        legged_ms = phase_cost_dial(device)
        print(f"[time tools] the tools' phases: wall {time.perf_counter() - t0:.1f} s")
        summary.append(
            "go2_stand profile: " + ", ".join(f"{k} {v}" for k, v in phases.items())
            + f", roofline fraction {float(roof['fraction_of_roof']):.5f} of "
            f"{float(roof['ideal_vpu_ms']):.4f} ms ideal over {float(roof['measured_ms']):.2f} ms; "
            f"fp32 peak {record['measured_peak_ops_per_sec'] / 1e12:.3f} T ops/s, memory "
            f"{record['measured_hbm_bytes_per_sec'] / 1e12:.3f} TB/s; fp32_peak {record['ms']:.4f} "
            f"ms; LeggedRobot improve {legged_ms:.1f} ms")
        t0 = time.perf_counter()
        nccl_ms, gloo_ms, shard_launches = phase_shard()
        print(f"[time shard] wall {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        scaling_row, overhead = phase_scaling(device)
        print(f"[time scaling] wall {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        bench_rows = phase_bench()
        print(f"[time bench] wall {time.perf_counter() - t0:.1f} s")
        # [small]'s processes run beside [quality]: neither times anything
        # but its own wall, and the plain chain is host-bound
        small = start_small_against_plain()
        try:
            t0 = time.perf_counter()
            gates, gate_launches = phase_quality(card, device, all_envs)
            print(f"[time quality] wall {time.perf_counter() - t0:.1f} s")
        except BaseException:
            stop_small(small)
            raise
        finish_small_against_plain(small)
        records[0]["sharded_launches_per_rank"] = shard_launches
        records[0]["quality_launches"] = {"go2_trot": gate_launches["go2_trot"]}
        records[1]["quality_launches"] = {"go2_jump (crate at x=30)": gate_launches["go2_jump"]}
        summary.append(
            f"go2_stand sharded reverse_once: 1 NCCL rank {nccl_ms['sharded']:.2f} ms (MBDPI "
            f"{nccl_ms['single']:.2f} ms), 2 gloo ranks on the card {gloo_ms['sharded']:.2f} ms "
            f"(MBDPI at 1024 in each {gloo_ms['block']:.2f} ms); scaling "
            f"{scaling_row['ms_per_iteration']:.2f} ms per iteration on 1 card; overhead "
            f"{overhead['unsharded_ms']:.2f} -> {overhead['sharded_ms']:.2f} ms; bench "
            + ", ".join(f"{r['metric']} {r['value']}" for r in bench_rows))
        summary.append("quality quick lane: " + ", ".join(
            f"{g['gate']} passed={g['passed']} ({sum(c['passed'] for c in g['checks'])}/"
            f"{len(g['checks'])} checks, {g['wall_s']} s)" for g in gates["gates"]))
    except SmokeError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    print(f"[summary] {card}, per call at B=2049: " + "; ".join(summary))
    print(f"[summary] total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
