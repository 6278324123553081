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
  stand-ins, Nsample=2048, Hsample=32, Hnode=8;
- h1_walk on the 33-dof humanoid with the H1-2 joint layout
  (tests/assets/unitree_h1/mjx_scene_h1_2_walk.xml, given by path: 27
  motors), Nsample=2048, Hsample=32, Hnode=8: its kernel keeps each dof
  mask in two 32-bit words, and the compare's inputs hold the right hand,
  whose contact slot carries dof 32, on the floor in some samples.

All seven paths' kernels, the [wide] model's and go2_jump's are built
first, in parallel (one nvcc each).  Phases, for
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
  3. the main path: reset, the reverse warm start, 3 control steps, through
     a planner that captures (`MBDPI(capture="auto")`: `reverse_once` and
     the control step as CUDA graphs, tpu_dialmpc_torch/planner/capture.py),
     with the kernel's launch count checked, then timings: 5 timed
     `reverse_once` and control steps (graph replays), and on the first
     four paths a torch.profiler window over 3 and 2 of them, after
     a pre-roll of spin kernels that is left out of the counts (wall
     ms, device busy ms and idle share, the fused kernel's device ms and
     launches, the trace's count of them held against the launch counter,
     the counted launches with no device record,
     the other kernels', and the host's cudaStreamSynchronize calls and
     wait; wall includes the profiler's own cost);
  4. [capture]: the same planner against `MBDPI(capture=False)` on the
     same state, plan and generator seed, 3 `reverse_once` calls and 3
     chained control steps each: every output field (Ybar, each ReverseInfo
     field, each field of the executed state) bit-equal, its max abs diff
     printed, the launches per replay, the generators' states equal after,
     and the eager units' median ms beside the captured ones; on go2_stand
     and h1_push_crate the eager units' profile windows too, and
     [sync-debug]: a warm eager and a captured `reverse_once` and control
     step under torch.cuda.set_sync_debug_mode("error"); and the path's
     wall seconds.
After the seven paths, [wide]: the fused pair-kinds model (nv=36,
tests/assets/pairs/mjx_scene_pair_kinds_fused.xml: the pair-kinds scene's
objects colliding with the floor alone), which no env runs: its build, its
kernel against its plain version at B=2049 and B=1 (the second stick's
pattern rows and slot masks in the masks' second word), its time and bound,
then 21 FusedStep calls at B=2049 chained state to state, their launches
counted from 0.
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
Then [env-kernels]: the Go2 env step's two kernels (csrc/go2_env_step.cu,
go2_ctrl and go2_post_physics) against their plain version (the env's
`_ctrl_batch_plain` and `_post_physics_plain`) on the same CUDA tensors, on
each Go2 path's env at B=2049 (info broadcast with stride 0) and B=1:
integers and bools equal, floats within REL_TOL; their launches on
go2_stand's captured control step at its benchmark cell's width
(N2048/H25/Hnode5, Ndiffuse 2), 3 replays counted from 0, 53 each a step;
and each kernel's time per call at B=2049 and B=1 captured 50 times in one
graph, its own device time from the profiler, the plain ops' time captured
and eager, and its bound (the bytes it moves at 3.35 TB/s).
Then [mjcf]: the port's MJCF compiler (`dynamics/mjcf.py`,
no mujoco, which the script checks is never imported) compiles the seven
stand-in scenes of tests/assets, each held to its shipped .npz (integers
and tables exactly, floats to 1e-12; host ms per compile); each path's env is
built again from its XML (TPU_DIALMPC_ASSETS) and its packed kernel
constants and build key compared with the .npz env's (an equal key reuses
the kernel already built); then go2_stand (N2048/H20/Hnode5) and
h1_push_crate (N2048/H32/Hnode8), built from XML, run one reverse_once under
injected noise and one control step, each against the same calls on the .npz
env (bit-equal where the keys are equal, else within REL_TOL), with their
fused launches counted from 0 and checked.
Then the physics pipeline (`dynamics/pipeline.py`, the JAX
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
  - [xla-path go2_stand] go2_stand with fused="off" at full width, the
    planner capturing its env steps as CUDA graphs (B=2049 for the
    env's horizon step, B=1 for the executed `step_lean`): 3 `reverse_once`
    and 2 chained control steps (graph replays, under
    set_sync_debug_mode("error")) bit-equal to `MBDPI(capture=False)`'s,
    median ms of both, each graph's nodes and capture and instantiate
    seconds, the phase's peak memory, no fused launch; and one
    `reverse_once` under injected noise held against the fused path's;
  - [xla-path compat_q1] the chained-candidate planner at a small width,
    captured on the card (its env.step graph at B=1) against the CPU in
    float64;
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
    one-rank NCCL group, captured (its all-reduces inside the graph): a
    `reverse_once` under injected noise, one from the shared generator and
    one more under the injected noise (a replay), each against `MBDPI` on
    the same inputs (Ybar max abs diff and weights over the largest weight,
    1e-5) and against the eager sharded planner to the bit (the same bytes
    all-reduced), the fused launches of each (Hsample+1); the captured and
    eager sharded planner and `MBDPI` timed in turns, the captured one at
    most 1.10x `MBDPI`;
  - [shard gloo-2] the same on two gloo ranks sharing the card (NCCL refuses
    two ranks on one device), 1025 candidates each, eager (gloo's
    all-reduces are host round trips): the ranks equal to the bit, each
    against MBDPI, each rank's launches and time;
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
import dataclasses
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
import time
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path
from types import SimpleNamespace
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


def h1_2_floor_inputs(model, B, seed, device):
    """The same on the 33-dof humanoid (tests/assets/unitree_h1/
    mjx_scene_h1_2_walk.xml).  At B=1: a sample lying face down, its right
    hand, whose contact slot carries dof 32, in the floor."""
    from torch_port_helpers import h1_floor_states

    return _inputs_from(h1_floor_states, model, B, seed, device, row=4, n_min=10)


def pair_kinds_inputs(model, B, seed, device):
    """Inputs on the fused pair-kinds scene (tests/assets/pairs/
    mjx_scene_pair_kinds_fused.xml): the robot near home, the ball and the
    sticks in the floor (tests/torch_port_helpers.py:pair_kinds_states; the
    second stick, whose dof masks take a second word, in two thirds of the
    samples).  At B=1: a sample with both sticks in the floor."""
    from torch_port_helpers import pair_kinds_states

    return _inputs_from(pair_kinds_states, model, B, seed, device, row=0, n_min=10)


def go2_at_crate(qpos):
    qpos[0] = CRATE_FACE_X


def h1_at_crate(qpos):
    from torch_port_helpers import H1_CRATE_AT_HANDS

    qpos[26] = H1_CRATE_AT_HANDS


class SmokePath(NamedTuple):
    task: str
    # the model its kernel is built for: the task's own scene (a name of
    # the scene table), or an MJCF file by its path in the repository, which
    # the task then runs (get_env(task, scene=<path>))
    scene: str
    width: tuple  # its full width (Nsample, Hsample, Hnode, n_substeps)
    inputs: Callable  # (model, B, seed, device) -> kernel inputs for the compare
    at_crate: Optional[Callable]  # moves the reset qpos to the crate, in place
    big_batch: Optional[int]  # a larger batch the kernel is also timed at
    # [small]'s reverse_once against the plain chain and the profile
    # windows; else neither
    full: bool = True

    @property
    def by_path(self) -> bool:
        return "/" in self.scene

    @property
    def scene_kw(self) -> dict:
        """get_env's scene override: the file's absolute path, or none."""
        return {"scene": str(ROOT / self.scene)} if self.by_path else {}

    @property
    def tag(self) -> str:
        """The build's name in the lines and the kernels' record."""
        return Path(self.scene).stem.replace("mjx_scene_", "") if self.by_path else self.scene

    @property
    def label(self) -> str:
        """The path's name: the task, and the scene where it is given by path."""
        return f"{self.task}[{self.tag}]" if self.by_path else self.task


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
    # the H1-2 joint layout (nv=33) through h1_walk: the right hand's
    # contact slot carries dof 32, so the kernel's dof masks take two words
    SmokePath("h1_walk", "tests/assets/unitree_h1/mjx_scene_h1_2_walk.xml", (2048, 32, 8, 8),
              h1_2_floor_inputs, None, None, full=False),
)
# a model that only the kernel runs, against its plain version and through
# a chain of FusedStep calls: its second stick's pattern rows reach bits
# 30-34 and its slots' dof masks bit 35
WIDE_PATTERN_SCENE = "tests/assets/pairs/mjx_scene_pair_kinds_fused.xml"
WIDE_PATTERN = SmokePath("fused_step", WIDE_PATTERN_SCENE, None, pair_kinds_inputs, None, None,
                         full=False)
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
          f"{info['blocks_per_sm']} blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor), "
          f"{lib.resident} samples a wave")
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
        if env.model.nv > 32:
            wide = fused.active_contacts_past(env.model, args[0], 32)
            print(f"[compare {tag}] B={B} nv={env.model.nv}: dof masks of 2 words; active "
                  f"contacts in slots that carry dof 32 or past it: {wide}")
            check(wide > 0, f"B={B}: no active contact uses the masks' second word, the "
                  f"compare proves nothing")
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


def fused_record(tag, launches, max_err, ms, plain_ms, bound, ops):
    """One fused_step build's entry in the kernels' JSON line."""
    return {
        "name": f"fused_step[{tag}]",
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
        "ms_b1": ms[1],
    }


def make_wide_pattern():
    """The fused pair-kinds model (nv=36, WIDE_PATTERN_SCENE) compiled by the
    port from its MJCF, and its FusedStep (8 substeps, the Go2 envs' reward
    inputs), as an object with the `model` and `fused_step` an env has."""
    from tpu_dialmpc_torch.dynamics import fused
    from tpu_dialmpc_torch.dynamics.fused_cuda import FusedStep
    from tpu_dialmpc_torch.dynamics.model import load_scene

    model = load_scene(str(ROOT / WIDE_PATTERN_SCENE)).with_options(timestep=0.0025)
    check(model.nv == 36 and fused.supported(model), "the wide-pattern model is not the "
          "fused pair-kinds scene")
    spec = fused.DerivedSpec(torso_body=model.body_names.index("base"))
    return SimpleNamespace(model=model, fused_step=FusedStep(model, N_SUBSTEPS, spec))


WIDE_CHAIN = 21  # FusedStep calls chained in [wide]'s run: a go2_stand horizon (H20 + 1)


def phase_wide_pattern(wide, device, all_envs):
    """[wide] The nv=36 build, which no env runs (the Go2 env's default pose
    is the robot's qpos alone): built, held against its plain version at
    B=2049 and B=1 with its time and bound, then driven through its entry
    point a user calls, FusedStep, as a rollout does: WIDE_CHAIN calls at
    B=2049 chained state to state (constant torques), every count set to 0
    just before, its launches read just after.  Returns its kernels' record."""
    import torch

    path, tag = WIDE_PATTERN, WIDE_PATTERN.tag
    fs = wide.fused_step
    phase_build(wide, device, tag)
    max_err, ms, plain_ms = phase_compare(wide, path, device, tag)
    ops, bound = phase_bound(wide, ms, tag)
    qpos, qvel, ws, ctrl = path.inputs(wide.model, 2049, 3, device)
    ctrl = 0.5 * ctrl
    for e in all_envs + [wide]:  # every count to 0 just before this run
        e.fused_step.launches = 0
    t0 = time.perf_counter()
    for _ in range(WIDE_CHAIN):
        qpos, qvel, ws, _ = fs(qpos, qvel, ws, ctrl)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    launches, others = fs.launches, [e.fused_step.launches for e in all_envs]
    finite = [bool(torch.isfinite(x).all()) for x in (qpos, qvel, ws)]
    print(f"[wide {tag}] {WIDE_CHAIN} chained FusedStep calls at B=2049, {N_SUBSTEPS} "
          f"substeps each: {wall:.1f} ms host wall; launches {launches} (expected "
          f"{WIDE_CHAIN}), other models' kernels {others}; final qpos, qvel, warmstart "
          f"finite: {finite}")
    check(launches == WIDE_CHAIN and not any(others), "[wide] the chain did not launch the "
          "nv=36 kernel as expected")
    check(all(finite), "[wide] the chained rollout is not finite")
    return dict(fused_record(tag, launches, max_err, ms, plain_ms, bound, ops),
                path=f"{WIDE_CHAIN} chained FusedStep calls at B=2049 (no env runs this model)")


# [env-kernels]: go2_stand at its benchmark cell's width (benchmark/configs/go2_stand.json)
ENV_KERNELS_WIDTH = dict(Nsample=2048, Hsample=25, Hnode=5, Ndiffuse=2)
ENV_KERNELS_STEPS = 3  # captured control steps whose launches are counted
ENV_KERNELS_REPEAT = 50  # calls captured in one graph to time one call
H100_HBM_BYTES = 3.35e12  # the H100 SXM's memory rate (NVIDIA's data sheet)


def env_kernel_bytes(env, B):
    """(go2_ctrl, go2_post_physics) bytes a call at B reads and writes, from
    the fields each reads and writes per sample (info broadcast: read once)."""
    m, s = env.model, env._dtype.itemsize
    ctrl = B * (m.nu if env.config.leg_control == "position" else 3 * m.nu) * s + B * m.nu * s
    per_sample_in = (m.nu + 4 * 3 + 3 + 4 + 6 + 3) * s  # joints, feet, torso, cvel, com
    info_in = (3 + 3 + 3 + 1 + 4) * s + 4 + 4 + 8  # targets, air time; step, contact, seed
    out = (1 + 3 + 3 + 4 + 4 + 4) * s + 1 + 4 + 4  # reward, targets, feet; done, step, contact
    return ctrl, B * (per_sample_in + out) + (info_in if B > 1 else B * info_in)


def _graph_ms(fn, device):
    """ms per call of `fn` captured ENV_KERNELS_REPEAT times in one CUDA
    graph (node gaps included, as the planner's graph runs it): the median
    of 7 replays timed by two events; returns (ms, graph)."""
    import torch

    fn()
    torch.cuda.synchronize()
    stream, graph = torch.cuda.Stream(device), torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(ENV_KERNELS_REPEAT):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(7):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        graph.replay()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / ENV_KERNELS_REPEAT)
    return statistics.median(times), graph


def _kernel_device_ms(graph, name):
    """Mean device ms of the kernel records named `name` in one replay of
    `graph` under the profiler (after a pre-roll of spin kernels, as
    `_profile_window`); None where the trace holds none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_dialmpc_torch.telemetry.profile import TRACE_SETTLE_S

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PREROLL_LAUNCHES):
            torch.cuda._sleep(PREROLL_CYCLES)
        torch.cuda.synchronize()
        graph.replay()
        torch.cuda.synchronize()
        time.sleep(TRACE_SETTLE_S)
    d = [e.duration_ns() for e in prof.profiler.kineto_results.events()
         if name in e.name() and not str(e.device_type()).endswith("CPU")]
    return 1e-6 * statistics.mean(d) if d else None


def _env_kernels_against_plain(env, tag, device):
    """go2_ctrl and go2_post_physics against `_ctrl_batch_plain` and
    `_post_physics_plain` on the same CUDA tensors, at B=2049 (the rollout:
    info broadcast with stride 0, the reward inputs views of one row block)
    and B=1 (the executed step): integers and bools equal, floats within
    REL_TOL of each output's scale.  Returns {kernel: max abs err}."""
    import torch

    from tpu_dialmpc_torch.envs.base import StateInfo

    from torch_port_helpers import go2_env_inputs

    worst = {"go2_ctrl": 0.0, "go2_post_physics": 0.0}
    for B in (2049, 1):
        args, info, action = go2_env_inputs(env, B, seed=B, broadcast_info=B > 1, device=device)
        check(B == 1 or info.pos_tar.stride(0) == 0, "the B=2049 info is not broadcast")
        got_c = env._ctrl_batch(action, args["qpos"], args["qvel"])
        want_c = env._ctrl_batch_plain(action, args["qpos"], args["qvel"])
        r1, d1, i1 = env._post_physics(**args, info=info, ctrl=got_c)
        r0, d0, i0 = env._post_physics_plain(**args, info=info)
        torch.cuda.synchronize()
        pairs = [("go2_ctrl", "ctrl", got_c, want_c), ("go2_post_physics", "reward", r1, r0),
                 ("go2_post_physics", "done", d1, d0)]
        pairs += [("go2_post_physics", f.name, getattr(i1, f.name), getattr(i0, f.name))
                  for f in dataclasses.fields(StateInfo)]
        line = []
        for kernel, name, g, w in pairs:
            check(g.shape == w.shape and g.dtype == w.dtype,
                  f"[env-kernels {tag}] B={B} {name}: {g.dtype}{tuple(g.shape)} != "
                  f"{w.dtype}{tuple(w.shape)}")
            if not w.is_floating_point():
                check(torch.equal(g, w), f"[env-kernels {tag}] B={B} {name}: not equal to the "
                      f"plain version's")
                continue
            err = (g - w).abs().max().item()
            tol = REL_TOL * max(1.0, w.abs().max().item())
            worst[kernel] = max(worst[kernel], err)
            line.append(f"{name} {err:.2e}")
            check(err <= tol, f"[env-kernels {tag}] B={B} {name}: max abs diff {err:.3e} over "
                  f"the tolerance {tol:.3e}")
        print(f"[env-kernels {tag}] B={B} kernels vs plain, max abs diff: {', '.join(line)}; "
              f"done, step, last_contact equal")
    return worst


def phase_env_kernels(go2_paths, device):
    """[env-kernels] The Go2 env step's two kernels (csrc/go2_env_step.cu):
    against their plain version on each Go2 path's env; their launches on
    go2_stand's captured control step at its benchmark cell's width, counted
    from 0; each kernel's and its plain version's time per call at B=2049
    and B=1 and its bound.  Returns the kernels' records."""
    import torch

    from tpu_dialmpc_torch.envs import dial_defaults
    from tpu_dialmpc_torch.envs.base import to_lean
    from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI
    from tpu_dialmpc_torch.planner.runner import make_control_step

    from torch_port_helpers import go2_env_inputs

    worst = {"go2_ctrl": 0.0, "go2_post_physics": 0.0}
    for path, env in go2_paths:
        for k, err in _env_kernels_against_plain(env, path.label, device).items():
            worst[k] = max(worst[k], err)
    env = next(env for path, env in go2_paths if path.task == "go2_stand")
    kernels = env._env_kernels

    # the main path: go2_stand's control step, captured, at the cell's width
    cfg = dataclasses.replace(DialConfig(**dial_defaults("go2_stand")), **ENV_KERNELS_WIDTH)
    mbdpi = MBDPI(cfg, env)
    check(mbdpi.captured, "[env-kernels] go2_stand did not capture on the card")
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    step = make_control_step(mbdpi, cfg.Ndiffuse)
    state = to_lean(env.reset())
    Y0 = torch.zeros((cfg.Hnode + 1, env.action_size), dtype=torch.float32, device=device)
    for _ in range(2):  # the unit's eager first call, then its capture and first replay
        state, Y0, _ = step(state, Y0, gen)
    torch.cuda.synchronize()
    kernels.ctrl_launches = kernels.post_physics_launches = env.fused_step.launches = 0
    for _ in range(ENV_KERNELS_STEPS):
        state, Y0, infos = step(state, Y0, gen)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(infos.rews).all()), "[env-kernels] non-finite rollout rewards")
    per_step = cfg.Ndiffuse * (cfg.Hsample + 1) + 1
    launches = {"go2_ctrl": kernels.ctrl_launches,
                "go2_post_physics": kernels.post_physics_launches}
    print(f"[env-kernels go2_stand] N{cfg.Nsample}/H{cfg.Hsample}/Hnode{cfg.Hnode}/Ndiffuse"
          f"{cfg.Ndiffuse}, {ENV_KERNELS_STEPS} captured control steps: launches {launches}, "
          f"fused {env.fused_step.launches} (expected {ENV_KERNELS_STEPS} x {per_step} = "
          f"{cfg.Ndiffuse} x (H{cfg.Hsample} + 1) + 1 each)")
    for n in list(launches.values()) + [env.fused_step.launches]:
        check(n == ENV_KERNELS_STEPS * per_step, "[env-kernels] the captured control step did "
              "not launch each env kernel once per env step")

    # time per call, as a graph runs it, and the bound
    records = {}
    for B in (2049, 1):
        args, info, action = go2_env_inputs(env, B, seed=B, broadcast_info=B > 1, device=device)
        q, qd = args["qpos"], args["qvel"]
        calls = {"go2_ctrl": (lambda: env._ctrl_batch(action, q, qd),
                              lambda: env._ctrl_batch_plain(action, q, qd)),
                 "go2_post_physics": (lambda: env._post_physics(**args, info=info, ctrl=None),
                                      lambda: env._post_physics_plain(**args, info=info))}
        for (name, (kernel, plain)), nbytes in zip(calls.items(), env_kernel_bytes(env, B)):
            ms, graph = _graph_ms(kernel, device)
            dev_ms = _kernel_device_ms(graph, name)
            library_ms, _ = _graph_ms(plain, device)  # the parent's path: the ops captured
            plain_ms = cuda_ms(plain, ENV_KERNELS_REPEAT)  # eager, each op launched by the host
            bound = nbytes / H100_HBM_BYTES * 1e3
            check(dev_ms is not None, f"[env-kernels] the trace holds no {name} record")
            print(f"[env-kernels go2_stand] {name} B={B}: {ms * 1e3:.2f} us per call in a graph "
                  f"(the kernel's own device time {dev_ms * 1e3:.2f} us); the plain PyTorch ops "
                  f"{library_ms * 1e3:.2f} us in a graph, {plain_ms * 1e3:.2f} us eager; bound "
                  f"{bound * 1e3:.4f} us ({nbytes} bytes at 3.35 TB/s), share {bound / ms:.5f}")
            suffix = "" if B > 1 else "_b1"
            records.setdefault(name, {}).update(
                {"ms" + suffix: ms, "plain_ms" + suffix: plain_ms, "bound_ms" + suffix: bound,
                 "library_ms" + suffix: library_ms, "device_ms" + suffix: dev_ms})
    return [dict({"name": name, "route": "cuda",
                  "source": "tpu_dialmpc_torch/csrc/go2_env_step.cu",
                  "replaces": None,  # the JAX package left these ops to XLA's fusion
                  "launches": launches[name], "max_abs_err": worst[name]},
                 **rec, bound_by="bytes", share=rec["bound_ms"] / rec["ms"],
                 path=f"go2_stand N2048/H25 captured control step x {ENV_KERNELS_STEPS}")
            for name, rec in records.items()]


MJCF_TIMESTEP = 0.0025  # the envs' timestep, as tests/assets/export_npz.py compiles at
MJCF_TOL = 1e-12  # rtol = atol for float fields, XML compile against the shipped .npz
MJCF_PATHS = ("go2_stand", "h1_push_crate")


def _hold_models(tag, want, got):
    """Every PhysicsModel field and pair table of `got` (compiled from XML
    here) held to `want` (the shipped .npz): integers, bools, names and
    tables exactly, floats to MJCF_TOL.  Returns (bit-equal float fields,
    the float fields that are not, the fields whose float32 values differ)."""
    import dataclasses

    import numpy as np

    bit, rest, f32 = [], [], []

    def hold(name, a, b):
        if isinstance(a, (np.ndarray, float)):
            a, b = np.asarray(a), np.asarray(b)
            check(a.shape == b.shape and a.dtype == b.dtype, f"[mjcf {tag}] {name}: shape or "
                  f"dtype {b.shape} {b.dtype} != {a.shape} {a.dtype}")
            if a.dtype.kind != "f":
                check(np.array_equal(a, b), f"[mjcf {tag}] {name} differs")
                return
            check(np.allclose(b, a, rtol=MJCF_TOL, atol=MJCF_TOL),
                  f"[mjcf {tag}] {name}: max abs diff {np.max(np.abs(a - b)):.3e}")
            (bit if np.array_equal(a, b) else rest).append(name)
            if not np.array_equal(a.astype(np.float32), b.astype(np.float32)):
                f32.append(name)
        else:
            check(a == b, f"[mjcf {tag}] {name}: {b!r} != {a!r}")

    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if f.name == "pairs":
            check(sorted(a) == sorted(b), f"[mjcf {tag}] pair kinds differ")
            for kind in a:
                for pf in dataclasses.fields(a[kind]):
                    hold(f"pairs{kind}.{pf.name}", getattr(a[kind], pf.name),
                         getattr(b[kind], pf.name))
        elif f.name == "key_qpos":
            check(list(a) == list(b), f"[mjcf {tag}] keyframes differ")
            for k in a:
                hold(f"key_qpos[{k}]", a[k], b[k])
        else:
            hold(f.name, a, b)
    return bit, rest, f32


def phase_mjcf(envs, device, all_envs):
    """[mjcf] The port's MJCF compiler (dynamics/mjcf.py, no mujoco) on the
    card's host: the seven stand-in scenes compiled from tests/assets and
    held to the shipped .npz files; each kernel model's packed constants and
    build key from an env built from XML against the .npz env's; then
    go2_stand and h1_push_crate built from their XML at full width: one
    reverse_once under injected noise and one control step through the fused
    kernel, each against the same call on the .npz env (bit-equal where the
    build key is equal, else within REL_TOL), the XML envs' fused launches
    checked.  Returns {task: launches} for the kernels' line."""
    import os

    import torch

    from tpu_dialmpc_torch.dynamics import assets, fused_cuda, mjcf
    from tpu_dialmpc_torch.dynamics.model import ASSETS, SCENES, compile_model, load_model
    from tpu_dialmpc_torch.envs import get_env
    from tpu_dialmpc_torch.envs.base import to_lean
    from tpu_dialmpc_torch.planner.dial import MBDPI
    from tpu_dialmpc_torch.planner.runner import make_control_step

    check("mujoco" not in sys.modules, "[mjcf] mujoco is imported")
    standins = ROOT / "tests" / "assets"
    for scene in SCENES:
        t0 = time.perf_counter()
        got = compile_model(mjcf.load(standins / assets.SCENES[scene]))
        ms = (time.perf_counter() - t0) * 1e3
        got = got.with_options(timestep=MJCF_TIMESTEP)
        bit, rest, f32 = _hold_models(scene, load_model(str(ASSETS / SCENES[scene])), got)
        print(f"[mjcf {scene}] compiled from {assets.SCENES[scene]} in {ms:.1f} ms (host); "
              f"equals the shipped .npz: {len(bit)} float fields bit-equal, "
              f"{len(rest)} within {MJCF_TOL:g} {rest}; float32 values differ in "
              f"{f32 or 'no field'}")

    key_equal = {}
    xml_envs = {}
    old = os.environ.get("TPU_DIALMPC_ASSETS")
    os.environ["TPU_DIALMPC_ASSETS"] = str(standins)
    try:
        for path, env, cfg in envs:
            xml_env = get_env(path.task, device=device, **path.scene_kw)
            check(xml_env.model is not env.model and xml_env.config == env.config,
                  f"[mjcf {path.label}] the XML env is not a fresh env of the same config")
            packed = [fused_cuda.pack_model(e.model, e.fused_step.meta, e.fused_step.spec)
                      for e in (env, xml_env)]
            (_, blob0, tab0), (_, blob1, tab1) = packed
            key0, key1 = (hashlib.sha256(b + t).hexdigest() for _, b, t in packed)
            key_equal[path.label] = key0 == key1
            print(f"[mjcf {path.label}] XML env ({path.scene}): packed model "
                  f"{'equal' if blob0 == blob1 else 'DIFFERENT'} ({len(blob1)} bytes), tables "
                  f"{'equal' if tab0 == tab1 else 'DIFFERENT'}, build key {key1[:16]} "
                  f"{'equals' if key_equal[path.label] else 'differs from'} the "
                  f"{'first XML' if path.by_path else '.npz'} env's")
            if path.task in MJCF_PATHS:
                xml_envs[path.task] = xml_env
    finally:
        if old is None:
            del os.environ["TPU_DIALMPC_ASSETS"]
        else:
            os.environ["TPU_DIALMPC_ASSETS"] = old
    check("mujoco" not in sys.modules, "[mjcf] mujoco is imported")

    launches = {}
    for path, env, cfg in envs:
        if path.task not in MJCF_PATHS:
            continue
        xml_env, task = xml_envs[path.task], path.task
        noise = torch.randn((cfg.Nsample, cfg.Hnode + 1, env.action_size),
                            generator=torch.Generator(device=device).manual_seed(11),
                            device=device)
        outs, walls = [], []
        for e in (env, xml_env):
            mb = MBDPI(cfg, e)
            scale = torch.as_tensor(mb.sigma_control, dtype=torch.float32, device=device)
            Y = torch.zeros((cfg.Hnode + 1, e.action_size), dtype=torch.float32, device=device)
            state = to_lean(e.reset())
            step = make_control_step(mb, cfg.Ndiffuse)
            gen = torch.Generator(device=device).manual_seed(cfg.seed)
            for x in all_envs + [xml_env]:  # every count to 0 just before this run
                x.fused_step.launches = 0
            Yb, info = mb.reverse_once(state, None, Y, scale, noise=noise)
            s1, Y1, infos = step(state, Yb, gen)
            torch.cuda.synchronize()
            n = e.fused_step.launches
            others = [x.fused_step.launches for x in all_envs + [xml_env] if x is not e]
            # one reverse_once, then one control step (as from a resumed step 1)
            expected = (cfg.Hsample + 1) + expected_launches(cfg, 2, t0=1)
            check(n == expected and not any(others),
                  f"[mjcf {task}] fused launches {n} (expected {expected}), others {others}")
            if e is xml_env:
                launches[task] = n
            outs.append({"rews": info.rews, "Ybar": Yb, "step qpos": s1.pipeline.qpos,
                         "step qvel": s1.pipeline.qvel, "step Ybar": Y1,
                         "step rews": infos.rews})
            walls.append([])
            for fn in (lambda: mb.reverse_once(state, None, Y, scale, noise=noise),
                       lambda: step(state, Yb, gen)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                walls[-1].append((time.perf_counter() - t0) * 1e3)
        exact = key_equal[task]
        for name in outs[0]:
            a, b = outs[1][name], outs[0][name]
            check(bool(torch.isfinite(a).all()), f"[mjcf {task}] {name}: non-finite")
            err = (a - b).abs().max().item()
            tol = 0.0 if exact else REL_TOL * max(1.0, b.abs().max().item())
            print(f"[mjcf {task}] XML env vs .npz env, {name}: max abs diff {err:.3e} "
                  f"({'bit-equal required' if exact else f'tolerance {tol:.3e}'})")
            check(err <= tol, f"[mjcf {task}] {name}: the XML env differs from the .npz env")
        print(f"[mjcf {task}] N{cfg.Nsample}/H{cfg.Hsample}/Hnode{cfg.Hnode}/sub"
              f"{env.config.n_substeps}: reverse_once {walls[1][0]:.2f} ms (XML env) vs "
              f"{walls[0][0]:.2f} ms (.npz env), control step {walls[1][1]:.2f} vs "
              f"{walls[0][1]:.2f} ms (one more of each after the compared calls, host wall: "
              f"the call that captures each unit's CUDA graph and replays it); "
              f"XML env fused "
              f"launches {launches[task]} = {cfg.Hsample + 1} + (1 + {cfg.Ndiffuse}x"
              f"{cfg.Hsample + 1})")
    return launches


class _PlainSubsteps:
    """The plain substep chain where an env expects its FusedStep."""

    def __init__(self, fs):
        self.spec = fs.spec
        self.plain = fs.plain

    def __call__(self, *args):
        return self.plain(*args)


KIND_NAMES = {(0, 2): "plane-sphere", (0, 3): "plane-capsule", (0, 6): "plane-box",
              (2, 6): "sphere-box", (3, 6): "capsule-box", (6, 6): "box-box"}


def make_env(path, device):
    from tpu_dialmpc_torch.envs import dial_defaults, get_env
    from tpu_dialmpc_torch.planner.dial import DialConfig

    task = path.task
    env = get_env(task, device=device, **path.scene_kw)
    cfg = DialConfig(**dial_defaults(task))
    scene = path.scene_kw.get("scene", path.scene)
    check(env.config.scene == scene, f"{task} does not run on {scene}")
    check((cfg.Nsample, cfg.Hsample, cfg.Hnode, env.config.n_substeps) == path.width,
          f"{task} is not at the full planner width {path.width}")
    check(env.on_fused_path, f"{path.label} is not on the fused kernel's path")
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
    check(mbdpi.captured, f"{task}: MBDPI(capture='auto') did not capture on the card")
    print(f"[main {task}] N{cfg.Nsample}/H{cfg.Hsample}/Hnode{cfg.Hnode}/sub"
          f"{env.config.n_substeps} (captured={mbdpi.captured}): reset, reverse, {n_steps} "
          f"control steps; rewards "
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
    env, cfg = make_env(path, device)
    return path.label, small_against_plain(env, cfg, path, device)


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
    that precedes the synchronize are left out of every count.  The
    records of the last kernels can reach the profiler after the final
    synchronize (the tail of a window's last graph replay): the window
    waits `TRACE_SETTLE_S` before it stops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_dialmpc_torch.telemetry.profile import TRACE_SETTLE_S

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
        time.sleep(TRACE_SETTLE_S)
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


def _median_ms(fn, reps):
    """Median host wall ms of fn() over `reps` calls, each between two
    torch.cuda.synchronize(), after one warm-up call."""
    import torch

    fn()  # warm-up
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(out)


def _windows(tag, mbdpi, state, Y0, gen, step, device):
    """The profile windows over 3 `reverse_once` and 2 control steps of
    `mbdpi`: {unit: window}."""
    import torch

    scale = torch.as_tensor(mbdpi.sigma_control, dtype=torch.float32, device=device)
    out = {}
    for name, fn, n in (("reverse_once", lambda: mbdpi.reverse_once(state, gen, Y0, scale), 3),
                        ("control_step", lambda: step(state, Y0, gen), 2)):
        out[name] = _profile_window(fn, n, mbdpi.env.fused_step)
        print(f"[profile {tag}] {name}: {json.dumps(out[name])}")
    return out


def time_main_path(mbdpi, state, Y0, gen, step_rest, cfg, device, task, full):
    """Median wall ms of the main path's `reverse_once` and control step
    (captured: their CUDA graphs' replays), 5 timed repetitions, and on a
    full path the profile windows."""
    import torch

    scale = torch.as_tensor(mbdpi.sigma_control, dtype=torch.float32, device=device)
    reps = 5
    ro_ms = _median_ms(lambda: mbdpi.reverse_once(state, gen, Y0, scale), reps)
    cs_ms = _median_ms(lambda: step_rest(state, Y0, gen), reps)
    print(f"[time {task}] median ms per reverse_once: {ro_ms:.2f}; per control step "
          f"(step + shift + {cfg.Ndiffuse} reverse_once): {cs_ms:.2f} ({reps} timed; "
          f"captured={mbdpi.captured})")
    windows = _windows(task, mbdpi, state, Y0, gen, step_rest, device) if full else None
    return ro_ms, cs_ms, windows


# the paths whose eager units get profile windows beside the captured ones,
# and a [sync-debug] check
CAPTURE_WINDOWS = ("go2_stand", "h1_push_crate")
CAPTURE_CALLS = 3  # calls of each unit held captured against eager


def _leaves_named(prefix, obj):
    """[(name, tensor)] of a unit's output: dict items, dataclass and
    NamedTuple fields by name."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return [(prefix, obj)]
    if isinstance(obj, dict):
        return [x for k, v in obj.items() for x in _leaves_named(f"{prefix}.{k}", v)]
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj)
                for x in _leaves_named(f"{prefix}.{f.name}", getattr(obj, f.name))]
    if hasattr(obj, "_fields"):
        return [x for k, v in zip(obj._fields, obj) for x in _leaves_named(f"{prefix}.{k}", v)]
    return []


def _bits(t):
    """A tensor's bits (floats as integers, so NaN equals the same NaN)."""
    import torch

    if t.is_floating_point():
        return t.view({4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def _hold_unit(worst, unequal, got, want):
    """Fold one call's captured output `got` against the eager `want` into
    `worst` (max abs diff per field) and `unequal` (fields not bit-equal)."""
    import torch

    for (name, a), (_, b) in zip(_leaves_named("", got), _leaves_named("", want)):
        name = name.lstrip(".")
        if a.shape != b.shape or a.dtype != b.dtype:
            unequal.add(name)
            continue
        d = ((a != b).sum().item() if a.dtype == torch.bool
             else (a.double() - b.double()).abs().max().item() if a.numel() else 0.0)
        worst[name] = max(worst.get(name, 0.0), d)
        if not torch.equal(_bits(a), _bits(b)):
            unequal.add(name)


def phase_capture(path, env, cfg, mbc, state, Y0, device, captured_ms):
    """[capture]: the main path's planner (captured, its units already
    replaying) against `MBDPI(capture=False)` on the same state, plan and
    generator seed: CAPTURE_CALLS `reverse_once` calls and as many chained
    control steps, every output field's max abs diff and bit-equality, the
    launches per replay, the generators' states after, and the eager units'
    median ms beside the captured ones; on CAPTURE_WINDOWS the eager units'
    profile windows and [sync-debug]: a warm eager and a captured
    `reverse_once` and control step under
    torch.cuda.set_sync_debug_mode("error").  Returns the eager ms and
    windows."""
    import torch

    from tpu_dialmpc_torch.planner.dial import MBDPI
    from tpu_dialmpc_torch.planner.runner import make_control_step

    task, fs = path.label, env.fused_step
    check(mbc.captured, f"{task}: the main path's planner does not capture")
    mbe = MBDPI(cfg, env, capture=False)
    scale = torch.as_tensor(mbc.sigma_control, dtype=torch.float32, device=device)
    steps = (make_control_step(mbc, cfg.Ndiffuse), make_control_step(mbe, cfg.Ndiffuse))
    gens = [torch.Generator(device=device).manual_seed(cfg.seed + 100) for _ in range(2)]
    horizon = cfg.Hsample + 1
    expect = {"reverse_once": horizon, "control step": 1 + cfg.Ndiffuse * horizon}
    per_replay = {}
    for unit in expect:
        worst, unequal = {}, set()
        chain = [(state, Y0), (state, Y0)]  # the control steps' (state, plan), per mode
        for _ in range(CAPTURE_CALLS):
            outs = []
            for k, mb in enumerate((mbc, mbe)):
                n0 = fs.launches
                if unit == "reverse_once":
                    outs.append(mb.reverse_once(state, gens[k], Y0, scale))
                else:
                    s2, Y2, infos = steps[k](*chain[k], gens[k])
                    chain[k] = (s2, Y2)
                    outs.append({"state": s2, "Ybar": Y2, "infos": infos})
                if k == 0:
                    per_replay[unit] = fs.launches - n0
            if unit == "reverse_once":
                outs = [{"Ybar": Y, "info": info} for Y, info in outs]
            _hold_unit(worst, unequal, outs[0], outs[1])
        print(f"[capture {task}] {unit} x{CAPTURE_CALLS}, captured (graph replays) vs "
              f"capture=False, same state, plan and generator seed: max abs diff "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
        check(not unequal, f"{task}: the captured {unit} is not bit-equal to the eager one in "
                           f"{sorted(unequal)}")
    same_gen = torch.equal(gens[0].get_state(), gens[1].get_state())
    print(f"[capture {task}] bit-equal; launches per replay: "
          + ", ".join(f"{u} {per_replay[u]} (expected {n})" for u, n in expect.items())
          + f"; generators' states after: {'equal' if same_gen else 'DIFFERENT'}")
    check(per_replay == expect, f"{task}: a replay did not add its captured launches")
    check(same_gen, f"{task}: the captured units drew the noise otherwise than the eager ones")
    print_graphs(f"[capture {task}]", mbc)

    gen = gens[1]
    eager_ms = (_median_ms(lambda: mbe.reverse_once(state, gen, Y0, scale), 3),
                _median_ms(lambda: steps[1](state, Y0, gen), 3))
    print(f"[capture {task}] median ms (host wall around torch.cuda.synchronize): "
          f"reverse_once captured {captured_ms[0]:.2f} / eager {eager_ms[0]:.2f} "
          f"({eager_ms[0] / captured_ms[0]:.2f}x), control step captured {captured_ms[1]:.2f} / "
          f"eager {eager_ms[1]:.2f} ({eager_ms[1] / captured_ms[1]:.2f}x)")
    windows = None
    if path.task in CAPTURE_WINDOWS and not path.by_path:
        windows = _windows(f"{task} eager", mbe, state, Y0, gen, steps[1], device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for mb, step in ((mbe, steps[1]), (mbc, steps[0])):
                mb.reverse_once(state, gen, Y0, scale)
                step(state, Y0, gen)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        print(f"[sync-debug {task}] a warm eager and a captured reverse_once and control step "
              f"under torch.cuda.set_sync_debug_mode('error'): no synchronising call")
    return eager_ms, windows


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


XLA_CALLS = 3  # reverse_once calls held captured against eager on the pipeline path
XLA_STEPS = 2  # chained control steps, the same
XLA_WINDOW = 2  # replays of the B=2049 env-step graph in its profile window


def graph_nodes(cuda_graph) -> int:
    """The nodes of a kept `torch.cuda.CUDAGraph` (`keep_graph=True`, as
    `capture.CudaGraph` makes them), from libcuda's cuGraphGetNodes."""
    import ctypes

    fn = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    n = ctypes.c_size_t(0)
    rc = fn(ctypes.c_void_p(cuda_graph.raw_cuda_graph()), None, ctypes.byref(n))
    check(rc == 0, f"cuGraphGetNodes returned {rc}")
    return n.value


def print_graphs(tag, mbdpi):
    """One line per captured unit of `mbdpi`: nodes, capture and instantiate
    seconds; returns {unit: nodes}."""
    nodes = {}
    for name, unit in mbdpi.graphs.units.items():
        g = unit.graph
        if g.capture_s is None:
            continue
        nodes[name] = graph_nodes(g.graph)
        print(f"{tag} graph of {name}: {nodes[name]} nodes, capture {g.capture_s:.3f} s, "
              f"instantiate {g.instantiate_s:.3f} s; {unit.calls} calls")
    return nodes


def phase_xla_path(fused_env, device, all_envs):
    """go2_stand with fused="off" at full width (Nsample=2048, Hsample=20,
    Hnode=5, 8 substeps) through get_env, MBDPI and make_control_step.  The
    planner captures (`MBDPI(capture="auto")` on the card): each env step is
    a replay of its CUDA graph, B=2049 for the env's horizon step and B=1
    for the executed step, `step_lean` (`planner/capture.py`).
    - reset, one reverse_once with injected noise (its first two horizon
      steps build the B=2049 graph: an eager call, then the capture); two
      chained control steps (the B=1 graph's eager call and capture),
      executed by step_lean;
    - XLA_CALLS reverse_once and XLA_STEPS chained control steps, every one
      a replay, against `MBDPI(capture=False)` on the same state, plan and
      generator seed: every output field bit-equal, the generators alike
      after, the captured calls under torch.cuda.set_sync_debug_mode("error");
      median ms of both; no fused launch in all this;
    - the first reverse_once's rewards (2049, 21) and Ybar held against the
      fused path's on the same noise and state;
    - the graphs' nodes, capture and instantiate seconds, a profile window
      over XLA_WINDOW replays of the B=2049 graph (device busy and idle),
      and the phase's peak memory (torch.cuda.max_memory_allocated).
    The 10-iteration warm start (`reverse`, Ndiffuse_init=10) is skipped:
    ten more eager reverse_once of several seconds each would not fit the
    script's time limit, and it adds no code path.  Returns the median ms
    (reverse_once captured, control step captured, reverse_once eager,
    control step eager)."""
    import torch

    from tpu_dialmpc_torch.envs import dial_defaults, get_env
    from tpu_dialmpc_torch.envs.base import LeanEnvState, to_lean
    from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI
    from tpu_dialmpc_torch.planner.runner import make_control_step

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()  # what earlier phases still hold
    env = get_env("go2_stand", device=device, fused="off")
    cfg = DialConfig(**dial_defaults("go2_stand"))
    check((cfg.Nsample, cfg.Hsample, cfg.Hnode, env.config.n_substeps) == (2048, 20, 5, 8),
          "go2_stand is not at its full width")
    check(not env.on_fused_path, "fused='off' did not pick the physics pipeline")
    for e in all_envs:  # every count to 0 just before this path
        e.fused_step.launches = 0
    mb, mbe, fmb = MBDPI(cfg, env), MBDPI(cfg, env, capture=False), MBDPI(cfg, fused_env)
    check(mb.captured and not mb.graphs.whole,
          "MBDPI(capture='auto') does not capture the env steps on the physics pipeline")
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

    first_ms, (all_Y0s, rewss, Ybar) = timed(reverse_once)
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    step = make_control_step(mb, cfg.Ndiffuse)
    build_ms, s2 = [], (state, Ybar)
    for _ in range(2):  # the B=1 graph: its eager call, then its capture
        ms, out = timed(lambda: step(*s2, gen))
        build_ms.append(ms)
        s2 = out[:2]
    state2, Y2 = s2
    check(bool(torch.isfinite(Y2).all()) and isinstance(state2, LeanEnvState),
          "the control step did not execute through step_lean")

    # captured (every call a replay) against eager, call for call
    gens = [torch.Generator(device=device).manual_seed(cfg.seed + 100) for _ in range(2)]
    steps = (step, make_control_step(mbe, cfg.Ndiffuse))
    ms = {("reverse_once", k): [] for k in range(2)}
    ms.update({("control step", k): [] for k in range(2)})
    for unit, n in (("reverse_once", XLA_CALLS), ("control step", XLA_STEPS)):
        worst, unequal = {}, set()
        chain = [(state, Ybar), (state, Ybar)]
        for _ in range(n):
            outs = []
            for k, planner in enumerate((mb, mbe)):
                if unit == "reverse_once":
                    fn = lambda: planner.reverse_once(state, gens[k], Ybar, scale)  # noqa: E731
                else:
                    fn = lambda: steps[k](*chain[k], gens[k])  # noqa: E731
                torch.cuda.synchronize()
                if k == 0:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    t = time.perf_counter()
                    out = fn()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                torch.cuda.synchronize()
                ms[(unit, k)].append((time.perf_counter() - t) * 1e3)
                if unit == "reverse_once":
                    outs.append({"Ybar": out[0], "info": out[1]})
                else:
                    chain[k] = out[:2]
                    outs.append({"state": out[0], "Ybar": out[1], "infos": out[2]})
            _hold_unit(worst, unequal, outs[0], outs[1])
        print(f"[xla-path go2_stand] {unit} x{n}, captured (env-step graph replays) vs "
              f"capture=False, same state, plan and generator seed: max abs diff "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
        check(not unequal, f"the pipeline path's captured {unit} is not bit-equal to the eager "
                           f"one in {sorted(unequal)}")
    same_gen = torch.equal(gens[0].get_state(), gens[1].get_state())
    check(same_gen, "the pipeline path's captured units drew the noise otherwise than the eager")
    launched = [e.fused_step.launches for e in all_envs]
    check(env._fused_step is None and not any(launched),
          f"the fused='off' path launched the fused kernel: {launched}")

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

    med_ms = {key: statistics.median(v) for key, v in ms.items()}
    nodes = print_graphs("[xla-path go2_stand]", mb)
    check(sorted(nodes) == ["execute", "horizon step"],
          f"the pipeline path captured {sorted(nodes)}, not the env step at B=2049 and B=1")
    # where a replay's time goes: the B=2049 graph on its current inputs,
    # against [physics no-syncs]' eager pipeline.step
    unit = mb.graphs.units["horizon step"]
    window = _profile_window(lambda: unit(unit.static), XLA_WINDOW, SimpleNamespace(launches=0))
    print(f"[profile xla-path go2_stand] horizon step (B=2049) x{XLA_WINDOW}, graph replays: "
          f"{json.dumps(window)}")
    check(window["stream_syncs"] == 0, "a pipeline graph's replay synchronised with the host")
    peak = torch.cuda.max_memory_allocated()
    wall = time.perf_counter() - t0
    print(f"[xla-path go2_stand] bit-equal, generators alike, no synchronising call in a "
          f"captured unit under set_sync_debug_mode('error'); N{cfg.Nsample}/H{cfg.Hsample}/"
          f"Hnode{cfg.Hnode}/sub{env.config.n_substeps} on the physics pipeline, median ms: "
          f"reverse_once captured {med_ms[('reverse_once', 0)]:.1f} / eager "
          f"{med_ms[('reverse_once', 1)]:.1f}, control step (step_lean + shift + {cfg.Ndiffuse} "
          f"reverse_once) captured {med_ms[('control step', 0)]:.1f} / eager "
          f"{med_ms[('control step', 1)]:.1f}; the graphs' first calls: reverse_once "
          f"{first_ms:.1f} ms (B=2049: eager call, capture), control steps "
          f"{build_ms[0]:.1f} / {build_ms[1]:.1f} ms (B=1: eager call, capture); reward after "
          f"the step {state2.reward.item():.5f}; peak memory allocated {peak / 2**30:.2f} GiB, "
          f"{(peak - held) / 2**30:.2f} GiB above what the phase started with; path wall "
          f"{wall:.1f} s")
    return (med_ms[("reverse_once", 0)], med_ms[("control step", 0)],
            med_ms[("reverse_once", 1)], med_ms[("control step", 1)])


def phase_compat(device):
    """compat_q1 (reference quirk Q1) at Nsample=8, Hsample=4: the candidates
    chained one after another through env.step, on the card in float32
    (captured: each env.step a replay of its B=1 CUDA graph) against the CPU
    in float64.  The path is sequential over candidates by design (a parity
    fixture, not for production): at full width it would be 2049 x 21
    sequential env.steps, so it runs small here."""
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
        check(mb.captured == (dev == device), f"compat_q1 on {dev}: captured={mb.captured}")
        t0 = time.perf_counter()
        Y = torch.zeros((cfg.Hnode + 1, 12), dtype=env._dtype, device=dev)
        scale = torch.as_tensor(mb.sigma_control, dtype=env._dtype, device=dev)
        res = mb.reverse_once_compat(env.reset(), None, Y, scale, noise=noise.to(dev, env._dtype))
        out.append((res, time.perf_counter() - t0))
        if mb.captured:
            nodes = print_graphs("[xla-path compat_q1]", mb)
            check(list(nodes) == ["compat env.step"], f"compat_q1 captured {list(nodes)}")
    ((Y32, i32, p32), s32), ((Y64, i64, p64), s64) = out
    drew = (i32.rews.double().cpu() - i64.rews).abs().max().item()
    dq = (p32[0].double().cpu() - p64[0]).abs().max().item()
    dY = (Y32.double().cpu() - Y64).abs().max().item()
    print(f"[xla-path compat_q1] N{cfg.Nsample}/H{cfg.Hsample}, {cfg.Nsample + 1} candidates x "
          f"{cfg.Hsample + 1} chained env.steps: card {s32:.1f} s (captured), CPU float64 "
          f"{s64:.1f} s; "
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
    # eager: the hook below reads every _post_physics call, which a CUDA
    # graph's replay does not run
    mb = MBDPI(cfg, env, capture=False)
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


SHARD_OVER_MBDPI = 1.10  # one captured NCCL rank's ms over the captured MBDPI's, at most


def _hold_sharded(tag, outs, horizon):
    """Every rank against the single-device planner, the ranks against each
    other to the bit, each rank's launches per reverse_once, and a captured
    planner against the eager sharded one to the bit, with the same bytes
    all-reduced per call."""
    import numpy as np
    from torch_shard_ranks import SHARD_HOWS

    for how in SHARD_HOWS:
        for rank, out in enumerate(outs):
            o = out[how]
            dy = float(np.abs(o["Ybar"] - o["single_Ybar"]).max())
            dw = float(np.abs(o["weights"] - o["single_weights"]).max() / o["single_weights"].max())
            print(f"[{tag}] rank {rank} ({out['backend']}, samples {out['block'][0]}-"
                  f"{out['block'][1] - 1} + the anchor, captured={out['captured']}) {how}: Ybar "
                  f"max abs diff from MBDPI {dy:.3e}, weights {dw:.3e} of the largest (tolerance "
                  f"{SHARD_TOL:.0e}); fused launches {o['launches']} (expected {horizon}); "
                  f"{o['reduced_bytes']} bytes all-reduced")
            check(bool(np.isfinite(o["Ybar"]).all()), f"{tag}: non-finite Ybar")
            check(dy <= SHARD_TOL and dw <= SHARD_TOL, f"{tag}: the sharded planner disagrees "
                  "with MBDPI")
            check(o["launches"] == horizon, f"{tag}: a rank did not launch the kernel once per "
                  "horizon step")
            if out["captured"]:
                same = (np.array_equal(o["Ybar"], o["eager_Ybar"])
                        and np.array_equal(o["weights"], o["eager_weights"]))
                print(f"[{tag}] rank {rank} {how}: captured vs capture=False Ybar and weights "
                      f"equal to the bit: {same}; bytes all-reduced {o['reduced_bytes']} / "
                      f"{o['eager_reduced_bytes']}")
                check(same, f"{tag}: the captured sharded planner disagrees with the eager one")
                check(o["reduced_bytes"] == o["eager_reduced_bytes"] > 0,
                      f"{tag}: a replay did not add the bytes its capture all-reduced")
        if len(outs) > 1:
            same = all(np.array_equal(out[how]["Ybar"], outs[0][how]["Ybar"])
                       and np.array_equal(out[how]["weights"], outs[0][how]["weights"])
                       for out in outs)
            print(f"[{tag}] {how}: the ranks' Ybar and weights equal to the bit: {same}")
            check(same, f"{tag}: the ranks disagree")


def phase_shard():
    """go2_stand at full width through ShardedMBDPI: one rank of NCCL, then
    two gloo ranks sharing the card (NCCL refuses two ranks on one device),
    each rank a spawned process.  The NCCL rank's planner captures its
    reverse_once, all-reduces inside the graph (`MBDPI(capture="auto")`
    rules, planner/capture.py), and is held to the bit against the eager
    sharded planner; gloo's all-reduces are host round trips, so those
    ranks run eagerly.  Timed in turns: on one rank against the eager
    sharded planner and MBDPI (captured), at most SHARD_OVER_MBDPI times
    MBDPI's ms; on two against MBDPI at each rank's block size (the same
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
        check(all(o["backend"] == backend for o in outs), f"{tag}: the group is not {backend}")
        check(all(o["captured"] == (backend == "nccl") for o in outs),
              f"{tag}: ShardedMBDPI(capture='auto') did not capture on NCCL alone")
        if backend == "gloo":
            print(f"[{tag}] eager, as capture='auto' rules on a gloo group: its all-reduces "
                  "are host round trips, which a CUDA graph cannot hold")
        _hold_sharded(tag, outs, horizon)
        for rank, o in enumerate(outs):
            calls = ", ".join(f"{k} x{c} ({ms:.2f} ms host)" for k, (c, ms) in
                              sorted(o["host_calls"].items()))
            print(f"[{tag}] rank {rank}: median ms per reverse_once (7 calls in turns): "
                  f"{json.dumps({k: round(v, 2) for k, v in o['ms'].items()})}; one sharded "
                  f"call's {calls}")
            # captured, the all-reduces are in the graph the call launched:
            # the eager sharded planner's call makes them from the host
            check(o.get("eager_host_calls", o["host_calls"]).get("c10d::allreduce_", (0,))[0] > 0,
                  f"{tag}: the sharded call made no all-reduce")
            if o["captured"]:
                print(f"[{tag}] rank {rank}: one eager sharded call's " + ", ".join(
                    f"{k} x{c} ({ms:.2f} ms host)"
                    for k, (c, ms) in sorted(o["eager_host_calls"].items())))
                check(o["host_calls"].get("cudaGraphLaunch", (0,))[0] == 1
                      and "c10d::allreduce_" not in o["host_calls"],
                      f"{tag}: the captured sharded call did not replay one graph")
        if backend == "nccl":
            ratio = outs[0]["ms"]["sharded"] / outs[0]["ms"]["single"]
            print(f"[{tag}] the captured sharded reverse_once over the captured MBDPI's: "
                  f"{ratio:.3f}x (limit {SHARD_OVER_MBDPI:.2f}x); eager sharded "
                  f"{outs[0]['ms']['eager'] / outs[0]['ms']['single']:.3f}x")
            check(ratio <= SHARD_OVER_MBDPI,
                  f"{tag}: one NCCL rank costs {ratio:.3f}x the captured MBDPI")
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
        envs = [(path,) + make_env(path, device) for path in PATHS]
        all_envs = [env for _, env, _ in envs]
        from tpu_dialmpc_torch.envs import get_env

        wide = make_wide_pattern()
        # the [quality] phase's go2_jump: the crate scene with the crate at
        # x=30, another build of the crate model
        phase_build_all(all_envs + [wide, get_env("go2_jump", device=device)])
        for path, env, cfg in envs:
            t0 = time.perf_counter()
            task, scene = path.label, path.tag
            phase_build(env, device, scene)
            max_err, ms, plain_ms = phase_compare(env, path, device, scene)
            ops, bound = phase_bound(env, ms, scene)
            mbdpi, state, Y0, gen, step_rest, launches = run_main_path(
                env, cfg, device, task, all_envs + [wide])
            ro_ms, cs_ms, windows = time_main_path(mbdpi, state, Y0, gen, step_rest, cfg,
                                                   device, task, path.full)
            eager_ms, eager_windows = phase_capture(path, env, cfg, mbdpi, state, Y0, device,
                                                    (ro_ms, cs_ms))
            print(f"[time {task}] path wall {time.perf_counter() - t0:.1f} s")
            summary.append(f"{task} reverse_once {ro_ms:.2f} ms captured / {eager_ms[0]:.2f} "
                           f"eager, control step {cs_ms:.2f} / {eager_ms[1]:.2f} ms, "
                           f"fused_step[{scene}] {ms[2049]:.3f} ms vs plain {plain_ms:.1f} ms, "
                           f"bound {bound:.4f} ms")
            if eager_windows:
                summary.append(f"{task} device idle: reverse_once captured "
                               f"{windows['reverse_once']['idle_share']:.3f} / eager "
                               f"{eager_windows['reverse_once']['idle_share']:.3f}, control step "
                               f"{windows['control_step']['idle_share']:.3f} / "
                               f"{eager_windows['control_step']['idle_share']:.3f}")
            if task == CLI_TASK:
                t0 = time.perf_counter()
                loop_s, scan_s = phase_cli(cfg)
                phase_diag(env, cfg, device)
                print(f"[time cli] phase wall {time.perf_counter() - t0:.1f} s")
                summary.append(f"cli run 6 steps {loop_s:.2f} s, --scan {scan_s:.2f} s")
            records.append(fused_record(scene, launches, max_err, ms, plain_ms, bound, ops))
            records[-1]["main_path_ms"] = {"reverse_once": ro_ms, "control_step": cs_ms,
                                           "eager_reverse_once": eager_ms[0],
                                           "eager_control_step": eager_ms[1]}
        t0 = time.perf_counter()
        records.append(phase_wide_pattern(wide, device, all_envs))
        print(f"[time wide] phase wall {time.perf_counter() - t0:.1f} s")
        summary.append(f"fused_step[{WIDE_PATTERN.tag}] (nv={wide.model.nv}) "
                       f"{records[-1]['ms']:.3f} ms vs plain {records[-1]['plain_ms']:.1f} ms, "
                       f"bound {records[-1]['bound_ms']:.4f} ms")
        t0 = time.perf_counter()
        env_records = phase_env_kernels(
            [(path, env) for path, env, _ in envs if path.task.startswith("go2_")], device)
        records += env_records
        print(f"[time env-kernels] phase wall {time.perf_counter() - t0:.1f} s")
        summary.append("; ".join(
            f"{r['name']} {r['ms'] * 1e3:.2f} us in a graph (plain ops {r['library_ms'] * 1e3:.2f} "
            f"us), {r['launches']} launches in {ENV_KERNELS_STEPS} control steps"
            for r in env_records))
        t0 = time.perf_counter()
        mjcf_launches = phase_mjcf(envs, device, all_envs)
        print(f"[time mjcf] phase wall {time.perf_counter() - t0:.1f} s")
        for record, (path, _, _) in zip(records, envs):
            if path.task in mjcf_launches:
                record["mjcf_launches"] = mjcf_launches[path.task]
        summary.append("built from MJCF by the port (no mujoco), fused launches: " + ", ".join(
            f"{task} {n}" for task, n in mjcf_launches.items()))
        t0 = time.perf_counter()
        by_scene = {path.scene: (path, env) for path, env, _ in envs}
        physics_ms = {}
        for scene, what in PHYSICS_MODELS:
            path, env = by_scene[scene]
            physics_ms[scene] = phase_physics(env, path.inputs, device, what)
        phase_pair_kinds(device)
        per_substep = phase_no_syncs(by_scene["go2_force"][1], device)
        xla_ms = phase_xla_path(by_scene["go2_force"][1], device, all_envs)
        phase_compat(device)
        drift = phase_cli_physics()
        print(f"[time physics] the physics pipeline's phases: wall {time.perf_counter() - t0:.1f} s")
        summary.append("physics pipeline, 8 substeps at B=2049: " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in physics_ms.items())
            + f", {per_substep:.0f} kernels per substep; go2_stand fused='off' reverse_once "
            f"{xla_ms[0]:.1f} ms captured / {xla_ms[2]:.1f} eager, control step {xla_ms[1]:.1f} / "
            f"{xla_ms[3]:.1f} ms; replay drift {drift:.3e}")
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
            f"go2_stand sharded reverse_once: 1 NCCL rank {nccl_ms['sharded']:.2f} ms captured, "
            f"{nccl_ms['eager']:.2f} eager (MBDPI {nccl_ms['single']:.2f} ms), 2 gloo ranks on the card {gloo_ms['sharded']:.2f} ms "
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
