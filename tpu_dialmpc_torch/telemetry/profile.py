"""Profiling and roofline analysis of the DIAL-MPC hot path, on the card.

Counterpart of `tpu_dialmpc/telemetry/profile.py`, with its functions and
their keys:

- `phase_timings`: ms per phase of one annealing iteration (sample +
  spline, rollout, score + update), read from the tracer's device spans
  (`telemetry/spans.py`) in a captured `reverse_once` on the card (the host
  clock on the CPU);
- `fused_kernel_roofline`: the fused substep kernel's operation count
  (`fused.count_ops`, the plain substep's arithmetic) against the measured
  time of the rollouts that launch it: the achieved fraction of the card's
  roof;
- `fp32_peak_ops_per_sec` and `hbm_copy_bytes_per_sec`: the roof itself,
  measured on the card (the fp32 peak by a hand-written FMA-chain kernel,
  `csrc/fp32_peak.cu`; the memory rate by an in-place scale of 256 MiB);
- `capture_trace`: a `torch.profiler` trace (Chrome trace JSON).

The roofline's estimators are the JAX module's: the min over repetitions of
anything timed (interference on a shared host only adds time), the max over
calibration attempts of the roof, and the roof raised to a kernel's
observed rate if a quiet kernel window beats a noisy microbench window, so
the fraction stays at or below 1.  The roof is measured independently of the
kernel under test.  Operations are counted in one unit throughout: fp32
arithmetic operations per sample, an FMA as two (the unit `fused.count_ops`
counts, mul and add apart).

Everything timed here runs on a CUDA device: the microbenchmarks and the
roofline raise on the CPU rather than time anything else.
"""

from __future__ import annotations

import ctypes
import functools
import os
import statistics
import time
from typing import Dict

import torch

from tpu_dialmpc_torch.dynamics import _build, fused

# seconds a trace waits after its final synchronize before the profiler
# stops: the device records of the last kernels before the stop can reach
# the profiler late (seen on an H100 under CUDA graph replays: the tail of
# the window's last graph missing from the trace), and are lost if it stops
# first.  `tests/trace_tail_probe.py` measures the loss with and without it.
TRACE_SETTLE_S = 0.5

# the card's shape for the microbench: threads per block, blocks per SM,
# dependent FMA steps per accumulator
PEAK_THREADS = 256
PEAK_BLOCKS_PER_SM = 16
PEAK_STEPS = 4096


def _amortized(fn, args, r_lo=2, r_hi=18, reps=7, attempts=1, settle_s=0.0,
               return_attempts=False):
    """Per-call seconds of `fn` via chain-length slope.

    One chain of length r is r back-to-back Python calls of
    `fn(*args, acc)`, each returning the next accumulator, then one read of
    the accumulator (on a card: one synchronisation).  The slope between
    r_hi and r_lo removes that fixed cost and the chain's first launch.  It
    is host wall per call, on purpose: the rollouts are host-bound (the host
    issues the horizon loop's small ops), and wall is what a user feels.

    Min over `reps` at each chain length (interference only adds time);
    `attempts` repeats the whole slope, `settle_s` apart, and returns the
    min.  `return_attempts=True` also returns every attempt's slope, the
    run-to-run spread."""

    def chain(r):
        acc = 0.0
        for _ in range(r):
            acc = fn(*args, acc)
        return float(acc)

    def timed(r):
        chain(r)
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            chain(r)
            ts.append(time.perf_counter() - t0)
        return min(ts)

    slopes = []
    for i in range(max(1, attempts)):
        if i and settle_s:
            time.sleep(settle_s)
        slopes.append(max(timed(r_hi) - timed(r_lo), 1e-9) / (r_hi - r_lo))
    if return_attempts:
        return min(slopes), slopes
    return min(slopes)


def _amortized_raw(make, r_lo, r_hi, reps=5):
    """Chain-length slope of `make(r)`, which queues r steps and returns a
    tensor whose read waits for them."""

    def timed(r):
        float(make(r))
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(make(r))
            ts.append(time.perf_counter() - t0)
        return min(ts)

    return max(timed(r_hi) - timed(r_lo), 1e-12) / (r_hi - r_lo)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the fp32 and memory microbenchmarks measure a CUDA card; none is here")
    return torch.device("cuda", torch.cuda.current_device())


class FusedPathUnavailable(RuntimeError):
    """The roofline was asked for off the fused kernel (a CPU device, or a
    model the env runs on the physics pipeline)."""


class FmaChain:
    """The fp32 peak microbench (`csrc/fp32_peak.cu`): per element i,
    NACC accumulators x0[i] + j, each taken k times through
    acc = fma(acc, a[i], b[i]), summed in order into out[i].

    On CPU tensors it runs the plain version; on CUDA tensors it launches
    the kernel, or raises.  `launches` counts kernel launches and nothing
    else."""

    SOURCE = "fp32_peak.cu"
    NACC = 8  # FP_NACC in the source; the build checks it

    def __init__(self):
        self.launches = 0
        self._lib = None

    def plain(self, x0, a, b, k: int):
        """The same chain in PyTorch ops: each FMA as a float64 multiply-add
        of the float32 values, rounded once to float32 (the product of two
        floats is exact in float64; a rare tie rounds twice)."""
        acc = x0[:, None] + torch.arange(self.NACC, dtype=x0.dtype, device=x0.device)
        a64, b64 = a.double()[:, None], b.double()[:, None]
        for _ in range(k):
            acc = (acc.double() * a64 + b64).to(x0.dtype)
        out = acc[:, 0]
        for j in range(1, self.NACC):
            out = out + acc[:, j]
        return out

    def library(self):
        """The kernel's library, built from the checkout at first use."""
        if self._lib is None:
            path, _, _ = _build.build(self.SOURCE, {})
            lib = ctypes.CDLL(str(path))
            lib.fp32_peak_nacc.restype = ctypes.c_int
            lib.fp32_peak_nacc.argtypes = []
            lib.fp32_fma_chain_launch.restype = ctypes.c_int
            lib.fp32_fma_chain_launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 5
            if lib.fp32_peak_nacc() != self.NACC:
                raise RuntimeError(f"fp32_peak.cu has FP_NACC {lib.fp32_peak_nacc()}, the "
                                   f"wrapper {self.NACC}")
            self._lib = lib
        return self._lib

    def __call__(self, x0, a, b, k: int):
        if all(t.device.type == "cpu" for t in (x0, a, b)):
            return self.plain(x0, a, b, k)
        return self.launch(x0, a, b, k)

    def launch(self, x0, a, b, k: int):
        device = x0.device
        n = x0.shape[0]
        for name, t in (("x0", x0), ("a", a), ("b", b)):
            if t.device != device or device.type != "cuda":
                raise ValueError(f"{name}: expected a CUDA tensor on {device}, got {t.device}")
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
            if t.shape != (n,) or not t.is_contiguous():
                raise ValueError(f"{name}: expected a contiguous ({n},) tensor, "
                                 f"got {tuple(t.shape)}")
        lib = self.library()
        out = torch.empty(n, dtype=torch.float32, device=device)
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            err = lib.fp32_fma_chain_launch(n, int(k), PEAK_THREADS, x0.data_ptr(), a.data_ptr(),
                                            b.data_ptr(), out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"fp32_peak kernel launch failed: cudaGetLastError() = {err}")
        self.launches += 1
        return out

    def ops(self, n: int, k: int) -> float:
        """fp32 operations of one call: an FMA is two."""
        return 2.0 * self.NACC * k * n


FMA_CHAIN = FmaChain()


def fp32_peak_inputs(device, n=None):
    """The microbench's inputs on `device`: n elements (default: enough
    blocks to fill every SM PEAK_BLOCKS_PER_SM times), x0 in [0.5, 1.5],
    a = 1 + 2^-12 (so that every step moves the result) and b = 1e-3."""
    if n is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        n = sms * PEAK_BLOCKS_PER_SM * PEAK_THREADS
    x0 = torch.linspace(0.5, 1.5, n, dtype=torch.float32, device=device)
    a = torch.full((n,), 1.0 + 2.0**-12, dtype=torch.float32, device=device)
    b = torch.full((n,), 1e-3, dtype=torch.float32, device=device)
    return x0, a, b


@functools.lru_cache(maxsize=1)
def fp32_peak_ops_per_sec() -> float:
    """Measured fp32 peak of the card, in operations per second (an FMA is
    two): the FMA-chain kernel's rate, the slope between chains of 4 and
    64 launches, the faster of two calibration attempts (the roof is a
    capability lower bound, only raisable by evidence)."""
    device = _card()
    x0, a, b = fp32_peak_inputs(device)

    def make(r):
        out = None
        for _ in range(r):
            out = FMA_CHAIN.launch(x0, a, b, PEAK_STEPS)
        return out[0]

    sec = min(_amortized_raw(make, r_lo=4, r_hi=64) for _ in range(2))
    return FMA_CHAIN.ops(x0.shape[0], PEAK_STEPS) / sec


@functools.lru_cache(maxsize=1)
def hbm_copy_bytes_per_sec() -> float:
    """Measured streaming device-memory rate: a 256 MiB float32 tensor scaled
    in place r times (each step reads and writes it all), credited 2 x bytes
    per step.  256 MiB is far beyond the H100's 50 MB L2."""
    device = _card()
    n = 64 * 1024 * 1024  # 256 MiB of f32
    x = torch.ones(n, dtype=torch.float32, device=device)

    def make(r):
        for _ in range(r):
            x.mul_(1.0000001)
        return x[0]

    sec = _amortized_raw(make, r_lo=4, r_hi=64)
    return 2.0 * n * 4 / sec


def count_fused_ops(model, n_substeps: int = 1) -> Dict[str, float]:
    """The plain fused substep's op counts, per sample and substep:
    `arith_ops_per_substep` its arithmetic without the selects
    (`fused.count_ops(..., exclude=("where",))`, the JAX package's count of
    the same graph), `vector_ops_per_substep` every dispatched op but views."""
    spec = fused.DerivedSpec(torso_body=1)
    n_arith = fused.count_ops(model, spec, exclude=("where",))
    return {
        "vector_ops_per_substep": fused.count_ops(model, spec, arith_only=False),
        "arith_ops_per_substep": n_arith,
        "flops_per_sample_substep": float(n_arith),
        "n_substeps": n_substeps,
    }


def fused_kernel_roofline(task: str = "go2_stand", nsample: int = 2048,
                          n_substeps: int = 8, hsample: int = 20,
                          device: str = "cuda") -> Dict:
    """Measured fused-rollout throughput against the card's roof.

    Times `env.rollout_batch` of Nsample+1 clipped noisy control sequences,
    which launches the fused kernel once per horizon step, as wall per call
    (`_amortized`, 3 attempts 5 s apart).  Operations: the plain substep's
    arithmetic (`count_fused_ops`) x (hsample+1) x n_substeps x B, in fp32
    operations.  Bytes: what the kernel moves per launch, its inputs
    B x (nq + 2 nv + nu) and outputs B x (nq + 2 nv + nd) float32, per
    horizon step.  The roof: max(the microbench's fp32 peak, the observed
    rate) and the measured memory rate.  Raises FusedPathUnavailable (a
    RuntimeError) off the fused kernel (a CPU device, or a model the env runs on the physics pipeline):
    it never times the plain path in the kernel's place."""
    from tpu_dialmpc_torch.envs import get_env
    from tpu_dialmpc_torch.envs.base import to_lean

    env = get_env(task, device=device, n_substeps=n_substeps)
    if env.device.type != "cuda" or not env.on_fused_path:
        raise FusedPathUnavailable(
            f"fused path unavailable (device {env.device}, on_fused_path "
            f"{env.on_fused_path}): the roofline times the CUDA kernel only")
    state = to_lean(env.reset())
    B = nsample + 1
    us = torch.zeros((B, hsample + 1, env.action_size), dtype=torch.float32, device=env.device)
    gen = torch.Generator(device=env.device)

    def one(acc):
        gen.manual_seed(1)
        noise = torch.randn(us.shape, generator=gen, device=env.device) * 0.3
        rews = env.rollout_batch(state, torch.clamp(us + noise, -1, 1))
        return acc + rews.mean()

    sec, sec_attempts = _amortized(one, (), attempts=3, settle_s=5.0, return_attempts=True)
    counts = count_fused_ops(env.model, n_substeps)
    substeps_total = (hsample + 1) * n_substeps
    ops = counts["arith_ops_per_substep"] * substeps_total * B
    microbench_peak = fp32_peak_ops_per_sec()
    # an observed rate above the microbench's is evidence that the microbench
    # met interference: raise the roof to it (module docstring)
    peak = max(microbench_peak, ops / sec)
    compute_sec = ops / peak
    m = env.model
    nd = fused.derived_size(m, env.fused_step.spec)
    bytes_moved = (hsample + 1) * B * 4 * ((m.nq + 2 * m.nv + m.nu) + (m.nq + 2 * m.nv + nd))
    bw = hbm_copy_bytes_per_sec()
    memory_sec = bytes_moved / bw
    ideal_sec = max(compute_sec, memory_sec)
    return {
        "task": task,
        "nsample": nsample,
        "n_substeps": n_substeps,
        "measured_ms": 1e3 * sec,
        "measured_ms_attempts": [1e3 * s for s in sec_attempts],
        "vector_ops_per_substep": counts["vector_ops_per_substep"],
        "arith_ops_per_substep": counts["arith_ops_per_substep"],
        "measured_peak_gops": peak / 1e9,
        "microbench_peak_gops": microbench_peak / 1e9,
        "roof_raised_by_kernel_evidence": bool(peak > microbench_peak),
        "measured_hbm_gbps": bw / 1e9,
        "ideal_compute_ms": 1e3 * compute_sec,
        "ideal_memory_ms": 1e3 * memory_sec,
        "bound": "compute" if compute_sec >= memory_sec else "memory",
        # the JAX key's name; here the ideal time on the card
        "ideal_vpu_ms": 1e3 * ideal_sec,
        "fraction_of_roof": ideal_sec / sec,
        "samples_steps_per_sec": B * substeps_total / sec,
    }


PHASES = {"sample_spline_ms": ("candidates",), "rollout_ms": ("rollout",),
          "score_update_ms": ("score_update",)}


def phase_timings(task: str = "go2_stand", nsample: int = 2048,
                  hsample: int = 20, hnode: int = 5,
                  n_substeps: int = 8, device: str = "cuda",
                  reps: int = 5) -> Dict[str, float]:
    """ms per phase of one annealing iteration (`MBDPI.reverse_once`), the
    median of `reps` calls after its eager first call and its capture: the
    whole call on the device's clock (its input copies, the graph and its
    output clones), and the tracer's device spans in it
    (`telemetry/spans.py`): the candidates and their splines (`candidates`),
    the rollouts (every horizon step's `rollout`) and score + update
    (`score_update`).  On the card the planner captures, so the spans are the
    graph's event-record nodes; on the CPU it runs eagerly and they read the
    host clock.  The tracer is on for the call and as it was after."""
    from tpu_dialmpc_torch.envs import get_env
    from tpu_dialmpc_torch.envs.base import to_lean
    from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI
    from tpu_dialmpc_torch.telemetry import spans

    was_on = spans.enabled()
    spans.enable()
    try:
        env = get_env(task, device=device, n_substeps=n_substeps)
        cfg = DialConfig(Hsample=hsample, Hnode=hnode, Nsample=nsample, Ndiffuse=2)
        mb = MBDPI(cfg, env)
        state = to_lean(env.reset())
        dtype = state.obs.dtype
        Y0 = torch.zeros((cfg.Hnode + 1, env.action_size), dtype=dtype, device=env.device)
        scale = torch.as_tensor(mb.sigma_control, dtype=dtype, device=env.device)
        gen = torch.Generator(device=env.device).manual_seed(1)
        for _ in range(2):  # the eager first call, then the capture
            mb.reverse_once(state, gen, Y0, scale)
        spans.collect()
        reps_ms = []
        for _ in range(reps):
            before = spans.summary()
            whole = _device_seconds(lambda: mb.reverse_once(state, gen, Y0, scale), env.device)
            spans.collect()
            after = spans.summary()

            def spent(paths):
                return sum(after[p]["device_s"] - before.get(p, {}).get("device_s", 0.0)
                           for p in paths)

            reps_ms.append(dict(reverse_once_ms=1e3 * whole,
                                **{k: 1e3 * spent(p) for k, p in PHASES.items()}))
    finally:
        if not was_on:
            spans.disable()
    return {k: statistics.median(r[k] for r in reps_ms) for k in reps_ms[0]}


def _device_seconds(fn, device) -> float:
    """Seconds `fn()` takes on `device`: between two CUDA events around it on
    the card, on the host clock on the CPU."""
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    fn()
    e1.record()
    e1.synchronize()
    return 1e-3 * e0.elapsed_time(e1)


def capture_trace(path: str, fn, *args):
    """Run `fn(*args)` under `torch.profiler` (CPU, and CUDA where there is
    a card), wait for the device and its last records (`TRACE_SETTLE_S`),
    and write the Chrome trace to `path/trace.json`; returns fn's output."""
    from torch.profiler import ProfilerActivity, profile

    activities = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
                  if a in torch.profiler.supported_activities()]
    cuda = torch.cuda.is_available()
    with profile(activities=activities) as prof:
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize()
            time.sleep(TRACE_SETTLE_S)
    os.makedirs(path, exist_ok=True)
    prof.export_chrome_trace(os.path.join(path, "trace.json"))
    return out
