"""The traffic generator: drives the control step as a traffic file says.

A traffic file (`benchmark/traffic/<name>.json`) holds the parameters:

- `loop`: "closed", a robot's loop: each step, then the new plan's first
  action copied to the host before the next step starts (a step's latency
  runs from its start to that copy); or "queued": steps enqueued back to
  back with at most `max_in_flight` unfinished on the device and nothing
  read back until the window closes (`run_scan`'s form).
- `episode_steps`: the loop starts a new episode (the reset state and a
  zero plan) at every step index that is a multiple of it: a robot run from
  its home pose for that many control steps, then again;
- `warmup_steps`: steps before the window (the first runs eagerly, the
  second captures, the rest replay), counted as set-up;
- `trace_steps`: the steps a traced run profiles after the timed ones.

Every step's noise is drawn from the run's seed and the step's index, on the
device (`noise`), so the comparison can draw it again, and the same seed
gives the same inputs.
"""

from __future__ import annotations

import collections
import contextlib
import time
from types import SimpleNamespace

import torch

LOOPS = ("closed", "queued")
_GOLDEN = 0x9E3779B97F4A7C15


def noise_seed(seed: int, k: int) -> int:
    """The generator seed of step k's noise (k counts from the first
    warm-up step)."""
    return (seed * _GOLDEN + k) % (1 << 63)


class Noise:
    """Each step's standard normal draws, (Ndiffuse, Nsample, Hnode+1, nu),
    on `device` in `dtype`."""

    def __init__(self, seed: int, shape, device, dtype):
        self.seed, self.shape, self.dtype = seed, tuple(shape), dtype
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)

    def __call__(self, k: int) -> torch.Tensor:
        self.gen.manual_seed(noise_seed(self.seed, k))
        return torch.randn(self.shape, generator=self.gen, dtype=self.dtype, device=self.device)


class Fence:
    """A point in the device's stream that the host can wait for (a CUDA
    event); on the CPU every op has finished when it returns."""

    def __init__(self, device):
        self.event = None
        if torch.device(device).type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record()

    def wait(self):
        if self.event is not None:
            self.event.synchronize()


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def read_action(Y) -> torch.Tensor:
    """The new plan's first action, on the host: what a robot's loop sends."""
    return Y[0].cpu()


def run(step, state, Y, noise, k0: int, traffic: dict, device, seconds=None, n=None,
        clock=time.perf_counter, span=None, start=None) -> SimpleNamespace:
    """Control steps from (state, Y), the first with noise index `k0`: `n`
    of them, or as many as start before `seconds` have passed on the host
    clock (the step that is running then completes); at the start of an
    episode the step begins from `start` (the reset state and the zero
    plan) in place of the last step's output.  Returns the steps' inputs
    and outputs in order, their latencies (closed loop), the host seconds each
    call to `step` took to return (`enqueue`), and the window's wall time,
    from its start until the last step's action is on the host (closed) or
    the device has finished every step (queued).  `span(name)` is a context
    manager that marks the host's phases for a trace."""
    loop = traffic["loop"]
    if loop not in LOOPS:
        raise ValueError(f"traffic loop {loop!r}: expected one of {LOOPS}")
    span = span or (lambda name: contextlib.nullcontext())
    ins, outs, latency, enqueue = [], [], [], []
    episode = int(traffic.get("episode_steps", 0))
    pending = collections.deque()
    depth = int(traffic.get("max_in_flight", 1))
    k = k0
    t_start = clock()
    while len(outs) < n if n is not None else clock() - t_start < seconds:
        t0 = clock()
        if episode and k % episode == 0 and k and start is not None:
            state, Y = start
        ins.append((state, Y))
        with span("bench.noise"):
            eps = noise(k)
        t1 = clock()
        with span("bench.control_step"):
            out = step(state, Y, eps)
        t2 = clock()
        state, Y = out[0], out[1]
        outs.append(out)
        enqueue.append(t2 - t1)
        if loop == "closed":
            with span("bench.read_action"):
                read_action(Y)
            latency.append(clock() - t0)
        else:
            pending.append(Fence(device))
            if len(pending) > depth:
                with span("bench.wait_in_flight"):
                    pending.popleft().wait()
        k += 1
    with span("bench.sync"):
        sync(device)
    wall = clock() - t_start
    return SimpleNamespace(ins=ins, outs=outs, latency=latency, enqueue=enqueue, wall=wall,
                           state=state, Y=Y, k=k)

