"""The traced part of a `--trace 1` run: a `torch.profiler` window over a
fixed number of control steps, reduced to what the per-layer readers read.

The arithmetic follows `chip_smoke.py:_profile_window`: the launches at the
start of a trace can miss their device record, so the window opens with a
pre-roll of spin kernels and a synchronize, and only what follows counts;
the device records of the last kernels can reach the profiler after the
final synchronize, so the window waits `SETTLE_S` before the profiler stops.
The counted window is the host span `WINDOW` (from after the pre-roll's
synchronize to after the final one).  Device busy time is the union of
every kernel, copy and set record in it.
"""

from __future__ import annotations

import collections
import time
from types import SimpleNamespace

import torch

PREROLL_LAUNCHES = 256
PREROLL_CYCLES = 40_000
SETTLE_S = 0.5
WINDOW = "bench.window"
TOP = 10
COPIES = ("Memcpy", "Memset")  # device records that are not kernels


def _start_ns(e):
    return e.start_ns()


def _end_ns(e):
    return e.end_ns() if hasattr(e, "end_ns") else e.start_ns() + e.duration_ns()


def _on_device(e) -> bool:
    return not str(e.device_type()).endswith("CPU")


def _annotation(e) -> bool:
    flag = getattr(e, "is_user_annotation", None)
    return bool(flag()) if callable(flag) else e.name().startswith("bench.")


def profile(fn, device) -> SimpleNamespace:
    """Run `fn()` (the traced steps, ending in a synchronize) under the
    profiler; returns the reduced trace and `fn`'s result."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    torch.cuda.synchronize(device)
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PREROLL_LAUNCHES):
            torch.cuda._sleep(PREROLL_CYCLES)
        torch.cuda.synchronize(device)
        with record_function(WINDOW):
            result = fn()
            torch.cuda.synchronize(device)
        time.sleep(SETTLE_S)
    return reduce(list(prof.profiler.kineto_results.events())), result


def reduce(events) -> SimpleNamespace:
    """Kernel records by name ((count, seconds)), busy and wall seconds, and
    the breakdown: the device records that took most time and the longest
    idle gaps, labelled by what the host was doing; all inside `WINDOW`."""
    spans = [e for e in events if not _on_device(e) and e.name() == WINDOW]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = _start_ns(spans[0]), _end_ns(spans[0])
    dev = [e for e in events if _on_device(e) and not _annotation(e)
           and w0 <= _start_ns(e) <= w1 and "spin_kernel" not in e.name()]
    host = [e for e in events if not _on_device(e) and e.name() != WINDOW
            and w0 <= _start_ns(e) <= w1]

    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in dev:
        by_name[e.name()][0] += 1
        by_name[e.name()][1] += (_end_ns(e) - _start_ns(e)) * 1e-9
    kernels = {n: tuple(v) for n, v in by_name.items() if not n.startswith(COPIES)}

    # the union of the device intervals, and the gaps between them
    iv = sorted((max(_start_ns(e), w0), min(_end_ns(e), w1)) for e in dev)
    merged = []
    for a, b in iv:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)

    def doing(t):
        """The host's activity at time t: the benchmark's span and the
        innermost operation running then."""
        live = [e for e in host if _start_ns(e) <= t <= _end_ns(e)]
        ours = [e for e in live if e.name().startswith("bench.")]
        inner = max((e for e in live if not e.name().startswith("bench.")),
                    key=_start_ns, default=None)
        parts = [max(ours, key=_start_ns).name() if ours else "between the benchmark's spans"]
        if inner is not None:
            parts.append(inner.name())
        return " > ".join(parts)

    idle_gaps = [[doing((a + b) // 2), (b - a) * 1e-9] for a, b in gaps[:TOP]]
    device_ops = sorted(([n, v[1]] for n, v in by_name.items()), key=lambda x: -x[1])[:TOP]
    return SimpleNamespace(
        window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, kernels=kernels,
        breakdown={"device_ops": device_ops, "idle_gaps": idle_gaps},
    )
