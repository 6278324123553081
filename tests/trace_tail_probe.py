"""How many of a profile window's fused-kernel records the trace loses, with
and without the wait before the profiler stops (`TRACE_SETTLE_S`).

On the card, from the repository's root:

    python tests/trace_tail_probe.py [--task go2_crate_climb] [--windows 16]

It builds the task's env at its full planner width, drives `chip_smoke.py`'s
main path (so `reverse_once` and the control step replay their CUDA graphs),
then opens `--windows` windows over 3 `reverse_once` and over 2 control
steps, as `chip_smoke.py`'s [profile] windows do, once with no wait after the
final synchronize and once waiting `TRACE_SETTLE_S`.  Each window's line
gives the fused launches made, the fused records traced, and per graph
replay (ms after the window opened) its fused records and all its device
records; a summary line per case counts the windows that lost a record.
"""

from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(ROOT / "tests"))


def window(fn, n, fused_step, settle_s):
    """fn() n times under torch.profiler after chip_smoke's spin pre-roll:
    (launched, traced, [(ms, fused records, device records)] per replay)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(cs.PREROLL_LAUNCHES):
            torch.cuda._sleep(cs.PREROLL_CYCLES)
        torch.cuda.synchronize()
        launched = fused_step.launches
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        time.sleep(settle_s)
    launched = fused_step.launches - launched
    raw = list(prof.profiler.kineto_results.events())
    device = [e for e in raw if not str(e.device_type()).endswith("CPU")]
    fused = collections.Counter(e.correlation_id() for e in device
                                if "fused_step_kernel" in e.name())
    records = collections.Counter(e.correlation_id() for e in device)
    opened = min(e.start_ns() for e in raw)
    replays = [(round((e.start_ns() - opened) / 1e6, 2), fused[e.correlation_id()],
                records[e.correlation_id()]) for e in raw if "GraphLaunch" in e.name()]
    return launched, sum(fused.values()), replays


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--task", default="go2_crate_climb")
    ap.add_argument("--windows", type=int, default=16)
    args = ap.parse_args(argv)

    import torch

    import chip_smoke as cs
    from tpu_dialmpc_torch.telemetry.profile import TRACE_SETTLE_S

    if not torch.cuda.is_available():
        print("trace_tail_probe: no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    path = next(p for p in cs.PATHS if p.task == args.task and not p.by_path)
    env, cfg = cs.make_env(path, device)
    cs.phase_card()
    cs.phase_build_all([env])
    mbdpi, state, Y0, gen, step, _ = cs.run_main_path(env, cfg, device, path.label, [env])
    scale = torch.as_tensor(mbdpi.sigma_control, dtype=torch.float32, device=device)
    units = (("reverse_once", lambda: mbdpi.reverse_once(state, gen, Y0, scale), 3),
             ("control_step", lambda: step(state, Y0, gen), 2))
    for settle_s in (0.0, TRACE_SETTLE_S):
        for name, fn, n in units:
            lossy = 0
            for i in range(args.windows):
                launched, traced, replays = window(fn, n, env.fused_step, settle_s)
                lossy += traced != launched
                print(f"[tail {path.label} {name} settle {settle_s} s #{i}] launched {launched}, "
                      f"traced {traced}; per replay (ms, fused, all records) {replays}")
            print(f"[tail {path.label} {name} settle {settle_s} s] {lossy} of {args.windows} "
                  f"windows lost a fused record (captured={mbdpi.captured})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
