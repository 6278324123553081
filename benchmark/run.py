"""Run one benchmark cell once on this machine's card and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (an entry of `BENCHMARK.json`'s
`workloads`) names a configuration (`benchmark/configs/<name>.json`) and a
traffic mix (`benchmark/traffic/<name>.json`).  The run builds the
configuration's env and captured planner (`tpu_dialmpc_torch`), warms up
every shape, drives the control step for `--seconds` as the traffic says,
then judges a sample of the window's steps against the plain reference
(`benchmark/harness/correct.py`).  With `--trace 0` the result holds the
cell's end-to-end metrics; with `--trace 1` its per-layer metrics, read by
`benchmark/metrics/<name>.py` from a profile of the steps that close the
window and from the program's own spans (`run_cell`).  The last line of
standard output is the result, as JSON; the last lines of standard error are
the numbers compared, each beside its limit.

Without a CUDA card (or with fewer than the cell asks for) it exits with 3
and prints no result; it never falls back to the CPU.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import cells  # noqa: E402

# top-level module names that may not be loaded in the process that prints
# a result: JAX and the JAX package (the port's name begins with it, so
# names are compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_dialmpc")
# a traced run's steps with the program's host spans on, between the timed
# window (the spans' own host time would sit in its enqueue times) and the
# profiled steps (after a profile a graph's launch reads ~4x longer on the
# host): ~1 s of go2_stand
HOST_SPAN_STEPS = 20


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_state(device_index: int = 0) -> str:
    """The card's SM clock, power draw and limit, and temperature, as
    nvidia-smi reads them ("not read" where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(device_index),
             "--query-gpu=name,clocks.sm,power.draw,power.limit,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
        return out.stdout.strip() or f"not read ({out.stderr.strip()})"
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"


def _caches():
    """Every build and kernel cache the run might write, at fixed places
    inside the checkout (the port's own kernels build into build/kernels)."""
    base = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(base / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(base / "triton")
    os.environ.setdefault("USE_FLAX", "0")


def _merge(base: dict, over: dict | None) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(base.get(k, {}), v) if isinstance(v, dict) else v
    return out


def run_cell(found, seed: int, seconds: float, trace: bool, device="cuda",
             t_process: float | None = None, overrides: dict | None = None,
             log=print) -> dict:
    """One run of the cell `found` (`cells.find_cell`) on `device`: the
    result's keys.  `overrides` replace parts of the configuration (the CPU
    rehearsals shrink the planner with it).  On the card the planner
    captures its graphs or raises; on the CPU it runs eagerly.

    With `trace` the program's tracer records three phases, each read into
    `ctx.spans[phase]` (a summary by span path, `program.spans_summary`) and
    `ctx.span_steps[phase]` (the control steps it ran): "setup", host spans
    from before the build to the end of the warm-up; "host", after the
    timed window, host spans over `HOST_SPAN_STEPS` steps of the untraced
    graph; "device", after the profiled steps, the device spans of
    `trace_steps` steps, each replay read before the next.  The window and
    the profiled steps run with the tracer off; without `trace` it stays
    off, and the run is the untraced program's."""
    import torch

    from benchmark.harness import correct, loop, program, work
    from benchmark.harness import trace as tracing

    t_process = time.perf_counter() if t_process is None else t_process
    config = _merge(found.config, overrides)
    traffic = found.traffic
    device = torch.device(device)
    on_card = device.type == "cuda"
    spans, span_steps = {}, {}

    def take(phase, steps):
        got = program.spans_summary()
        if got is not None:
            spans[phase], span_steps[phase] = got, steps

    # set-up: the program, its reset state, and the warm-up steps (eager,
    # capture, replays), each with its read-back
    if trace:
        program.spans_on(device=False)
    prog = program.build(config, device, True if on_card else "auto")
    state0, Y0 = program.reset(prog)
    start = correct.snapshot(program.state_dict(state0))
    pl = config["planner"]
    noise = loop.Noise(seed, (pl["Ndiffuse"], pl["Nsample"], pl["Hnode"] + 1,
                              prog.env.action_size), device, Y0.dtype)
    begin = (state0, Y0)
    warm = loop.run(prog.step, state0, Y0, noise, 0, traffic, device,
                    n=int(traffic["warmup_steps"]), start=begin)
    del warm.outs, warm.ins
    capture_s = program.capture_seconds(prog) if on_card else None
    setup_s = time.perf_counter() - t_process
    if trace:
        take("setup", int(traffic["warmup_steps"]))
        program.spans_off()

    if on_card:
        log(f"[card] before the window: {card_state()}", file=sys.stderr)
    k_window = warm.k
    window = loop.run(prog.step, warm.state, warm.Y, noise, k_window, traffic, device,
                      seconds=seconds, start=begin)
    if on_card:
        log(f"[card] after the window: {card_state()}", file=sys.stderr)
    # the program's peak: the traced run's later phases (the host spans' and
    # the profile's steps, the traced graph) are the instrument's
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    summary, traced_launches, traced_steps = None, None, int(traffic["trace_steps"])
    kernel_launches = {}
    if trace:
        from torch.profiler import record_function

        last = window
        if program.spans_on(device=False):
            last = loop.run(prog.step, window.state, window.Y, noise, window.k, traffic,
                            device, n=HOST_SPAN_STEPS, start=begin)
            del last.outs, last.ins
            take("host", HOST_SPAN_STEPS)
            program.spans_off()

        def traced():
            return loop.run(prog.step, last.state, last.Y, noise, last.k, traffic,
                            device, n=traced_steps, span=record_function, start=begin)

        before, counts = program.fused_launches(prog), program.launch_counts(prog)
        summary, after = tracing.profile(traced, device)
        traced_launches = program.fused_launches(prog) - before
        kernel_launches = {k: v - counts[k] for k, v in program.launch_counts(prog).items()
                           if k in counts}
    if trace:
        if program.spans_on(device=True):
            # one step captures the traced graph; then each step's replay is
            # read before the next one overwrites its events
            last = loop.run(prog.step, after.state, after.Y, noise, after.k, traffic, device,
                            n=1, start=begin)
            program.spans_summary()
            unread = 0
            for _ in range(traced_steps):
                last = loop.run(prog.step, last.state, last.Y, noise, last.k, traffic, device,
                                n=1, start=begin)
                unread += program.spans_collect()
            if unread:
                log(f"[spans] {unread} replays not read: no device spans", file=sys.stderr)
            else:
                take("device", traced_steps)
                log("[spans] device ms per step " + json.dumps(
                    {k: 1e3 * v["device_s"] / traced_steps
                     for k, v in spans["device"].items() if "device_s" in v}), file=sys.stderr)
        program.spans_off()
        del after, last
    failed = program.non_finite(window.outs)

    # the judged steps, copied out; then the program is freed
    chosen = correct.pick_steps(seed, len(window.outs), config["check"]["steps"])
    judged = []
    for i in chosen:
        st_in, Y_in = window.ins[i]
        judged.append(correct.snapshot(dict(
            inp=program.state_dict(st_in), Y_in=Y_in, noise=noise(k_window + i),
            out=program.outputs(window.outs[i]))))
    ctx = SimpleNamespace(
        config=config, traffic=traffic, window=window, setup_s=setup_s, capture_s=capture_s,
        trace=summary, traced_steps=traced_steps, traced_launches=traced_launches,
        kernel_launches=kernel_launches, ops_per_step=work.ops_per_step(config), spans=spans, span_steps=span_steps)
    names = [m["name"] for m in (found.per_layer if trace else found.end_to_end)]
    units = {m["name"]: m["unit"] for m in found.per_layer + found.end_to_end}
    metrics = {}
    for name in names:
        value = cells.metric_reader(name)(ctx)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    attempted = len(window.outs)
    del prog, window, warm, begin, state0, Y0, noise, ctx
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    ref = correct.Reference(config, device)
    numbers = dict(start_gap=correct.start_gap(ref, start))
    if judged:
        numbers.update(correct.judge(ref, judged, config["check"]["rows_per_block"]))
    ok, checks = correct.verdict(numbers, config["check"]["limits"])
    log(f"[readings] {json.dumps(numbers)}", file=sys.stderr)
    log(f"[reference] {len(judged)} judged steps of {attempted} in "
        f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    result = {"correct": ok and failed == 0, "attempted": attempted, "failed": failed,
              "metrics": metrics}
    result["device"] = {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
        "count": 1, "memory_peak_bytes": peak}
    if summary is not None:
        result["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = summary.breakdown
    result["checks"] = checks
    return result


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        found = cells.find_cell(args.workload)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    import torch

    chips = int(found.cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result",
              file=sys.stderr)
        return 3
    _caches()
    result = run_cell(found, args.seed, args.seconds, bool(args.trace), "cuda:0", T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"error: the process loaded {bad}: no result", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
