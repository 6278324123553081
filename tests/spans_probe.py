"""The tracer's spans (`tpu_dialmpc_torch/telemetry/spans.py`) on a benchmark
cell, on the card.

    python3 tests/spans_probe.py cell <workload> <seed> <seconds>
    python3 tests/spans_probe.py cost <workload> <pairs> <seconds>
    python3 tests/spans_probe.py nodes <tree>

`cell` runs the cell as a `--trace 1` run of `benchmark/run.py` does, with
the tracer's host spans on from before the program is built: set-up, the
timed window, the profiler window of `trace_steps` steps (the cell's
per-layer metrics, read by `benchmark/metrics/`); then the device spans on,
one step that captures the units' traced graphs, and `trace_steps` more
steps, each followed by `spans.collect()`, their replays timed by two
events.  It prints one JSON line: the span readings (the device spans per
step, the graph's launch per step of the window, the set-up split), the
per-layer metrics and the cross-checks.

`cost` alternates timed windows of the cell's program with the tracer off
and with its host spans on (off, on, on, off, ...): the window's ms per
control step as the benchmark times it, and the host's ms per call, per
pair.

`nodes` counts the nodes of the captured control step of go2_stand's cell
configuration, tracer off, with the program and harness of another tree (a
`git archive` of a commit unpacked under build/), so that two commits can be
held to the same graph.
"""

import time

T_PROCESS = time.perf_counter()

import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def card_name():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _setup(workload, seed):
    """The cell's program as `benchmark/run.py` sets it up, with the host
    clock at each stage (`clock`: seconds since the process started)."""
    clock = {}
    import torch

    clock["import torch"] = time.perf_counter() - T_PROCESS
    from benchmark.harness import cells, loop, program

    found = cells.find_cell(workload)
    device = torch.device("cuda", 0)
    clock["harness"] = time.perf_counter() - T_PROCESS
    prog = program.build(found.config, device, True)
    clock["build"] = time.perf_counter() - T_PROCESS
    state0, Y0 = program.reset(prog)
    pl = found.config["planner"]
    noise = loop.Noise(seed, (pl["Ndiffuse"], pl["Nsample"], pl["Hnode"] + 1,
                              prog.env.action_size), device, Y0.dtype)
    clock["reset"] = time.perf_counter() - T_PROCESS
    warm = loop.run(prog.step, state0, Y0, noise, 0, found.traffic, device,
                    n=int(found.traffic["warmup_steps"]), start=(state0, Y0))
    clock["warm-up steps"] = time.perf_counter() - T_PROCESS
    return SimpleNamespace(found=found, device=device, prog=prog, noise=noise, warm=warm,
                           begin=(state0, Y0), clock=clock)


def _per_step(summary, path, n):
    s = summary.get(path)
    return None if s is None else 1e3 * s["device_s"] / n


def cell(workload, seed, seconds):
    import torch

    from tpu_dialmpc_torch.telemetry import spans

    spans.reset()
    spans.enable(device=False)
    run = _setup(workload, seed)
    from benchmark.harness import cells, loop, program, work
    from benchmark.harness import trace as tracing
    from torch.profiler import record_function

    found, device, prog, traffic = run.found, run.device, run.prog, run.found.traffic
    setup_s = time.perf_counter() - T_PROCESS
    spans.collect()
    set_up = spans.summary()
    spans.reset()
    window = loop.run(prog.step, run.warm.state, run.warm.Y, run.noise, run.warm.k, traffic,
                      device, seconds=seconds, start=run.begin)
    in_window = spans.summary()
    spans.reset()
    n_trace = int(traffic["trace_steps"])
    before = program.fused_launches(prog)
    summary, after = tracing.profile(
        lambda: loop.run(prog.step, window.state, window.Y, run.noise, window.k, traffic,
                         device, n=n_trace, span=record_function, start=run.begin), device)
    traced_launches = program.fused_launches(prog) - before
    spans.collect()
    spans.reset()
    ctx = SimpleNamespace(
        config=found.config, traffic=traffic, window=window, setup_s=setup_s,
        capture_s=program.capture_seconds(prog), trace=summary, traced_steps=n_trace,
        traced_launches=traced_launches, ops_per_step=work.ops_per_step(found.config))
    per_layer = {m["name"]: cells.metric_reader(m["name"])(ctx) for m in found.per_layer}
    # the device spans: one step captures the traced graph, then the steps
    # read one at a time, each replay timed whole
    spans.enable()
    state, Y, k = after.state, after.Y, after.k
    state, Y, _ = prog.step(state, Y, run.noise(k))
    spans.collect()
    spans.reset()
    (unit,) = prog.mbdpi.graphs.units.values()
    replay, marks = unit.traced.replay, []

    def timed():
        marks.append([torch.cuda.Event(enable_timing=True) for _ in range(2)])
        marks[-1][0].record()
        replay()
        marks[-1][1].record()

    unit.traced.replay = timed
    unread = 0
    for i in range(1, n_trace + 1):
        state, Y, _ = prog.step(state, Y, run.noise(k + i))
        unread += spans.collect()
    whole = sum(1e-3 * e0.elapsed_time(e1) for e0, e1 in marks)
    dev = spans.summary()
    n = n_trace
    top = sum(s["device_s"] for p, s in dev.items() if "device_s" in s and "/" not in p)
    graph = in_window.get("graph/replay", {})
    readings = dict(
        execute_ms=_per_step(dev, "execute", n),
        pd_map_ms=_per_step(dev, "rollout/ctrl", n),
        reward_stack_ms=_per_step(dev, "rollout/reward", n),
        planner_ops_ms=sum(_per_step(dev, p, n) for p in ("shift", "candidates", "score_update")),
        rollout_physics_ms=_per_step(dev, "rollout/physics", n),
        execute_physics_ms=_per_step(dev, "execute/physics", n),
        rollout_ms=_per_step(dev, "rollout", n),
        top_level_ms=1e3 * top / n, whole_step_ms=1e3 * whole / n,
        graph_launch_ms=1e3 * graph.get("host_s", float("nan")) / max(graph.get("count", 1), 1),
        graph_load_ms=1e3 * in_window["graph/load"]["host_s"] / len(window.outs),
        graph_clone_ms=1e3 * in_window["graph/clone"]["host_s"] / len(window.outs),
        env_build_s=set_up["setup/env"]["self_s"],
        kernel_load_s=set_up.get("setup/kernel", {}).get("host_s"),
        env_kernels_load_s=set_up.get("setup/env_kernels", {}).get("host_s"),
        first_call_s=set_up["setup/first_call"]["self_s"],
        capture_span_s=set_up["setup/capture"]["host_s"] + set_up["setup/instantiate"]["host_s"],
        setup_s=setup_s, setup_clock=run.clock, unread=unread, window_steps=len(window.outs),
        ctrl_step_ms=1e3 * window.wall / len(window.outs))
    kernel_only = per_layer["fused_kernel_ms"] - readings["execute_physics_ms"]
    checks = dict(
        top_over_whole=readings["top_level_ms"] / readings["whole_step_ms"],
        physics_over_kernel_minus_executed=readings["rollout_physics_ms"] / kernel_only,
        launch_le_enqueue=readings["graph_launch_ms"] <= per_layer["host_enqueue_ms"],
        split_le_setup=(readings["env_build_s"] + (readings["kernel_load_s"] or 0)
                        + (readings["env_kernels_load_s"] or 0)
                        + readings["first_call_s"] + per_layer["capture_s"] <= setup_s))
    print("RESULT " + json.dumps(dict(workload=workload, seed=seed, card=card_name(),
                                      readings=readings, per_layer=per_layer, checks=checks,
                                      busy_s=summary.busy_s, window_s=summary.window_s,
                                      breakdown=summary.breakdown)),
          flush=True)


def cost(workload, pairs, seconds):
    """Windows of the program with the tracer off and its host spans on, in
    turns."""
    import torch

    from tpu_dialmpc_torch.telemetry import spans

    spans.disable()
    t0 = time.perf_counter()
    torch.zeros(1, device="cuda")  # the CUDA context
    context_s = time.perf_counter() - t0
    run = _setup(workload, 2700000001)
    from benchmark.harness import loop

    ms, enqueue = {"off": [], "on": []}, {"off": [], "on": []}
    order = [("off", "on"), ("on", "off")]
    for i in range(pairs):
        for side in order[i % 2]:
            if side == "on":
                spans.enable(device=False)
            w = loop.run(run.prog.step, run.warm.state, run.warm.Y, run.noise, run.warm.k,
                         run.found.traffic, run.device, seconds=seconds, start=run.begin)
            spans.disable()
            spans.reset()
            ms[side].append(1e3 * w.wall / len(w.outs))
            enqueue[side].append(1e3 * statistics.mean(w.enqueue))
            del w
    ratios = [a / b for a, b in zip(ms["on"], ms["off"])]
    print("RESULT " + json.dumps(dict(
        workload=workload, card=card_name(), seconds=seconds, context_s=context_s,
        ms=ms, on_over_off=ratios, enqueue_ms=enqueue,
        median_on=statistics.median(ms["on"]), median_off=statistics.median(ms["off"]))),
        flush=True)


def nodes(tree):
    tree = Path(tree).resolve()
    sys.path[:0] = [str(tree), str(ROOT / "tests")]
    run = _setup("go2_stand.realtime", 2700000002)
    import tpu_dialmpc_torch
    from torch_port_helpers import graph_node_types

    assert Path(tpu_dialmpc_torch.__file__).resolve().is_relative_to(tree)
    (unit,) = run.prog.mbdpi.graphs.units.values()
    print("RESULT " + json.dumps(dict(tree=str(tree), card=card_name(),
                                      nodes=graph_node_types(unit.graph.graph))), flush=True)


if __name__ == "__main__":
    what, *args = sys.argv[1:]
    if what != "nodes":
        sys.path.insert(0, str(ROOT))
    if what == "cell":
        cell(args[0], int(args[1]), float(args[2]))
    elif what == "cost":
        cost(args[0], int(args[1]), float(args[2]))
    elif what == "nodes":
        nodes(args[0])
    else:
        raise SystemExit(f"unknown mode {what!r}: cell, cost or nodes")
