"""The program's spans and launch counters handed to the per-layer readers:
each reader on a hand-built context, the harness's hooks on a program
without a tracer, and a traced run rehearsed on the CPU (its profiler stood
in for)."""

import sys
from types import SimpleNamespace

import pytest

from benchmark import run as bench_run
from benchmark.harness import cells, loop, program
from benchmark.harness import trace as tracing
from tpu_dialmpc_torch.telemetry import spans as tracer

TRACER = "tpu_dialmpc_torch.telemetry.spans"

# a traced run's spans by phase, and the control steps each phase ran
SPANS = {
    "setup": {
        "setup/env": dict(count=1, host_s=0.74, self_s=0.68),
        "setup/kernel": dict(count=1, host_s=0.03, self_s=0.03),
        "setup/env_kernels": dict(count=1, host_s=0.012, self_s=0.012),
        "setup/first_call": dict(count=1, host_s=0.56, self_s=0.52),
    },
    "host": {"graph/replay": dict(count=100, host_s=0.005, self_s=0.005)},
    "device": {
        "execute": dict(count=4, device_s=0.0034),
        "rollout/physics": dict(count=208, device_s=0.19336),
        "shift": dict(count=4, device_s=0.0002),
        "candidates": dict(count=8, device_s=0.0004),
        "score_update": dict(count=8, device_s=0.00056),
    },
}
STEPS = {"setup": 3, "host": 100, "device": 4}

# reader: (the (phase, path) pairs it reads, its reading of SPANS)
READS = {
    "execute_ms": ([("device", "execute")], 0.85),
    "planner_ops_ms": ([("device", "shift"), ("device", "candidates"),
                        ("device", "score_update")], 0.29),
    "graph_launch_ms": ([("host", "graph/replay")], 0.05),
    "env_build_s": ([("setup", "setup/env")], 0.68),
    "kernel_load_s": ([("setup", "setup/kernel")], 0.03),
    "env_kernels_load_s": ([("setup", "setup/env_kernels")], 0.012),
    "first_call_s": ([("setup", "setup/first_call")], 0.52),
}
SPAN_METRICS = sorted(READS)

# the env kernels' readers: (kernel, launch counter, ms per step of KERNELS)
KERNEL_READS = {
    "pd_map_ms": ("go2_ctrl", "Go2EnvKernels.ctrl_launches", 0.10),
    "reward_stack_ms": ("go2_post_physics", "Go2EnvKernels.post_physics_launches", 0.26),
}
KERNEL_METRICS = sorted(KERNEL_READS)
# the profiler's records of 4 traced steps: (records, device seconds) by name
KERNELS = {
    "fused_step_kernel(FusedModel const*, FusedTables const*, int)": (212, 0.19696),
    "void go2_ctrl<float>(Go2Params<float>, CtrlIo, int)": (212, 0.0004),
    "void go2_post_physics<float>(Go2Params<float>, PostIo, int)": (212, 0.00104),
}
LAUNCHES = {"FusedStep.launches": 212, "Go2EnvKernels.ctrl_launches": 212,
            "Go2EnvKernels.post_physics_launches": 212}


def _ctx(spans):
    return SimpleNamespace(spans=spans, span_steps=dict(STEPS))


def _traced(kernels=KERNELS, launches=LAUNCHES):
    return SimpleNamespace(trace=SimpleNamespace(kernels=dict(kernels)), traced_steps=4,
                           kernel_launches=dict(launches))


def test_the_span_metrics_are_the_benchmarks():
    spec = cells.load_spec()
    by_name = {m["name"]: m for m in spec["per_layer"]}
    entries = {n for n, m in by_name.items() if m["source"] == "program_span"}
    assert entries == set(SPAN_METRICS) | {"capture_s"}
    for name in SPAN_METRICS + KERNEL_METRICS:
        assert set(by_name[name]["workloads"]) == {w["name"] for w in spec["workloads"]}
    assert {by_name[n]["source"] for n in KERNEL_METRICS} == {"device_trace"}


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_reader_reads_its_span(name):
    assert cells.metric_reader(name)(_ctx(SPANS)) == pytest.approx(READS[name][1])


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_a_reader_without_its_span_reads_none(name):
    """Each span the reader reads, taken out alone; no phase at all; a
    context with no spans."""
    read = cells.metric_reader(name)
    for phase, path in READS[name][0]:
        spans = {p: dict(s) for p, s in SPANS.items()}
        del spans[phase][path]
        assert read(_ctx(spans)) is None
    assert read(_ctx({})) is None
    assert read(SimpleNamespace()) is None


@pytest.mark.parametrize("name", KERNEL_METRICS)
def test_a_kernel_reader_reads_its_records(name):
    read = cells.metric_reader(name)
    assert read(_traced()) == pytest.approx(KERNEL_READS[name][2])
    # a trace that lost its last record is made up in proportion
    kernel, counter, ms = KERNEL_READS[name]
    lost = {n: (c - 1, s * (c - 1) / c) if kernel in n else (c, s) for n, (c, s) in KERNELS.items()}
    assert read(_traced(lost)) == pytest.approx(ms)


@pytest.mark.parametrize("name", KERNEL_METRICS)
def test_a_kernel_reader_without_its_records_reads_none(name):
    """No trace; the kernel's records absent; two records lost; the
    counter absent or at nought; an untraced context."""
    read = cells.metric_reader(name)
    kernel, counter, _ = KERNEL_READS[name]
    assert read(SimpleNamespace(trace=None, traced_steps=4, kernel_launches=dict(LAUNCHES))) is None
    assert read(_traced({n: v for n, v in KERNELS.items() if kernel not in n})) is None
    assert read(_traced({n: (c - 2, s) if kernel in n else (c, s)
                         for n, (c, s) in KERNELS.items()})) is None
    assert read(_traced(launches={k: v for k, v in LAUNCHES.items() if k != counter})) is None
    assert read(_traced(launches=dict(LAUNCHES, **{counter: 0}))) is None
    assert read(SimpleNamespace()) is None


class Go2EnvKernels:
    ctrl_launches = 7
    post_physics_launches = 9


def test_the_launch_counts_are_the_envs_counters():
    kernels = Go2EnvKernels()
    env = SimpleNamespace(launch_counters=lambda: [(kernels, "ctrl_launches"),
                                                   (kernels, "post_physics_launches")])
    assert program.launch_counts(SimpleNamespace(env=env)) == {
        "Go2EnvKernels.ctrl_launches": 7, "Go2EnvKernels.post_physics_launches": 9}
    assert program.launch_counts(SimpleNamespace(env=SimpleNamespace())) == {}


def _calls(monkeypatch):
    """Every call to the tracer's enable, in order."""
    calls = []
    enable = tracer.enable

    def spy(device=True):
        calls.append(device)
        enable(device)

    monkeypatch.setattr(tracer, "enable", spy)
    return calls


@pytest.mark.parametrize("hook, args", [(program.spans_on, (True,)),
                                        (program.spans_on, (False,)),
                                        (program.spans_collect, ()),
                                        (program.spans_summary, ()),
                                        (program.spans_off, ())])
def test_the_hooks_without_a_tracer_return_none(monkeypatch, hook, args):
    calls = _calls(monkeypatch)
    monkeypatch.setitem(sys.modules, TRACER, None)
    assert hook(*args) is None
    assert calls == [] and not tracer.enabled()


def test_the_hooks_drive_the_tracer(monkeypatch):
    calls = _calls(monkeypatch)
    try:
        assert program.spans_on(False) is True and tracer.enabled()
        with tracer.span("setup/env"):
            pass
        assert program.spans_collect() == 0
        got = program.spans_summary()
        assert got["setup/env"]["count"] == 1 and program.spans_summary() == {}
    finally:
        assert program.spans_off() is True
    assert calls == [False] and not tracer.enabled()


def test_an_untraced_run_never_enables_the_tracer(monkeypatch, small_run):
    calls, hooked = _calls(monkeypatch), []
    on = program.spans_on
    monkeypatch.setattr(program, "spans_on", lambda device: hooked.append(device) or on(device))
    res = small_run("go2_stand.realtime", trace=False)
    assert res["correct"] is True
    assert calls == [] and hooked == [] and not tracer.enabled()


def _stand_in_profile(monkeypatch):
    """The profiler's phase stood in for (the CPU has no device records):
    the steps run, and the trace reads as an empty one; the host-span phase
    shortened to 2 steps.  Returns each `loop.run` call's steps ("window"
    for the timed one) and the tracer's host and device state during it."""
    phases = []
    run = loop.run

    def spy(*args, **kw):
        phases.append((kw.get("n") or "window", tracer.enabled(), tracer.device_on()))
        return run(*args, **kw)

    def profile(fn, device):
        got = fn()
        return SimpleNamespace(window_s=1.0, busy_s=0.5, kernels={},
                               breakdown={"device_ops": [], "idle_gaps": []}), got

    monkeypatch.setattr(loop, "run", spy)
    monkeypatch.setattr(tracing, "profile", profile)
    monkeypatch.setattr(bench_run, "HOST_SPAN_STEPS", 2)
    return phases


# what the CPU's eager run records: no graph, no kernel library
ON_THE_CPU = {"execute_ms", "planner_ops_ms", "env_build_s"}


def test_a_traced_run_reads_the_spans(monkeypatch, small_run):
    """Host spans over set-up, none in the timed window, host spans over
    the host phase, none in the profiled steps, then device spans."""
    calls = _calls(monkeypatch)
    phases = _stand_in_profile(monkeypatch)
    res = small_run("go2_stand.queued", trace=True)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) & set(SPAN_METRICS + KERNEL_METRICS) == ON_THE_CPU
    assert all(res["metrics"][n]["value"] > 0 for n in ON_THE_CPU)
    assert phases == [(3, True, False), ("window", False, False), (2, True, False),
                      (4, False, False)] + [(1, True, True)] * 5
    assert calls == [False, False, True] and not tracer.enabled() and tracer.summary() == {}


def test_a_traced_run_without_a_tracer_prints_its_result(monkeypatch, small_run):
    calls = _calls(monkeypatch)
    phases = _stand_in_profile(monkeypatch)
    monkeypatch.setitem(sys.modules, TRACER, None)
    res = small_run("go2_stand.queued", trace=True)
    assert res["correct"] is True and res["failed"] == 0
    assert not set(res["metrics"]) & set(SPAN_METRICS + KERNEL_METRICS)
    assert {"busy_s", "window_s"} <= set(res["device"]) and calls == []
    assert [n for n, _, _ in phases] == [3, "window", 4]
