"""The harness rehearsed on the CPU at a small size: the result line, the
window's statistics, and no result without a card."""

import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from benchmark.harness import loop
from benchmark.harness.cells import ROOT
from benchmark.metrics import ctrl_step_ms, ctrl_step_p90_ms


def test_the_result_line(small_run):
    res = small_run("go2_stand.realtime")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) >= {"ctrl_step_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())


def test_a_queued_window(small_run):
    res = small_run("go2_stand.queued")
    assert res["correct"] is True and "ctrl_step_p90_ms" not in res["metrics"]


class _Clock:
    """A host clock that a step advances by its own latency."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


@pytest.mark.parametrize("stalled", [None, 3])
def test_a_stall_moves_the_rate_and_the_tail(stalled):
    """ctrl_step_ms is the whole window over the steps in it, and the p90
    is over every step: one step held in a stall moves both."""
    clock = _Clock()
    steps = []

    def step(state, Y, eps):
        clock.t += 0.050 if len(steps) != stalled else 0.500
        steps.append(eps)
        return state, Y, None

    w = loop.run(step, None, torch.zeros(2, 1), lambda k: k, 0, {"loop": "closed"}, "cpu", seconds=0.24,
                 clock=clock)
    ctx = SimpleNamespace(window=w)
    mean, p90 = ctrl_step_ms.read(ctx), ctrl_step_p90_ms.read(ctx)
    if stalled is None:
        assert len(w.outs) == 5 and mean == pytest.approx(50.0) and p90 == pytest.approx(50.0)
    else:
        assert len(w.outs) == 4 and mean == pytest.approx(650 / 4) and p90 > 300.0


def test_no_card_no_result():
    """Without a card the run exits with 3 and prints nothing on stdout."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "go2_stand.realtime",
                          "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 3 and out.stdout == "" and "CUDA card" in out.stderr


def test_an_unknown_cell_exits_without_a_result():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "nonesuch",
                          "--seed", "7", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 2 and out.stdout == "" and "unknown workload" in out.stderr


@pytest.mark.cuda
def test_a_traced_run_reads_every_per_layer_metric():
    """On the card: a short traced run reports each per-layer metric of the
    cell, busy and window seconds, and a breakdown."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the trace reads the device's records")
    from benchmark import run as bench_run
    from benchmark.harness import cells

    found = cells.find_cell("go2_stand.queued")
    t0 = time.perf_counter()
    res = bench_run.run_cell(found, 17, 2.0, True, "cuda:0", t0)
    assert set(res["metrics"]) == {m["name"] for m in found.per_layer}
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"] and res["correct"] is True
