"""torch port, tpu_dialmpc_torch/bench.py and the CLI's `bench`, on the CPU:
the rows' metric names, units and budgets against the repository root's
bench.py (its defaults and f-strings, and BENCH_r05.json's names), at a
tiny width with chains of 1 and 2 calls.  The root bench is imported for
its signatures and constants only, never run.  Timings on the CPU are not
the card's and are asserted for shape only; the roofline refuses the CPU.
"""

import inspect
import json
from pathlib import Path

import pytest

import bench as root_bench
from tpu_dialmpc_torch import bench
from tpu_dialmpc_torch.cli import main as tcli
from tpu_dialmpc_torch.telemetry import profile as prof

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(task="go2_stand", nsample=4, hsample=2, hnode=1, iters=1, n_substeps=1,
            device="cpu")


def _reverse_once_name(task, nsample, hsample, n_substeps, **_):
    return f"{task}_reverse_once_ms_N{nsample}_H{hsample}_sub{n_substeps}"  # bench.py:107


def _control_step_name(task, nsample, hsample, n_substeps, n_diffuse, **_):
    return f"{task}_control_step_ms_N{nsample}_H{hsample}" f"_sub{n_substeps}_d{n_diffuse}"


def _roofline_name(task, nsample, **_):
    return f"{task}_fused_rollout_vpu_roofline_N{nsample}"


def _defaults(fn):
    return {k: p.default for k, p in inspect.signature(fn).parameters.items()
            if p.default is not inspect.Parameter.empty}


@pytest.fixture
def short_chains(monkeypatch):
    orig = prof._amortized
    monkeypatch.setattr(prof, "_amortized",
                        lambda fn, args, **kw: orig(fn, args, r_lo=1, r_hi=2, reps=1))


@pytest.mark.parametrize("name,namer", [
    ("run_bench", _reverse_once_name),
    ("run_control_step_bench", _control_step_name),
    ("run_roofline", _roofline_name),
])
def test_defaults_give_the_root_benchs_names(name, namer):
    """The port's defaults are the root bench's (plus `device`), and at them
    the root bench's f-strings give BENCH_r05.json's metric names."""
    port, root = _defaults(getattr(bench, name)), _defaults(getattr(root_bench, name))
    assert port.pop("device") == "cuda"
    assert port == root
    parsed = json.loads((ROOT / "BENCH_r05.json").read_text())["parsed"]
    names = [parsed["metric"]] + [row["metric"] for row in parsed["extra"]]
    assert namer(**port) in names


def test_budgets_are_the_root_benchs():
    assert (bench.NORTH_STAR_MS, bench.CTRL_DT_MS) == (root_bench.NORTH_STAR_MS,
                                                       root_bench.CTRL_DT_MS)
    for fn, kw in bench.MEASURE_ALL_ROWS:
        inspect.signature(getattr(bench, fn)).bind(**kw)  # every row is a call the port takes


def test_reverse_once_row_on_the_cpu(short_chains):
    row = bench.run_bench(**TINY)
    assert row["metric"] == _reverse_once_name(**TINY)
    assert row["unit"] == "ms/iteration" and row["platform"] == "cpu"
    budget = root_bench.NORTH_STAR_MS * (4 / 2048.0) * (3 / 21.0)
    assert row["value"] > 0
    assert row["vs_baseline"] == pytest.approx(budget / row["value"], rel=1e-2, abs=1e-3)


def test_control_step_row_on_the_cpu(short_chains):
    row = bench.run_control_step_bench(**TINY)
    assert row["metric"] == _control_step_name(n_diffuse=2, **TINY)
    assert row["unit"] == "ms/control-step" and row["platform"] == "cpu"
    assert row["value"] > 0
    assert row["vs_baseline"] == pytest.approx(root_bench.CTRL_DT_MS / row["value"], rel=1e-2,
                                               abs=1e-3)


def test_roofline_refuses_the_cpu():
    with pytest.raises(prof.FusedPathUnavailable, match="fused path unavailable"):
        bench.run_roofline(nsample=4, hsample=2, n_substeps=1, device="cpu")


def test_cli_bench_full_on_the_cpu(short_chains, capsys):
    assert tcli.main(["bench", "--task", "go2_stand", "--device", "cpu", "--nsample", "4",
                      "--hsample", "2", "--hnode", "1", "--substeps", "1", "--iters", "1",
                      "--full"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "go2_stand_reverse_once_ms_N4_H2_sub1"
    assert line["platform"] == "cpu" and line["value"] > 0
    control, roof = line["extra"]
    assert control["metric"] == "go2_stand_control_step_ms_N4_H2_sub1_d2"
    assert roof["metric"] == "skipped" and "fused path unavailable" in roof["error"]
