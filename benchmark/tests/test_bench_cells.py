"""BENCHMARK.json against the benchmark's contract, and cells found by name:
every part of a cell is a file of its own, so a new cell is new files."""

import json
import re
import shutil

import pytest

from benchmark.harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keeps_to_the_contract():
    spec = cells.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= spec["run_seconds"] <= 51
    n = len(spec["workloads"])
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, n // 4)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(names)) == len(names)
    assert "setup_s" in [m["name"] for m in spec["end_to_end"]]
    for m in spec["end_to_end"]:
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in [e["name"] for e in spec["end_to_end"]]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["source"] in SOURCES
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(spec)) <= 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in cells.load_spec()["workloads"]])
def test_every_cell_is_found_with_its_parts(cell):
    found = cells.find_cell(cell)
    assert found.config["planner"]["Nsample"] > 0 and found.traffic["loop"] in ("closed", "queued")
    for m in found.end_to_end + found.per_layer:
        assert callable(cells.metric_reader(m["name"]))
    assert "setup_s" in [m["name"] for m in found.end_to_end]
    assert len(found.end_to_end) >= 2 and found.per_layer


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError, match="unknown workload"):
        cells.find_cell("go2_stand.nonesuch")


def test_a_new_cell_is_new_files_alone(tmp_path):
    """A configuration, a traffic mix and a cell added as files and entries,
    with no edit to a file that is there, are found by name."""
    bench = tmp_path / "benchmark"
    shutil.copytree(cells.BENCH / "configs", bench / "configs")
    shutil.copytree(cells.BENCH / "traffic", bench / "traffic")
    spec = cells.load_spec()
    config = json.loads((bench / "configs" / "go2_stand.json").read_text())
    config["planner"]["Nsample"] = 8192
    (bench / "configs" / "go2_stand_n8192.json").write_text(json.dumps(config))
    traffic = dict(json.loads((bench / "traffic" / "queued.json").read_text()), max_in_flight=2)
    (bench / "traffic" / "queued_shallow.json").write_text(json.dumps(traffic))
    spec["configs"].append(dict(spec["configs"][0], name="go2_stand_n8192",
                                file="benchmark/configs/go2_stand_n8192.json"))
    spec["workloads"].append({"name": "go2_stand_n8192.queued_shallow",
                              "config": "go2_stand_n8192", "traffic": "queued_shallow",
                              "chips": 1, "why": "a wider planner"})
    found = cells.find_cell("go2_stand_n8192.queued_shallow", spec, bench=bench)
    assert found.config["planner"]["Nsample"] == 8192 and found.traffic["max_in_flight"] == 2
    assert {m["name"] for m in found.per_layer} >= {"device_idle_pct", "kernels_per_step"}
