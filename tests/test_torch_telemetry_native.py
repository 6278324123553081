"""torch port, the native telemetry sink (`csrc/telemetry_sink.cpp`, loaded by
`telemetry/native.py`) and `TelemetryStream`'s backends: the sink builds
with the host compiler from the port's own copy of the source, round-trips
pushes to JSONL, drops on a full ring instead of blocking, and "native"
raises where it cannot be built while "auto" falls back to the Python
writer; a CLI `run` writes the same records through either backend."""

import json
import time

import pytest

from tpu_dialmpc_torch.cli import main as tcli
from tpu_dialmpc_torch.dynamics import _build
from tpu_dialmpc_torch.telemetry import TelemetryStream, native


def test_sink_builds_from_the_ports_source():
    lib = native.load_telemetry_sink()
    assert lib is not None
    built = list(_build.BUILD_DIR.glob("telemetry_sink_host_*.so"))
    assert built, "no host build of csrc/telemetry_sink.cpp in build/kernels"


def test_pushes_round_trip_to_jsonl(tmp_path):
    path = tmp_path / "n.jsonl"
    sink = native.NativeSink(str(path), capacity=64)
    records = [{"t": i, "v": i * 0.5, "tag": f"r{i}"} for i in range(20)]
    assert all(sink.push(json.dumps(r)) for r in records)
    sink.close()
    assert (sink.accepted, sink.dropped) == (20, 0)
    assert [json.loads(line) for line in path.read_text().splitlines()] == records


def test_full_ring_drops_rather_than_blocks(tmp_path):
    path = tmp_path / "d.jsonl"
    sink = native.NativeSink(str(path), capacity=2)
    t0 = time.perf_counter()
    accepted = sum(sink.push(json.dumps({"t": i})) for i in range(10_000))
    elapsed = time.perf_counter() - t0
    # longer than a slot (4 KB): refused, neither truncated nor counted as a drop
    assert not sink.push("x" * 5000)
    sink.close()
    assert elapsed < 5.0
    assert sink.dropped > 0 and sink.accepted == accepted
    assert sink.accepted + sink.dropped == 10_000
    lines = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(lines) == accepted and lines[0]["t"] == 0
    assert [r["t"] for r in lines] == sorted(r["t"] for r in lines)  # in push order


def test_native_raises_and_auto_falls_back_when_the_build_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib_handle", None)
    monkeypatch.setattr(_build, "HOST_CXX", str(tmp_path / "no-such-c++"))
    with pytest.raises(RuntimeError, match="native telemetry sink unavailable"):
        TelemetryStream(str(tmp_path / "n.jsonl"), backend="native")
    with TelemetryStream(str(tmp_path / "a.jsonl"), backend="auto") as s:
        s.emit({"t": 0})
        time.sleep(0.2)
    assert s.backend == "python"
    assert json.loads((tmp_path / "a.jsonl").read_text()) == {"t": 0}


def test_cli_run_writes_the_same_records_through_both_backends(tmp_path, capsys):
    records = {}
    for backend in ("auto", "python"):
        path = tmp_path / f"{backend}.jsonl"
        assert tcli.main(["run", "--task", "go2_stand", "--device", "cpu", "--nsample", "4",
                          "--hsample", "2", "--substeps", "1", "--n-steps", "3",
                          "--telemetry", str(path), "--telemetry-backend", backend]) == 0
        records[backend] = [json.loads(line) for line in path.read_text().splitlines()]
    capsys.readouterr()
    assert [r["t"] for r in records["auto"]] == [0, 1, 2]
    for a, p in zip(records["auto"], records["python"]):
        assert list(a) == list(p)
        assert {k: v for k, v in a.items() if k != "time"} == \
            {k: v for k, v in p.items() if k != "time"}


def test_auto_picks_the_native_sink_where_it_builds(tmp_path):
    with TelemetryStream(str(tmp_path / "t.jsonl")) as s:
        assert s.backend == "native"
    with TelemetryStream(str(tmp_path / "p.jsonl"), backend="python") as s:
        assert s.backend == "python"
    with TelemetryStream() as s:
        assert s.backend is None  # no path: nothing written
