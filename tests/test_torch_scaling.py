"""torch port, shard/scaling.py and the CLI's `scaling`, on the CPU: the
predicted-efficiency rows against the JAX package's, and the two measured
reports on the stub env with the structure tests/test_scaling.py asserts
of the JAX harness.  Ranks beyond the first are processes spawned under
gloo (tests/torch_shard_ranks.py: torch and the port only).  Timings on
the CPU are not the card's and are asserted for shape only.
"""

import json

import numpy as np
import pytest

import torch_shard_ranks as ranks
from tpu_dialmpc.shard.scaling import predicted_efficiency_rows as jax_predicted_rows
from tpu_dialmpc_torch.cli import main as tcli
from tpu_dialmpc_torch.shard import scaling
from tpu_dialmpc_torch.telemetry import profile as prof

ROW_KEYS = {"devices", "nsample", "ms_per_iteration", "iterations_per_sec",
            "efficiency_vs_linear"}


@pytest.fixture
def short_chains(monkeypatch):
    """Chains of 1 and 2 calls, one repetition, in this process."""
    orig = prof._amortized
    monkeypatch.setattr(prof, "_amortized",
                        lambda fn, args, **kw: orig(fn, args, r_lo=1, r_hi=2, reps=1))


@pytest.mark.parametrize("kw", [
    dict(compute_ms=2.5, payload_bytes=320, n_hosts_list=(1, 2, 4), latency_us_list=(100.0,),
         dcn_gbps=25.0),
    dict(compute_ms=72.559, payload_bytes=(5 + 1) * 12 * 4 + 8 * 4),
])
def test_predicted_efficiency_rows_equal_jax(kw):
    assert scaling.predicted_efficiency_rows(**kw) == jax_predicted_rows(**kw)


def test_scaling_report_on_the_stub_one_and_two_ranks():
    rows = scaling.scaling_report(nsample=32, hsample=6, hnode=2, mesh_sizes=[1, 2],
                                  env=ranks.stub_env, device="cpu")
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) == ROW_KEYS
        assert r["ms_per_iteration"] > 0 and r["nsample"] == 32
        assert np.isfinite(r["iterations_per_sec"])
        assert r["iterations_per_sec"] == pytest.approx(1e3 / r["ms_per_iteration"])
    assert rows[0]["efficiency_vs_linear"] == 1.0
    assert rows[1]["efficiency_vs_linear"] == pytest.approx(
        rows[1]["iterations_per_sec"] / rows[0]["iterations_per_sec"] / 2)


def test_collective_overhead_report_structure():
    """Unsharded against 2 ranks on the same device (the CPU): both timings
    positive, the JAX payload (Hnode+1)·nu·4 + 8·4 bytes, and the port's:
    the (Hnode+1, nu) partials, four scalars and two zero-padded
    (Nsample+1,) buffers, in the stub's float64."""
    row = scaling.collective_overhead_report(nsample=64, hsample=6, hnode=2, n_devices=2,
                                             env=ranks.stub_env, device="cpu")
    assert row["unsharded_ms"] > 0 and row["sharded_ms"] > 0
    assert row["payload_bytes_per_iteration"] == 3 * 4 * 4 + 32
    assert row["port_payload_bytes_per_iteration"] == (3 * 4 + 4 + 2 * 65) * 8
    assert row["n_devices_virtual"] == 2 and row["nsample"] == 64
    assert abs(row["overhead_ms"] - (row["sharded_ms"] - row["unsharded_ms"])) < 1e-9
    assert row["overhead_frac"] == pytest.approx(row["overhead_ms"] / row["unsharded_ms"])


def test_cli_scaling_on_the_cpu_is_one_rank(short_chains, capsys):
    assert tcli.main(["scaling", "--task", "go2_stand", "--device", "cpu", "--nsample", "4",
                      "--hsample", "2", "--hnode", "1", "--substeps", "1"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert set(row) == ROW_KEYS
    assert row["devices"] == 1 and row["nsample"] == 4 and row["efficiency_vs_linear"] == 1.0
    assert row["ms_per_iteration"] > 0


def test_scaling_default_mesh_sizes_follow_the_device(monkeypatch):
    seen = []
    monkeypatch.setattr(scaling, "_sharded_sec",
                        lambda env, cfg, n, device, backend=None:
                        seen.append((n, device)) or (1.0, 0))
    scaling.scaling_report(device="cpu", env=ranks.stub_env)
    monkeypatch.setattr(scaling.torch.cuda, "device_count", lambda: 4)
    scaling.scaling_report(device="cuda", env=ranks.stub_env)
    # the CPU: one rank; four cards: 1, 2 and 4 ranks, one card each
    assert seen == [(1, "cpu"), (1, "cuda"), (2, None), (4, None)]
