"""torch port, telemetry/profile.py and the CLI's `profile`, on the CPU: the
roofline's operation count against the JAX package's, the phase-timing
report's shape, the profiler trace, the estimators, the fp32 microbench's
plain version, and the refusals off the card (no timing of anything but
the CUDA kernel and the card).  The kernel itself: tests/test_torch_cuda.py.

The JAX count (`tpu_dialmpc.telemetry.profile.count_fused_ops`) traces the
substep into a jaxpr and counts its arithmetic equations, including the
nq + nv + 1 adds that sum its outputs into one scalar; the port's
`arith_ops_per_substep` is `fused.count_ops` without the selects, which
counts the substep alone.  The two are held equal, exactly, after those
adds.

Timings on the CPU are not the card's and are asserted for shape only:
`phase_timings` reads the tracer's spans of an eager `reverse_once` on the
host clock there (a captured one's on the card).
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from torch_port_helpers import jax_standin_model, port_model_from
from tpu_dialmpc.telemetry import profile as jprof
from tpu_dialmpc_torch.cli import main as tcli
from tpu_dialmpc_torch.telemetry import profile as prof
from tpu_dialmpc_torch.telemetry import spans

PHASE_KEYS = {"reverse_once_ms", "sample_spline_ms", "rollout_ms", "score_update_ms"}


@functools.lru_cache(maxsize=None)
def _counts(scene):
    mp = pytest.MonkeyPatch()
    try:
        jm = jax_standin_model(mp, scene)
    finally:
        mp.undo()
    tm = port_model_from(jm)
    return jprof.count_fused_ops(jm, 8), prof.count_fused_ops(tm, 8), tm


@pytest.mark.parametrize("scene", ["go2_force", "go2_force_crate"])
def test_count_fused_ops_matches_the_jax_count(scene):
    want, got, tm = _counts(scene)
    assert set(got) == set(want) - {"n"}  # "n": the JAX function's scratch counter
    assert got["arith_ops_per_substep"] + tm.nq + tm.nv + 1 == want["arith_ops_per_substep"]
    assert got["flops_per_sample_substep"] == float(got["arith_ops_per_substep"])
    assert got["n_substeps"] == 8
    # every dispatched op but views: more than the arithmetic, and of the
    # JAX count's order (its unit is a jaxpr equation, not an aten op)
    assert got["arith_ops_per_substep"] < got["vector_ops_per_substep"]
    assert abs(got["vector_ops_per_substep"] / want["vector_ops_per_substep"] - 1) < 0.15


def test_crate_scene_costs_more_ops():
    flat, crate = _counts("go2_force")[1], _counts("go2_force_crate")[1]
    assert crate["arith_ops_per_substep"] > 4 * flat["arith_ops_per_substep"]
    assert crate["vector_ops_per_substep"] > flat["vector_ops_per_substep"]


def test_roofline_and_microbenchmarks_refuse_the_cpu():
    with pytest.raises(RuntimeError, match="fused path unavailable"):
        prof.fused_kernel_roofline(nsample=8, n_substeps=1, hsample=2, device="cpu")
    if not torch.cuda.is_available():
        for fn in (prof.fp32_peak_ops_per_sec, prof.hbm_copy_bytes_per_sec):
            with pytest.raises(RuntimeError, match="CUDA card"):
                fn()


def test_capture_trace_returns_fn_value_and_writes_a_trace(tmp_path):
    out = prof.capture_trace(str(tmp_path / "trace"), lambda x: (x * x).sum(),
                             torch.arange(8.0))
    assert float(out) == pytest.approx(140.0)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "aten::mul" in names and "aten::sum" in names


def test_amortized_attempts_spread():
    """return_attempts gives every attempt's slope; the estimate is their min."""
    sec, attempts = prof._amortized(lambda acc: acc + 1.0, (), r_lo=1, r_hi=4, reps=1,
                                    attempts=3, return_attempts=True)
    assert len(attempts) == 3 and sec == min(attempts)
    assert all(a > 0 for a in attempts)


def test_phase_timings_shape_tiny():
    """One call's phases (reps=1): each spent, the three inside the whole
    call; the tracer left off as it was."""
    assert not spans.enabled()
    out = prof.phase_timings(task="go2_stand", nsample=8, hsample=4, hnode=2, n_substeps=1,
                             device="cpu", reps=1)
    assert set(out) == PHASE_KEYS
    assert all(v > 0 for v in out.values())
    parts = out["sample_spline_ms"] + out["rollout_ms"] + out["score_update_ms"]
    assert parts <= out["reverse_once_ms"]
    assert not spans.enabled()


def test_fma_chain_plain_version_is_the_recurrence():
    """The microbench's plain version on the CPU (the wrapper's path for CPU
    tensors, no launch): the closed form of the recurrence acc <- a acc + b
    from x0 + j, summed over j, to 1e-5 (k float32 roundings)."""
    chain = prof.FmaChain()
    x0 = torch.linspace(0.5, 1.5, 64)
    a = torch.full((64,), 1.0 + 2.0**-12)
    b = torch.full((64,), 1e-3)
    k = 512
    got = chain(x0, a, b, k)
    assert chain.launches == 0 and got.dtype == torch.float32 and got.shape == (64,)
    a64, b64 = float(a[0]), float(b[0])
    j = np.arange(chain.NACC)
    start = x0.double().numpy()[:, None] + j
    want = (a64**k * start + b64 * (a64**k - 1) / (a64 - 1)).sum(1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    # every step moves the result: one step fewer is far outside the tolerance
    assert np.abs(chain(x0, a, b, k - 1).numpy() / want - 1).min() > 1e-4
    assert chain.ops(64, k) == 2 * chain.NACC * k * 64


def test_cli_profile_runs_on_the_cpu(tmp_path, capsys):
    trace = tmp_path / "trace"
    assert tcli.main(["profile", "--task", "go2_stand", "--device", "cpu", "--nsample", "4",
                      "--hsample", "2", "--substeps", "1", "--out", str(trace)]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "phase timings (spans of one reverse_once, ms):"
    assert {line.split(":")[0].strip() for line in lines[1:5]} == PHASE_KEYS
    assert lines[5].startswith("roofline skipped: fused path unavailable")
    assert lines[-1] == f"profiler trace written to {trace}"
    assert os.path.getsize(trace / "trace.json") > 0
