"""The work a control step does, from the frozen op counts in the
configuration files."""

import pytest

from benchmark.harness import cells, work


@pytest.mark.parametrize("config, ops, per_step", [
    ("go2_stand", 38_881, 3.3142e10),
])
def test_work_per_step(config, ops, per_step):
    found = cells.find_cell(f"{config}.realtime")
    c = found.config
    assert c["ops_per_sample_substep"]["value"] == ops
    pl = c["planner"]
    n_calls = (pl["Nsample"] + 1) * (pl["Hsample"] + 1) * pl["Ndiffuse"] + 1
    assert work.sample_substeps_per_step(pl, c["env"]["n_substeps"]) == n_calls * 8
    assert work.ops_per_step(c) == pytest.approx(per_step, rel=5e-4)


def test_roofline_reads_the_frozen_count_at_the_published_peak():
    from types import SimpleNamespace

    from benchmark.metrics import fused_step_roofline

    found = cells.find_cell("go2_stand.realtime")
    ops = work.ops_per_step(found.config)
    trace = SimpleNamespace(kernels={"fused_step_kernel(x)": (43, 0.0401)})
    ctx = SimpleNamespace(trace=trace, traced_launches=43, traced_steps=1, ops_per_step=ops)
    assert fused_step_roofline.read(ctx) == pytest.approx(100 * ops / (67e12 * 0.0401))
    # a record lost from the trace is made up; two are not
    ctx.traced_launches = 44
    assert fused_step_roofline.read(ctx) == pytest.approx(100 * ops / (67e12 * 0.0401 * 44 / 43))
    ctx.traced_launches = 45
    assert fused_step_roofline.read(ctx) is None
