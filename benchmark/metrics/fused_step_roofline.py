"""fused_step_roofline: the physics kernel's share of its roofline, in %:
the frozen fp32 op count of a control step (the configuration's ops per
sample-substep x sample-substeps per step) at the published 67 TFLOP/s,
over the kernel's device time per step.  Its bytes (under 1 KB per sample)
do not bound it."""

from benchmark.harness.reading import kernel_seconds
from benchmark.harness.work import PEAK_FP32_OPS_PER_S

PATTERN = "fused_step_kernel"


def read(ctx):
    got = kernel_seconds(ctx, PATTERN, ctx.traced_launches)
    if got is None or got[0] <= 0:
        return None
    return 100.0 * ctx.ops_per_step / (PEAK_FP32_OPS_PER_S * got[0] / ctx.traced_steps)
