"""fused_kernel_ms: device time of the physics kernel's records in the
traced steps, per control step, in ms.  The trace's count of records is held
against the program's launch counter (`FusedStep.launches`)."""

from benchmark.harness.reading import kernel_seconds

PATTERN = "fused_step_kernel"


def read(ctx):
    got = kernel_seconds(ctx, PATTERN, ctx.traced_launches)
    return None if got is None else 1e3 * got[0] / ctx.traced_steps
