"""other_kernels_ms: device time of every kernel record but the physics
kernel's in the traced steps (the planner's ops, the PD map and reward
stack, the copies into and out of the graph as kernels), per control step,
in ms."""

PATTERN = "fused_step_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    s = sum(sec for n, (_, sec) in ctx.trace.kernels.items() if PATTERN not in n)
    return 1e3 * s / ctx.traced_steps
