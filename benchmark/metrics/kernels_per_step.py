"""kernels_per_step: device kernel records per control step in the traced
steps (a count, the physics kernel's included)."""


def read(ctx):
    if ctx.trace is None:
        return None
    return sum(c for c, _ in ctx.trace.kernels.values()) / ctx.traced_steps
