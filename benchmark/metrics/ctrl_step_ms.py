"""ctrl_step_ms: the window's wall time over the control steps completed in
it (host clock), in ms."""


def read(ctx):
    w = ctx.window
    return 1e3 * w.wall / len(w.outs) if w.outs else None
