"""device_idle_pct: 100 x (1 - device busy / wall) over the traced steps,
busy the union of every kernel, copy and set record in the window."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
