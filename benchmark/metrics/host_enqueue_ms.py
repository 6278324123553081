"""host_enqueue_ms: the benchmark's own span, host clock from the call to
the control step to its return (before any read-back), averaged over the
window's steps, in ms."""


def read(ctx):
    e = ctx.window.enqueue
    return 1e3 * sum(e) / len(e) if e else None
