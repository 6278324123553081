"""What the per-layer readers share: a kernel pattern's device seconds in
the traced window, held against the program's launch counter."""

from __future__ import annotations


def kernel_seconds(ctx, pattern: str, launched: int | None = None):
    """(device seconds, records) of the traced kernels whose name holds
    `pattern`.  Where `launched` is given, the trace's count is held
    against it: one record lost from the trace is made up in proportion (a
    trace can lose the record of its last graph replay's tail), more makes
    the reading None."""
    if ctx.trace is None:
        return None
    hits = [v for n, v in ctx.trace.kernels.items() if pattern in n]
    count, seconds = sum(c for c, _ in hits), sum(s for _, s in hits)
    if launched is not None:
        if count == 0 or not launched - 1 <= count <= launched:
            return None
        seconds *= launched / count
    return seconds, count
