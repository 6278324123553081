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


def kernel_ms_per_step(ctx, pattern: str, counter: str) -> float | None:
    """`kernel_seconds` per traced control step, in ms, with the trace's
    count held against the program's launch counter `counter`
    (`program.launch_counts`' key); None where the counter reads no
    launch or the records do not match it."""
    launched = (getattr(ctx, "kernel_launches", None) or {}).get(counter)
    if not launched:
        return None
    got = kernel_seconds(ctx, pattern, launched)
    return None if got is None else 1e3 * got[0] / ctx.traced_steps


def span_seconds(ctx, phase: str, key: str, *paths: str) -> float | None:
    """The `key` seconds ("host_s", "self_s" or "device_s") of the
    program's spans `paths`, summed, as its tracer recorded them over
    `phase` of a traced run ("setup", "host" or "device", `run.run_cell`);
    None where one of them is absent."""
    spans = (getattr(ctx, "spans", None) or {}).get(phase, {})
    if any(p not in spans for p in paths):
        return None
    return sum(spans[p][key] for p in paths)


def span_ms_per_step(ctx, phase: str, key: str, *paths: str) -> float | None:
    """`span_seconds` per control step that the phase ran, in ms."""
    s = span_seconds(ctx, phase, key, *paths)
    return None if s is None else 1e3 * s / ctx.span_steps[phase]
