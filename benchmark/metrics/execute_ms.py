"""execute_ms: device time of the executed step (the program's span
`execute`: the env step that carries out the plan's first action, its PD
map, physics at B=1 and reward stack), per control step, in ms.

Device time is the program's own event timing of its traced graph (a
second graph of the control step with two timing events around each span,
replayed only while device spans are on; `telemetry/spans.py`), not the
profiler's records.
"""

from benchmark.harness.reading import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "device", "device_s", "execute")
