"""planner_ops_ms: device time of the planner's own ops (the program's
spans `shift`, `candidates` and `score_update`: the plan's shift, the
noise scaled into candidates and their controls, the softmax and weighted
update), summed, per control step, in ms.

Device time is the program's own event timing of its traced graph (a
second graph of the control step with two timing events around each span,
replayed only while device spans are on; `telemetry/spans.py`), not the
profiler's records.
"""

from benchmark.harness.reading import span_ms_per_step

PATHS = ("shift", "candidates", "score_update")


def read(ctx):
    return span_ms_per_step(ctx, "device", "device_s", *PATHS)
