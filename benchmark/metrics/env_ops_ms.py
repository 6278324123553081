"""env_ops_ms: device time of the env's ops around the physics in the
rollouts (the program's spans `rollout/ctrl`, the PD map, and
`rollout/reward`, the reward and termination stack, at every horizon step),
per control step, in ms.  On H1 each span holds the env's PyTorch ops, so
its two event nodes are a small share of it.

Device time is the program's own event timing of its traced graph
(`telemetry/spans.py`), as `execute_ms` reads it; None where a span is
absent.
"""

from benchmark.harness.reading import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "device", "device_s", "rollout/ctrl", "rollout/reward")
