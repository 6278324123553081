"""ctrl_step_p90_ms: the 90th percentile, over every control step of the
window, of a step's latency from its start until the new plan's first action
is on the host (host clock), in ms.  Closed-loop traffic only."""

import statistics


def read(ctx):
    lat = ctx.window.latency
    if len(lat) < 2:
        return None
    return 1e3 * statistics.quantiles(lat, n=10, method="inclusive")[8]
