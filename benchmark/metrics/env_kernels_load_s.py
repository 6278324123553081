"""env_kernels_load_s: host seconds of set-up in building or loading the
env step's kernels (the PD map and the reward stack; the program's span
`setup/env_kernels`, `Go2EnvKernels.library`)."""

from benchmark.harness.reading import span_seconds


def read(ctx):
    return span_seconds(ctx, "setup", "host_s", "setup/env_kernels")
