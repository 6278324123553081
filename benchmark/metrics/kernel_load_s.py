"""kernel_load_s: host seconds of set-up in building or loading the physics
kernel's library and uploading its model (the program's span
`setup/kernel`, `FusedStep.library`)."""

from benchmark.harness.reading import span_seconds


def read(ctx):
    return span_seconds(ctx, "setup", "host_s", "setup/kernel")
