"""first_call_s: host seconds of set-up in each captured unit's eager first
call (the program's span `setup/first_call`: the kernels' first launches,
cached constants, the graph's side stream), its self time: less the spans
inside it, such as a kernel's load."""

from benchmark.harness.reading import span_seconds


def read(ctx):
    return span_seconds(ctx, "setup", "self_s", "setup/first_call")
