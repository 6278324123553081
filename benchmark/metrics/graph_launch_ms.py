"""graph_launch_ms: host time of the CUDA graph launches (the program's
span `graph/replay`, host clock around `CUDAGraph.replay`), over the steps
of a traced run's host-span phase (the untraced graph, no profiler
running), per control step, in ms."""

from benchmark.harness.reading import span_ms_per_step


def read(ctx):
    return span_ms_per_step(ctx, "host", "host_s", "graph/replay")
