"""capture_s: host seconds that set-up spent capturing and instantiating
the planner's CUDA graphs (the program's own span, `CudaGraph.capture_s`
and `instantiate_s`)."""


def read(ctx):
    return ctx.capture_s
