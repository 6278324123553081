"""setup_s: host seconds from the process's start to the first timed step:
imports, CUDA start, the env and the kernel (built or loaded), the warm-up
steps and the graphs' capture."""


def read(ctx):
    return ctx.setup_s
