"""reward_stack_ms: device time of the Go2 reward and termination stack's
kernel (`go2_post_physics`: a launch per rollout horizon step at the full
batch, and one in the executed step at B=1), per control step, in ms.

Read from the profiler's records of the traced steps, which replay the
untraced graph, so the time is the kernel's alone; the trace's count of
records is held against the program's launch counter
(`Go2EnvKernels.post_physics_launches`).  None on a program or env without
the kernel.
"""

from benchmark.harness.reading import kernel_ms_per_step


def read(ctx):
    return kernel_ms_per_step(ctx, "go2_post_physics", "Go2EnvKernels.post_physics_launches")
