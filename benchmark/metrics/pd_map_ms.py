"""pd_map_ms: device time of the Go2 PD map's kernel (`go2_ctrl`: a launch
per rollout horizon step at the full batch, and one in the executed step at
B=1), per control step, in ms.

Read from the profiler's records of the traced steps, which replay the
untraced graph, so the time is the kernel's alone; the trace's count of
records is held against the program's launch counter
(`Go2EnvKernels.ctrl_launches`).  None on a program or env without the
kernel.
"""

from benchmark.harness.reading import kernel_ms_per_step


def read(ctx):
    return kernel_ms_per_step(ctx, "go2_ctrl", "Go2EnvKernels.ctrl_launches")
