"""env_build_s: host seconds of set-up in building the task's env (the
program's span `setup/env`, `envs/registry.get_env`), its self time: less
the spans inside it, such as the kernels' loads."""

from benchmark.harness.reading import span_seconds


def read(ctx):
    return span_seconds(ctx, "setup", "self_s", "setup/env")
