"""Probes of a benchmark cell on the card, outside the harness's own runs.

    python3 tests/h1_cell_probe.py run <workload> <seed> <seconds> <trace>
    python3 tests/h1_cell_probe.py env_ops <workload> <replays>

`run` is one run of the cell as `benchmark/run.py` makes it (`run_cell`, the
same caches and arguments), printing its result line, and on standard error
the torso's height (qpos[2], the floating base's z) at the window's last
step and its lowest over the window (`[height]`), read from the window's
outputs after the window closes: whether the robot is still up when the
window ends.

`env_ops` times the env's ops around the physics at the cell's rollout
batch (Nsample + 1) without the tracer: one horizon step's PD map and
reward and termination stack (`_ctrl_batch`, `_post_physics`, the info
broadcast as the rollouts broadcast it) captured in a CUDA graph and
replayed `replays` times under `torch.profiler` (the harness's
`trace.profile`).  It prints one JSON line: the profiler's device time of
the replays' kernel records (copies left out) per horizon step
and per control step (2 x (Hsample + 1) horizon steps), the number the
span metric `env_ops_ms` reads with the span's event nodes added.
"""

import time

T_PROCESS = time.perf_counter()

import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from spans_probe import card_name  # noqa: E402


def run(workload, seed, seconds, trace):
    import torch

    from benchmark import run as bench_run
    from benchmark.harness import cells, program

    found = cells.find_cell(workload)
    bench_run._caches()
    non_finite = program.non_finite
    heights = {}

    def spy(outs):
        z = torch.stack([o[0].pipeline.qpos[2] for o in outs]).cpu()
        heights.update(seed=seed, steps=len(outs), last=float(z[-1]),
                       lowest=float(z.nan_to_num(nan=-1e9).min()))
        return non_finite(outs)

    program.non_finite = spy
    result = bench_run.run_cell(found, seed, seconds, bool(trace), "cuda:0", T_PROCESS)
    print(f"[height] {json.dumps(heights)}", file=sys.stderr)
    print(f"[card] {card_name()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)


def env_ops(workload, replays):
    import torch

    from benchmark.harness import cells, program
    from benchmark.harness import trace as tracing
    from tpu_dialmpc_torch.dynamics import fused
    from tpu_dialmpc_torch.envs.base import map_tensors

    found = cells.find_cell(workload)
    device = torch.device("cuda", 0)
    prog = program.build(found.config, device, True)
    env, pl = prog.env, found.config["planner"]
    B = pl["Nsample"] + 1
    state, _ = program.reset(prog)
    ps = state.pipeline

    def bcast(x):
        return x.expand((B,) + tuple(x.shape)).contiguous()

    qpos, qvel, ws = bcast(ps.qpos), bcast(ps.qvel), bcast(ps.qacc_warmstart)
    info = map_tensors(state.info, lambda x: x.expand((B,) + tuple(x.shape)))
    gen = torch.Generator(device=device).manual_seed(3)
    action = torch.rand((B, env.action_size), generator=gen, device=device) * 2 - 1
    ctrl = env._ctrl_batch(action, qpos, qvel)
    qpos2, qvel2, _, der_flat = env.fused_step(qpos, qvel, ws, ctrl)
    der = fused.split_derived(env.model, env.fused_step.spec, der_flat)

    def ops():
        c = env._ctrl_batch(action, qpos, qvel)
        return env._post_physics(qpos=qpos2, qvel=qvel2, **der, info=info, ctrl=c)

    stream, graph = torch.cuda.Stream(device), torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        ops()  # warm the allocator off the graph
    torch.cuda.synchronize()
    with torch.cuda.graph(graph, stream=stream):
        ops()
    for _ in range(5):
        graph.replay()
    torch.cuda.synchronize()

    def replay():
        for _ in range(replays):
            graph.replay()
        torch.cuda.synchronize()

    trace, _ = tracing.profile(replay, device)
    count = sum(c for c, _ in trace.kernels.values())
    per_horizon = 1e3 * sum(s for _, s in trace.kernels.values()) / replays
    horizon_steps = 2 * (pl["Hsample"] + 1)
    print(json.dumps({"workload": workload, "B": B, "replays": replays,
                      "kernels_per_horizon_step": count / replays,
                      "kernel_ms_per_horizon_step": per_horizon,
                      "kernel_ms_per_control_step": per_horizon * horizon_steps,
                      "card": card_name()}), flush=True)


if __name__ == "__main__":
    cmd, args = sys.argv[1], sys.argv[2:]
    if cmd == "run":
        run(args[0], int(args[1]), float(args[2]), int(args[3]))
    elif cmd == "env_ops":
        env_ops(args[0], int(args[1]))
    else:
        sys.exit(f"unknown command {cmd!r}: run or env_ops")
