"""The reward gaps of a benchmark run's judged steps, taken apart, on the
card: the go2_stand cell's closed loop from the seed (deterministic in the
step index, so a run's judged steps are reproduced), then for each judged
step the rollouts of its candidates through the Go2 env kernels and
through the plain PyTorch ops (`_ctrl_batch_plain`, `_post_physics_plain`),
each against the float64 reference, in units of the reference's std, as
`benchmark/harness/correct.py` reads them (p50, p90, max).

    python3 tests/reward_gap_probe.py <seed> <window steps>

<window steps> is the `attempted` of the run to reproduce (it picks the
judged steps).  Prints one JSON line.
"""
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT)]  # the checkout: the port and benchmark/

import torch  # noqa: E402

from benchmark.harness import cells, correct, loop, program  # noqa: E402
from tpu_dialmpc_torch.envs.base import LeanEnvState, LeanPipelineState, StateInfo  # noqa: E402


def q(g):
    t = torch.quantile(g.float().flatten(), torch.tensor([0.5, 0.9], device=g.device))
    return [float(t[0]), float(t[1]), float(g.max())]


def main():
    seed, n_window = int(sys.argv[1]), int(sys.argv[2])
    found = cells.find_cell("go2_stand.realtime")
    config, traffic = found.config, found.traffic
    device = torch.device("cuda", 0)
    prog = program.build(config, device, True)
    state0, Y0 = program.reset(prog)
    pl = config["planner"]
    noise = loop.Noise(seed, (pl["Ndiffuse"], pl["Nsample"], pl["Hnode"] + 1,
                              prog.env.action_size), device, Y0.dtype)
    begin = (state0, Y0)
    warm = loop.run(prog.step, state0, Y0, noise, 0, traffic, device,
                    n=int(traffic["warmup_steps"]), start=begin)
    chosen = correct.pick_steps(seed, n_window, config["check"]["steps"])
    window = loop.run(prog.step, warm.state, warm.Y, noise, warm.k, traffic, device,
                      n=max(chosen) + 1, start=begin)
    judged = []
    for i in chosen:
        st_in, Y_in = window.ins[i]
        judged.append(correct.snapshot(dict(
            inp=program.state_dict(st_in), Y_in=Y_in, noise=noise(warm.k + i),
            out=program.outputs(window.outs[i]))))
    ref = correct.Reference(config, device)
    rows_per_block = config["check"]["rows_per_block"]
    numbers = correct.judge(ref, judged, rows_per_block)
    env = prog.env
    P, put = ref.planner, ref.put
    nd = pl["Ndiffuse"]
    per_step = []
    for i, s in zip(chosen, judged):
        Y = P.shift(put(s["Y_in"]))
        rews = put(s["out"]["rews"])
        cands = []
        for it in range(nd):
            C = P.candidates(Y, put(s["noise"][it]), it)
            cands.append(C)
            _, Y = P.update(rews[it], C)
        us = P.node2u(torch.cat(cands))
        n_rows = us.shape[0]
        st = s["out"]["state"]

        def rows(x):
            x = put(x)
            return x.expand((n_rows,) + tuple(x.shape))

        info = {k: rows(v) for k, v in st["info"].items()}
        mean_ref = correct._rollouts(ref, rows(st["qpos"]), rows(st["qvel"]), rows(st["ws"]),
                                     info, us, rows_per_block).view(nd, -1)
        mean_ref = correct.worst_for_non_finite(mean_ref)
        std = torch.sqrt(torch.mean((mean_ref - mean_ref.mean(-1, keepdim=True)) ** 2, -1,
                                    keepdim=True)).clamp(min=1e-12)
        state = LeanEnvState(
            pipeline=LeanPipelineState(qpos=st["qpos"].to(device).float(),
                                       qvel=st["qvel"].to(device).float(),
                                       qacc_warmstart=st["ws"].to(device).float()),
            obs=None, reward=None, done=None,
            info=StateInfo(**{k: v.to(device) for k, v in st["info"].items()}))
        u32 = us.float().to(device)
        r_k = env.rollout_batch(state, u32).double().mean(1).view(nd, -1)
        post, ctrl = env._post_physics, env._ctrl_batch
        env._post_physics = lambda ctrl=None, **kw: env._post_physics_plain(**kw)
        env._ctrl_batch = env._ctrl_batch_plain
        r_p = env.rollout_batch(state, u32).double().mean(1).view(nd, -1)
        env._post_physics, env._ctrl_batch = post, ctrl
        r_k, r_p = correct.worst_for_non_finite(r_k), correct.worst_for_non_finite(r_p)
        prog_r = correct.worst_for_non_finite(rews)
        per_step.append(dict(
            step=i, std=std.flatten().tolist(),
            prog_vs_ref=q((prog_r - mean_ref).abs() / std),
            kernel_vs_ref=q((r_k - mean_ref).abs() / std),
            plain_vs_ref=q((r_p - mean_ref).abs() / std),
            kernel_vs_plain=q((r_k - r_p).abs() / std),
            kernel_vs_plain_abs=float((r_k - r_p).abs().max()),
            prog_vs_kernel=q((prog_r - r_k).abs() / std)))
    print("RESULT " + json.dumps(dict(seed=seed, chosen=chosen, numbers=numbers,
                                      steps=per_step)), flush=True)


if __name__ == "__main__":
    main()
