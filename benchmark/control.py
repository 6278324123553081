"""The readings that the comparison's limits are set from, on the card at a
cell's own size: the program's numbers on many seeds, and the control's
(the reference in bfloat16, put in the program's place) on some of them.

    python3 benchmark/control.py --workload <cell> --seeds 1-12 --control-seeds 3 --seconds 36

For each seed: the cell's set-up from the reset state, its warm-up steps, a
window at the cell's own load (long enough to reach into its episodes), then
the judged steps drawn as a run draws them, judged against the float64 reference (`correct.judge`).  For
the first `--control-seeds` seeds the same steps' inputs go through the
reference in bfloat16 (`correct.reference_step`), judged the same way.  One
JSON line per reading (the program's with its count of non-finite steps,
the judged steps' indices and the torso's lowest height); the last line gives, for each number, the largest
program reading and the smallest control reading.  The benchmark's own runs
do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def seeds(text: str) -> list:
    if "-" in text:
        a, b = text.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(x) for x in text.split(",")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=seeds, default=seeds("1-12"))
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=36.0)
    p.add_argument("--device", default="cuda:0")
    args = p.parse_args(argv)

    import torch

    from benchmark.harness import cells, correct, loop, program

    found = cells.find_cell(args.workload)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA card", file=sys.stderr)
        return 3
    config, traffic, dev = found.config, found.traffic, args.device
    prog = program.build(config, dev, True if dev.startswith("cuda") else "auto")
    ref = correct.Reference(config, dev)
    low = correct.Reference(config, dev, dtype=torch.bfloat16)
    pl = config["planner"]
    worst, least = {}, {}
    for i, seed in enumerate(args.seeds):
        noise = loop.Noise(seed, (pl["Ndiffuse"], pl["Nsample"], pl["Hnode"] + 1,
                                  prog.env.action_size), dev, torch.float32)
        s0, Y0 = program.reset(prog)
        warm = loop.run(prog.step, s0, Y0, noise, 0, traffic, dev,
                        n=int(traffic["warmup_steps"]), start=(s0, Y0))
        win = loop.run(prog.step, warm.state, warm.Y, noise, warm.k, traffic, dev,
                       seconds=args.seconds, start=(s0, Y0))
        steps = []
        for j in correct.pick_steps(seed, len(win.outs), config["check"]["steps"]):
            st, Y = win.ins[j]
            steps.append(correct.snapshot(dict(
                inp=program.state_dict(st), Y_in=Y, noise=noise(warm.k + j),
                out=program.outputs(win.outs[j]))))
        t0 = time.perf_counter()
        nums = correct.judge(ref, steps, config["check"]["rows_per_block"])
        t_judge = time.perf_counter() - t0
        z = torch.stack([o[0].pipeline.qpos[2] for o in win.outs]).cpu()
        print(json.dumps({"seed": seed, "side": "program", "steps": len(win.outs),
                          "failed": program.non_finite(win.outs), "judged": [
                              warm.k + j for j in correct.pick_steps(
                                  seed, len(win.outs), config["check"]["steps"])],
                          "torso_z_min": float(z.nan_to_num(nan=-1e9).min()),
                          "judge_s": t_judge, **nums}), flush=True)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
        if i < args.control_seeds:
            ctl = [dict(s, out=correct.reference_step(low, s["inp"], s["Y_in"], s["noise"]))
                   for s in steps]
            nums = correct.judge(ref, ctl, config["check"]["rows_per_block"])
            print(json.dumps({"seed": seed, "side": "control bfloat16", **nums}), flush=True)
            for k, v in nums.items():
                v = v if v == v else float("inf")  # a NaN reading has failed
                least[k] = min(least.get(k, float("inf")), v)
        del win, warm, steps
    print(json.dumps({"workload": args.workload, "program_max": worst, "control_min": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
