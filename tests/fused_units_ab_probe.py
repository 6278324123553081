"""The fused path's captured units, another tree of the repository against
this one, on one card, in turns (other, this, this, other), each run in a
process of its own: the median host wall ms of 11 `reverse_once` and 11
control steps of `MBDPI(capture="auto")` on go2_stand and go2_trot_position
at full width, after 3 warm calls.

    git archive <commit> | tar -x -C build/parent    # build/ is not committed
    python3 tests/fused_units_ab_probe.py build/parent

Prints the card's name and power limit, each run's medians, and per unit
the ratio of this tree's mean to the other's."""
import json, statistics, subprocess, sys, time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TREES = {"parent": None, "change": ROOT}  # "parent": the tree given on the command line
TASKS = ("go2_stand", "go2_trot_position")
REPS = 11


def child(tree):
    sys.path.insert(0, str(tree))
    import torch
    from tpu_dialmpc_torch.envs import dial_defaults, get_env
    from tpu_dialmpc_torch.envs.base import to_lean
    from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI
    from tpu_dialmpc_torch.planner.runner import make_control_step
    import tpu_dialmpc_torch
    assert Path(tpu_dialmpc_torch.__file__).resolve().is_relative_to(Path(tree).resolve())
    dev = torch.device("cuda", 0)
    out = {}
    for task in TASKS:
        env = get_env(task, device=dev)
        cfg = DialConfig(**dial_defaults(task))
        mb = MBDPI(cfg, env)
        assert mb.captured
        state = to_lean(env.reset())
        Y = torch.zeros((cfg.Hnode + 1, env.action_size), device=dev)
        scale = torch.as_tensor(mb.sigma_control, dtype=torch.float32, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        step = make_control_step(mb, cfg.Ndiffuse)
        for name, fn in (("reverse_once", lambda: mb.reverse_once(state, gen, Y, scale)),
                         ("control_step", lambda: step(state, Y, gen))):
            for _ in range(3):
                fn()
            ts = []
            for _ in range(REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            out[f"{task} {name}"] = statistics.median(ts)
    print("RESULT " + json.dumps(out), flush=True)


def main(other):
    TREES["parent"] = Path(other).resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    runs = []
    for label in ("parent", "change", "change", "parent"):
        r = subprocess.run([sys.executable, __file__, "child", str(TREES[label])],
                           capture_output=True, text=True, cwd=TREES[label], timeout=600)
        line = [l for l in r.stdout.splitlines() if l.startswith("RESULT ")]
        if r.returncode or not line:
            print(r.stdout[-3000:], r.stderr[-3000:])
            raise SystemExit(f"{label} failed")
        runs.append((label, json.loads(line[0][7:])))
        print(label, json.dumps(runs[-1][1]), flush=True)
    for key in runs[0][1]:
        p = [r[key] for l, r in runs if l == "parent"]
        c = [r[key] for l, r in runs if l == "change"]
        print(f"{key}: parent {p} change {c}; change/parent of means "
              f"{statistics.mean(c) / statistics.mean(p):.4f}")


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "child":
        child(sys.argv[2])
    else:
        main(sys.argv[1])
