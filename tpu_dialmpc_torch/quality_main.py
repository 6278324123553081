"""The quality and scaling harness: runs the gates and writes the round
artifacts (counterpart of the repository root's `quality.py`).

    python -m tpu_dialmpc_torch.quality                # QUALITY_TORCH_r{N}.json
    python -m tpu_dialmpc_torch.quality --quick        # QUALITY_TORCH_QUICK_r{N}.json:
                                                       #   the 150-step audit lane
    python -m tpu_dialmpc_torch.quality --gates go2_trot h1_walk   # a subset
    python -m tpu_dialmpc_torch.quality --quick --seed 7           # another noise draw
    python -m tpu_dialmpc_torch.quality --quick --seeds 0 7 21     # per-seed spread
    python -m tpu_dialmpc_torch.quality --scaling      # SCALING_TORCH_r{N}.json
    python -m tpu_dialmpc_torch.quality --quick --device cpu       # the plain versions

The round number {N} is 1 + the highest BENCH_r{N}.json at the repository
root; `--out` overrides the path.  The port's artifact names start with
QUALITY_TORCH / SCALING_TORCH, so the JAX package's README generator, which
reads QUALITY_r*.json, never picks one up.

The scaling artifact holds three measurements and a prediction:
  - native: `shard/scaling.py:scaling_report` at go2_stand's full width on
    `--device` (the card: the mesh sizes its card count allows);
  - cpu_group_gloo: the same report over 1, 2 and 4 gloo ranks, one CPU
    process each, go2_stand at Nsample=512 on a short horizon: it checks
    that the collective layout runs at every size, not the hardware's
    scaling;
  - collective_overhead_cpu_group: `collective_overhead_report` over 4 gloo
    ranks on the CPU at the same width;
  - predicted_multihost: `predicted_efficiency_rows` with the native row's
    measured ms as the compute time and the bytes `ShardedMBDPI` reduces
    per iteration at that width.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

from tpu_dialmpc_torch import quality as q

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# go2_stand's full width: the native scaling rows and the prediction's compute
NATIVE = dict(task="go2_stand", nsample=2048, hsample=20, hnode=5, n_substeps=8)
# the CPU ranks: Nsample=512 on a short horizon, one substep, so each of the
# ~50 timed iterations per size takes about a second on the host
CPU_GROUP = dict(task="go2_stand", nsample=512, hsample=4, hnode=2, n_substeps=1,
                 mesh_sizes=[1, 2, 4])
CPU_OVERHEAD_RANKS = 4


def _round_tag() -> str:
    rounds = [0]
    for f in glob.glob(os.path.join(ROOT, "BENCH_r*.json")):
        m = re.search(r"BENCH_r(\d+)\.json$", f)
        if m:
            rounds.append(int(m.group(1)))
    return f"r{max(rounds) + 1:02d}"


def _seed_spread(results):
    """Per-gate metric spread + seed-sensitivity flags across seed runs.

    A check is seed-sensitive when it passes under some seeds and fails
    under others (thresholds calibrated to one noise realization).
    """
    by_gate = {}
    for r in results:
        by_gate.setdefault(r["gate"], []).append(r)
    spread, sensitive = {}, []
    for gate, runs in by_gate.items():
        if len(runs) < 2:
            continue
        metrics = {}
        for m in runs[0]["metrics"]:
            vals = [r["metrics"][m] for r in runs if m in r["metrics"]]
            if vals and all(isinstance(v, (int, float)) for v in vals):
                metrics[m] = {
                    "min": round(min(vals), 4),
                    "max": round(max(vals), 4),
                    "by_seed": {
                        str(r["seed"]): round(r["metrics"][m], 4)
                        for r in runs if m in r["metrics"]
                    },
                }
        spread[gate] = metrics
        for i, chk in enumerate(runs[0]["checks"]):
            outcomes = {r["seed"]: r["checks"][i]["passed"] for r in runs}
            if len(set(outcomes.values())) > 1:
                sensitive.append(
                    {"gate": gate, "metric": chk["metric"],
                     "passed_by_seed": {str(k): v for k, v in outcomes.items()}}
                )
    return spread, sensitive


def _platform(device) -> str:
    import torch

    return "cuda" if torch.device(device).type == "cuda" else "cpu"


def _progress(r, i, n):
    # per-gate progress (a full run takes hours; a silent harness is
    # undiagnosable mid-run)
    line = {c["metric"]: round(c["measured"], 3) for c in r["checks"]}
    print(f"[{i}/{n}] {r['gate']}[seed={r['seed']}]: passed={r['passed']} {line} "
          f"({r['wall_s']:.0f}s)", flush=True)


def run_quality(names, out_path, quick=False, seeds=None, device="cuda"):
    t0 = time.time()
    results = q.run_all(names, quick=quick, seeds=seeds, on_result=_progress, device=device)
    card, power = q.device_identity(device)
    doc = {
        "artifact": "quality",
        "lane": "quick" if quick else "full",
        "platform": _platform(device),
        "device": card,
        "power_limit": power,
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "wall_s": round(time.time() - t0, 1),
        "seeds": sorted({r["seed"] for r in results}),
        "gates": results,
        "all_passed": all(r["passed"] for r in results),
    }
    if seeds and len(seeds) > 1:
        doc["seed_spread"], doc["seed_sensitive_checks"] = _seed_spread(results)
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps({k: doc[k] for k in ("platform", "device", "power_limit", "all_passed")}))
    print(f"wrote {out_path}")
    return 0 if doc["all_passed"] else 1


def port_payload_bytes(nsample: int, hnode: int, nu: int, itemsize: int = 4) -> int:
    """Bytes one rank of `ShardedMBDPI` all-reduces per `reverse_once` with
    the default scoring: the (Hnode+1, nu) update partials, four scalars and
    the zero-padded (Nsample+1,) mean rewards and weights."""
    return ((hnode + 1) * nu + 4 + 2 * (nsample + 1)) * itemsize


def _predicted_efficiency(native):
    """Predicted multi-host rows from this artifact's native row: its
    measured ms per iteration is the compute time, the payload what the
    port's ranks reduce at that width (the JAX formula's bytes beside it).
    The latency of a hop between hosts cannot be measured on one host, so
    the rows span a latency grid (shard/scaling.py)."""
    from tpu_dialmpc_torch.envs import get_env
    from tpu_dialmpc_torch.shard.scaling import predicted_efficiency_rows

    row = native["rows"][0]
    nu = get_env(NATIVE["task"], device="cpu").action_size
    payload = port_payload_bytes(NATIVE["nsample"], NATIVE["hnode"], nu)
    return {
        f"{NATIVE['task']}_N{NATIVE['nsample']}_per_device": {
            "per_chip_compute_ms": row["ms_per_iteration"],
            "compute_basis": {
                "source": "this artifact's native row (measured in this run)",
                "platform": native["platform"],
                "device": native["device"],
                "power_limit": native["power_limit"],
                "devices": row["devices"],
            },
            "payload_bytes": payload,
            "jax_formula_payload_bytes": (NATIVE["hnode"] + 1) * nu * 4 + 32,
            "rows": predicted_efficiency_rows(
                compute_ms=row["ms_per_iteration"], payload_bytes=payload,
                n_hosts_list=(1, 2, 4, 8),
            ),
        }
    }


def run_scaling(out_path, device="cuda"):
    from tpu_dialmpc_torch.shard.scaling import (
        collective_overhead_report,
        scaling_report,
    )

    card, power = q.device_identity(device)
    native = {
        "platform": _platform(device),
        "device": card,
        "power_limit": power,
        "width": dict(NATIVE),
        "rows": scaling_report(device=device, **NATIVE),
    }
    doc = {
        "artifact": "scaling",
        "measured_at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "native": native,
    }
    cpu = {k: v for k, v in CPU_GROUP.items() if k not in ("mesh_sizes", "env")}
    try:
        doc["cpu_group_gloo"] = {
            "platform": (
                "cpu (gloo, one process per rank on one host's cores, "
                f"{cpu['task']} Nsample={cpu['nsample']} Hsample={cpu['hsample']} "
                f"sub{cpu['n_substeps']}) — collective-layout validation only: the "
                "ranks share the cores, so efficiency-vs-linear is not a hardware "
                "scaling measurement"
            ),
            "rows": scaling_report(device="cpu", **CPU_GROUP),
        }
    except Exception as e:
        doc["cpu_group_gloo"] = {"error": str(e)[:500]}
    try:
        doc["collective_overhead_cpu_group"] = collective_overhead_report(
            task=cpu["task"], nsample=cpu["nsample"], hsample=cpu["hsample"],
            hnode=cpu["hnode"], n_devices=CPU_OVERHEAD_RANKS, device="cpu",
            env=_cpu_env_factory(),
        )
    except Exception as e:
        doc["collective_overhead_cpu_group"] = {"error": str(e)[:500]}
    try:
        doc["predicted_multihost"] = _predicted_efficiency(native)
    except Exception as e:
        doc["predicted_multihost"] = {"error": str(e)[:500]}
    with open(out_path, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc["native"]))
    print(f"wrote {out_path}")
    return 0


def _cpu_env_factory():
    """The CPU group's env factory: its `env` where it names one, else the
    task's registry env at its substeps (collective_overhead_report takes
    no n_substeps of its own)."""
    import functools

    from tpu_dialmpc_torch.envs import get_env

    return CPU_GROUP.get("env") or functools.partial(
        get_env, CPU_GROUP["task"], n_substeps=CPU_GROUP["n_substeps"])


def main(argv=None):
    p = argparse.ArgumentParser(prog="python -m tpu_dialmpc_torch.quality")
    p.add_argument("--scaling", action="store_true",
                   help="write SCALING_TORCH_r{N}.json instead of running the gates")
    p.add_argument("--gates", nargs="*", default=None, help=f"a subset of {list(q.GATES)}")
    p.add_argument("--out", default=None)
    p.add_argument(
        "--quick", action="store_true",
        help="150-step audit lane: same tasks/planner/metrics, re-derived "
             "thresholds (writes QUALITY_TORCH_QUICK_r{N}.json)",
    )
    p.add_argument(
        "--seed", type=int, default=None,
        help="override the planner seed (noise + reset draw): thresholds are "
             "envelopes and must hold across seeds, not fit one trajectory",
    )
    p.add_argument(
        "--seeds", type=int, nargs="+", default=None,
        help="run every gate once per seed (distinct values) and record the "
             "per-seed metric spread and seed-sensitive checks in one artifact",
    )
    p.add_argument("--device", default="cuda", help="torch device (default: the card)")
    args = p.parse_args(argv)
    if args.seeds is not None:
        if args.seed is not None:
            p.error("--seed and --seeds are exclusive: put the seed in --seeds")
        repeated = sorted({s for s in args.seeds if args.seeds.count(s) > 1})
        if repeated:
            p.error(f"--seeds repeats {repeated}: each seed once (the spread is keyed by seed)")
    unknown = [g for g in args.gates or () if g not in q.GATES]
    if unknown:
        p.error(f"unknown gates {unknown}; known: {list(q.GATES)}")
    tag = _round_tag()
    if args.scaling:
        return run_scaling(args.out or os.path.join(ROOT, f"SCALING_TORCH_{tag}.json"),
                           device=args.device)
    name = f"QUALITY_TORCH_QUICK_{tag}.json" if args.quick else f"QUALITY_TORCH_{tag}.json"
    seeds = args.seeds or ([args.seed] if args.seed is not None else None)
    return run_quality(args.gates, args.out or os.path.join(ROOT, name), quick=args.quick,
                       seeds=seeds, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
