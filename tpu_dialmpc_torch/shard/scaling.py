"""Scaling of the sample-parallel planner: iterations per second against the
number of ranks.

Counterpart of `tpu_dialmpc/shard/scaling.py`, with its reports and their
keys:

- `scaling_report`: strong scaling (a fixed Nsample) of
  `ShardedMBDPI.reverse_once` over `mesh_sizes` ranks, one card per rank
  (NCCL), or processes on the CPU (gloo); efficiency against linear scaling
  from the first size;
- `collective_overhead_report`: the same workload through the unsharded
  `MBDPI` and through `ShardedMBDPI` over n ranks on the same device (gloo:
  NCCL refuses two ranks on one card), so the difference is what sharding
  adds, not what more hardware gives;
- `predicted_efficiency_rows`: the scaling model's arithmetic.

Every time is `telemetry/profile.py:_amortized`'s chain-length slope, at
the JAX harness's chain lengths (2 and 10, 4 repetitions).  A mesh of one
rank runs in this process without a process group; larger meshes are
processes started with torch.multiprocessing in spawn mode
(`distributed.run_group`), and rank 0's time is the row's.  Where the JAX
functions take an `env` object, these take `env`, a picklable factory
`env(device=...) -> env` (a top-level function or class, or a
functools.partial of one), since each rank builds its own env on its own
device; by default the task's registry env with `n_substeps`.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch

from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI
from tpu_dialmpc_torch.shard import distributed
from tpu_dialmpc_torch.shard.mesh import make_mesh
from tpu_dialmpc_torch.shard.planner import ShardedMBDPI
from tpu_dialmpc_torch.telemetry import profile as prof

CHAIN = dict(r_lo=2, r_hi=10, reps=4)  # the JAX harness's chain lengths


def _task_env(task: str, n_substeps: int) -> Callable:
    from tpu_dialmpc_torch.envs import get_env

    return functools.partial(get_env, task, n_substeps=n_substeps)


def _iteration_sec(planner, env) -> Tuple[float, int]:
    """Amortized seconds per `reverse_once` of `planner` from env's reset
    state, Y0 = 0 at the planner's sigma_control, and the bytes the planner
    all-reduced in one call (0 off a process group)."""
    from tpu_dialmpc_torch.envs.base import to_lean

    state = to_lean(env.reset())
    dtype = state.obs.dtype
    Y0 = torch.zeros((planner.args.Hnode + 1, env.action_size), dtype=dtype,
                     device=planner.device)
    scale = torch.as_tensor(planner.sigma_control, dtype=dtype, device=planner.device)
    gen = torch.Generator(device=planner.device).manual_seed(1)

    def one(acc):
        y, info = planner.reverse_once(state, gen, Y0, scale)
        return acc + y.sum() + info.rew_Ybar

    before = getattr(planner, "reduced_bytes", 0)
    one(0.0)  # first use: the kernel's build and upload
    nbytes = getattr(planner, "reduced_bytes", 0) - before
    distributed.barrier("iteration_sec")
    return prof._amortized(one, (), **CHAIN), nbytes


def _sharded_rank_sec(mesh, env_factory, cfg) -> Tuple[float, int]:
    """One rank of a sharded timing (run by `distributed.run_group`)."""
    env = env_factory(device=mesh.device)
    return _iteration_sec(ShardedMBDPI(cfg, env, mesh), env)


def _sharded_sec(env_factory, cfg, n_ranks: int, device, backend=None) -> Tuple[float, int]:
    """Rank 0's (seconds per iteration, bytes all-reduced per iteration)."""
    if n_ranks == 1:
        env = env_factory(device=device)
        return _iteration_sec(ShardedMBDPI(cfg, env, make_mesh(device=device)), env)
    secs = distributed.run_group(_sharded_rank_sec, n_ranks, (env_factory, cfg),
                                 backend=backend, device=device, timeout_s=1200.0)
    return secs[0]


def scaling_report(
    task: str = "go2_stand",
    nsample: int = 2048,
    hsample: int = 20,
    hnode: int = 5,
    n_substeps: int = 8,
    mesh_sizes: Optional[List[int]] = None,
    env: Optional[Callable] = None,
    device: str = "cuda",
) -> List[Dict]:
    """Iterations/s for each mesh size; efficiency vs linear scaling.

    The workload is fixed at Nsample (strong scaling).  On the card a mesh
    of n ranks takes cards 0..n-1 (NCCL), and `mesh_sizes` defaults to the
    sizes in (1, 2, 4, 8, 16) that the card count allows; on the CPU every
    rank is a CPU process (gloo) and it defaults to [1]."""
    on_card = torch.device(device).type == "cuda"
    if mesh_sizes is None:
        n_avail = torch.cuda.device_count() if on_card else 1
        mesh_sizes = [s for s in (1, 2, 4, 8, 16) if s <= n_avail]
    env_factory = env if env is not None else _task_env(task, n_substeps)
    cfg = DialConfig(Hsample=hsample, Hnode=hnode, Nsample=nsample, Ndiffuse=2)
    rows = []
    base = None
    for n_dev in mesh_sizes:
        # one card per rank on the card: cuda:<rank> (None); the CPU for all
        rank_device = None if on_card and n_dev > 1 else device
        sec, _ = _sharded_sec(env_factory, cfg, n_dev, rank_device)
        ips = 1.0 / sec
        if base is None:
            base = (n_dev, ips)
        eff = (ips / base[1]) / (n_dev / base[0])
        rows.append(
            dict(
                devices=n_dev,
                nsample=nsample,
                ms_per_iteration=1e3 * sec,
                iterations_per_sec=ips,
                efficiency_vs_linear=eff,
            )
        )
    return rows


def collective_overhead_report(
    task: str = "go2_stand",
    nsample: int = 512,
    hsample: int = 20,
    hnode: int = 5,
    n_devices: int = 8,
    env: Optional[Callable] = None,
    device: str = "cuda",
) -> Dict:
    """Measured collective and partitioning overhead of the sharded planner.

    The same total workload (Nsample candidates) through the unsharded MBDPI
    in this process and through ShardedMBDPI over `n_devices` ranks (gloo),
    all on the one `device`.  Total compute is the same, so the difference
    is what sharding adds: the per-rank fixed costs, the scoring and update
    collectives (through the host under gloo) and the ranks' contention for
    the device.  It is the measured input of `predicted_efficiency_rows`.
    `payload_bytes_per_iteration` is the JAX package's formula;
    `port_payload_bytes_per_iteration` is what the port's ranks reduce."""
    env_factory = env if env is not None else _task_env(task, 8)
    cfg = DialConfig(Hsample=hsample, Hnode=hnode, Nsample=nsample, Ndiffuse=2)
    one_env = env_factory(device=device)
    sec_unsharded, _ = _iteration_sec(MBDPI(cfg, one_env), one_env)
    sec_sharded, port_bytes = _sharded_sec(env_factory, cfg, n_devices, device, backend="gloo")
    nu = one_env.action_size
    # the JAX formula: the weighted update's (Hnode+1, nu) partials and a
    # handful of scalar reductions, in float32
    payload_bytes = (cfg.Hnode + 1) * nu * 4 + 8 * 4
    return {
        "task": task,
        "nsample": nsample,
        "n_devices_virtual": n_devices,
        "unsharded_ms": 1e3 * sec_unsharded,
        "sharded_ms": 1e3 * sec_sharded,
        "overhead_ms": 1e3 * (sec_sharded - sec_unsharded),
        "overhead_frac": (sec_sharded - sec_unsharded) / sec_unsharded,
        "payload_bytes_per_iteration": payload_bytes,
        # what ShardedMBDPI all-reduced in one iteration on rank 0: the
        # formula's partials and scalars, and the zero-padded (Nsample+1,)
        # mean rewards and weights, in the env's dtype
        "port_payload_bytes_per_iteration": port_bytes,
        "note": (
            "same total workload, ranks sharing one device: the delta is "
            "partitioning + collective cost, not hardware scaling"
        ),
    }


def predicted_efficiency_rows(
    compute_ms: float,
    payload_bytes: int,
    n_hosts_list=(1, 2, 4, 8),
    latency_us_list=(50.0, 200.0, 1000.0),
    dcn_gbps: float = 25.0,
) -> List[Dict]:
    """Predicted strong-scaling efficiency vs host count.

    One annealing iteration per device costs `compute_ms` (per-device batch
    fixed) plus one tree all-reduce of `payload_bytes` across hosts:

        t_coll(N) = 2 * ceil(log2 N) * L + 2 * payload / BW
        eff(N)    = compute / (compute + t_coll(N))

    L is the one-way latency of a hop between hosts, which one device cannot
    measure, so rows are given over a grid of latencies.  The JAX package's
    payload is O((Hnode+1) * nu) floats and the port's about 2 (Nsample+1)
    more (`collective_overhead_report` gives both): at N2048 17 KB,
    latency-bound at any plausible bandwidth either way."""
    rows = []
    for L_us in latency_us_list:
        for n in n_hosts_list:
            hops = math.ceil(math.log2(n)) if n > 1 else 0
            t_coll_ms = 2 * hops * L_us * 1e-3 + 2 * payload_bytes / (
                dcn_gbps * 1e9
            ) * 1e3
            rows.append(
                {
                    "n_hosts": n,
                    "dcn_latency_us": L_us,
                    "compute_ms": compute_ms,
                    "collective_ms": round(t_coll_ms, 4),
                    "predicted_efficiency": round(
                        compute_ms / (compute_ms + t_coll_ms), 4
                    ),
                }
            )
    return rows
