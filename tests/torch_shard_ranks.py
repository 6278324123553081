"""Rank functions of the sharded planner's CPU tests (test_torch_shard.py,
test_torch_scaling.py).  Each runs in a process spawned by
`tpu_dialmpc_torch.shard.distributed.run_group`, on the CPU under gloo, so
this module imports torch, numpy and the port only: no jax.

The stub cases use `TorchStubEnv` (linear dynamics, torch_port_helpers.py);
`GO2` is the go2_stand stand-in on the physics pipeline (fused="off") at a
tiny width, float64.
"""

import time

import numpy as np
import torch

from torch_port_helpers import TorchStubEnv
from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI
from tpu_dialmpc_torch.shard import ShardedMBDPI, distributed

STUB = dict(Hsample=6, Hnode=2, Nsample=16, ctrl_dt=0.02)
OWN = dict(Hsample=6, Hnode=2, Nsample=13, ctrl_dt=0.02)  # uneven blocks on 2, 3, 4 ranks
GO2 = dict(Nsample=8, Hsample=4, Hnode=2)
GO2_SUBSTEPS = 1
INFO_FIELDS = ("rews", "rew_Ybar", "weights", "ess", "entropy", "qbar", "qdbar", "xbar")


def stub_env(device="cpu"):
    """The scaling reports' env factory for the stub."""
    return TorchStubEnv()


def go2_env(device="cpu"):
    from tpu_dialmpc_torch.envs import get_env

    return get_env("go2_stand", device=device, n_substeps=GO2_SUBSTEPS, dtype="float64",
                   fused="off")


def go2_config():
    from tpu_dialmpc_torch.envs import dial_defaults

    return DialConfig(**dict(dial_defaults("go2_stand"), **GO2))


def _t(x):
    return torch.as_tensor(x, dtype=torch.float64)


def _host(y, info):
    out = {"Ybar": y.numpy()}
    out.update({f: getattr(info, f).numpy() for f in INFO_FIELDS})
    return out


def injected(planner_cls, mesh, cfg, env, Y, scale, noise):
    """One reverse_once under injected noise, as host arrays."""
    planner = planner_cls(cfg, env) if mesh is None else planner_cls(cfg, env, mesh)
    y, info = planner.reverse_once(env.reset(), None, _t(Y), _t(scale), noise=_t(noise))
    return _host(y, info)


def own_draw(planner_cls, mesh, seed, Y, scale):
    """One reverse_once of the stub at OWN from the planner's own draw."""
    env = TorchStubEnv()
    cfg = DialConfig(**OWN)
    planner = planner_cls(cfg, env) if mesh is None else planner_cls(cfg, env, mesh)
    gen = torch.Generator().manual_seed(seed)
    y, info = planner.reverse_once(env.reset(), gen, _t(Y), _t(scale))
    return _host(y, info)


def control_step(planner_cls, mesh, seed, Y0, n_diffuse):
    """make_control_step on the stub at STUB: the executed step, the shift
    and an improve chain of n_diffuse iterations."""
    from tpu_dialmpc_torch.planner.runner import make_control_step

    env = TorchStubEnv()
    cfg = DialConfig(**STUB)
    planner = planner_cls(cfg, env) if mesh is None else planner_cls(cfg, env, mesh)
    gen = torch.Generator().manual_seed(seed)
    state, y, infos = make_control_step(planner, n_diffuse)(env.reset(), _t(Y0), gen)
    return {"Ybar": y.numpy(), "rews": infos.rews.numpy(), "qpos": state.pipeline.qpos.numpy()}


def cases(mesh, specs):
    """Every case in `specs` on this rank: a list of (kind, kwargs), kind one
    of "stub", "go2", "own", "control"; returns their results in order."""
    torch.set_num_threads(1)
    out = []
    for kind, kw in specs:
        if kind == "stub":
            kw = dict(kw)
            cfg = DialConfig(**dict(STUB, **kw.pop("cfg")))
            out.append(injected(ShardedMBDPI, mesh, cfg, TorchStubEnv(), **kw))
        elif kind == "go2":
            out.append(injected(ShardedMBDPI, mesh, go2_config(), go2_env(), **kw))
        elif kind == "own":
            out.append(own_draw(ShardedMBDPI, mesh, **kw))
        elif kind == "control":
            out.append(control_step(ShardedMBDPI, mesh, **kw))
        else:
            raise ValueError(kind)
    return out


def late_to_barrier(mesh, timeout_s):
    """Rank 0 waits at a barrier that rank 1 reaches only after rank 0's
    timeout (an all-reduce holds rank 1 back until then, whatever the
    ranks' start-up skew): rank 0 returns the error it raised."""
    release = torch.ones(1)
    if mesh.rank == 0:
        try:
            distributed.barrier("late", timeout_s=timeout_s)
            msg = "no timeout"
        except TimeoutError as e:
            msg = str(e)
        torch.distributed.all_reduce(release)
        return msg
    torch.distributed.all_reduce(release)
    distributed.barrier("late", timeout_s=timeout_s)  # rank 0's arrival is on record
    return "late"


def hang(mesh):
    """Rank 1 never joins rank 0's all-reduce."""
    if mesh.rank == 0:
        torch.distributed.all_reduce(torch.ones(1))
    else:
        time.sleep(3600)


def fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("rank 1 refuses")
    return np.zeros(1)


def card_reverse_once(mesh, width, reps=0, compare=()):
    """go2_stand at `width` (Nsample, Hsample, Hnode, n_substeps) on
    mesh.device: one reverse_once through ShardedMBDPI and through MBDPI,
    under injected noise (numpy seed 0) and from a generator seeded 1 (the
    same on every rank), with each sharded call's fused-kernel launches
    counted from 0, and the host calls of one sharded call (a profiler
    window: all-reduces, stream synchronisations).  With `reps`, the median
    ms of `reps` more sharded calls, each in turn with the planners named in
    `compare`: "single" (MBDPI at Nsample) and "block" (MBDPI at this
    rank's block size: the same rollouts with no collective).  Host values
    out."""
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from tpu_dialmpc_torch.envs import dial_defaults, get_env
    from tpu_dialmpc_torch.envs.base import to_lean

    n, h, hnode, sub = width
    device = mesh.device
    env = get_env("go2_stand", device=device, n_substeps=sub)
    kw = dict(dial_defaults("go2_stand"), Hsample=h, Hnode=hnode)
    cfg = DialConfig(**dict(kw, Nsample=n))
    single, sharded = MBDPI(cfg, env), ShardedMBDPI(cfg, env, mesh)
    block = sharded.block.stop - sharded.block.start
    state = to_lean(env.reset())
    Y = torch.zeros((hnode + 1, env.action_size), dtype=torch.float32, device=device)
    scale = torch.as_tensor(single.sigma_control, dtype=torch.float32, device=device)
    draw = np.random.default_rng(0).standard_normal((n, hnode + 1, env.action_size))
    noise = torch.as_tensor(draw, dtype=torch.float32, device=device)

    def call(planner, injected):
        gen = torch.Generator(device=device).manual_seed(1)
        y, info = planner.reverse_once(state, gen, Y, scale, noise=noise if injected else None)
        return y.cpu().numpy(), info.weights.cpu().numpy()

    distributed.barrier("card_reverse_once")  # every rank's env is up
    out = {"backend": torch.distributed.get_backend() if torch.distributed.is_initialized()
           else None, "block": (sharded.block.start, sharded.block.stop)}
    for how in ("injected", "generator"):
        y1, w1 = call(single, how == "injected")
        env.fused_step.launches = 0
        y, w = call(sharded, how == "injected")
        out[how] = dict(Ybar=y, weights=w, single_Ybar=y1, single_weights=w1,
                        launches=env.fused_step.launches)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call(sharded, True)
    out["host_calls"] = {e.key: (e.count, e.cpu_time_total / 1e3) for e in prof.key_averages()
                         if e.key in ("c10d::allreduce_", "cudaStreamSynchronize")}

    timed = {"sharded": sharded}
    if "single" in compare:
        timed["single"] = single
    if "block" in compare:
        timed["block"] = MBDPI(DialConfig(**dict(kw, Nsample=block)), env)
    ts = {name: [] for name in timed}
    for _ in range(reps):  # in turns, so that a drift of the host's speed hits each
        for name, planner in timed.items():
            distributed.barrier("turn")
            t0 = time.perf_counter()
            planner.reverse_once(state, None, Y, scale, noise=noise[:planner.args.Nsample])[0]\
                .sum().item()
            ts[name].append(1e3 * (time.perf_counter() - t0))
    out["ms"] = {name: statistics.median(t) for name, t in ts.items() if t}
    return out
