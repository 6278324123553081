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
NU_STUB = 4  # TorchStubEnv's
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


def _same(a, b) -> bool:
    from tpu_dialmpc_torch.planner.capture import _flatten

    la, lb = _flatten(a), _flatten(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


CAPTURED_CALLS = 3  # the eager first call, the capture and a replay


def captured_against_eager(mesh):
    """The captured ShardedMBDPI on this rank's gloo group, through the CPU
    stand-in for a CUDA graph (`torch_port_helpers.use_eager_graphs`),
    against the eager one: on the stub, reverse_once from the planner's own
    draw and under injected noise and a chain of control steps (whole
    graphs); on go2_stand with fused="off", reverse_once (the env step's
    graph at the block + 1).  Per case: every call's outputs bit-equal, the
    generators' states equal after, the bytes all-reduced per call of each
    planner.  First, `capture=True` on the gloo group and the CPU: the
    message it raises."""
    from torch_port_helpers import use_eager_graphs
    from tpu_dialmpc_torch.planner.runner import make_control_step

    torch.set_num_threads(1)
    out = {}
    try:
        ShardedMBDPI(DialConfig(**STUB), TorchStubEnv(), mesh, capture=True)
        out["raises"] = None
    except ValueError as e:
        out["raises"] = str(e)
    graphs = use_eager_graphs()
    rng = np.random.default_rng(17)

    def case(name, cfg, env, call):
        cap, eag = ShardedMBDPI(cfg, env, mesh), ShardedMBDPI(cfg, env, mesh, capture=False)
        gens = [torch.Generator().manual_seed(23) for _ in range(2)]
        equal, nbytes = [], ([], [])
        carry = [None, None]
        for _ in range(CAPTURED_CALLS):
            got = []
            for k, planner in enumerate((cap, eag)):
                before = planner.reduced_bytes
                res, carry[k] = call(planner, gens[k], carry[k])
                got.append(res)
                nbytes[k].append(planner.reduced_bytes - before)
            equal.append(_same(*got))
        out[name] = dict(captured=cap.captured, whole=cap.graphs.whole, equal=equal,
                         same_generator=torch.equal(gens[0].get_state(), gens[1].get_state()),
                         captured_bytes=nbytes[0], eager_bytes=nbytes[1])

    stub = TorchStubEnv()
    cfg = DialConfig(**dict(STUB, diag_states=True))
    Y = _t(rng.uniform(-0.5, 0.5, (STUB["Hnode"] + 1, NU_STUB)))
    scale = _t(np.full(STUB["Hnode"] + 1, 0.4))
    noise = _t(rng.normal(size=(STUB["Nsample"], STUB["Hnode"] + 1, NU_STUB)))
    case("stub own draw", cfg, stub,
         lambda p, g, c: (p.reverse_once(stub.reset(), g, Y, scale), None))
    case("stub injected", cfg, stub,
         lambda p, g, c: (p.reverse_once(stub.reset(), None, Y, scale, noise=noise), None))

    def control(p, g, carried):
        state, Y0 = carried or (stub.reset(), Y)
        s2, Y2, infos = make_control_step(p, 2)(state, Y0, g)
        # the stub's step carries `done` over from its input, which a
        # graph's static state does not hold: the fields the step makes
        return (s2.pipeline, s2.obs, s2.reward, Y2, infos), (s2, Y2)

    case("stub control step", DialConfig(**STUB), stub, control)
    go2, go2_cfg = go2_env(), go2_config()
    Yg = _t(rng.uniform(-0.3, 0.3, (GO2["Hnode"] + 1, 12)))
    scale_g = _t(0.5 ** np.arange(GO2["Hnode"], -1, -1))
    start = go2.reset()
    case("go2 pipeline", go2_cfg, go2,
         lambda p, g, c: (p.reverse_once(start, g, Yg, scale_g), None))
    out["captures"] = [g.captures for g in graphs]
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


SHARD_HOWS = ("injected", "generator", "replayed")  # card_reverse_once's calls


def card_reverse_once(mesh, width, reps=0, compare=()):
    """go2_stand at `width` (Nsample, Hsample, Hnode, n_substeps) on
    mesh.device: reverse_once through ShardedMBDPI (captured where it can
    be: an NCCL group) and through MBDPI, under injected noise (numpy seed
    0), from a generator seeded 1 (the same on every rank) and under the
    injected noise again ("replayed": a captured planner's first call runs
    eagerly, its second captures and replays); each sharded call's
    fused-kernel launches counted from 0 and bytes all-reduced; where the
    sharded planner captures, the same calls of the eager one
    (`capture=False`) beside it; and the host calls of one sharded call, and
    of one eager sharded call (a profiler window each: all-reduces, graph
    launches, stream synchronisations).
    With `reps`, the median ms of `reps` more sharded calls, each in turn
    with the eager sharded planner where there is one and the planners
    named in `compare`: "single" (MBDPI at Nsample) and "block" (MBDPI at
    this rank's block size: the same rollouts with no collective).  Host
    values out."""
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
    eager = ShardedMBDPI(cfg, env, mesh, capture=False) if sharded.captured else None
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
           else None, "block": (sharded.block.start, sharded.block.stop),
           "captured": sharded.captured}
    for how in SHARD_HOWS:
        injected = how != "generator"
        y1, w1 = call(single, injected)
        env.fused_step.launches = 0
        b0 = sharded.reduced_bytes
        y, w = call(sharded, injected)
        out[how] = dict(Ybar=y, weights=w, single_Ybar=y1, single_weights=w1,
                        launches=env.fused_step.launches,
                        reduced_bytes=sharded.reduced_bytes - b0)
        if eager is not None:
            b0 = eager.reduced_bytes
            ye, we = call(eager, injected)
            out[how].update(eager_Ybar=ye, eager_weights=we,
                            eager_reduced_bytes=eager.reduced_bytes - b0)

    for key, planner in (("host_calls", sharded), ("eager_host_calls", eager)):
        if planner is None:
            continue
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            call(planner, True)
        out[key] = {e.key: (e.count, e.cpu_time_total / 1e3) for e in prof.key_averages()
                    if e.key in ("c10d::allreduce_", "cudaGraphLaunch", "cudaStreamSynchronize")}

    timed = {"sharded": sharded}
    if eager is not None:
        timed["eager"] = eager
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
