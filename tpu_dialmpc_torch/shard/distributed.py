"""Process-group bootstrap for the sample-parallel planner: torch.distributed.

Counterpart of `tpu_dialmpc/shard/distributed.py`.  One process per rank,
each with its own device; `initialize` joins them into a `torch.distributed`
process group, `make_multihost_mesh` gives each its rank of the
("dcn", "sample") layout (shard/mesh.py), and only the scoring's scalars and
the (Hnode+1, nu) weighted update cross between ranks (shard/planner.py).

Usage, one process per card under torchrun (which sets RANK, WORLD_SIZE,
LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT):

    from tpu_dialmpc_torch.shard import ShardedMBDPI, distributed
    distributed.initialize()                 # NCCL on cuda:<LOCAL_RANK>
    mesh = distributed.make_multihost_mesh()
    env = get_env("go2_stand", device=mesh.device)
    planner = ShardedMBDPI(cfg, env, mesh)

    torchrun --nnodes 1 --nproc-per-node 4 plan.py

Elsewhere pass `coordinator_address` ("host:port", "tcp://host:port" or
"file:///path"), `num_processes` and `process_id`.  `run_group` starts a
group of spawned processes on one host and returns each rank's result.

The backend is NCCL on a card and gloo on the CPU.  Ranks that share one
card take gloo (`backend="gloo"`): NCCL refuses two ranks on one device, and
gloo all-reduces CUDA tensors through the host.  A failed NCCL
initialisation raises; nothing falls back to gloo.
"""

from __future__ import annotations

import datetime
import os
import queue as queue_mod
import socket
import time
import traceback
import urllib.parse
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

from tpu_dialmpc_torch.shard.mesh import Mesh, make_mesh

# this process's rendezvous store (barriers use it) and each barrier name's
# use count: process-wide, as the default process group is
_STATE = {"store": None, "barriers": {}}


def _store(address: str, world_size: int, rank: int, timeout: datetime.timedelta):
    if "://" not in address:
        address = "tcp://" + address
    url = urllib.parse.urlparse(address)
    if url.scheme == "tcp":
        return dist.TCPStore(url.hostname, url.port, world_size, rank == 0, timeout)
    if url.scheme == "file":
        return dist.FileStore(url.path, world_size)
    raise ValueError(f"coordinator address {address!r}: expected host:port, tcp:// or file://")


def _env(name: str) -> str:
    if name not in os.environ:
        raise ValueError(f"{name} is not set: pass coordinator_address, num_processes and "
                         "process_id, or start the processes with torchrun")
    return os.environ[name]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = 1200.0,
) -> None:
    """`torch.distributed.init_process_group`, idempotent.

    Arguments left out are read from torchrun's environment (MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE, RANK).  `device` (default `cuda:<LOCAL_RANK>`)
    picks the backend unless `backend` is given: NCCL on a card, gloo on the
    CPU.  `timeout_s` bounds the rendezvous and every collective."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if num_processes not in (None, world) or process_id not in (None, rank):
            raise RuntimeError(f"already initialised as rank {rank} of {world}")
        return
    if coordinator_address is None:
        coordinator_address = f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT')}"
    if num_processes is None:
        num_processes = int(_env("WORLD_SIZE"))
    if process_id is None:
        process_id = int(_env("RANK"))
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    store = _store(coordinator_address, num_processes, process_id, timeout)
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=timeout)
    _STATE.update(store=store, barriers={})


def shutdown() -> None:
    """Leave the process group (if any)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE.update(store=None, barriers={})


def barrier(name: str, timeout_s: float = 1200.0) -> None:
    """Block until every rank reaches this barrier, or raise TimeoutError
    naming the ranks that did not.

    Use before the first collective after heavy per-rank work (a kernel
    build, a first upload): a rank that arrives at a collective long before
    a peer would otherwise wait there without a word until the group's
    timeout.  The barrier rides the rendezvous store, so it works on any
    backend.  Every rank must pass the same barriers in the same order."""
    store = _STATE["store"]
    if store is None:
        if dist.is_initialized():
            raise RuntimeError("barrier needs the process group made by initialize()")
        return  # a single process: nothing to synchronise
    world, rank = dist.get_world_size(), dist.get_rank()
    n = _STATE["barriers"][name] = _STATE["barriers"].get(name, 0) + 1
    keys = [f"tpu_dialmpc/barrier/{name}/{n}/{r}" for r in range(world)]
    store.set(keys[rank], "1")
    try:
        store.wait(keys, datetime.timedelta(seconds=timeout_s))
    except RuntimeError as e:
        missing = [r for r, k in enumerate(keys) if not store.check([k])]
        raise TimeoutError(f"barrier {name!r}: rank(s) {missing} of {world} did not arrive "
                           f"within {timeout_s:g} s") from e


def make_multihost_mesh(device=None) -> Mesh:
    """The ("dcn", "sample") mesh of an initialised group: nodes on the dcn
    axis (LOCAL_WORLD_SIZE ranks each, torchrun's node-major order), this
    rank on `device` (default `cuda:<LOCAL_RANK>`)."""
    if not dist.is_initialized():
        raise RuntimeError("make_multihost_mesh needs initialize() first")
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError("uneven devices per host")
    if device is None:
        local = os.environ.get("LOCAL_RANK", dist.get_rank() % per_host)
        device = torch.device("cuda", int(local))
    return make_mesh(device=device, dcn_axis=world // per_host)


# ---------------------------------------------------------------------------
# a group of spawned processes on one host


def free_address() -> str:
    """tcp://127.0.0.1:<a port that was free a moment ago>."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def _rank_main(rank, world_size, address, backend, device, timeout_s, fn, args, results):
    try:
        dev = torch.device("cuda", rank) if device is None else torch.device(device)
        initialize(address, world_size, rank, backend=backend, device=dev, timeout_s=timeout_s)
        out = fn(make_mesh(device=dev), *args)
        results.put((rank, True, out))
    except Exception:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        shutdown()


def run_group(
    fn: Callable,
    world_size: int,
    args: Sequence = (),
    backend: Optional[str] = None,
    device=None,
    timeout_s: float = 600.0,
    address: Optional[str] = None,
) -> List:
    """Run `fn(mesh, *args)` on `world_size` ranks, each a process started
    with torch.multiprocessing in spawn mode (fork is unsafe once CUDA is
    up), and return their results in rank order.

    `fn` and `args` are pickled (`fn` by import path) and `fn` returns host
    values (numbers, numpy arrays).  Every rank runs on `device`, or on
    `cuda:<rank>` when it is None; `backend` as `initialize`.  `address`
    is the rendezvous (default: a free port on 127.0.0.1).  A rank that
    raises or dies, or a group that has not finished within `timeout_s`
    (a hung collective), kills every rank and raises."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    address = address or free_address()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, address, backend, device, timeout_s, fn,
                               tuple(args), results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    outs, dead_since = {}, None
    try:
        while len(outs) < world_size:
            now = time.monotonic()
            if now >= deadline:
                missing = sorted(set(range(world_size)) - set(outs))
                raise TimeoutError(f"rank(s) {missing} of {world_size} did not finish within "
                                   f"{timeout_s:g} s")
            try:
                rank, ok, out = results.get(timeout=min(deadline - now, 1.0))
            except queue_mod.Empty:
                # a rank that died without a report (a signal, a crash); a
                # few seconds' grace for a report still in the pipe
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in outs and p.exitcode not in (None, 0)]
                dead_since = (now if dead_since is None else dead_since) if dead else None
                if dead and now - dead_since > 5.0:
                    raise RuntimeError(f"rank(s) exited without a result (rank, exit code): "
                                       f"{dead}")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{out}")
            outs[rank] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5.0)
        results.close()
    return [outs[r] for r in range(world_size)]
