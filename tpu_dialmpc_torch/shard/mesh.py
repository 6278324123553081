"""The sample layout of the sample-parallel planner.

Counterpart of `tpu_dialmpc/shard/mesh.py`.  The parallel axis is the
sample axis: the Nsample candidates of an annealing iteration are split
into contiguous blocks, one per rank (one process per device), the horizon
stays a per-sample loop, and the softmax-weighted update is reduced over
the ranks with `torch.distributed` collectives (shard/planner.py).

A `Mesh` is one rank's view of that layout: the world size, this rank, its
device, and the number of nodes.  The JAX mesh's ("dcn", "sample") axis
order becomes rank order, node-major then local rank (torchrun's order), so
a node's ranks hold adjacent blocks.  Blocks are as even as possible:
`Nsample % world` ranks hold one sample more, the first ones, and an
uneven Nsample is allowed (the JAX package's GSPMD pads it).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank of a (dcn, sample) layout of `world_size` ranks."""

    world_size: int
    rank: int
    device: torch.device
    dcn: int = 1  # nodes; each holds world_size // dcn ranks

    @property
    def shape(self) -> dict:
        """The ("dcn", "sample") axis sizes: nodes, and ranks per node."""
        return {"dcn": self.dcn, "sample": self.world_size // self.dcn}


def sample_blocks(nsample: int, world_size: int) -> List[Tuple[int, int]]:
    """Every rank's block [lo, hi) of the global sample indices, in rank
    order: contiguous, the first `nsample % world_size` one sample longer."""
    base, extra = divmod(nsample, world_size)
    blocks, lo = [], 0
    for r in range(world_size):
        hi = lo + base + (r < extra)
        blocks.append((lo, hi))
        lo = hi
    return blocks


def sample_sharding(mesh: Mesh, nsample: int) -> slice:
    """The global sample indices this rank owns, as a slice."""
    return slice(*sample_blocks(nsample, mesh.world_size)[mesh.rank])


def make_mesh(
    n_devices: Optional[int] = None,
    device=None,
    dcn_axis: int = 1,
) -> Mesh:
    """This process's rank of the sample layout.

    With a `torch.distributed` process group the mesh spans its ranks
    (`n_devices`, if given, must equal its world size); without one it is a
    single rank, whose reductions are local (the JAX package's 1-device
    mesh).  `device` defaults to `cuda:<local rank>`: one card per rank;
    ranks that share a card pass it."""
    if dist.is_available() and dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"the process group has {world} ranks, not {n_devices}")
    else:
        if n_devices not in (None, 1):
            raise ValueError(
                f"a mesh of {n_devices} ranks needs a process group: call "
                "tpu_dialmpc_torch.shard.distributed.initialize first")
        world, rank = 1, 0
    if dcn_axis < 1 or world % dcn_axis:
        raise ValueError(f"{world} ranks do not split over a dcn axis of {dcn_axis}")
    if device is None:
        device = torch.device("cuda", rank % (world // dcn_axis))
    return Mesh(world_size=world, rank=rank, device=torch.device(device), dcn=dcn_axis)

