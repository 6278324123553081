"""Sample-parallel MBDPI: the annealing step split over ranks.

Counterpart of `tpu_dialmpc/shard/planner.py`.  Where the JAX package puts
sharding constraints on the candidate tensor and lets GSPMD lower the
reductions to collectives, each rank here owns a contiguous block of the
Nsample candidates (shard/mesh.py) and the reductions are explicit
`torch.distributed.all_reduce` calls:

- noise: every rank draws the whole (Nsample, Hnode+1, nu) tensor from its
  generator (the same seed on every rank) and keeps its block, so the draw
  is a function of the global sample index and any world size gives the
  candidates of `MBDPI` (the JAX package's partitionable threefry).  An
  injected `noise=` is global too and is sliced the same way;
- rollouts: each rank appends the anchor Ybar to its block and rolls the
  block + 1 candidates out in one `rollout_us_batch`, the env's
  `rollout_batch` (one fused-kernel launch per horizon step on a fused
  env);
- scoring, `MBDPI._score_update` over the rank's block, with its `_reduce`
  an all-reduce: with score_std="sample" the global mean, then the global
  variance, of all Nsample+1 mean rewards (two SUM reductions); with "time"
  a per-sample std and no collective; the softmax takes a MAX, then a SUM
  of the exponentials; the weighted update is a SUM of the (Hnode+1, nu)
  partials, with the diag_states averages beside it.  The anchor enters
  each global sum once: it is added after the reduction, on every rank;
- `ReverseInfo`: `rews` and `weights` are the global (Nsample+1,) vectors
  on every rank (a SUM of zero-padded buffers: gloo reduces CUDA tensors
  but does not gather them), `ess` and `entropy` computed over them.
  These two buffers are most of the bytes a rank reduces: about
  2 (Nsample+1) floats an iteration, counted in `reduced_bytes`.

`compat_q1` is not honoured: the JAX package's `ShardedMBDPI.reverse_once`
has no Q1 branch either (the chained candidates are sequential by design).
Without a process group (one rank) every reduction is local; with one,
even of one rank, every reduction is a collective.

Captured as `MBDPI` is (`planner/capture.py`): on a CUDA env whose process
group is NCCL, or without one, "auto" captures `reverse_once` and the
control step with their all-reduces inside the graph (the JAX package's
GSPMD program holds its collectives too), or the env steps off the fused
path; on a gloo group, whose all-reduces are host round trips, "auto" runs
eagerly and True raises.  The eager first call of a unit makes the first
all-reduce, which creates the NCCL communicator before the capture.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI, ReverseInfo
from tpu_dialmpc_torch.shard.mesh import Mesh, sample_sharding
from tpu_dialmpc_torch.telemetry import spans


class ShardedMBDPI(MBDPI):
    """MBDPI with the sample axis split over the ranks of `mesh`: `MBDPI`'s
    scoring over this rank's block, its `_reduce` an all-reduce."""

    COUNTERS = ("reduced_bytes",)

    def __init__(self, args: DialConfig, env, mesh: Mesh, capture="auto"):
        # collectives wherever there is a process group, even of one rank
        self._grouped = dist.is_available() and dist.is_initialized()
        # `capture` as MBDPI's; a gloo group runs eagerly (module docstring)
        super().__init__(args, env, capture=capture)
        self.mesh = mesh
        self.block = sample_sharding(mesh, args.Nsample)
        self.reduced_bytes = 0  # bytes this rank has all-reduced, for the reports

    def collective_backend(self) -> Optional[str]:
        return dist.get_backend() if self._grouped else None

    def _reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """All-reduce `t` in place over the ranks; local without a process
        group."""
        if self._grouped:
            dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)
            self.reduced_bytes += t.numel() * t.element_size()
        return t

    def _reverse_once(
        self,
        state,
        generator: Optional[torch.Generator],
        Ybar_i: torch.Tensor,
        noise_scale: torch.Tensor,
        noise: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, ReverseInfo]:
        """One annealing step over this rank's block, eagerly (what
        `MBDPI.reverse_once` runs or captures); every rank returns the same
        Ybar and info."""
        if noise is None:
            noise = self.draw_noise(generator, Ybar_i)
        with spans.span("candidates", device=self.device):
            all_Y0s = self._candidates(None, Ybar_i, noise_scale, noise[self.block])
            us = self.node2u(all_Y0s)  # (block + 1, Hsample+1, nu), the anchor last
        rewss, diag = self._rollouts(state, us)
        with spans.span("score_update", device=self.device):
            return self._score_update(rewss, all_Y0s, noise_scale, diag=diag)
