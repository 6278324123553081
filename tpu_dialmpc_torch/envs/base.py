"""Environment state containers, as dataclasses of tensors.

Counterpart of `tpu_dialmpc/envs/base.py`; `PipelineState` is the physics
pipeline's (`dynamics/pipeline.py`), as in the JAX package.  JAX's
NamedTuple pytrees become dataclasses; `map_tensors` plays the part of
`jax.tree_util.tree_map` (broadcasting a state to a batch of candidates,
adding or taking off a batch axis).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from tpu_dialmpc_torch.dynamics.pipeline import PipelineState

__all__ = ["EnvState", "LeanEnvState", "LeanPipelineState", "PipelineState", "StateInfo",
           "map_tensors", "to_lean"]


def map_tensors(obj, fn: Callable[[torch.Tensor], torch.Tensor]):
    """A copy of a state dataclass with `fn` applied to every tensor field
    (recursing into nested state dataclasses)."""
    changes = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            changes[f.name] = fn(v)
        elif dataclasses.is_dataclass(v):
            changes[f.name] = map_tensors(v, fn)
    return dataclasses.replace(obj, **changes)


@dataclasses.dataclass(frozen=True)
class StateInfo:
    """Command targets and bookkeeping carried from step to step.

    The JAX StateInfo holds a PRNG key that `_post_physics` splits every
    step, feeding only `randomize_tasks` (the command redrawn every 500
    steps).  In its place the port carries `seed`, an int64 drawn by `reset`
    from the caller's generator: the redraw at step t is a counter-based hash
    of (seed, t) (`envs/legged.py:command_uniforms`), so, as in JAX, it is a
    function of the episode and the step alone, the same for every rollout
    candidate and for the executed step.  Fields have a leading batch shape
    (...) in rollouts."""

    pos_tar: torch.Tensor  # (..., 3)
    vel_tar: torch.Tensor  # (..., 3)
    ang_vel_tar: torch.Tensor  # (..., 3)
    yaw_tar: torch.Tensor  # (...)
    step: torch.Tensor  # (...) int32
    z_feet: torch.Tensor  # (..., n_feet)
    z_feet_tar: torch.Tensor  # (..., n_feet)
    last_contact: torch.Tensor  # (..., n_feet) bool
    feet_air_time: torch.Tensor  # (..., n_feet)
    seed: torch.Tensor  # (...) int64, the episode's command seed


@dataclasses.dataclass(frozen=True)
class EnvState:
    pipeline: PipelineState
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    info: StateInfo


@dataclasses.dataclass(frozen=True)
class LeanPipelineState:
    """Live physics state only (qpos, qvel, warmstart): what the control loop
    carries between steps."""

    qpos: torch.Tensor  # (nq,)
    qvel: torch.Tensor  # (nv,)
    qacc_warmstart: torch.Tensor  # (nv,)


@dataclasses.dataclass(frozen=True)
class LeanEnvState:
    """EnvState with a LeanPipelineState — the same field names, so code that
    reads .pipeline.qpos / .reward / .info works on either."""

    pipeline: LeanPipelineState
    obs: torch.Tensor
    reward: torch.Tensor
    done: torch.Tensor
    info: StateInfo


def to_lean(state: EnvState) -> LeanEnvState:
    ps = state.pipeline
    return LeanEnvState(
        pipeline=LeanPipelineState(
            qpos=ps.qpos, qvel=ps.qvel, qacc_warmstart=ps.qacc_warmstart
        ),
        obs=state.obs,
        reward=state.reward,
        done=state.done,
        info=state.info,
    )
