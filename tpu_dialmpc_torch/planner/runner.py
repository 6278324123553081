"""Receding-horizon DIAL-MPC driver (counterpart of
`tpu_dialmpc/planner/runner.py`, without checkpointing, retries or
telemetry).

`make_control_step` is one control step: execute Y0[0] through the env's
`step_lean`, shift the plan, then `improve` it.  `run` is the host loop:
reset, the `reverse` warm start, then `n_steps` control steps, the first with
`Ndiffuse_init` annealing iterations and the rest with `Ndiffuse`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from tpu_dialmpc_torch.envs.base import to_lean
from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI


class RunResult(NamedTuple):
    rewards: torch.Tensor  # (n_steps,)
    dones: torch.Tensor  # (n_steps,)
    qpos: torch.Tensor  # (n_steps, nq) executed trajectory
    qvel: torch.Tensor  # (n_steps, nv)
    us: torch.Tensor  # (n_steps, nu) executed controls
    final_state: object
    final_Y0: torch.Tensor
    # the state us[0] was executed from (qpos[t] is post-step)
    qpos0: torch.Tensor
    qvel0: torch.Tensor
    warmstart0: torch.Tensor


def make_control_step(mbdpi: MBDPI, n_diffuse: int):
    """One receding-horizon step: execute, shift, anneal (dial-core-test.cpp:64-99)."""

    def control_step(state, Y0: torch.Tensor, generator: torch.Generator):
        state2 = mbdpi.env.step_lean(state, Y0[0])
        Y1 = mbdpi.shift(Y0)
        Y2, infos = mbdpi.improve(state2, Y1, generator, n_diffuse)
        return state2, Y2, infos

    return control_step


def run(env, cfg: DialConfig, n_steps: Optional[int] = None) -> RunResult:
    """Host-loop driver: reset, warm start, n_steps control steps.  The
    planner's noise comes from one generator on the env's device, seeded with
    cfg.seed."""
    mbdpi = MBDPI(cfg, env)
    generator = torch.Generator(device=mbdpi.device).manual_seed(cfg.seed)
    state = to_lean(env.reset())
    Y0 = torch.zeros((cfg.Hnode + 1, env.action_size), dtype=state.obs.dtype,
                     device=mbdpi.device)
    Y0 = mbdpi.reverse(state, Y0, generator)
    qpos0, qvel0 = state.pipeline.qpos, state.pipeline.qvel
    warmstart0 = state.pipeline.qacc_warmstart

    step_init = make_control_step(mbdpi, cfg.Ndiffuse_init)
    step_rest = make_control_step(mbdpi, cfg.Ndiffuse)
    n = cfg.n_steps if n_steps is None else n_steps
    rewards, dones, qpos, qvel, us = [], [], [], [], []
    for t in range(n):
        action = Y0[0]
        state, Y0, _ = (step_init if t == 0 else step_rest)(state, Y0, generator)
        rewards.append(state.reward)
        dones.append(state.done)
        qpos.append(state.pipeline.qpos)
        qvel.append(state.pipeline.qvel)
        us.append(action)
    return RunResult(
        rewards=torch.stack(rewards),
        dones=torch.stack(dones),
        qpos=torch.stack(qpos),
        qvel=torch.stack(qvel),
        us=torch.stack(us),
        final_state=state,
        final_Y0=Y0,
        qpos0=qpos0,
        qvel0=qvel0,
        warmstart0=warmstart0,
    )
