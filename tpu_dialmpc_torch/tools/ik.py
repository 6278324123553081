"""IK / keyframe probe tool.

Counterpart of `tpu_dialmpc/tools/ik.py` (the reference's
legged_robot_ik.cpp): both modes over the port's batched kinematics and
physics pipeline, on the env's device and dtype.

- `solve_feet_ik`: Gauss-Newton on the feet sites' world positions with the
  base pose shifted by an offset and frozen: damped least squares on the
  (n_feet*3, n_joint) site Jacobian (`constraint.point_jacobian`), a
  Python loop of `iters` steps.
- `settle_probe`: shift the base, hold the home pose with the env's PD law,
  and step the physics (`pipeline.step`, one substep per step).

The port's kinematics and pipeline take a batch: both run at B=1.
"""

from __future__ import annotations

import torch

from tpu_dialmpc_torch.dynamics import kinematics, pipeline
from tpu_dialmpc_torch.dynamics.constraint import point_jacobian
from tpu_dialmpc_torch.envs.base import LeanPipelineState


def _home(env, base_offset) -> torch.Tensor:
    """The home keyframe with the base moved by `base_offset` (3,)."""
    q = torch.as_tensor(env._init_q, dtype=env._dtype, device=env.device).clone()
    q[0:3] += torch.as_tensor(base_offset, dtype=env._dtype, device=env.device)
    return q


def solve_feet_ik(env, base_offset, iters: int = 20, damping: float = 1e-4):
    """Joint angles keeping the feet at their home world positions after
    shifting the base by `base_offset` (3,).  Returns (qpos (nq,), the feet's
    residual norm in m)."""
    model = env.model
    q0 = torch.as_tensor(env._init_q, dtype=env._dtype, device=env.device)
    feet = [model.site_names.index(s) for s in env.FEET_SITES]
    bodies = torch.as_tensor([int(model.site_bodyid[s]) for s in feet], device=env.device)
    targets = kinematics.kinematics(model, q0[None]).site_xpos[0, feet]  # (n_feet, 3)
    n_joint = model.nv - 6
    eye = torch.eye(n_joint, dtype=q0.dtype, device=q0.device)

    q = _home(env, base_offset)
    for _ in range(iters):
        kin = kinematics.kinematics(model, q[None])
        sites = kin.site_xpos[:, feet]  # (1, n_feet, 3)
        res = (sites[0] - targets).reshape(-1)  # (3*n_feet,)
        jp = point_jacobian(model, kin, sites, bodies)[0]  # (n_feet, nv, 3)
        J = jp[:, 6:, :].transpose(1, 2).reshape(-1, n_joint)  # (3*n_feet, n_joint)
        JtJ = J.T @ J + damping * eye
        dq = torch.linalg.solve(JtJ, J.T @ res)
        q = torch.cat([q[:7], q[7:] - dq])
    sites = kinematics.kinematics(model, q[None]).site_xpos[0, feet]
    return q, torch.linalg.vector_norm((sites - targets).reshape(-1))


def settle_probe(env, base_offset, n_steps: int = 400) -> torch.Tensor:
    """The reference's live half (legged_robot_ik.cpp:166-227): shift the
    base, PD-hold the home pose, step the physics `n_steps` times; returns
    the final qpos (nq,)."""
    model = env.model
    q0 = _home(env, base_offset)
    zeros = q0.new_zeros((1, model.nv))
    ps = LeanPipelineState(qpos=q0[None], qvel=zeros, qacc_warmstart=zeros)
    home_joints = torch.as_tensor(env._init_q[7:], dtype=q0.dtype, device=q0.device)
    for _ in range(n_steps):
        tau = env.config.kp * (home_joints - ps.qpos[:, 7:]) - env.config.kd * ps.qvel[:, 6:]
        ps = pipeline.step(model, ps, tau, n_substeps=1)
    return ps.qpos[0]
