# Frozen copy of tpu_dialmpc_torch/dynamics/pipeline.py at commit ce76357, imports made relative.
"""Physics pipeline: `init` and the substepped `step` over a state dataclass,
batched over samples.

Counterpart of `tpu_dialmpc/dynamics/pipeline.py` (the JAX package's XLA
physics path): one forward pass is kinematics → CoM velocities → mass matrix,
actuation, passive and bias forces → qacc_smooth → collision → constraint
rows → the Newton solve; `step` then integrates (semi-implicit Euler,
implicitly in the joint damping as mj_Euler does, free-joint quaternions by
mju_quatIntegrate).  As in mj_step, the derived fields of the returned state
are those of the last substep's forward pass, before its integration.

Every tensor has a leading sample axis; `init` and `step` also take one
unbatched state (qpos (nq,), ...) and return it unbatched.  `step`'s
substeps are a Python loop.  No op reads a value back to the host and every
model constant is a device tensor made once (`model.cached`), so a step
makes no host-device synchronisation.  This path runs every pair kind and
any model; the fused substep (`fused.py`, `fused_cuda.py`) is the fast path
for the models `fused.supported` accepts.
"""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from .rotations import quat_integrate
from . import collision, constraint, kinematics, linalg, smooth, solver
from .model import JNT_FREE, PhysicsModel, cached


@dataclasses.dataclass(frozen=True)
class PipelineState:
    """Physics state plus the derived quantities of its last forward pass."""

    qpos: torch.Tensor  # (..., nq)
    qvel: torch.Tensor  # (..., nv)
    qacc_warmstart: torch.Tensor  # (..., nv)
    xpos: torch.Tensor  # (..., nbody, 3)
    xquat: torch.Tensor  # (..., nbody, 4)
    site_xpos: torch.Tensor  # (..., nsite, 3)
    subtree_com: torch.Tensor  # (..., nbody, 3)
    cvel: torch.Tensor  # (..., nbody, 6) [ang; lin] com-anchored
    qfrc_actuator: torch.Tensor  # (..., nv)
    # (..., nefc_max) constraint forces; None in a state the fused substep's
    # forward stages built (envs/legged.py full_state), which have no solve
    efc_force: Optional[torch.Tensor] = None


def _forward(model: PhysicsModel, qpos, qvel, ctrl):
    """One forward-dynamics pass: (kinematics, velocities, M, qacc_smooth,
    constraint rows, qfrc_actuator)."""
    cparams = collision.get_contact_params(model)
    kin = kinematics.kinematics(model, qpos)
    vel = kinematics.com_vel(model, kin, qvel)
    m_mat = smooth.crb_mass_matrix(model, kin)
    qfrc_actuator = smooth.actuator_force(model, ctrl, qpos, qvel)
    qfrc_smooth = (smooth.passive_force(model, qvel) + qfrc_actuator
                   - smooth.rne_bias(model, kin, vel, qvel))
    qacc_smooth = linalg.solve_psd(m_mat, qfrc_smooth)
    contacts = collision.collide(model, kin)
    con = constraint.make_constraints(model, kin, qpos, qvel, contacts, cparams)
    return kin, vel, m_mat, qacc_smooth, con, qfrc_actuator


def _build_consts(model: PhysicsModel, device, dtype):
    # (nq, nv): the linear dof velocities into their qpos slots (zero rows
    # for the quaternions' components, integrated on their own)
    S = np.zeros((model.nq, model.nv))
    quat_q, omega_d = [], []
    for j in range(model.njnt):
        qadr, dadr = int(model.jnt_qposadr[j]), int(model.jnt_dofadr[j])
        if int(model.jnt_type[j]) == JNT_FREE:
            S[qadr : qadr + 3, dadr : dadr + 3] = np.eye(3)
            quat_q.append([qadr + 3 + k for k in range(4)])
            omega_d.append([dadr + 3 + k for k in range(3)])
        else:
            S[qadr, dadr] = 1.0
    damping = np.asarray(model.dof_damping, np.float64)
    return SimpleNamespace(
        S_t=torch.as_tensor(S.T, dtype=dtype, device=device),
        quat_q=torch.as_tensor(np.asarray(quat_q, np.int64), device=device),
        omega_d=torch.as_tensor(np.asarray(omega_d, np.int64), device=device),
        has_free=bool(quat_q),
        implicit_damp=bool(model.eulerdamp) and bool((damping != 0).any()),
        dt_damp=torch.as_tensor(np.diag(model.timestep * damping), dtype=dtype, device=device),
    )


def consts(model: PhysicsModel, device, dtype):
    return cached(model, ("pipeline", str(device), dtype),
                  lambda: _build_consts(model, device, dtype))


def _integrate_pos(model: PhysicsModel, c, qpos, qvel, dt):
    """Semi-implicit position update (mj_integratePos): one product for every
    linear qpos slot, mju_quatIntegrate for each free joint's quaternion."""
    out = qpos + dt * (qvel @ c.S_t)
    if c.has_free:
        B = qpos.shape[0]
        quat = quat_integrate(qpos[:, c.quat_q], qvel[:, c.omega_d], dt)
        out = out.index_copy(1, c.quat_q.reshape(-1), quat.reshape(B, -1))
    return out


def _batched(fn):
    """Let fn take one unbatched state: a leading sample axis is added to the
    tensors in and taken off those out."""

    def wrapper(model, *args, **kw):
        single = args[0].qpos.dim() == 1 if hasattr(args[0], "qpos") else args[0].dim() == 1
        if not single:
            return fn(model, *args, **kw)

        def add(x):
            if isinstance(x, torch.Tensor):
                return x[None]
            if dataclasses.is_dataclass(x):
                return dataclasses.replace(x, **{
                    f.name: add(getattr(x, f.name)) for f in dataclasses.fields(x)})
            return x

        out = fn(model, *(add(a) for a in args), **{k: add(v) for k, v in kw.items()})
        return dataclasses.replace(out, **{
            f.name: getattr(out, f.name)[0] for f in dataclasses.fields(out)
            if isinstance(getattr(out, f.name), torch.Tensor)})

    wrapper.__doc__, wrapper.__name__ = fn.__doc__, fn.__name__
    return wrapper


def _state(qpos, qvel, warmstart, kin, vel, qfrc_actuator, efc_force) -> PipelineState:
    return PipelineState(
        qpos=qpos, qvel=qvel, qacc_warmstart=warmstart, xpos=kin.xpos, xquat=kin.xquat,
        site_xpos=kin.site_xpos, subtree_com=kin.subtree_com, cvel=vel.cvel,
        qfrc_actuator=qfrc_actuator, efc_force=efc_force,
    )


@_batched
def init(model: PhysicsModel, qpos: torch.Tensor, qvel: torch.Tensor) -> PipelineState:
    """mj_forward: the derived fields at (qpos, qvel), zero ctrl.

    The warm start is zero, as after mj_resetData (mj_forward does not
    update it); the truncated Newton solve's starting point is observable,
    so the first step starts from zero, as the oracle's reset → forward →
    step does."""
    ctrl = qpos.new_zeros((qpos.shape[0], model.nu))
    kin, vel, m_mat, qacc_smooth, con, qfrc_actuator = _forward(model, qpos, qvel, ctrl)
    zero = torch.zeros_like(qacc_smooth)
    res = solver.solve(model, m_mat, qacc_smooth, zero, con)
    return _state(qpos, qvel, zero, kin, vel, qfrc_actuator, res.efc_force)


@_batched
def step(model: PhysicsModel, state, ctrl: torch.Tensor, n_substeps: int = 1) -> PipelineState:
    """Advance by n_substeps × model.timestep under constant ctrl (B, nu).
    Reads only the state's qpos, qvel and qacc_warmstart (a PipelineState
    or a LeanPipelineState)."""
    dt = model.timestep
    qpos, qvel, ws = state.qpos, state.qvel, state.qacc_warmstart
    c = consts(model, qpos.device, qpos.dtype)
    out = None
    for _ in range(n_substeps):
        kin, vel, m_mat, qacc_smooth, con, qfrc_actuator = _forward(model, qpos, qvel, ctrl)
        res = solver.solve(model, m_mat, qacc_smooth, ws, con)
        if c.implicit_damp:
            # mj_Euler: (M + dt·diag(damping)) qacc_int = qfrc_smooth +
            # qfrc_constraint, qfrc_smooth recovered as M @ qacc_smooth; the
            # warm start keeps the solver's qacc
            qfrc = (m_mat @ qacc_smooth[..., None])[..., 0] + res.qfrc_constraint
            qacc_int = linalg.solve_psd(m_mat + c.dt_damp, qfrc)
        else:
            qacc_int = res.qacc
        qvel_new = qvel + dt * qacc_int
        qpos_new = _integrate_pos(model, c, qpos, qvel_new, dt)
        out = _state(qpos_new, qvel_new, res.qacc, kin, vel, qfrc_actuator, res.efc_force)
        qpos, qvel, ws = qpos_new, qvel_new, res.qacc
    return out
