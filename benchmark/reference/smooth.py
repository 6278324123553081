# Frozen copy of tpu_dialmpc_torch/dynamics/smooth.py at commit ce76357, imports made relative.
"""Smooth (unconstrained) dynamics: CRB mass matrix, RNE bias, passive force,
actuation, batched over samples.

Counterpart of `tpu_dialmpc/dynamics/smooth.py` (MuJoCo's mj_crb, mj_rne,
mj_passive, mj_fwdActuation).  The JAX stages' backward tree passes (the
composite inertias, the body forces) are sums over each body's subtree;
here they are one product with the tree's subtree matrix
(`kinematics.subtree_matrix`), and the forward pass of the accelerations a
sum over each body's ancestor dofs.  The mass matrix is assembled as in the
JAX stage: one batched (nv, 6) x (6, nv) product, masked to ancestor pairs.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from . import kinematics as K
from .model import PhysicsModel, cached


def _build_consts(model: PhysicsModel, device, dtype):
    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int64).reshape(-1), device=device)

    nv = model.nv
    mask_l = np.asarray(model.ancestor_mask, np.float64)  # j ancestor-or-self of i
    g = np.asarray(model.gravity, np.float64)
    lo, hi = np.asarray(model.actuator_ctrlrange, np.float64).T.reshape(2, -1)
    flo, fhi = np.asarray(model.actuator_forcerange, np.float64).T.reshape(2, -1)
    bias = np.asarray(model.actuator_biasprm, np.float64).reshape(-1, 3)
    return SimpleNamespace(
        dof_bodyid=i(model.dof_bodyid),
        mask_l=f(mask_l),
        strict=f(mask_l * (1.0 - np.eye(nv))),
        armature=f(np.diag(model.dof_armature)),
        cacc0=f(np.concatenate([np.zeros(3), -g])),
        damping=f(model.dof_damping),
        ctrl_limited=bool(np.asarray(model.actuator_ctrllimited).any()),
        ctrl_mask=torch.as_tensor(np.asarray(model.actuator_ctrllimited, bool), device=device),
        ctrl_lo=f(lo), ctrl_hi=f(hi),
        force_limited=bool(np.asarray(model.actuator_forcelimited).any()),
        force_mask=torch.as_tensor(np.asarray(model.actuator_forcelimited, bool), device=device),
        force_lo=f(flo), force_hi=f(fhi),
        gain=f(model.actuator_gainprm),
        has_bias=bool((bias != 0).any()),
        bias=f(bias),
        act_qadr=i(model.actuator_qposadr),
        act_dadr=i(model.actuator_dofadr),
        gear=f(model.actuator_gear),
    )


def consts(model: PhysicsModel, device, dtype):
    return cached(model, ("smooth", str(device), dtype),
                  lambda: _build_consts(model, device, dtype))


def crb_mass_matrix(model: PhysicsModel, kin: K.Kinematics) -> torch.Tensor:
    """Dense joint-space inertia matrices M (B, nv, nv), armature included.

    Composite rigid body: crb[b] = the sum of cinert over b's subtree;
    M[i,j] = cdof[j]ᵀ crb[body(i)] cdof[i] for ancestor pairs, assembled as
    one masked product."""
    c = consts(model, kin.cdof.device, kin.cdof.dtype)
    kc = K.consts(model, kin.cdof.device, kin.cdof.dtype)
    crb = torch.einsum("pb,nbij->npij", kc.subtree, kin.cinert)
    crb_per_dof = crb.index_select(1, c.dof_bodyid)
    f = torch.einsum("niab,nib->nia", crb_per_dof, kin.cdof)
    g = f @ kin.cdof.transpose(-1, -2)  # g[i, j] = cdof[j]' crb[body(i)] cdof[i]
    m_mat = g * c.mask_l + (g * c.strict).transpose(-1, -2)
    return m_mat + c.armature


def rne_bias(model: PhysicsModel, kin: K.Kinematics, vel: K.Velocity,
             qvel: torch.Tensor) -> torch.Tensor:
    """Bias force qfrc_bias = C(q, qvel) (mj_rne with flg_acc=0), (B, nv)."""
    c = consts(model, qvel.device, qvel.dtype)
    kc = K.consts(model, qvel.device, qvel.dtype)
    # spatial accelerations: gravity as the base acceleration, no qacc
    cacc = c.cacc0 + torch.einsum("bd,ndk->nbk", kc.body_dof_mask,
                                  vel.cdof_dot * qvel[..., None])
    # body forces f = I a + v ×f (I v), summed over each subtree
    iv = (kin.cinert @ vel.cvel[..., None])[..., 0]
    cfrc = (kin.cinert @ cacc[..., None])[..., 0] + K.force_cross(vel.cvel, iv)
    cfrc = torch.einsum("pb,nbk->npk", kc.subtree, cfrc)
    return torch.sum(kin.cdof * cfrc.index_select(1, c.dof_bodyid), dim=-1)


def passive_force(model: PhysicsModel, qvel: torch.Tensor) -> torch.Tensor:
    """qfrc_passive: joint damping (mj_passive; no springs or fluid here)."""
    return -consts(model, qvel.device, qvel.dtype).damping * qvel


def actuator_force(model: PhysicsModel, ctrl: torch.Tensor, qpos: torch.Tensor | None = None,
                   qvel: torch.Tensor | None = None) -> torch.Tensor:
    """qfrc_actuator (mj_fwdActuation for fixed-gain, none/affine-bias
    actuators), (B, nv).

    Per actuator: force = gain·ctrl + b0 + b1·q + b2·q̇, ctrl clamped to its
    ctrlrange and the force to its forcerange where limited, then scaled by
    the gear and added to the target dof.  Covers <motor> (gain 1, no bias)
    and <position kp kv> (gain kp, bias (0, -kp, -kv))."""
    c = consts(model, ctrl.device, ctrl.dtype)
    x = ctrl
    if c.ctrl_limited:
        x = torch.where(c.ctrl_mask, torch.clamp(x, c.ctrl_lo, c.ctrl_hi), x)
    force = c.gain * x
    if c.has_bias:
        if qpos is None or qvel is None:
            raise ValueError("affine-bias actuators need qpos/qvel")
        b = c.bias
        force = force + b[:, 0] + b[:, 1] * qpos.index_select(1, c.act_qadr) \
            + b[:, 2] * qvel.index_select(1, c.act_dadr)
    if c.force_limited:
        force = torch.where(c.force_mask, torch.clamp(force, c.force_lo, c.force_hi), force)
    force = c.gear * force
    qfrc = ctrl.new_zeros((ctrl.shape[0], model.nv))
    return qfrc.index_add_(1, c.act_dadr, force)
