# Frozen copy of tpu_dialmpc_torch/dynamics/constraint.py at commit ce76357, imports made relative.
"""Constraint row (efc) assembly: dof friction loss, joint limits, pyramidal
contacts, batched over samples.

Counterpart of `tpu_dialmpc/dynamics/constraint.py` (MuJoCo's
mj_makeConstraint / mj_instantiate*): a fixed row count per model, each row
with an `active` mask, in MuJoCo's order: friction loss (one row per dof
with frictionloss > 0, always active), limits (a lower and an upper row per
limited hinge or slide joint, active when violated within the margin), then
contacts slot by slot, 1 row for condim 1 and 4 pyramidal rows (tangent 1
±μ, tangent 2 ±μ) for condim 3; any other condim raises.  The
soft-constraint parameters follow the MuJoCo computation spec (see the JAX
module's docstring): impedance, aref = -b·(J qvel) - k·imp·(pos - margin),
D = 1/R with mj_diagApprox's diagonal (pyramidal rows 2·(1+μ²)·invweight).

All rows of a kind are built at once; the fused substep (`fused.py`) builds
the same rows per sample.  MJ_MINVAL, MJ_MINIMP and MJ_MAXIMP are MuJoCo's
constants, as in the JAX module.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from .collision import ContactParams, Contacts
from .kinematics import Kinematics, cross
from .kinematics import consts as kin_consts
from .model import JNT_HINGE, JNT_SLIDE, PhysicsModel, cached

MJ_MINVAL = 1e-15
MJ_MINIMP = 0.0001
MJ_MAXIMP = 0.9999


class Constraints(NamedTuple):
    J: torch.Tensor  # (B, nefc, nv)
    pos: torch.Tensor  # (B, nefc) constraint "position" (dist for contacts)
    margin: torch.Tensor  # (nefc,) a model constant per row
    aref: torch.Tensor  # (B, nefc)
    D: torch.Tensor  # (B, nefc) inverse regularizer
    active: torch.Tensor  # (B, nefc) bool: the row exists this step
    floss: torch.Tensor  # (nefc,) frictionloss (> 0 marks Huber rows)


def impedance(solimp: torch.Tensor, pos: torch.Tensor, margin: torch.Tensor):
    """MuJoCo's impedance sigmoid d(x), x = |pos - margin| / width."""
    dmin, dmax, width, mid, power = solimp.unbind(-1)
    x = torch.clamp(torch.abs(pos - margin) / torch.clamp(width, min=MJ_MINVAL), 0.0, 1.0)
    mid = torch.clamp(mid, MJ_MINIMP, MJ_MAXIMP)
    power = torch.clamp(power, min=1.0)
    a = 1.0 / torch.pow(mid, power - 1.0)
    b = 1.0 / torch.pow(1.0 - mid, power - 1.0)
    y = torch.where(x <= mid, a * torch.pow(x, power), 1.0 - b * torch.pow(1.0 - x, power))
    return torch.clamp(dmin + y * (dmax - dmin), MJ_MINIMP, MJ_MAXIMP)


def _kb(solref: torch.Tensor, dmax: torch.Tensor):
    """Stiffness and damping from solref (standard positive or direct
    negative)."""
    timeconst, dampratio = solref.unbind(-1)
    std_k = 1.0 / torch.clamp(
        dmax * dmax * timeconst * timeconst * dampratio * dampratio, min=MJ_MINVAL)
    std_b = 2.0 / torch.clamp(dmax * timeconst, min=MJ_MINVAL)
    direct = (timeconst <= 0) | (dampratio <= 0)
    k = torch.where(direct, -timeconst / torch.clamp(dmax * dmax, min=MJ_MINVAL), std_k)
    b = torch.where(direct, -dampratio, std_b)
    return k, b


def aref_and_d(solref, solimp, diag_approx, pos, margin, vel):
    """Reference acceleration and inverse regularizer D of rows."""
    imp = impedance(solimp, pos, margin)
    k, b = _kb(solref, solimp[..., 1])
    aref = -b * vel - k * imp * (pos - margin)
    r = torch.clamp((1.0 - imp) / imp * diag_approx, min=MJ_MINVAL)
    return aref, 1.0 / r


def point_jacobian(model: PhysicsModel, kin: Kinematics, point: torch.Tensor,
                   body: torch.Tensor) -> torch.Tensor:
    """Translational jacobians (mj_jac) of world points (B, k, 3) on bodies
    `body` (k,), a long tensor on the points' device: (B, k, nv, 3)."""
    c = kin_consts(model, point.device, point.dtype)
    com = kin.subtree_com.index_select(1, c.rootid.index_select(0, body))
    offset = point - com
    cdof = kin.cdof[:, None]  # (B, 1, nv, 6)
    jac = cdof[..., 3:] + cross(cdof[..., :3], offset[:, :, None, :])
    return jac * c.body_dof_mask.index_select(0, body)[..., None]


def _build_consts(model: PhysicsModel, cparams: ContactParams, device, dtype):
    nv = model.nv
    J0, solref, solimp, diag, margin, floss = [], [], [], [], [], []

    # dof friction loss
    fl_dofs = [d for d in range(nv) if float(model.dof_frictionloss[d]) > 0]
    for d in fl_dofs:
        J0.append(np.eye(nv)[d])
        solref.append(model.dof_solref[d])
        solimp.append(model.dof_solimp[d])
        diag.append(model.dof_invweight0[d])
        margin.append(0.0)
        floss.append(float(model.dof_frictionloss[d]))

    # joint limits: a lower and an upper row per limited joint
    lim_qadr, lim_sign, lim_bound = [], [], []
    for j in range(model.njnt):
        if not model.jnt_limited[j] or int(model.jnt_type[j]) not in (JNT_HINGE, JNT_SLIDE):
            continue
        dadr = int(model.jnt_dofadr[j])
        for sign, bound in ((1.0, model.jnt_range[j, 0]), (-1.0, model.jnt_range[j, 1])):
            J0.append(sign * np.eye(nv)[dadr])
            solref.append(model.jnt_solref[j])
            solimp.append(model.jnt_solimp[j])
            diag.append(model.dof_invweight0[dadr])
            margin.append(model.jnt_margin[j])
            floss.append(0.0)
            lim_qadr.append(int(model.jnt_qposadr[j]))
            lim_sign.append(sign)
            lim_bound.append(float(bound))

    # contacts: the rows of the condim-1 slots, then those of the condim-3
    # slots (slot, tangent, sign), put back in slot order by `perm`
    condim = np.asarray(cparams.condim, np.int64)
    bad = sorted({int(x) for x in condim} - {1, 3})
    if bad:
        raise NotImplementedError(f"condim {bad[0]} not supported")
    s1 = np.flatnonzero(condim == 1)
    s3 = np.flatnonzero(condim == 3)
    iw = np.asarray(cparams.invweight, np.float64)
    mu = np.asarray(cparams.friction, np.float64)[s3, :2]  # (n3, 2)
    row_slot = list(s1) + [k for k in s3 for _ in range(4)]
    sm = np.stack([mu, -mu], -1)  # (n3, 2 tangents, 2 signs): s·μ
    c_diag = list(iw[s1]) + [2.0 * (iw[k] + mu[a, t] * mu[a, t] * iw[k])
                             for a, k in enumerate(s3) for t in range(2) for _ in range(2)]
    order = np.argsort(np.asarray(row_slot), kind="stable")
    n0 = len(J0)
    for k in np.asarray(row_slot, np.int64)[order]:
        solref.append(cparams.solref[k])
        solimp.append(cparams.solimp[k])
        margin.append(cparams.includemargin[k])
        floss.append(0.0)
    diag += list(np.asarray(c_diag)[order])

    def f(x, shape):
        return torch.as_tensor(np.asarray(x, np.float64).reshape(shape), dtype=dtype,
                               device=device)

    def i(x):
        return torch.as_tensor(np.asarray(x, np.int64).reshape(-1), device=device)

    nrow = len(diag)
    floss = np.asarray(floss)
    return SimpleNamespace(
        nrow=nrow,
        n0=n0,
        J0=f(J0, (n0, nv)),
        lim_qadr=i(lim_qadr),
        lim_sign=f(lim_sign, (-1,)),
        lim_bound=f(lim_bound, (-1,)),
        n_fl=len(fl_dofs),
        s1=i(s1), s3=i(s3), has1=s1.size > 0, has3=s3.size > 0,
        sm=f(sm, (-1, 2, 2)),
        body1=i(cparams.body1), body2=i(cparams.body2),
        row_slot=i(np.asarray(row_slot, np.int64)[order]),
        perm=None if np.array_equal(order, np.arange(order.size)) else i(order),
        solref=f(solref, (nrow, 2)),
        solimp=f(solimp, (nrow, 5)),
        diag=f(diag, (nrow,)),
        margin=f(margin, (nrow,)),
        floss=f(floss, (nrow,)),
        any_floss=bool((floss > 0).any()),
    )


def consts(model: PhysicsModel, cparams: ContactParams, device, dtype):
    return cached(model, ("constraint", str(device), dtype),
                  lambda: _build_consts(model, cparams, device, dtype))


def make_constraints(model: PhysicsModel, kin: Kinematics, qpos: torch.Tensor,
                     qvel: torch.Tensor, contacts: Contacts,
                     cparams: ContactParams) -> Constraints:
    """Every constraint row of every sample: qpos (B, nq), qvel (B, nv)."""
    B = qvel.shape[0]
    c = consts(model, cparams, qvel.device, qvel.dtype)
    if c.nrow == 0:
        z = qvel.new_zeros((B, 0))
        return Constraints(J=qvel.new_zeros((B, 0, model.nv)), pos=z, margin=c.margin, aref=z,
                           D=z, active=z.bool(), floss=c.floss)
    parts_J, parts_pos = [], []
    if c.n0:
        parts_J.append(c.J0.expand(B, -1, -1))
        parts_pos.append(qvel.new_zeros((B, c.n_fl)))
        # dist > 0 away from the limit, negative when violated
        parts_pos.append(c.lim_sign * (qpos.index_select(1, c.lim_qadr) - c.lim_bound))
    if c.nrow > c.n0:
        jac_rel = (point_jacobian(model, kin, contacts.pos, c.body2)
                   - point_jacobian(model, kin, contacts.pos, c.body1))  # (B, ncon, nv, 3)
        # (B, ncon, 3 frame rows, nv): the jacobian along n, t1, t2
        jf = contacts.frame @ jac_rel.transpose(-1, -2)
        rows = []
        if c.has1:
            rows.append(jf.index_select(1, c.s1)[:, :, 0])
        if c.has3:
            j3 = jf.index_select(1, c.s3)  # (B, n3, 3, nv)
            J3 = j3[:, :, None, None, 0] + c.sm[..., None] * j3[:, :, 1:, None]
            rows.append(J3.reshape(B, -1, model.nv))
        Jc = torch.cat(rows, 1) if len(rows) > 1 else rows[0]
        if c.perm is not None:
            Jc = Jc.index_select(1, c.perm)
        parts_J.append(Jc)
        parts_pos.append(contacts.dist.index_select(1, c.row_slot))
    J = torch.cat(parts_J, 1) if len(parts_J) > 1 else parts_J[0]
    pos = torch.cat(parts_pos, 1) if len(parts_pos) > 1 else parts_pos[0]
    vel = (J @ qvel[..., None])[..., 0]
    aref, D = aref_and_d(c.solref, c.solimp, c.diag, pos, c.margin, vel)
    active = pos < c.margin
    if c.n_fl:
        active[:, : c.n_fl] = True  # friction-loss rows are always active
    return Constraints(J=J, pos=pos, margin=c.margin, aref=aref, D=D, active=active,
                       floss=c.floss)
