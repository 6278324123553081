# Frozen copy of tpu_dialmpc_torch/dynamics/kinematics.py at commit ce76357, imports made relative.
"""Forward kinematics and CoM-frame quantities (MuJoCo mj_kinematics,
mj_comPos, mj_comVel), batched over samples.

Counterpart of `tpu_dialmpc/dynamics/kinematics.py`, with the same outputs
and conventions (6D vectors are [angular; linear], in the world frame
anchored at the kinematic root's subtree CoM).  The JAX stages are written
per sample, with Python loops over bodies, and batched by `vmap`; here every
tensor has a leading sample axis (B, ...) and:

- forward kinematics runs one tree level at a time: the bodies of a level
  have their parents in the level before, so each level is a few ops over
  all its bodies (split by joint type);
- the sums over a body's subtree (subtree CoM; CRB and RNE in `smooth.py`)
  and over its ancestors' dofs (cvel, the dofs' velocities before their own
  joint) are products with fixed 0/1 matrices of the tree.  They add the
  same terms as the JAX package's unrolled recursions, in another order.

Model constants live on the device, made once per (model, device, dtype)
(`model.cached`).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from .rotations import normalize_quat, quat_mul, quat_to_mat, rotate
from .model import (
    JNT_FREE,
    JNT_HINGE,
    JNT_SLIDE,
    PhysicsModel,
    cached,
)


class Kinematics(NamedTuple):
    xpos: torch.Tensor  # (B, nbody, 3) body frame origins
    xquat: torch.Tensor  # (B, nbody, 4)
    xipos: torch.Tensor  # (B, nbody, 3) inertial frame origins
    ximat: torch.Tensor  # (B, nbody, 3, 3)
    xanchor: torch.Tensor  # (B, njnt, 3) joint anchors
    xaxis: torch.Tensor  # (B, njnt, 3) joint axes
    geom_xpos: torch.Tensor  # (B, ngeom, 3)
    geom_xmat: torch.Tensor  # (B, ngeom, 3, 3)
    site_xpos: torch.Tensor  # (B, nsite, 3)
    subtree_com: torch.Tensor  # (B, nbody, 3)
    cinert: torch.Tensor  # (B, nbody, 6, 6) spatial inertia, com-anchored frame
    cdof: torch.Tensor  # (B, nv, 6)


class Velocity(NamedTuple):
    cvel: torch.Tensor  # (B, nbody, 6)
    cdof_dot: torch.Tensor  # (B, nv, 6)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a × b over the last axis, broadcasting the others."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v ×ₘ m (mju_crossMotion), [ang; lin]."""
    ang = cross(v[..., :3], m[..., :3])
    lin = cross(v[..., :3], m[..., 3:]) + cross(v[..., 3:], m[..., :3])
    return torch.cat([ang, lin], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v ×f f (mju_crossForce), [ang; lin]."""
    ang = cross(v[..., :3], f[..., :3]) + cross(v[..., 3:], f[..., 3:])
    lin = cross(v[..., :3], f[..., 3:])
    return torch.cat([ang, lin], dim=-1)


def _skew(v: torch.Tensor) -> torch.Tensor:
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


def subtree_matrix(model: PhysicsModel) -> np.ndarray:
    """(nbody, nbody): S[p, b] = 1 where b is p or a descendant of p."""
    nb = model.nbody
    S = np.eye(nb)
    for b in range(nb - 1, 0, -1):
        S[int(model.body_parentid[b])] += S[b]
    return np.minimum(S, 1.0)


def _build_consts(model: PhysicsModel, device, dtype):
    def f(x):
        return torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)

    def i(x, shape=(-1,)):
        return torch.as_tensor(np.asarray(x, np.int64).reshape(shape), device=device)

    nb = model.nbody
    depth = [0] * nb
    for b in range(1, nb):
        depth[b] = depth[int(model.body_parentid[b])] + 1

    def group(level, jt):
        """The level's bodies whose joint has type jt: their places in the
        level and their joints."""
        rows = [(k, int(model.body_jntadr[b])) for k, b in enumerate(level)
                if int(model.body_jntadr[b]) >= 0
                and int(model.jnt_type[int(model.body_jntadr[b])]) == jt]
        if not rows:
            return None
        local = [k for k, _ in rows]
        jids = [j for _, j in rows]
        qadr = [int(model.jnt_qposadr[j]) for j in jids]
        return SimpleNamespace(
            whole=local == list(range(len(level))),
            local=i(local),
            jids=i(jids),
            qadr=i(qadr),
            free_pos=i([[a + k for k in range(3)] for a in qadr], (-1, 3)),
            free_quat=i([[a + 3 + k for k in range(4)] for a in qadr], (-1, 4)),
            axis=f(model.jnt_axis[jids]),
            jpos=f(model.jnt_pos[jids]),
            qpos0=f(model.qpos0[qadr]),
        )

    levels = []
    for d in range(1, max(depth) + 1):
        level = [b for b in range(nb) if depth[b] == d]
        levels.append(SimpleNamespace(
            idx=i(level),
            parent=i([int(model.body_parentid[b]) for b in level]),
            bpos=f(model.body_pos[level]),
            bquat=f(model.body_quat[level]),
            free=group(level, JNT_FREE),
            slide=group(level, JNT_SLIDE),
            hinge=group(level, JNT_HINGE),
        ))

    # cdof, by joint type: hinge and slide joints one dof each; free joints
    # six, the translational three constant
    def joints(jt):
        return [j for j in range(model.njnt) if int(model.jnt_type[j]) == jt]

    hinge, slide, free = joints(JNT_HINGE), joints(JNT_SLIDE), joints(JNT_FREE)
    free_lin = np.zeros((len(free), 3, 6))
    free_lin[:, [0, 1, 2], [3, 4, 5]] = 1.0

    # the velocity a dof's cdof_dot is taken at: its body's parent's cvel,
    # plus, for a free joint's rotational dofs, its translational ones
    nv = model.nv
    dmask = np.asarray(model.body_dof_mask, np.float64)
    v_before = np.zeros((nv, nv))
    not_free_lin = np.ones(nv)
    for j in range(model.njnt):
        b = int(model.jnt_bodyid[j])
        adr = int(model.jnt_dofadr[j])
        ndof = 6 if int(model.jnt_type[j]) == JNT_FREE else 1
        for k in range(ndof):
            v_before[adr + k] = dmask[int(model.body_parentid[b])]
        if ndof == 6:
            v_before[adr + 3 : adr + 6, adr : adr + 3] = 1.0
            not_free_lin[adr : adr + 3] = 0.0

    mass = np.asarray(model.body_mass, np.float64)
    S = subtree_matrix(model)
    sub_mass = np.maximum(S @ mass, 1e-12)
    rootid = [int(r) for r in model.body_rootid]
    return SimpleNamespace(
        levels=levels,
        body_ipos=f(model.body_ipos),
        body_iquat=f(model.body_iquat),
        body_inertia=f(model.body_inertia),
        mass=f(mass),
        sub_mass=f(sub_mass),
        subtree=f(S),
        rootid=i(rootid),
        geom_bodyid=i(model.geom_bodyid),
        geom_pos=f(model.geom_pos),
        geom_quat=f(model.geom_quat),
        site_bodyid=i(model.site_bodyid),
        site_pos=f(model.site_pos),
        eye3=f(np.eye(3)),
        identity_quat=f([1.0, 0.0, 0.0, 0.0]),
        hinge=SimpleNamespace(
            jids=i(hinge), dofs=i(model.jnt_dofadr[hinge]),
            root=i([rootid[int(model.jnt_bodyid[j])] for j in hinge])) if hinge else None,
        slide=SimpleNamespace(
            jids=i(slide), dofs=i(model.jnt_dofadr[slide])) if slide else None,
        free=SimpleNamespace(
            body=i(model.jnt_bodyid[free]),
            root=i([rootid[int(model.jnt_bodyid[j])] for j in free]),
            dofs=i([[int(model.jnt_dofadr[j]) + k for k in range(6)] for j in free]),
            lin=f(free_lin)) if free else None,
        body_dof_mask=f(dmask),
        v_before=f(v_before),
        not_free_lin=f(not_free_lin),
    )


def consts(model: PhysicsModel, device, dtype):
    """The kinematics stages' model constants on `device` in `dtype`."""
    return cached(model, ("kinematics", str(device), dtype),
                  lambda: _build_consts(model, device, dtype))


def _axis_angle_quat(axis, angle):
    half = 0.5 * angle
    return torch.cat([torch.cos(half)[..., None], axis * torch.sin(half)[..., None]], dim=-1)


def kinematics(model: PhysicsModel, qpos: torch.Tensor) -> Kinematics:
    """FK + CoM-position stage (mj_kinematics + mj_comPos) for qpos (B, nq)."""
    B = qpos.shape[0]
    c = consts(model, qpos.device, qpos.dtype)
    xpos = qpos.new_zeros((B, model.nbody, 3))
    xquat = qpos.new_zeros((B, model.nbody, 4))
    xquat[:, 0] = c.identity_quat
    xanchor = qpos.new_zeros((B, model.njnt, 3))
    xaxis = qpos.new_zeros((B, model.njnt, 3))

    def part(x, g):
        return x if g.whole else x.index_select(1, g.local)

    def put(x, g, v):
        return v if g.whole else x.index_copy(1, g.local, v)

    for lv in c.levels:
        pq = xquat.index_select(1, lv.parent)
        pos = xpos.index_select(1, lv.parent) + rotate(lv.bpos, pq)
        quat = quat_mul(pq, lv.bquat)
        g = lv.free
        if g is not None:
            p = qpos[:, g.free_pos]
            xanchor.index_copy_(1, g.jids, p)
            xaxis.index_copy_(1, g.jids, g.axis.expand(B, -1, -1))
            pos = put(pos, g, p)
            quat = put(quat, g, normalize_quat(qpos[:, g.free_quat]))
        g = lv.slide
        if g is not None:
            q = part(quat, g)
            axis_w = rotate(g.axis, q)
            p = part(pos, g)
            # the anchor is at the reference (untranslated) joint position
            xanchor.index_copy_(1, g.jids, p + rotate(g.jpos, q))
            pos = put(pos, g, p + axis_w * (qpos[:, g.qadr] - g.qpos0)[..., None])
            xaxis.index_copy_(1, g.jids, axis_w)
        g = lv.hinge
        if g is not None:
            q = part(quat, g)
            anchor = part(pos, g) + rotate(g.jpos, q)
            q = quat_mul(q, _axis_angle_quat(g.axis, qpos[:, g.qadr] - g.qpos0))
            xanchor.index_copy_(1, g.jids, anchor)
            xaxis.index_copy_(1, g.jids, rotate(g.axis, q))
            pos = put(pos, g, anchor - rotate(g.jpos, q))
            quat = put(quat, g, q)
        xpos.index_copy_(1, lv.idx, pos)
        xquat.index_copy_(1, lv.idx, quat)

    xipos = xpos + rotate(c.body_ipos, xquat)
    ximat = quat_to_mat(quat_mul(xquat, c.body_iquat))
    gq = xquat.index_select(1, c.geom_bodyid)
    geom_xpos = xpos.index_select(1, c.geom_bodyid) + rotate(c.geom_pos, gq)
    geom_xmat = quat_to_mat(quat_mul(gq, c.geom_quat))
    site_xpos = xpos.index_select(1, c.site_bodyid) + rotate(
        c.site_pos, xquat.index_select(1, c.site_bodyid))

    # subtree CoM: the mass-weighted inertial origins summed over each subtree
    sub_mpos = torch.einsum("pb,nbk->npk", c.subtree, c.mass[:, None] * xipos)
    subtree_com = sub_mpos / c.sub_mass[:, None]

    # spatial inertia in the com-anchored world frame
    cvec = xipos - subtree_com.index_select(1, c.rootid)
    inert_c = (ximat * c.body_inertia[:, None, :]) @ ximat.transpose(-1, -2)
    chat = _skew(cvec)
    m_ = c.mass[:, None, None]
    upper_left = inert_c + m_ * (
        torch.sum(cvec * cvec, -1)[..., None, None] * c.eye3
        - cvec[..., None, :] * cvec[..., :, None]
    )
    upper_right = m_ * chat
    lower_right = (m_ * c.eye3).expand_as(upper_left)
    cinert = torch.cat(
        [torch.cat([upper_left, upper_right], -1), torch.cat([-upper_right, lower_right], -1)],
        -2,
    )

    # cdof: motion subspace per dof, in the com-anchored frame
    cdof = qpos.new_zeros((B, model.nv, 6))
    if c.hinge is not None:
        ax = xaxis.index_select(1, c.hinge.jids)
        off = subtree_com.index_select(1, c.hinge.root) - xanchor.index_select(1, c.hinge.jids)
        cdof.index_copy_(1, c.hinge.dofs, torch.cat([ax, cross(ax, off)], -1))
    if c.slide is not None:
        ax = xaxis.index_select(1, c.slide.jids)
        cdof.index_copy_(1, c.slide.dofs, torch.cat([torch.zeros_like(ax), ax], -1))
    if c.free is not None:
        R = quat_to_mat(xquat.index_select(1, c.free.body))  # (B, nf, 3, 3)
        ax = R.transpose(-1, -2)  # row i: the body's axis i in the world
        off = subtree_com.index_select(1, c.free.root) - xpos.index_select(1, c.free.body)
        rot = torch.cat([ax, cross(ax, off[:, :, None, :])], -1)
        block = torch.cat([c.free.lin.expand(B, -1, -1, -1), rot], -2)  # (B, nf, 6, 6)
        cdof.index_copy_(1, c.free.dofs, block.reshape(B, -1, 6))

    return Kinematics(
        xpos=xpos, xquat=xquat, xipos=xipos, ximat=ximat, xanchor=xanchor, xaxis=xaxis,
        geom_xpos=geom_xpos, geom_xmat=geom_xmat, site_xpos=site_xpos,
        subtree_com=subtree_com, cinert=cinert, cdof=cdof,
    )


def com_vel(model: PhysicsModel, kin: Kinematics, qvel: torch.Tensor) -> Velocity:
    """Body spatial velocities and cdof time derivatives (mj_comVel).

    cvel[b] is the sum of cdof·qvel over the dofs of b's ancestor chain
    (itself included); a dof's cdof_dot is taken at its body's parent's
    cvel, for a free joint's rotational dofs plus its translational part,
    and is zero for the translational dofs, as in the JAX stage."""
    c = consts(model, qvel.device, qvel.dtype)
    vd = kin.cdof * qvel[..., None]
    cvel = torch.einsum("bd,ndk->nbk", c.body_dof_mask, vd)
    v = torch.einsum("de,nek->ndk", c.v_before, vd)
    cdof_dot = motion_cross(v, kin.cdof) * c.not_free_lin[:, None]
    return Velocity(cvel=cvel, cdof_dot=cdof_dot)
