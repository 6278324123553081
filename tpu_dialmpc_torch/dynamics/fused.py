"""The fused physics substep chain, as plain PyTorch: the reference version of
the CUDA kernel in `fused_cuda.py` / `csrc/fused_step.cu`.

Counterpart of `tpu_dialmpc/dynamics/fused.py`.  It computes, per sample,
`n_substeps` x (FK, CoM frames, CRB mass matrix, RNE bias, actuation,
collision, constraint rows, truncated Newton solve, integration) and returns
(qpos', qvel', warmstart', derived reward inputs).

Design: the JAX package's "batched scalar" graph, carried over op for op.  A
scalar is either a Python float (a model constant, folded at graph-build time:
multiplications by 0 and 1 and additions of 0 vanish) or a `(B,)` tensor
holding one value per sample.  Each op below is one elementwise torch op over
the batch, so the plain version runs on the CPU (the tests) and on the card
(where `chip_smoke.py` holds the kernel against it) in float32 or float64.
The op order matches the JAX graph, so float64 runs agree with the JAX
package to rounding, and the kernel, which follows the same order, agrees
with the float32 run closely.

Contact kinds: the six of the JAX kernel, plane-sphere, plane-capsule,
plane-box, sphere-box, capsule-box and box-box (condim 1 or 3, pyramidal),
with the JAX kernel's per-kind approximations (`_contact_geometry`).  A
geom on a body with no dofs (the floor, a mocap crate) has a constant pose,
so its contact math folds into Python constants in double precision, as in
the JAX graph.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from tpu_dialmpc_torch.dynamics.collision import contact_params
from tpu_dialmpc_torch.dynamics.constraint import MJ_MAXIMP, MJ_MINIMP, MJ_MINVAL
from tpu_dialmpc_torch.dynamics.model import (
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_PLANE,
    GEOM_SPHERE,
    JNT_FREE,
    JNT_HINGE,
    JNT_SLIDE,
    PhysicsModel,
)

# ======================================================================
# Batched-scalar algebra with constant folding.
# A "scalar" is either a Python float (model constant) or a (B,) tensor;
# mixing broadcasts.  Folding keeps the op graph lean: unit quaternions, zero
# offsets and axis components vanish when the graph is built.
# ======================================================================


def _isf(a):
    return isinstance(a, (float, int))


def sneg(a):
    if _isf(a):
        return -float(a)
    return -a


def sadd(a, b):
    if _isf(a) and a == 0.0:
        return b
    if _isf(b) and b == 0.0:
        return a
    if _isf(a) and _isf(b):
        return float(a) + float(b)
    return a + b


def ssub(a, b):
    if _isf(b) and b == 0.0:
        return a
    if _isf(a) and _isf(b):
        return float(a) - float(b)
    if _isf(a) and a == 0.0:
        return sneg(b)
    return a - b


def smul(a, b):
    if _isf(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if a == -1.0:
            return sneg(b)
    if _isf(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
        if b == -1.0:
            return sneg(a)
    if _isf(a) and _isf(b):
        return float(a) * float(b)
    return a * b


def sdiv(a, b):
    if _isf(b):
        return smul(a, 1.0 / float(b))
    if _isf(a) and a == 0.0:
        return 0.0
    if _isf(a):
        # true division of the rounded constant (torch's float / tensor is
        # reciprocal-then-multiply, which rounds twice)
        return torch.div(torch.full_like(b, float(a)), b)
    return a / b


def srecip(a):
    if _isf(a):
        return 1.0 / float(a)
    return torch.reciprocal(a)


def ssqrt(a):
    if _isf(a):
        return math.sqrt(float(a))
    return torch.sqrt(a)


def srsqrt(a):
    if _isf(a):
        return 1.0 / math.sqrt(float(a))
    return torch.rsqrt(a)


def ssin(a):
    if _isf(a):
        return math.sin(float(a))
    return torch.sin(a)


def scos(a):
    if _isf(a):
        return math.cos(float(a))
    return torch.cos(a)


def smax(a, b):
    if _isf(a) and _isf(b):
        return max(float(a), float(b))
    if _isf(b):
        return torch.clamp(a, min=float(b))
    if _isf(a):
        return torch.clamp(b, min=float(a))
    return torch.maximum(a, b)


def smin(a, b):
    if _isf(a) and _isf(b):
        return min(float(a), float(b))
    if _isf(b):
        return torch.clamp(a, max=float(b))
    if _isf(a):
        return torch.clamp(b, max=float(a))
    return torch.minimum(a, b)


def sabs(a):
    if _isf(a):
        return abs(float(a))
    return torch.abs(a)


def swhere(c, a, b, like=None):
    """where(c, a, b) over the batch; `like` gives the dtype when both
    branches are constants.  A constant condition (a Python bool, where both
    sides of a comparison folded) picks its branch at graph-build time."""
    if isinstance(c, bool):
        return a if c else b
    if _isf(a) and _isf(b):
        a = torch.full_like(like, float(a))
    return torch.where(c, a, b)


def sdot(xs, ys):
    """Dot product of two scalar sequences with folding."""
    acc = 0.0
    for x, y in zip(xs, ys):
        acc = sadd(acc, smul(x, y))
    return acc


def ssum(xs):
    acc = 0.0
    for x in xs:
        acc = sadd(acc, x)
    return acc


# ---------------------------------------------------------------------
# 3-vectors / quaternions / symmetric 3x3 as tuples of scalars
# ---------------------------------------------------------------------


def v3add(a, b):
    return tuple(sadd(x, y) for x, y in zip(a, b))


def v3sub(a, b):
    return tuple(ssub(x, y) for x, y in zip(a, b))


def v3scale(a, s):
    return tuple(smul(x, s) for x in a)


def v3dot(a, b):
    return sdot(a, b)


def v3cross(a, b):
    return (
        ssub(smul(a[1], b[2]), smul(a[2], b[1])),
        ssub(smul(a[2], b[0]), smul(a[0], b[2])),
        ssub(smul(a[0], b[1]), smul(a[1], b[0])),
    )


def qmul(p, q):
    """Hamilton product (core/rotations.py quat_mul)."""
    pw, px, py, pz = p
    qw, qx, qy, qz = q
    return (
        ssub(ssub(ssub(smul(pw, qw), smul(px, qx)), smul(py, qy)), smul(pz, qz)),
        ssub(sadd(sadd(smul(pw, qx), smul(px, qw)), smul(py, qz)), smul(pz, qy)),
        sadd(sadd(ssub(smul(pw, qy), smul(px, qz)), smul(py, qw)), smul(pz, qx)),
        sadd(ssub(sadd(smul(pw, qz), smul(px, qy)), smul(py, qx)), smul(pz, qw)),
    )


def qrotate(v, q):
    """Rodrigues rotation (core/rotations.py rotate)."""
    s, u = q[0], q[1:]
    uv = v3dot(u, v)
    uu = v3dot(u, u)
    c = v3cross(u, v)
    k = ssub(smul(s, s), uu)
    return tuple(
        sadd(sadd(smul(2.0, smul(u[i], uv)), smul(k, v[i])), smul(2.0, smul(s, c[i])))
        for i in range(3)
    )


def qmat(q):
    """Quaternion -> 3x3 rotation (rows), matching core/rotations.py quat_to_mat."""
    w, x, y, z = q
    return (
        (
            ssub(1.0, smul(2.0, sadd(smul(y, y), smul(z, z)))),
            smul(2.0, ssub(smul(x, y), smul(w, z))),
            smul(2.0, sadd(smul(x, z), smul(w, y))),
        ),
        (
            smul(2.0, sadd(smul(x, y), smul(w, z))),
            ssub(1.0, smul(2.0, sadd(smul(x, x), smul(z, z)))),
            smul(2.0, ssub(smul(y, z), smul(w, x))),
        ),
        (
            smul(2.0, ssub(smul(x, z), smul(w, y))),
            smul(2.0, sadd(smul(y, z), smul(w, x))),
            ssub(1.0, smul(2.0, sadd(smul(x, x), smul(y, y)))),
        ),
    )


def m33_vec(m, v):
    return tuple(sdot(m[i], v) for i in range(3))


def m33_t_vec(m, v):
    return tuple(sdot((m[0][i], m[1][i], m[2][i]), v) for i in range(3))


def qnormalize(q):
    inv = srsqrt(sdot(q, q))
    return tuple(smul(x, inv) for x in q)


# ======================================================================
# Spatial inertia in the CoM-anchored frame:
#   cinert = [[UL(sym 3x3), skew(h)], [-skew(h), m I]],  h = m*c
# represented as (UL 6-tuple: a00 a01 a02 a11 a12 a22, h 3-tuple, m scalar).
# ======================================================================


class CInert(NamedTuple):
    ul: tuple  # (a00, a01, a02, a11, a12, a22)
    h: tuple  # (3,)
    m: object  # scalar (python float: masses are model constants)


def cinert_add(a: CInert, b: CInert) -> CInert:
    return CInert(
        ul=tuple(sadd(x, y) for x, y in zip(a.ul, b.ul)),
        h=v3add(a.h, b.h),
        m=sadd(a.m, b.m),
    )


def _ul_vec(ul, v):
    a00, a01, a02, a11, a12, a22 = ul
    return (
        sadd(sadd(smul(a00, v[0]), smul(a01, v[1])), smul(a02, v[2])),
        sadd(sadd(smul(a01, v[0]), smul(a11, v[1])), smul(a12, v[2])),
        sadd(sadd(smul(a02, v[0]), smul(a12, v[1])), smul(a22, v[2])),
    )


def cinert_vec(ci: CInert, v6):
    """cinert @ [ang; lin] -> [UL@ang + h x lin ; -h x ang + m lin]."""
    ang, lin = v6[:3], v6[3:]
    out_ang = v3add(_ul_vec(ci.ul, ang), v3cross(ci.h, lin))
    out_lin = v3add(v3scale(v3cross(ci.h, ang), -1.0), v3scale(lin, ci.m))
    return out_ang + out_lin


def motion_cross(v, m):
    """Spatial motion cross product."""
    ang = v3cross(v[:3], m[:3])
    lin = v3add(v3cross(v[:3], m[3:]), v3cross(v[3:], m[:3]))
    return ang + lin


def force_cross(v, f):
    """Spatial force cross product."""
    ang = v3add(v3cross(v[:3], f[:3]), v3cross(v[3:], f[3:]))
    lin = v3cross(v[:3], f[3:])
    return ang + lin


# ======================================================================
# Static model metadata extraction
# ======================================================================


class _Meta(NamedTuple):
    anc_strict: Tuple[Tuple[int, ...], ...]  # per dof: strict ancestors (j<i)
    m_keys: Tuple[Tuple[int, int], ...]  # (i, j) i>=j tree-sparse M pattern
    # Newton-Hessian pattern: tree pattern + cliques over each contact row's
    # dof support + symbolic LDL fill-in
    anc_solver: Tuple[Tuple[int, ...], ...]
    contact_slots: tuple  # static per-slot contact descriptors
    limit_rows: tuple
    floss_rows: tuple


def _ancestors(model: PhysicsModel):
    return tuple(
        tuple(j for j in range(i) if model.ancestor_mask[i, j] > 0.5)
        for i in range(model.nv)
    )


_FUSED_KINDS = (
    (GEOM_PLANE, GEOM_SPHERE),
    (GEOM_PLANE, GEOM_CAPSULE),
    (GEOM_PLANE, GEOM_BOX),
    (GEOM_SPHERE, GEOM_BOX),
    (GEOM_CAPSULE, GEOM_BOX),
    (GEOM_BOX, GEOM_BOX),
)


def supported(model: PhysicsModel) -> bool:
    """Whether this model can run on the port's fused substep."""
    for kind in model.pairs:
        if kind not in _FUSED_KINDS:
            return False
    cp = contact_params(model)
    if cp.condim.size and not all(int(c) in (1, 3) for c in cp.condim):
        return False
    return True


def _meta(model: PhysicsModel) -> _Meta:
    anc = _ancestors(model)
    m_keys = []
    for i in range(model.nv):
        for j in anc[i]:
            m_keys.append((i, j))
        m_keys.append((i, i))

    cp = contact_params(model)
    slots = []
    # slot order: sorted pair kinds, then pairs, then sub-contacts — the order
    # of the JAX package's collision.collide + constraint.make_constraints
    k = 0
    for kind in sorted(model.pairs):
        pair = model.pairs[kind]
        for i in range(pair.geom1.shape[0]):
            g1, g2 = int(pair.geom1[i]), int(pair.geom2[i])
            for sub in range(pair.ncon):
                body2 = int(cp.body2[k])
                dofs = tuple(
                    d
                    for d in range(model.nv)
                    if model.body_dof_mask[body2, d] > 0.5
                    or model.body_dof_mask[int(cp.body1[k]), d] > 0.5
                )
                slots.append(
                    dict(
                        kind=kind,
                        g1=g1,
                        g2=g2,
                        sub=sub,
                        body1=int(cp.body1[k]),
                        body2=body2,
                        condim=int(cp.condim[k]),
                        friction=tuple(float(x) for x in cp.friction[k]),
                        solref=tuple(float(x) for x in cp.solref[k]),
                        solimp=tuple(float(x) for x in cp.solimp[k]),
                        includemargin=float(cp.includemargin[k]),
                        invweight=float(cp.invweight[k]),
                        dofs=dofs,
                    )
                )
                k += 1

    limits = []
    for j in range(model.njnt):
        if not model.jnt_limited[j]:
            continue
        if int(model.jnt_type[j]) not in (JNT_HINGE, JNT_SLIDE):
            continue
        for sign, bound in (
            (1.0, float(model.jnt_range[j, 0])),
            (-1.0, float(model.jnt_range[j, 1])),
        ):
            limits.append(
                dict(
                    qadr=int(model.jnt_qposadr[j]),
                    dadr=int(model.jnt_dofadr[j]),
                    sign=sign,
                    bound=bound,
                    margin=float(model.jnt_margin[j]),
                    solref=tuple(float(x) for x in model.jnt_solref[j]),
                    solimp=tuple(float(x) for x in model.jnt_solimp[j]),
                    invweight=float(model.dof_invweight0[int(model.jnt_dofadr[j])]),
                )
            )

    floss = []
    for d in range(model.nv):
        fl = float(model.dof_frictionloss[d])
        if fl <= 0:
            continue
        floss.append(
            dict(
                dof=d,
                floss=fl,
                solref=tuple(float(x) for x in model.dof_solref[d]),
                solimp=tuple(float(x) for x in model.dof_solimp[d]),
                invweight=float(model.dof_invweight0[d]),
            )
        )

    # solver pattern: tree + contact-row cliques, closed under LDL fill-in
    pat = {(i, j) for (i, j) in m_keys if i != j}
    for slot in slots:
        dofs = slot["dofs"]
        for a in range(len(dofs)):
            for b in range(a):
                pat.add((dofs[a], dofs[b]))
    for k in range(model.nv - 1, -1, -1):
        nbrs = sorted(j for j in range(k) if (k, j) in pat)
        for a in range(len(nbrs)):
            for b in range(a):
                pat.add((nbrs[a], nbrs[b]))
    anc_solver = tuple(
        tuple(j for j in range(i) if (i, j) in pat) for i in range(model.nv)
    )

    return _Meta(
        anc_strict=anc,
        m_keys=tuple(m_keys),
        anc_solver=anc_solver,
        contact_slots=tuple(slots),
        limit_rows=tuple(limits),
        floss_rows=tuple(floss),
    )


# ======================================================================
# Stage: forward kinematics + CoM quantities
# ======================================================================


def _fk(model: PhysicsModel, q):
    """q: list of nq scalars.  Returns dict of per-body/joint scalar tuples."""
    nb = model.nbody
    xpos = [(0.0, 0.0, 0.0)]
    xquat = [(1.0, 0.0, 0.0, 0.0)]
    xanchor = [None] * model.njnt
    xaxis = [None] * model.njnt

    for b in range(1, nb):
        parent = int(model.body_parentid[b])
        bp = tuple(float(x) for x in model.body_pos[b])
        bq = tuple(float(x) for x in model.body_quat[b])
        pos = v3add(xpos[parent], qrotate(bp, xquat[parent]))
        quat = qmul(xquat[parent], bq)
        j = int(model.body_jntadr[b])
        if j >= 0:
            jt = int(model.jnt_type[j])
            qadr = int(model.jnt_qposadr[j])
            ax = tuple(float(x) for x in model.jnt_axis[j])
            jp = tuple(float(x) for x in model.jnt_pos[j])
            if jt == JNT_FREE:
                pos = (q[qadr], q[qadr + 1], q[qadr + 2])
                quat = qnormalize(
                    (q[qadr + 3], q[qadr + 4], q[qadr + 5], q[qadr + 6])
                )
                xanchor[j] = pos
                xaxis[j] = ax
            elif jt == JNT_SLIDE:
                axis_w = qrotate(ax, quat)
                xanchor[j] = v3add(pos, qrotate(jp, quat))
                trans = ssub(q[qadr], float(model.qpos0[qadr]))
                # every component moves per sample, also where the axis's is
                # 0: the JAX graph folds those into double constants, the
                # kernel adds 0 * trans in float32; the two agree to float32
                # rounding, and this is the kernel's arithmetic
                pos = tuple(p_ + a_ * trans for p_, a_ in zip(pos, axis_w))
                xaxis[j] = axis_w
            elif jt == JNT_HINGE:
                anchor = v3add(pos, qrotate(jp, quat))
                angle = ssub(q[qadr], float(model.qpos0[qadr]))
                half = smul(0.5, angle)
                ch, sh = scos(half), ssin(half)
                qloc = (ch, smul(ax[0], sh), smul(ax[1], sh), smul(ax[2], sh))
                quat = qmul(quat, qloc)
                pos = v3sub(anchor, qrotate(jp, quat))
                xanchor[j] = anchor
                xaxis[j] = qrotate(ax, quat)
        xpos.append(pos)
        xquat.append(quat)

    xipos = [
        v3add(xpos[b], qrotate(tuple(float(x) for x in model.body_ipos[b]), xquat[b]))
        for b in range(nb)
    ]
    ximat = [
        qmat(qmul(xquat[b], tuple(float(x) for x in model.body_iquat[b])))
        for b in range(nb)
    ]
    geom_xpos, geom_xmat = [], []
    for g in range(model.geom_bodyid.shape[0]):
        b = int(model.geom_bodyid[g])
        gp = tuple(float(x) for x in model.geom_pos[g])
        gq = tuple(float(x) for x in model.geom_quat[g])
        geom_xpos.append(v3add(xpos[b], qrotate(gp, xquat[b])))
        geom_xmat.append(qmat(qmul(xquat[b], gq)))
    site_xpos = []
    for s in range(model.nsite):
        b = int(model.site_bodyid[s])
        sp = tuple(float(x) for x in model.site_pos[s])
        site_xpos.append(v3add(xpos[b], qrotate(sp, xquat[b])))

    # subtree CoM
    mass = [float(m) for m in model.body_mass]
    sub_mass = list(mass)
    sub_mpos = [v3scale(xipos[b], mass[b]) for b in range(nb)]
    for b in range(nb - 1, 0, -1):
        parent = int(model.body_parentid[b])
        sub_mass[parent] = sub_mass[parent] + sub_mass[b]
        sub_mpos[parent] = v3add(sub_mpos[parent], sub_mpos[b])
    subtree_com = [
        v3scale(sub_mpos[b], 1.0 / max(sub_mass[b], 1e-12)) for b in range(nb)
    ]

    # spatial inertia about the kinematic root's subtree CoM
    cinert = []
    for b in range(nb):
        root = int(model.body_rootid[b])
        c = v3sub(xipos[b], subtree_com[root])
        R = ximat[b]
        I3 = tuple(float(x) for x in model.body_inertia[b])

        # inert_c = R diag(I) R^T (symmetric upper entries)
        def ent(a_, b_):
            return ssum([smul(smul(I3[k2], R[a_][k2]), R[b_][k2]) for k2 in range(3)])

        m = mass[b]
        cc = v3dot(c, c)
        ul = (
            sadd(ent(0, 0), smul(m, ssub(cc, smul(c[0], c[0])))),
            ssub(ent(0, 1), smul(m, smul(c[0], c[1]))),
            ssub(ent(0, 2), smul(m, smul(c[0], c[2]))),
            sadd(ent(1, 1), smul(m, ssub(cc, smul(c[1], c[1])))),
            ssub(ent(1, 2), smul(m, smul(c[1], c[2]))),
            sadd(ent(2, 2), smul(m, ssub(cc, smul(c[2], c[2])))),
        )
        cinert.append(CInert(ul=ul, h=v3scale(c, m), m=m))

    # cdof
    cdof = [None] * model.nv
    for j in range(model.njnt):
        b = int(model.jnt_bodyid[j])
        jt = int(model.jnt_type[j])
        adr = int(model.jnt_dofadr[j])
        com = subtree_com[int(model.body_rootid[b])]
        if jt == JNT_FREE:
            for i in range(3):
                e = tuple(1.0 if k2 == i else 0.0 for k2 in range(3))
                cdof[adr + i] = (0.0, 0.0, 0.0) + e
            R = qmat(xquat[b])
            off = v3sub(com, xpos[b])
            for i in range(3):
                axc = (R[0][i], R[1][i], R[2][i])
                cdof[adr + 3 + i] = axc + v3cross(axc, off)
        elif jt == JNT_SLIDE:
            cdof[adr] = (0.0, 0.0, 0.0) + xaxis[j]
        elif jt == JNT_HINGE:
            off = v3sub(com, xanchor[j])
            cdof[adr] = xaxis[j] + v3cross(xaxis[j], off)

    return dict(
        xpos=xpos,
        xquat=xquat,
        geom_xpos=geom_xpos,
        geom_xmat=geom_xmat,
        site_xpos=site_xpos,
        subtree_com=subtree_com,
        cinert=cinert,
        cdof=cdof,
    )


def _com_vel(model: PhysicsModel, fk, v):
    nb = model.nbody
    cvel = [(0.0,) * 6]
    cdof_dot = [None] * model.nv
    for b in range(1, nb):
        parent = int(model.body_parentid[b])
        vel = cvel[parent]
        j = int(model.body_jntadr[b])
        if j >= 0:
            jt = int(model.jnt_type[j])
            adr = int(model.jnt_dofadr[j])
            if jt == JNT_FREE:
                for i in range(3):
                    cdof_dot[adr + i] = (0.0,) * 6
                for i in range(3):
                    vel = tuple(
                        sadd(vel[k2], smul(fk["cdof"][adr + i][k2], v[adr + i]))
                        for k2 in range(6)
                    )
                for i in range(3, 6):
                    cdof_dot[adr + i] = motion_cross(vel, fk["cdof"][adr + i])
                for i in range(3, 6):
                    vel = tuple(
                        sadd(vel[k2], smul(fk["cdof"][adr + i][k2], v[adr + i]))
                        for k2 in range(6)
                    )
            else:
                cdof_dot[adr] = motion_cross(vel, fk["cdof"][adr])
                vel = tuple(
                    sadd(vel[k2], smul(fk["cdof"][adr][k2], v[adr]))
                    for k2 in range(6)
                )
        cvel.append(vel)
    return cvel, cdof_dot


# ======================================================================
# Stage: CRB mass matrix (tree-sparse), RNE bias
# ======================================================================


def _crb(model: PhysicsModel, meta: _Meta, fk) -> Dict[Tuple[int, int], object]:
    nb = model.nbody
    crb = list(fk["cinert"])
    for b in range(nb - 1, 0, -1):
        parent = int(model.body_parentid[b])
        crb[parent] = cinert_add(crb[parent], crb[b])
    f = [cinert_vec(crb[int(model.dof_bodyid[d])], fk["cdof"][d]) for d in range(model.nv)]
    M = {}
    for (i, j) in meta.m_keys:
        M[(i, j)] = sdot(fk["cdof"][j], f[i])
    for i in range(model.nv):
        arm = float(model.dof_armature[i])
        if arm != 0.0:
            M[(i, i)] = sadd(M[(i, i)], arm)
    return M


def _rne_bias(model: PhysicsModel, fk, cvel, cdof_dot, v):
    nb = model.nbody
    g = model.gravity
    cacc = [(0.0, 0.0, 0.0, -float(g[0]), -float(g[1]), -float(g[2]))]
    for b in range(1, nb):
        parent = int(model.body_parentid[b])
        a = cacc[parent]
        j = int(model.body_jntadr[b])
        if j >= 0:
            adr = int(model.jnt_dofadr[j])
            ndof = 6 if int(model.jnt_type[j]) == JNT_FREE else 1
            for i in range(ndof):
                a = tuple(
                    sadd(a[k2], smul(cdof_dot[adr + i][k2], v[adr + i]))
                    for k2 in range(6)
                )
        cacc.append(a)
    cfrc = []
    for b in range(nb):
        iv = cinert_vec(fk["cinert"][b], cvel[b])
        ia = cinert_vec(fk["cinert"][b], cacc[b])
        fx = force_cross(cvel[b], iv)
        cfrc.append(tuple(sadd(ia[k2], fx[k2]) for k2 in range(6)))
    for b in range(nb - 1, 0, -1):
        parent = int(model.body_parentid[b])
        cfrc[parent] = tuple(
            sadd(cfrc[parent][k2], cfrc[b][k2]) for k2 in range(6)
        )
    return [
        sdot(fk["cdof"][d], cfrc[int(model.dof_bodyid[d])])
        for d in range(model.nv)
    ]


# ======================================================================
# Stage: actuation (fixed gain, none/affine bias)
# ======================================================================


def _actuator_force(model: PhysicsModel, ctrl, q, v):
    qfrc = [0.0] * model.nv
    for a in range(model.nu):
        c = ctrl[a]
        if bool(model.actuator_ctrllimited[a]):
            lo, hi = float(model.actuator_ctrlrange[a, 0]), float(
                model.actuator_ctrlrange[a, 1]
            )
            c = smin(smax(c, lo), hi)
        force = smul(float(model.actuator_gainprm[a]), c)
        b0, b1, b2 = (float(x) for x in model.actuator_biasprm[a])
        if b0 != 0.0 or b1 != 0.0 or b2 != 0.0:
            qa = int(model.actuator_qposadr[a])
            da = int(model.actuator_dofadr[a])
            force = sadd(
                force, sadd(b0, sadd(smul(b1, q[qa]), smul(b2, v[da])))
            )
        if bool(model.actuator_forcelimited[a]):
            lo, hi = (float(x) for x in model.actuator_forcerange[a])
            force = smin(smax(force, lo), hi)
        force = smul(float(model.actuator_gear[a]), force)
        d = int(model.actuator_dofadr[a])
        qfrc[d] = sadd(qfrc[d], force)
    return qfrc


# ======================================================================
# Tree-sparse LDL^T (the MuJoCo mj_factorI/mj_solveLD pattern: eliminate
# leaf dofs first; ancestors have smaller indices, so there is no fill-in).
# ======================================================================


def ldl_factor(M: Dict[Tuple[int, int], object], anc, nv: int):
    """anc[i] = sorted strict 'ancestors' (pattern neighbors j < i)."""
    Mw = dict(M)
    L: Dict[Tuple[int, int], object] = {}
    Dinv = [None] * nv
    for k in range(nv - 1, -1, -1):
        dinv = srecip(Mw[(k, k)])
        Dinv[k] = dinv
        a_k = anc[k]
        for j in a_k:
            L[(k, j)] = smul(Mw[(k, j)], dinv)
        for ii, i in enumerate(a_k):
            for j in a_k[: ii + 1]:
                Mw[(i, j)] = ssub(Mw[(i, j)], smul(L[(k, i)], Mw[(k, j)]))
    return L, Dinv


def ldl_solve(L, Dinv, anc, y: Sequence):
    x = list(y)
    nv = len(x)
    for k in range(nv - 1, -1, -1):
        for j in anc[k]:
            x[j] = ssub(x[j], smul(L[(k, j)], x[k]))
    for k in range(nv):
        x[k] = smul(x[k], Dinv[k])
    for k in range(nv):
        for j in anc[k]:
            x[k] = ssub(x[k], smul(L[(k, j)], x[j]))
    return x


def m_vec(M: Dict[Tuple[int, int], object], x: Sequence):
    """Sparse symmetric matvec over the tree pattern."""
    out = [0.0] * len(x)
    for (i, j), mij in M.items():
        out[i] = sadd(out[i], smul(mij, x[j]))
        if i != j:
            out[j] = sadd(out[j], smul(mij, x[i]))
    return out


# ======================================================================
# Stage: collision + constraint rows
# ======================================================================


def _impedance(solimp, pos, margin, like):
    dmin, dmax, width, mid, power = solimp
    x = ssub(pos, margin)
    x = sdiv(sabs(x), max(width, MJ_MINVAL))
    x = smin(smax(x, 0.0), 1.0)
    mid = min(max(mid, MJ_MINIMP), MJ_MAXIMP)
    power = max(power, 1.0)
    a = 1.0 / mid ** (power - 1.0)
    b = 1.0 / (1.0 - mid) ** (power - 1.0)

    # x ** power with static power
    def spow(base, p):
        if p == 2.0:
            return smul(base, base)
        if p == 1.0:
            return base
        return base ** p

    if _isf(x):  # fully constant row (e.g. friction-loss: pos = margin = 0)
        y = a * spow(x, power) if x <= mid else 1.0 - b * spow(1.0 - x, power)
    else:
        y = swhere(
            x <= mid,
            smul(a, spow(x, power)),
            ssub(1.0, smul(b, spow(ssub(1.0, x), power))),
            like,
        )
    return smin(smax(sadd(dmin, smul(y, dmax - dmin)), MJ_MINIMP), MJ_MAXIMP)


def _kb_const(solref, dmax):
    """solref (python consts) -> (k, b) python consts."""
    timeconst, dampratio = solref
    if timeconst <= 0 or dampratio <= 0:
        k = -timeconst / max(dmax * dmax, MJ_MINVAL)
        b = -dampratio
    else:
        k = 1.0 / max(
            dmax * dmax * timeconst * timeconst * dampratio * dampratio, MJ_MINVAL
        )
        b = 2.0 / max(dmax * timeconst, MJ_MINVAL)
    return k, b


def _aref_d(solref, solimp, diag_approx, pos, margin, vel, like):
    imp = _impedance(solimp, pos, margin, like)
    k, b = _kb_const(solref, solimp[1])
    aref = ssub(smul(-b, vel), smul(k, smul(imp, ssub(pos, margin))))
    r = smax(smul(sdiv(ssub(1.0, imp), imp), diag_approx), MJ_MINVAL)
    return aref, srecip(r)


class _Row(NamedTuple):
    dofs: Tuple[int, ...]  # static nonzero support
    J: tuple  # scalars aligned with dofs
    aref: object
    D: object
    active: object  # bool tensor (or python bool True)
    floss: float


def _make_frame(n, like):
    """mju_makeFrame on a scalar 3-vector."""
    ay = sabs(n[1])
    if _isf(ay):
        bvec = (0.0, 1.0, 0.0) if ay < 0.5 else (0.0, 0.0, 1.0)
    else:
        use_y = ay < 0.5
        bvec = (0.0, swhere(use_y, 1.0, 0.0, like), swhere(use_y, 0.0, 1.0, like))
    nb = v3dot(n, bvec)
    t1 = v3sub(bvec, v3scale(n, nb))
    t1 = v3scale(t1, srsqrt(v3dot(t1, t1)))
    t2 = v3cross(n, t1)
    return n, t1, t2


def _plane_sphere_scalar(ppos, n, spos, r, like):
    cdist = v3dot(n, v3sub(spos, ppos))
    dist = ssub(cdist, r)
    pos = v3sub(spos, v3scale(n, sadd(r, smul(0.5, dist))))
    return dist, pos, _make_frame(n, like)


def _sphere_box_scalar(spos, r, bpos, bmat, size, like):
    """collision.sphere_box on batched scalars (normal from box into sphere)."""
    rel = v3sub(spos, bpos)
    local = m33_t_vec(bmat, rel)
    sz = tuple(float(s) for s in size[:3])
    clamped = tuple(smin(smax(local[i], -sz[i]), sz[i]) for i in range(3))
    out_i = [sabs(local[i]) > sz[i] for i in range(3)]
    outside = out_i[0] | out_i[1] | out_i[2]
    delta_out = v3sub(local, clamped)
    len2 = v3dot(delta_out, delta_out)
    len_out = ssqrt(smax(len2, 0.0))
    inv_len = srecip(smax(len_out, 1e-12))
    n_out = v3scale(delta_out, inv_len)
    dist_out = ssub(len_out, r)
    pos_out = v3add(clamped, v3scale(n_out, smul(0.5, dist_out)))
    # inside: the face of least depth (argmin order: the first of a tie wins)
    depths = tuple(ssub(sz[i], sabs(local[i])) for i in range(3))
    m0 = (depths[0] <= depths[1]) & (depths[0] <= depths[2])
    m1 = (~m0) & (depths[1] <= depths[2])
    m2 = ~(m0 | m1)
    masks = (m0, m1, m2)
    sgns = tuple(torch.sign(local[i]) for i in range(3))
    n_in = tuple(swhere(masks[i], sgns[i], 0.0) for i in range(3))
    depth_min = swhere(m0, depths[0], swhere(m1, depths[1], depths[2]))
    dist_in = sneg(sadd(depth_min, r))
    surface = tuple(swhere(masks[i], smul(sgns[i], sz[i]), local[i]) for i in range(3))
    pos_in = v3add(surface, v3scale(n_in, smul(0.5, dist_in)))

    dist = swhere(outside, dist_out, dist_in)
    n_local = tuple(swhere(outside, n_out[i], n_in[i]) for i in range(3))
    pos_local = tuple(swhere(outside, pos_out[i], pos_in[i]) for i in range(3))
    n_world = m33_vec(bmat, n_local)
    pos_world = v3add(bpos, m33_vec(bmat, pos_local))
    return dist, pos_world, n_world


def _box_corners(bpos, bmat, size):
    """The 8 corners, x slowest then y then z, each sign -1 before +1."""
    sz = tuple(float(s) for s in size[:3])
    corners = []
    for sx in (-1, 1):
        for sy in (-1, 1):
            for sz_ in (-1, 1):
                local = (sx * sz[0], sy * sz[1], sz_ * sz[2])
                corners.append(v3add(bpos, m33_vec(bmat, local)))
    return corners


def _closest_on_segment_scalar(a, b, p):
    ab = v3sub(b, a)
    denom = smax(v3dot(ab, ab), 1e-12)
    t = sdiv(v3dot(v3sub(p, a), ab), denom)
    t = smin(smax(t, 0.0), 1.0)
    return v3add(a, v3scale(ab, t))


def _capsule_box_sweeps(a, b, bpos, bmat, size):
    """The deepest point of segment a-b against the box: 4 sweeps of
    segment projection and box clamping (collision._capsule_box)."""
    seg = None
    p = bpos
    sz = tuple(float(s) for s in size[:3])
    for _ in range(4):
        seg = _closest_on_segment_scalar(a, b, p)
        local = m33_t_vec(bmat, v3sub(seg, bpos))
        local = tuple(smin(smax(local[i], -sz[i]), sz[i]) for i in range(3))
        p = v3add(bpos, m33_vec(bmat, local))
    return seg


def _contact_geometry(model, fk, slot, like):
    """dist, pos, frame for one contact slot: collision.collide's per-kind
    math (with its capsule-box and box-box approximations) on batched
    scalars."""
    kind = slot["kind"]
    g1, g2 = slot["g1"], slot["g2"]
    p1, m1 = fk["geom_xpos"][g1], fk["geom_xmat"][g1]
    p2, m2 = fk["geom_xpos"][g2], fk["geom_xmat"][g2]
    size1, size2 = model.geom_size[g1], model.geom_size[g2]

    if kind == (GEOM_PLANE, GEOM_SPHERE):
        n = (m1[0][2], m1[1][2], m1[2][2])
        return _plane_sphere_scalar(p1, n, p2, float(size2[0]), like)

    if kind == (GEOM_PLANE, GEOM_CAPSULE):
        # slot `sub` is the end cap at +half (sub 0) or -half (sub 1)
        n = (m1[0][2], m1[1][2], m1[2][2])
        axis = (m2[0][2], m2[1][2], m2[2][2])
        r, half = float(size2[0]), float(size2[1])
        sgn = 1.0 if slot["sub"] == 0 else -1.0
        spos = v3add(p2, v3scale(axis, sgn * half))
        dist, pos, _ = _plane_sphere_scalar(p1, n, spos, r, like)
        # MuJoCo's plane-capsule frame: t1 is the capsule axis projected onto
        # the plane, the generic frame's where that projection vanishes
        proj = v3sub(axis, v3scale(n, v3dot(n, axis)))
        pl2 = v3dot(proj, proj)
        _, gen_t1, _ = _make_frame(n, like)
        nearz = pl2 < 1e-20
        inv = sdiv(1.0, ssqrt(swhere(nearz, 1.0, pl2)))
        t1 = tuple(swhere(nearz, gen_t1[a], smul(proj[a], inv), like) for a in range(3))
        t2 = v3cross(n, t1)
        return dist, pos, (n, t1, t2)

    if kind == (GEOM_PLANE, GEOM_BOX):
        # 4 slots: the 4 deepest of the 8 corners; slot `sub` is the corner
        # of rank `sub` by distance, ties broken by corner index.  The
        # selection is a sum of 8 masked terms, as in the JAX graph.
        n = (m1[0][2], m1[1][2], m1[2][2])
        corners = _box_corners(p2, m2, size2)
        dists = [v3dot(n, v3sub(c, p1)) for c in corners]
        ranks = []
        for i in range(8):
            r_i = 0.0
            for j in range(8):
                if j == i:
                    continue
                lt = dists[j] < dists[i]
                tie = (dists[j] == dists[i]) & (j < i)
                r_i = sadd(r_i, swhere(lt | tie, 1.0, 0.0, like))
            ranks.append(r_i)
        k = slot["sub"]
        sel = [ranks[i] == k for i in range(8)]
        d = ssum([swhere(sel[i], dists[i], 0.0, like) for i in range(8)])
        pos_c = tuple(
            ssum([swhere(sel[i], corners[i][a], 0.0, like) for i in range(8)])
            for a in range(3)
        )
        pos = v3sub(pos_c, v3scale(n, smul(0.5, d)))
        return d, pos, _make_frame(n, like)

    if kind == (GEOM_SPHERE, GEOM_BOX):
        d, pos, n_world = _sphere_box_scalar(p1, float(size1[0]), p2, m2, size2, like)
        # the contact normal points from geom1 (the sphere) into the box
        return d, pos, _make_frame(v3scale(n_world, -1.0), like)

    if kind == (GEOM_CAPSULE, GEOM_BOX):
        # slot 0: the deepest segment point; slot 1: the deeper end point,
        # switched off (dist 1) where it is slot 0's point
        r, half = float(size1[0]), float(size1[1])
        axis = (m1[0][2], m1[1][2], m1[2][2])
        a = v3sub(p1, v3scale(axis, half))
        b = v3add(p1, v3scale(axis, half))
        if slot["sub"] == 0:
            seg = _capsule_box_sweeps(a, b, p2, m2, size2)
            d, pos, n_world = _sphere_box_scalar(seg, r, p2, m2, size2, like)
        else:
            da = _sphere_box_scalar(a, r, p2, m2, size2, like)
            db = _sphere_box_scalar(b, r, p2, m2, size2, like)
            deeper = da[0] < db[0]
            d = swhere(deeper, da[0], db[0])
            pos = tuple(swhere(deeper, da[1][i], db[1][i]) for i in range(3))
            n_world = tuple(swhere(deeper, da[2][i], db[2][i]) for i in range(3))
            seg = _capsule_box_sweeps(a, b, p2, m2, size2)
            end = tuple(swhere(deeper, a[i], b[i]) for i in range(3))
            gap = v3sub(seg, end)
            dup = ssum([smul(gap[i], gap[i]) for i in range(3)]) < 1e-12
            d = swhere(dup, 1.0, d)
        return d, pos, _make_frame(v3scale(n_world, -1.0), like)

    if kind == (GEOM_BOX, GEOM_BOX):
        # 8 slots: box1's corners against box2 (a point in a box)
        c = _box_corners(p1, m1, size1)[slot["sub"]]
        d, pos, n_world = _sphere_box_scalar(c, 0.0, p2, m2, size2, like)
        return d, pos, _make_frame(v3scale(n_world, -1.0), like)

    raise NotImplementedError(f"contact kind {kind} is not a fused kind")


def spans_two_trees(model: PhysicsModel, slot) -> bool:
    """Whether both of a contact slot's bodies carry dofs, so that its rows
    couple two kinematic trees (a robot and a crate on its own joint)."""
    return all(bool((model.body_dof_mask[slot[k]] > 0.5).any()) for k in ("body1", "body2"))


def _active_per_slot(model: PhysicsModel, qpos: torch.Tensor):
    """(slot, number of samples where it is active (dist < margin)) at the
    poses qpos (B, nq): the plain forward kinematics and contact geometry,
    in qpos's dtype and on its device."""
    q = list(qpos.unbind(-1))
    fk = _fk(model, q)
    for slot in _meta(model).contact_slots:
        dist, _, _ = _contact_geometry(model, fk, slot, q[0])
        active = torch.as_tensor(dist < slot["includemargin"]).expand(qpos.shape[:-1])
        yield slot, int(active.sum())


def active_contacts(model: PhysicsModel, qpos: torch.Tensor) -> Dict[tuple, int]:
    """Per contact kind, how many (sample, slot) contacts are active at the
    poses qpos (B, nq)."""
    counts = {kind: 0 for kind in sorted(model.pairs)}
    for slot, n in _active_per_slot(model, qpos):
        counts[slot["kind"]] += n
    return counts


def active_two_tree_contacts(model: PhysicsModel, qpos: torch.Tensor) -> int:
    """How many (sample, slot) contacts are active at the poses qpos (B, nq)
    in slots whose rows couple two kinematic trees."""
    return sum(n for slot, n in _active_per_slot(model, qpos) if spans_two_trees(model, slot))


def active_contacts_past(model: PhysicsModel, qpos: torch.Tensor, dof: int) -> int:
    """How many (sample, slot) contacts are active at the poses qpos (B, nq)
    in slots whose dof lists reach `dof` or past it (dof 32: the slots whose
    dof masks take a second 32-bit word in the kernel)."""
    return sum(n for slot, n in _active_per_slot(model, qpos) if max(slot["dofs"]) >= dof)


def _point_jac(model, fk, point, body, dofs):
    """Translational jacobian rows of `point` on `body` for the static dof set."""
    com = fk["subtree_com"][int(model.body_rootid[body])]
    offset = v3sub(point, com)
    cols = {}
    for d in dofs:
        if model.body_dof_mask[body, d] <= 0.5:
            cols[d] = (0.0, 0.0, 0.0)
            continue
        cd = fk["cdof"][d]
        cols[d] = v3add(cd[3:], v3cross(cd[:3], offset))
    return cols


def _constraint_rows(model: PhysicsModel, meta: _Meta, fk, q, v) -> List[_Row]:
    rows: List[_Row] = []
    like = q[0]

    for fr in meta.floss_rows:
        d = fr["dof"]
        aref, D = _aref_d(
            fr["solref"], fr["solimp"], fr["invweight"], 0.0, 0.0, v[d], like
        )
        rows.append(
            _Row(dofs=(d,), J=(1.0,), aref=aref, D=D, active=True, floss=fr["floss"])
        )

    for lr in meta.limit_rows:
        sign, bound = lr["sign"], lr["bound"]
        dist = smul(sign, ssub(q[lr["qadr"]], bound))
        vel = smul(sign, v[lr["dadr"]])
        aref, D = _aref_d(
            lr["solref"], lr["solimp"], lr["invweight"], dist, lr["margin"], vel, like
        )
        active = dist < lr["margin"]
        rows.append(
            _Row(dofs=(lr["dadr"],), J=(sign,), aref=aref, D=D, active=active, floss=0.0)
        )

    for slot in meta.contact_slots:
        dist, pos, frame = _contact_geometry(model, fk, slot, like)
        margin = slot["includemargin"]
        active = dist < margin
        dofs = slot["dofs"]
        jac2 = _point_jac(model, fk, pos, slot["body2"], dofs)
        jac1 = _point_jac(model, fk, pos, slot["body1"], dofs)
        jac = {d: v3sub(jac2[d], jac1[d]) for d in dofs}
        j_n = {d: v3dot(jac[d], frame[0]) for d in dofs}
        if slot["condim"] == 1:
            vel = ssum([smul(j_n[d], v[d]) for d in dofs])
            aref, D = _aref_d(
                slot["solref"], slot["solimp"], slot["invweight"], dist, margin, vel,
                like,
            )
            rows.append(
                _Row(dofs=dofs, J=tuple(j_n[d] for d in dofs), aref=aref, D=D,
                     active=active, floss=0.0)
            )
        else:  # condim == 3, pyramidal
            iw = slot["invweight"]
            for t in range(2):
                mu = slot["friction"][t]
                j_t = {d: v3dot(jac[d], frame[t + 1]) for d in dofs}
                diag = 2.0 * (iw + mu * mu * iw)
                for s in (1.0, -1.0):
                    Jrow = tuple(
                        sadd(j_n[d], smul(s * mu, j_t[d])) for d in dofs
                    )
                    vel = ssum([smul(Jrow[k2], v[d]) for k2, d in enumerate(dofs)])
                    aref, D = _aref_d(
                        slot["solref"], slot["solimp"], diag, dist, margin, vel, like
                    )
                    rows.append(
                        _Row(dofs=dofs, J=Jrow, aref=aref, D=D, active=active,
                             floss=0.0)
                    )
    return rows


# ======================================================================
# Stage: truncated Newton solve
# ======================================================================


def _s_terms(x, D, floss, active):
    """Per-row cost/dcost/hcost for one row.

    x is always a tensor; D may be a python constant (friction-loss rows);
    active is either the constant True (friction-loss rows, always active) or
    a bool tensor.
    """
    if floss > 0.0:  # Huber (two-sided) friction-loss row
        knee = sdiv(floss, smax(D, 1e-30))
        ax = sabs(x)
        quad = ax <= knee
        sgn = torch.sign(x)
        cost = swhere(
            quad,
            smul(0.5, smul(D, smul(x, x))),
            ssub(smul(floss, ax), smul(0.5, smul(knee, floss))),
            x,
        )
        dcost = swhere(quad, smul(D, x), smul(floss, sgn), x)
        hcost = swhere(quad, D, 0.0, x)
        return cost, dcost, hcost
    neg = x < 0.0
    act = neg if (isinstance(active, bool) and active) else (active & neg)
    cost = swhere(act, smul(0.5, smul(D, smul(x, x))), 0.0, x)
    dcost = swhere(act, smul(D, x), 0.0, x)
    hcost = swhere(act, D, 0.0, x)
    return cost, dcost, hcost


def _newton_solve(model, meta, M, qacc_smooth, warmstart, rows):
    """Truncated Newton on scalar rows; returns (qacc, qfrc_constraint)."""
    nv = model.nv
    if not rows:
        return list(qacc_smooth), [0.0] * nv

    def jx(a):
        """x_r = J_r . a - aref_r per row."""
        return [
            ssub(ssum([smul(r.J[k2], a[d]) for k2, d in enumerate(r.dofs)]), r.aref)
            for r in rows
        ]

    def total_cost(a):
        da = [ssub(a[i], qacc_smooth[i]) for i in range(nv)]
        mda = m_vec(M, da)
        gauss = smul(0.5, sdot(da, mda))
        xs = jx(a)
        c = gauss
        for r, x in zip(rows, xs):
            cost, _, _ = _s_terms(x, r.D, r.floss, r.active)
            c = sadd(c, cost)
        return c

    # the warmstart is taken only where it is strictly cheaper
    cost_ws = total_cost(warmstart)
    cost_sm = total_cost(qacc_smooth)
    better = cost_ws < cost_sm
    a = [swhere(better, warmstart[i], qacc_smooth[i]) for i in range(nv)]
    cost_prev = smin(cost_ws, cost_sm)

    tol_scale = model.tolerance * model.meaninertia * max(1, nv)
    if any(isinstance(r.active, bool) and r.active for r in rows):
        any_active = True  # e.g. friction-loss rows are unconditionally active
    else:
        arrs = [r.active for r in rows if not isinstance(r.active, bool)]
        any_active = functools.reduce(lambda x, y: x | y, arrs) if arrs else False
    if any_active is False:
        return list(qacc_smooth), [0.0] * nv
    done = (
        torch.zeros_like(qacc_smooth[0], dtype=torch.bool)
        if any_active is True
        else ~any_active
    )

    for _ in range(max(1, model.iterations)):
        xs = jx(a)
        dcosts, hcosts = [], []
        for r, x in zip(rows, xs):
            _, dc, hc = _s_terms(x, r.D, r.floss, r.active)
            dcosts.append(dc)
            hcosts.append(hc)
        da = [ssub(a[i], qacc_smooth[i]) for i in range(nv)]
        mda = m_vec(M, da)
        grad = list(mda)
        for r, dc in zip(rows, dcosts):
            for k2, d in enumerate(r.dofs):
                grad[d] = sadd(grad[d], smul(r.J[k2], dc))
        # H = M + J^T diag(h) J on the solver pattern (zeros for entries
        # outside M's tree pattern)
        H = {}
        for i in range(nv):
            for j in meta.anc_solver[i]:
                H[(i, j)] = M.get((i, j), 0.0)
            H[(i, i)] = M[(i, i)]
        for r, hc in zip(rows, hcosts):
            nd = len(r.dofs)
            for ii in range(nd):
                i = r.dofs[ii]
                for jj2 in range(ii + 1):
                    j2 = r.dofs[jj2]
                    key = (i, j2) if i >= j2 else (j2, i)
                    H[key] = sadd(H[key], smul(hc, smul(r.J[ii], r.J[jj2])))
        L, Dinv = ldl_factor(H, meta.anc_solver, nv)
        delta = ldl_solve(L, Dinv, meta.anc_solver, [sneg(g) for g in grad])

        jd = [
            ssum([smul(r.J[k2], delta[d]) for k2, d in enumerate(r.dofs)])
            for r in rows
        ]
        md = m_vec(M, delta)
        dmd = sdot(delta, md)
        dma = sdot(delta, mda)

        # exactly max(1, ls_iterations) 1-D Newton steps on alpha
        alpha = 0.0
        for _ls in range(max(1, model.ls_iterations)):
            d1 = sadd(smul(alpha, dmd), dma)
            d2 = dmd
            for r, jdr, x in zip(rows, jd, xs):
                xa = sadd(x, smul(alpha, jdr))
                _, dc, hc = _s_terms(xa, r.D, r.floss, r.active)
                d1 = sadd(d1, smul(jdr, dc))
                d2 = sadd(d2, smul(hc, smul(jdr, jdr)))
            alpha = ssub(alpha, sdiv(d1, smax(d2, 1e-30)))
        alpha = smax(alpha, 0.0)

        a_new = [sadd(a[i], smul(alpha, delta[i])) for i in range(nv)]
        cost_new = total_cost(a_new)
        improved = ssub(cost_prev, cost_new)
        grad_norm = ssqrt(sdot(grad, grad))
        # `done` is sticky; a sample moves only where it was not done before
        done_new = done | (improved < tol_scale) | (grad_norm < tol_scale)
        a = [swhere(done, a[i], a_new[i]) for i in range(nv)]
        cost_prev = swhere(done, cost_prev, cost_new)
        done = done_new

    if any_active is not True:
        a = [swhere(any_active, a[i], qacc_smooth[i]) for i in range(nv)]

    xs = jx(a)
    qfrc = [0.0] * nv
    for r, x in zip(rows, xs):
        _, dc, _ = _s_terms(x, r.D, r.floss, r.active)
        for k2, d in enumerate(r.dofs):
            qfrc[d] = ssub(qfrc[d], smul(r.J[k2], dc))
    return a, qfrc


# ======================================================================
# One full substep (pipeline.step body) on batched scalars
# ======================================================================


class DerivedSpec(NamedTuple):
    torso_body: int
    want_sites: bool = True
    want_qfrc_actuator: bool = True


def _substep(model: PhysicsModel, meta: _Meta, spec: DerivedSpec, q, v, ws, ctrl):
    """One physics substep; returns (q', v', ws', derived list)."""
    nv = model.nv
    dt = float(model.timestep)

    fk = _fk(model, q)
    cvel, cdof_dot = _com_vel(model, fk, v)
    M = _crb(model, meta, fk)
    qfrc_act = _actuator_force(model, ctrl, q, v)
    bias = _rne_bias(model, fk, cvel, cdof_dot, v)
    qfrc_smooth = [
        ssub(
            sadd(smul(-float(model.dof_damping[d]), v[d]), qfrc_act[d]), bias[d]
        )
        for d in range(nv)
    ]
    L, Dinv = ldl_factor(M, meta.anc_strict, nv)
    qacc_smooth = ldl_solve(L, Dinv, meta.anc_strict, qfrc_smooth)

    rows = _constraint_rows(model, meta, fk, q, v)
    qacc, qfrc_constraint = _newton_solve(model, meta, M, qacc_smooth, ws, rows)

    # integration: optional implicit-Euler joint damping (mj_Euler), which
    # re-solves (M + dt·diag(damping)) qacc_int = M qacc_smooth + qfrc_constraint
    implicit_damp = bool(model.eulerdamp) and bool((model.dof_damping != 0).any())
    if implicit_damp:
        Mhb = dict(M)
        for d in range(nv):
            damp = float(model.dof_damping[d])
            if damp != 0.0:
                Mhb[(d, d)] = sadd(Mhb[(d, d)], dt * damp)
        qfrc_total = [
            sadd(x, y) for x, y in zip(m_vec(M, qacc_smooth), qfrc_constraint)
        ]
        L2, Dinv2 = ldl_factor(Mhb, meta.anc_strict, nv)
        qacc_int = ldl_solve(L2, Dinv2, meta.anc_strict, qfrc_total)
    else:
        qacc_int = qacc

    v_new = [sadd(v[d], smul(dt, qacc_int[d])) for d in range(nv)]

    q_new = list(q)
    for j in range(model.njnt):
        jt = int(model.jnt_type[j])
        qadr = int(model.jnt_qposadr[j])
        dadr = int(model.jnt_dofadr[j])
        if jt == JNT_FREE:
            for i in range(3):
                q_new[qadr + i] = sadd(q[qadr + i], smul(dt, v_new[dadr + i]))
            quat = (q[qadr + 3], q[qadr + 4], q[qadr + 5], q[qadr + 6])
            w3 = (v_new[dadr + 3], v_new[dadr + 4], v_new[dadr + 5])
            # mju_quatIntegrate (core/rotations.py quat_integrate)
            wn2 = v3dot(w3, w3)
            theta = smul(ssqrt(smax(wn2, 1e-30)), dt)
            half = smul(0.5, theta)
            small = theta < 1e-9
            sin_over = swhere(small, 0.5, sdiv(ssin(half), smax(theta, 1e-30)))
            dq = (scos(half),) + tuple(smul(w, smul(dt, sin_over)) for w in w3)
            quat_new = qnormalize(qmul(quat, dq))
            for i in range(4):
                q_new[qadr + 3 + i] = quat_new[i]
        else:
            q_new[qadr] = sadd(q[qadr], smul(dt, v_new[dadr]))

    # derived quantities for rewards — from THIS forward pass (the returned
    # state's derived fields are pre-integration, as in mj_step)
    tb = spec.torso_body
    derived = []
    derived += list(fk["xpos"][tb])
    derived += list(fk["xquat"][tb])
    derived += list(cvel[tb])
    derived += list(fk["subtree_com"][int(model.body_rootid[tb])])
    if spec.want_sites:
        for s in range(model.nsite):
            derived += list(fk["site_xpos"][s])
    if spec.want_qfrc_actuator:
        derived += list(qfrc_act)

    # the warmstart output is the solver's qacc, not the damped qacc_int
    return q_new, v_new, list(qacc), derived


# aten ops that are arithmetic: the counterparts of the JAX primitives that
# tpu_dialmpc/telemetry/profile.py:count_fused_ops counts (_ARITH_PRIMS)
ARITH_ATEN = frozenset({
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "sqrt", "rsqrt", "reciprocal",
    "sin", "cos", "pow", "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "where",
    "gt", "lt", "ge", "le", "eq", "ne", "bitwise_and", "bitwise_or", "bitwise_not",
    "bitwise_xor", "logical_and", "logical_or", "logical_not",
})


def count_ops(model: PhysicsModel, spec: DerivedSpec | None = None,
              exclude: Sequence[str] = (), arith_only: bool = True) -> int:
    """Arithmetic ops of one plain substep at B=1, less those named in
    `exclude`: each is one operation per sample, so B samples x n substeps
    take B * n * count_ops operations.  Model constants fold away as in the
    JAX graph, so without the selects (`where`, which count_fused_ops does
    not see: jnp.where traces into a nested jaxpr) this is the JAX
    package's count of the same graph, from torch alone.  With
    `arith_only=False`: every dispatched op but views."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counted = ARITH_ATEN - set(exclude)

    def counts(func) -> bool:
        if not arith_only:
            return not func.is_view
        return func.overloadpacket.__name__.rstrip("_") in counted

    class _Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if counts(func):
                self.n += 1
            return func(*args, **(kwargs or {}))

    def zeros(n):
        return [torch.zeros(1, dtype=torch.float32) for _ in range(n)]

    spec = spec if spec is not None else DerivedSpec(torso_body=1)
    with _Count() as counter:
        _substep(model, _meta(model), spec, zeros(model.nq), zeros(model.nv),
                 zeros(model.nv), zeros(model.nu))
    return counter.n


def derived_size(model: PhysicsModel, spec: DerivedSpec) -> int:
    n = 3 + 4 + 6 + 3
    if spec.want_sites:
        n += 3 * model.nsite
    if spec.want_qfrc_actuator:
        n += model.nv
    return n


def split_derived(model: PhysicsModel, spec: DerivedSpec, der: torch.Tensor):
    """Split a (..., ND) derived tensor into named fields."""
    out = {}
    o = 0
    out["torso_xpos"] = der[..., o : o + 3]; o += 3
    out["torso_xquat"] = der[..., o : o + 4]; o += 4
    out["torso_cvel"] = der[..., o : o + 6]; o += 6
    out["root_com"] = der[..., o : o + 3]; o += 3
    if spec.want_sites:
        out["site_xpos"] = der[..., o : o + 3 * model.nsite].reshape(
            der.shape[:-1] + (model.nsite, 3)
        )
        o += 3 * model.nsite
    if spec.want_qfrc_actuator:
        out["qfrc_actuator"] = der[..., o : o + model.nv]; o += model.nv
    return out


# ======================================================================
# The plain batched step: (B, n) tensors in and out
# ======================================================================


def _stack(xs, like):
    """(B,) scalars -> (B, len(xs)); constants are broadcast."""
    return torch.stack(
        [torch.full_like(like, float(x)) if _isf(x) else x for x in xs], dim=-1
    )


def fused_step_plain(model, meta, spec, n_substeps, qpos, qvel, ws, ctrl):
    """n_substeps substeps for every sample: (B,nq), (B,nv), (B,nv), (B,nu) ->
    (qpos', qvel', ws', derived (B, ND)), in the inputs' dtype."""
    q = list(qpos.unbind(-1))
    v = list(qvel.unbind(-1))
    w = list(ws.unbind(-1))
    c = list(ctrl.unbind(-1))
    der = None
    for _ in range(n_substeps):
        q, v, w, der = _substep(model, meta, spec, q, v, w, c)
    like = qpos[..., 0]
    return _stack(q, like), _stack(v, like), _stack(w, like), _stack(der, like)


def build_fused_step(model: PhysicsModel, n_substeps: int, spec: DerivedSpec):
    """fn(qpos, qvel, ws, ctrl) -> (qpos', qvel', ws', derived) running the
    plain substep chain (the JAX package's `build_fused_step`, backend "jax")."""
    if not supported(model):
        raise ValueError("model not supported by the fused substep")
    if n_substeps < 1:
        raise ValueError(f"n_substeps must be >= 1, got {n_substeps}")
    meta = _meta(model)
    return functools.partial(fused_step_plain, model, meta, spec, n_substeps)
