# Frozen copy of tpu_dialmpc_torch/dynamics/collision.py at commit ce76357, imports made relative.
"""Static-shape narrowphase collision (plane, sphere, capsule and box
primitives), batched over samples.

Counterpart of `tpu_dialmpc/dynamics/collision.py`: `contact_params` (the
per-slot constants of the static pair tables, which `fused._meta` also
reads), `make_frame`, the narrowphase of all nine pair kinds and `collide`,
with the same contact slots in the same order (sorted pair kinds, then
pairs, then each pair's sub-contacts) and the same conventions: the normal
points from geom1 into geom2, `pos` is midway between the surfaces, `frame`
rows are [normal, tangent1, tangent2] as mju_makeFrame builds them, except
plane-capsule, whose first tangent is the capsule axis projected onto the
plane.  The JAX package's approximations are kept: capsule-box emits the
deepest segment point and the deeper end point (switched off where the two
coincide), box-box the corners of box1 inside box2.

Each kind runs once over all its pairs: tensors (B, npair, ...).  The fused
substep (`fused.py`, `csrc/fused_step.cu`) has six of these kinds;
sphere-sphere, sphere-capsule and capsule-capsule exist only here, so a
model with them runs on this path (`fused.supported` rejects it).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from .kinematics import Kinematics, cross
from .model import (
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_PLANE,
    GEOM_SPHERE,
    PhysicsModel,
    cached,
)


class Contacts(NamedTuple):
    """Contact data of every slot, (B, ncon_max, ...)."""

    dist: torch.Tensor  # (B, ncon)
    pos: torch.Tensor  # (B, ncon, 3)
    frame: torch.Tensor  # (B, ncon, 3, 3) rows: normal, t1, t2


class ContactParams(NamedTuple):
    """Static per-slot parameters aligned with Contacts rows (numpy)."""

    body1: np.ndarray
    body2: np.ndarray
    geom1: np.ndarray
    geom2: np.ndarray
    condim: np.ndarray
    friction: np.ndarray  # (ncon, 5)
    solref: np.ndarray  # (ncon, 2)
    solimp: np.ndarray  # (ncon, 5)
    includemargin: np.ndarray  # (ncon,)
    invweight: np.ndarray  # (ncon,)


def contact_params(model: PhysicsModel) -> ContactParams:
    """Expand the per-pair static tables to per-contact-slot arrays."""
    rows = {k: [] for k in ContactParams._fields}
    for kind in sorted(model.pairs):
        p = model.pairs[kind]
        npair = p.geom1.shape[0]
        for i in range(npair):
            for _ in range(p.ncon):
                rows["body1"].append(model.geom_bodyid[p.geom1[i]])
                rows["body2"].append(model.geom_bodyid[p.geom2[i]])
                rows["geom1"].append(p.geom1[i])
                rows["geom2"].append(p.geom2[i])
                rows["condim"].append(p.condim[i])
                rows["friction"].append(p.friction[i])
                rows["solref"].append(p.solref[i])
                rows["solimp"].append(p.solimp[i])
                rows["includemargin"].append(p.margin[i] - p.gap[i])
                rows["invweight"].append(p.invweight[i])
    return ContactParams(
        body1=np.array(rows["body1"], dtype=np.int32),
        body2=np.array(rows["body2"], dtype=np.int32),
        geom1=np.array(rows["geom1"], dtype=np.int32),
        geom2=np.array(rows["geom2"], dtype=np.int32),
        condim=np.array(rows["condim"], dtype=np.int32),
        friction=np.stack(rows["friction"]) if rows["friction"] else np.zeros((0, 5)),
        solref=np.stack(rows["solref"]) if rows["solref"] else np.zeros((0, 2)),
        solimp=np.stack(rows["solimp"]) if rows["solimp"] else np.zeros((0, 5)),
        includemargin=np.array(rows["includemargin"]),
        invweight=np.array(rows["invweight"]),
    )


def get_contact_params(model: PhysicsModel) -> ContactParams:
    """contact_params, made once per model."""
    return cached(model, "contact_params", lambda: contact_params(model))


# ----------------------------------------------------------------------
# batched vector helpers: (..., 3) vectors, (..., 3, 3) matrices
# ----------------------------------------------------------------------


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _mv(m, v):
    """m @ v for (..., 3, 3) m and (..., 3) v."""
    return (m @ v[..., None])[..., 0]


def _mtv(m, v):
    """mᵀ @ v."""
    return (m.transpose(-1, -2) @ v[..., None])[..., 0]


def _norm(v):
    return torch.linalg.vector_norm(v, dim=-1)


def make_frame(normal: torch.Tensor) -> torch.Tensor:
    """Orthonormal contact frame rows [n, t1, t2] (mju_makeFrame semantics)."""
    n = normal
    # a helper axis not parallel to n: y where |n_y| < 0.5, else z
    use_y = torch.abs(n[..., 1]) < 0.5
    zero, one = torch.zeros_like(n[..., 0]), torch.ones_like(n[..., 0])
    b = torch.stack([zero, torch.where(use_y, one, zero), torch.where(use_y, zero, one)], -1)
    t1 = b - n * _dot(n, b)[..., None]
    t1 = t1 / _norm(t1)[..., None]
    t2 = cross(n, t1)
    return torch.stack([n, t1, t2], dim=-2)


def _plane_sphere(ppos, pmat, spos, r):
    n = pmat[..., :, 2]
    dist = _dot(n, spos - ppos) - r
    pos = spos - n * (r + 0.5 * dist)[..., None]
    return dist, pos, n


def _plane_capsule(ppos, pmat, cpos, cmat, size):
    """Two end-cap contacts, (B, npair, 2, ...), with the MuJoCo plane-capsule
    frame: t1 the capsule axis projected onto the plane, the generic frame's
    where that projection vanishes (see the JAX package's docstring)."""
    r, half = size[:, 0], size[:, 1]
    axis = cmat[..., :, 2]
    n = pmat[..., :, 2]
    proj = axis - n * _dot(n, axis)[..., None]
    plen = _norm(proj)[..., None]
    generic = make_frame(n)
    t1 = torch.where(plen > 1e-10, proj / torch.clamp(plen, min=1e-30), generic[..., 1, :])
    frame = torch.stack([n, t1, cross(n, t1)], dim=-2)
    outs = [_plane_sphere(ppos, pmat, cpos + sgn * half[:, None] * axis, r)
            for sgn in (1.0, -1.0)]
    dist = torch.stack([o[0] for o in outs], -1)
    pos = torch.stack([o[1] for o in outs], -2)
    return dist, pos, frame[..., None, :, :].expand(pos.shape[:-1] + (3, 3))


def _plane_box(ppos, pmat, bpos, bmat, size, corner_signs):
    """4 slots: the 4 deepest of the 8 corners, ties to the lower corner."""
    n = pmat[..., :, 2]
    local = corner_signs * size[:, None, :]  # (npair, 8, 3)
    corners = bpos[..., None, :] + (bmat[..., None, :, :] @ local[..., None])[..., 0]
    dists = _dot(n[..., None, :], corners - ppos[..., None, :])  # (B, npair, 8)
    order = torch.argsort(dists, dim=-1, stable=True)[..., :4]
    d = torch.gather(dists, -1, order)
    pos = torch.gather(corners, -2, order[..., None].expand(order.shape + (3,)))
    pos = pos - 0.5 * d[..., None] * n[..., None, :]
    frame = make_frame(n)[..., None, :, :].expand(pos.shape[:-1] + (3, 3))
    return d, pos, frame


def _sphere_sphere(p1, r1, p2, r2):
    delta = p2 - p1
    length = _norm(delta)
    n = delta / torch.clamp(length, min=1e-12)[..., None]
    # coincident centers: the z axis, like MuJoCo
    z = torch.zeros_like(n)
    z[..., 2] = 1.0
    n = torch.where(length[..., None] < 1e-12, z, n)
    dist = length - (r1 + r2)
    pos = p1 + n * (r1 + 0.5 * dist)[..., None]
    return dist, pos, n


def _closest_on_segment(a, b, p):
    ab = b - a
    t = _dot(p - a, ab) / torch.clamp(_dot(ab, ab), min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    return a + t[..., None] * ab


def _sphere_capsule(spos, r1, cpos, cmat, size):
    r2, half = size[:, 0], size[:, 1]
    axis = cmat[..., :, 2]
    a, b = cpos - half[:, None] * axis, cpos + half[:, None] * axis
    return _sphere_sphere(spos, r1, _closest_on_segment(a, b, spos), r2)


def sphere_box(spos, r, bpos, bmat, size):
    """Sphere (or point, r=0) vs box: (dist, pos, normal), the normal from the
    box into the sphere."""
    local = _mtv(bmat, spos - bpos)
    clamped = torch.clamp(local, -size, size)
    outside = torch.any(torch.abs(local) > size, dim=-1)
    # outside: the closest point on the box's surface
    delta_out = local - clamped
    len_out = _norm(delta_out)
    n_out_local = delta_out / torch.clamp(len_out, min=1e-12)[..., None]
    dist_out = len_out - r
    pos_out_local = clamped + 0.5 * dist_out[..., None] * n_out_local
    # inside: the face of least depth (the first of a tie)
    depths = size - torch.abs(local)
    ax = torch.argmin(depths, dim=-1, keepdim=True)
    sgn = torch.sign(torch.gather(local, -1, ax))
    on_ax = torch.arange(3, device=local.device) == ax
    n_in_local = on_ax.to(local.dtype) * sgn
    dist_in = -(torch.gather(depths, -1, ax)[..., 0] + r)
    surface = torch.where(on_ax, sgn * size, local)
    pos_in_local = surface + 0.5 * dist_in[..., None] * n_in_local

    dist = torch.where(outside, dist_out, dist_in)
    n_local = torch.where(outside[..., None], n_out_local, n_in_local)
    pos_local = torch.where(outside[..., None], pos_out_local, pos_in_local)
    return dist, bpos + _mv(bmat, pos_local), _mv(bmat, n_local)


def _capsule_capsule(p1, m1, s1, p2, m2, s2):
    r1, h1 = s1[:, 0], s1[:, 1:2]
    r2, h2 = s2[:, 0], s2[:, 1:2]
    a1, b1 = p1 - h1 * m1[..., :, 2], p1 + h1 * m1[..., :, 2]
    a2, b2 = p2 - h2 * m2[..., :, 2], p2 + h2 * m2[..., :, 2]
    # closest points between the segments: 4 sweeps of alternating projection
    c2 = p2
    for _ in range(4):
        c1 = _closest_on_segment(a1, b1, c2)
        c2 = _closest_on_segment(a2, b2, c1)
    return _sphere_sphere(c1, r1, c2, r2)


def _capsule_box(cpos, cmat, csize, bpos, bmat, bsize):
    """Two approximate contacts, (B, npair, 2, ...): the deepest segment
    point, and the deeper end point, switched off (dist 1) where it is the
    segment point (see the JAX package's docstring).  Normals box → capsule."""
    r, half = csize[:, 0], csize[:, 1:2]
    axis = cmat[..., :, 2]
    a, b = cpos - half * axis, cpos + half * axis
    # the segment point closest to the box: iterated closest-point projections
    p = bpos
    for _ in range(4):
        seg = _closest_on_segment(a, b, p)
        local = torch.clamp(_mtv(bmat, seg - bpos), -bsize, bsize)
        p = bpos + _mv(bmat, local)
    c0 = sphere_box(seg, r, bpos, bmat, bsize)
    da = sphere_box(a, r, bpos, bmat, bsize)
    db = sphere_box(b, r, bpos, bmat, bsize)
    deeper = da[0] < db[0]
    d1 = torch.where(deeper, da[0], db[0])
    pos1 = torch.where(deeper[..., None], da[1], db[1])
    n1 = torch.where(deeper[..., None], da[2], db[2])
    end = torch.where(deeper[..., None], a, b)
    dup = torch.sum((seg - end) ** 2, dim=-1) < 1e-12
    d1 = torch.where(dup, torch.ones_like(d1), d1)
    return (torch.stack([c0[0], d1], -1), torch.stack([c0[1], pos1], -2),
            torch.stack([c0[2], n1], -2))


def _box_box(p1, m1, s1, p2, m2, s2, corner_signs):
    """8 approximate contacts, (B, npair, 8, ...): box1's corners inside box2
    (no edge-edge).  Normals box2 → corner."""
    local = corner_signs * s1[:, None, :]
    corners = p1[..., None, :] + (m1[..., None, :, :] @ local[..., None])[..., 0]
    return sphere_box(corners, 0.0, p2[..., None, :], m2[..., None, :, :], s2[:, None, :])


def _build_consts(model: PhysicsModel, device, dtype):
    kinds = []
    for kind in sorted(model.pairs):
        p = model.pairs[kind]
        g1 = np.asarray(p.geom1, np.int64)
        g2 = np.asarray(p.geom2, np.int64)
        kinds.append(SimpleNamespace(
            kind=kind,
            g1=torch.as_tensor(g1, device=device),
            g2=torch.as_tensor(g2, device=device),
            s1=torch.as_tensor(model.geom_size[g1], dtype=dtype, device=device),
            s2=torch.as_tensor(model.geom_size[g2], dtype=dtype, device=device),
        ))
    signs = [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]
    return SimpleNamespace(kinds=kinds,
                           corner_signs=torch.as_tensor(signs, dtype=dtype, device=device))


def consts(model: PhysicsModel, device, dtype):
    return cached(model, ("collision", str(device), dtype),
                  lambda: _build_consts(model, device, dtype))


def collide(model: PhysicsModel, kin: Kinematics) -> Contacts:
    """The narrowphase of every static pair: Contacts with ncon_max slots."""
    B = kin.geom_xpos.shape[0]
    dtype, device = kin.geom_xpos.dtype, kin.geom_xpos.device
    c = consts(model, device, dtype)
    dists, poss, frames = [], [], []
    for k in c.kinds:
        p1, m1 = kin.geom_xpos.index_select(1, k.g1), kin.geom_xmat.index_select(1, k.g1)
        p2, m2 = kin.geom_xpos.index_select(1, k.g2), kin.geom_xmat.index_select(1, k.g2)
        s1, s2 = k.s1, k.s2
        kind = k.kind
        if kind == (GEOM_PLANE, GEOM_SPHERE):
            d, p, n = _plane_sphere(p1, m1, p2, s2[:, 0])
            d, p, f = d[..., None], p[..., None, :], make_frame(n)[..., None, :, :]
        elif kind == (GEOM_PLANE, GEOM_CAPSULE):
            d, p, f = _plane_capsule(p1, m1, p2, m2, s2)
        elif kind == (GEOM_PLANE, GEOM_BOX):
            d, p, f = _plane_box(p1, m1, p2, m2, s2, c.corner_signs)
        elif kind == (GEOM_SPHERE, GEOM_SPHERE):
            d, p, n = _sphere_sphere(p1, s1[:, 0], p2, s2[:, 0])
            d, p, f = d[..., None], p[..., None, :], make_frame(n)[..., None, :, :]
        elif kind == (GEOM_SPHERE, GEOM_CAPSULE):
            d, p, n = _sphere_capsule(p1, s1[:, 0], p2, m2, s2)
            d, p, f = d[..., None], p[..., None, :], make_frame(n)[..., None, :, :]
        elif kind == (GEOM_SPHERE, GEOM_BOX):
            # the sphere is geom1: the normal points from it into the box
            d, p, n = sphere_box(p1, s1[:, 0], p2, m2, s2)
            d, p, f = d[..., None], p[..., None, :], make_frame(-n)[..., None, :, :]
        elif kind == (GEOM_CAPSULE, GEOM_CAPSULE):
            d, p, n = _capsule_capsule(p1, m1, s1, p2, m2, s2)
            d, p, f = d[..., None], p[..., None, :], make_frame(n)[..., None, :, :]
        elif kind == (GEOM_CAPSULE, GEOM_BOX):
            d, p, n = _capsule_box(p1, m1, s1, p2, m2, s2)
            f = make_frame(-n)
        elif kind == (GEOM_BOX, GEOM_BOX):
            d, p, n = _box_box(p1, m1, s1, p2, m2, s2, c.corner_signs)
            # the convention is geom1 into geom2; sphere_box gave box2 → corner
            f = make_frame(-n)
        else:
            raise NotImplementedError(f"pair kind {kind}")
        dists.append(d.reshape(B, -1))
        poss.append(p.reshape(B, -1, 3))
        frames.append(f.reshape(B, -1, 3, 3))

    if not dists:
        z = kin.geom_xpos.new_zeros((B, 0))
        return Contacts(dist=z, pos=z.new_zeros((B, 0, 3)), frame=z.new_zeros((B, 0, 3, 3)))
    return Contacts(dist=torch.cat(dists, 1), pos=torch.cat(poss, 1), frame=torch.cat(frames, 1))
