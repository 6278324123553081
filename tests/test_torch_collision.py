"""torch port, dynamics/fused.py `_contact_geometry`: every contact kind of the
fused substep against the JAX package's `fused._contact_geometry` on the
crate stand-in's contact slots, in float64, plus the port's static metadata
(`_meta`) on that scene.

Inputs are random geom poses from a numpy seed: penetrating and separated
pairs, and tie cases (a box resting flat on the plane ties four corner
depths; a point on a box's diagonal ties two face depths).  The second geom
is either moving (a batched tensor) or static (Python constants, as the
floor and the mocap crate are in the substep graph, where its math folds in
double precision).

Tolerance 1e-12 absolute on dist, pos and the frame: the same formulas in
the same order, in float64."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from torch_port_helpers import jax_standin_model, port_model_from
from tpu_dialmpc.dynamics import fused as jfused
from tpu_dialmpc_torch.dynamics import fused as tfused
from tpu_dialmpc_torch.dynamics.model import GEOM_BOX, GEOM_CAPSULE, GEOM_PLANE, GEOM_SPHERE

TOL = 1e-12
B = 96
KINDS = {
    "plane_sphere": (GEOM_PLANE, GEOM_SPHERE),
    "plane_capsule": (GEOM_PLANE, GEOM_CAPSULE),
    "plane_box": (GEOM_PLANE, GEOM_BOX),
    "sphere_box": (GEOM_SPHERE, GEOM_BOX),
    "capsule_box": (GEOM_CAPSULE, GEOM_BOX),
    "box_box": (GEOM_BOX, GEOM_BOX),
}


@pytest.fixture(scope="module")
def models():
    mp = pytest.MonkeyPatch()
    try:
        jm = jax_standin_model(mp, "go2_force_crate")
    finally:
        mp.undo()
    return jm, port_model_from(jm)


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def _poses(model, kind, g1, g2, rng, static):
    """(pos1, mat1, pos2, mat2) as numpy (B, 3) / (B, 3, 3) arrays.  The
    static geom (the plane, else the box) has one pose for the batch; the
    last quarter of the samples is axis-aligned, for the tie cases."""
    s2 = model.geom_size[g2]
    mat1, mat2 = _rotations(rng, B), _rotations(rng, B)
    q = B // 4
    mat1[-q:] = np.eye(3)
    mat2[-q:] = np.eye(3)
    if kind[0] == GEOM_PLANE:
        pos1 = rng.normal(scale=0.1, size=(B, 3))
        pos1[-q:] = 0.0
        if static:
            pos1[:], mat1[:] = 0.0, np.eye(3)
        # geom2 above or below the plane by about its extent
        ext = float(np.max(s2[:3]))
        off = rng.uniform(-1.0, 1.5, size=B) * ext
        if kind == (GEOM_PLANE, GEOM_BOX):
            off[-q:] = s2[2]  # resting flat: 4 corner depths tie at 0
        if kind == (GEOM_PLANE, GEOM_CAPSULE):
            # the axis along the normal (no projection on the plane), or lying
            mat2[-q // 2:] = np.eye(3)
            mat2[-q:-q // 2] = np.array([[1, 0, 0], [0, 0, -1], [0, 1, 0]])
        pos2 = (pos1 + mat1[:, :, 2] * off[:, None]
                + np.einsum("bij,bj->bi", mat1, rng.normal(scale=0.1, size=(B, 3)) * [1, 1, 0]))
        return pos1, mat1, pos2, mat2
    pos2 = rng.normal(scale=0.1, size=(B, 3))
    if static:
        pos2[:], mat2[:] = pos2[0], mat2[-1]
    # geom1 inside, near or outside geom2 (a box)
    half2 = np.asarray(s2[:3])
    local = rng.uniform(-1.4, 1.4, size=(B, 3)) * half2
    # a point near the diagonal of the x and z faces: their depths tie
    d = rng.uniform(0.0, 0.1, size=q)
    local[-q:] = np.stack([half2[0] - d, np.zeros(q), half2[2] - d], -1)
    pos1 = pos2 + np.einsum("bij,bj->bi", mat2, local)
    return pos1, mat1, pos2, mat2


def _fk(model, g1, g2, poses, lib, static):
    """An fk dict holding only the two geoms' poses as `lib` scalars (B,);
    the static geom's as Python floats."""
    pos1, mat1, pos2, mat2 = poses
    if lib == "torch":
        def arr(x):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float64)
    else:
        def arr(x):
            return jnp.asarray(np.ascontiguousarray(x), jnp.float64)
    ng = model.geom_bodyid.shape[0]
    xpos, xmat = [None] * ng, [None] * ng
    static_g = (g1 if model.geom_type[g1] == GEOM_PLANE else g2) if static else None
    for g, pos, mat in ((g1, pos1, mat1), (g2, pos2, mat2)):
        if g == static_g:
            xpos[g] = tuple(float(x) for x in pos[0])
            xmat[g] = tuple(tuple(float(x) for x in row) for row in mat[0])
        else:
            xpos[g] = tuple(arr(pos[:, i]) for i in range(3))
            xmat[g] = tuple(tuple(arr(mat[:, i, j]) for j in range(3)) for i in range(3))
    return dict(geom_xpos=xpos, geom_xmat=xmat)


def _flat(out):
    """(dist, pos, (n, t1, t2)) -> (B, 13) numpy."""
    dist, pos, frame = out
    vals = [dist, *pos, *frame[0], *frame[1], *frame[2]]
    return np.stack([np.broadcast_to(np.asarray(v, np.float64), (B,)) for v in vals], -1)


@pytest.mark.parametrize("static", [False, True], ids=["moving", "static"])
@pytest.mark.parametrize("name", sorted(KINDS))
def test_contact_geometry_matches_jax(models, name, static):
    jm, tm = models
    kind = KINDS[name]
    slots_t = [s for s in tfused._meta(tm).contact_slots if s["kind"] == kind]
    slots_j = [s for s in jfused._meta(jm).contact_slots if s["kind"] == kind]
    assert slots_t == slots_j and slots_t
    g1, g2 = slots_t[0]["g1"], slots_t[0]["g2"]
    pair = [s for s in slots_t if (s["g1"], s["g2"]) == (g1, g2)]
    rng = np.random.default_rng(sum(map(ord, name)) + int(static))
    poses = _poses(tm, kind, g1, g2, rng, static)
    fk_t = _fk(tm, g1, g2, poses, "torch", static)
    fk_j = _fk(jm, g1, g2, poses, "jax", static)
    like = torch.zeros(B, dtype=torch.float64)
    dists = []
    for slot in pair:
        got = _flat(tfused._contact_geometry(tm, fk_t, slot, like))
        want = _flat(jfused._contact_geometry(jm, fk_j, slot))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL,
                                   err_msg=f"{name} sub {slot['sub']}")
        assert np.isfinite(got).all()
        dists.append(got[:, 0])
    dists = np.stack(dists)
    # penetrating and separated cases are both among the inputs
    assert (dists < 0).any() and (dists > 0).any()


@pytest.mark.parametrize(
    "field",
    ["anc_strict", "m_keys", "anc_solver", "contact_slots", "limit_rows", "floss_rows"],
)
def test_crate_meta_matches_jax(models, field):
    jm, tm = models
    assert getattr(tfused._meta(tm), field) == getattr(jfused._meta(jm), field)


def test_crate_scene_holds_the_six_kinds(models):
    jm, tm = models
    assert sorted(tm.pairs) == sorted(KINDS.values())
    assert tfused.supported(tm) and jfused.supported(jm)
    slots = tfused._meta(tm).contact_slots
    assert len(slots) == 52
    assert max(len(s["dofs"]) for s in slots) == 9  # free joint + one leg
    assert min(len(s["dofs"]) for s in slots) == 6  # the torso box
    # the crate and the floor are both welded to the world: no pair, so no
    # slot without dofs
    crate = tm.body_names.index("box_body")
    assert all(not (s["body1"] in (0, crate) and s["body2"] in (0, crate)) for s in slots)
