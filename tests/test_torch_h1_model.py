"""torch port, the H1 push-crate stand-in: the committed model file, the
port's static metadata (`_meta`: the cliques of contact rows that couple the
robot's and the crate's kinematic trees, and the LDL fill-in they cause)
and every contact slot's geometry, against the JAX package.

Model and metadata comparisons are exact (both sides hold the same numpy
values).  The geometry is compared in float64 at 1e-12 absolute on dist,
pos and frame: the same forward kinematics and contact formulas in the same
order, on states where every kind and the cross-tree slots are active."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from torch_port_helpers import (
    H1_NPZ,
    assert_same_model,
    h1_crate_states,
    jax_standin_model,
    port_model_from,
    standin_joint_names,
)
from tpu_dialmpc.dynamics import fused as jfused
from tpu_dialmpc_torch.dynamics import fused as tfused
from tpu_dialmpc_torch.dynamics.model import JNT_FREE, JNT_HINGE, JNT_SLIDE, load_model

SCENE = "h1_push_crate"


@pytest.fixture(scope="module")
def models():
    mp = pytest.MonkeyPatch()
    try:
        jm = jax_standin_model(mp, SCENE)
    finally:
        mp.undo()
    return jm, port_model_from(jm)


def test_committed_h1_npz_equals_fresh_compile(models, monkeypatch):
    jm, _ = models
    port = load_model(str(H1_NPZ))
    assert_same_model(port, jm)
    assert port.jnt_names == standin_joint_names(monkeypatch, SCENE)


def test_h1_standin_has_the_published_widths(models):
    """nq 27, nv 26, nu 19: a free pelvis, 19 hinges in the published order,
    19 motors, and the crate's unactuated slide joint last (qpos 26)."""
    _, tm = models
    names = load_model(str(H1_NPZ)).jnt_names
    assert (tm.nq, tm.nv, tm.nu) == (27, 26, 19)
    assert [int(t) for t in tm.jnt_type] == [JNT_FREE] + [JNT_HINGE] * 19 + [JNT_SLIDE]
    legs = [f"{side}_{j}" for side in ("left", "right")
            for j in ("hip_yaw", "hip_roll", "hip_pitch", "knee", "ankle")]
    arms = [f"{side}_{j}" for side in ("left", "right")
            for j in ("shoulder_pitch", "shoulder_roll", "shoulder_yaw", "elbow")]
    assert list(names[1:20]) == legs + ["torso"] + arms
    assert [int(d) for d in tm.actuator_dofadr] == list(range(6, 25))
    assert int(tm.jnt_qposadr[20]) == 26 and int(tm.jnt_dofadr[20]) == 25
    assert "pelvis" in tm.body_names and tm.body_names[-1] == "crate"
    assert {"left_foot", "right_foot"} <= set(tm.site_names)
    assert abs(float(tm.key_qpos["home"][2]) - 0.98) < 1e-12
    crate = tm.body_names.index("crate")
    assert float(tm.body_mass[crate]) == 30.0
    assert tfused.supported(tm) and jfused.supported(models[0])


@pytest.mark.parametrize(
    "field",
    ["anc_strict", "m_keys", "anc_solver", "contact_slots", "limit_rows", "floss_rows"],
)
def test_h1_meta_matches_jax(models, field):
    jm, tm = models
    assert getattr(tfused._meta(tm), field) == getattr(jfused._meta(jm), field)


def test_h1_solver_pattern_has_cross_tree_cliques_and_fill_in(models):
    """Slots between the robot and the crate carry the dofs of both trees,
    their cliques join the crate's dof (25) to the robot's, and the LDL
    elimination fills in entries that are in neither the tree pattern nor
    any clique."""
    _, tm = models
    meta = tfused._meta(tm)
    two = [s for s in meta.contact_slots if tfused.spans_two_trees(tm, s)]
    kinds = {s["kind"] for s in two}
    assert len(two) == 22 and len(kinds) == 3  # sphere-, capsule- and box-box
    for s in two:
        assert s["dofs"][-1] == 25 and 0 in s["dofs"]
    cliques = {(a, b) for s in meta.contact_slots for a in s["dofs"] for b in s["dofs"] if b < a}
    strict = {(i, j) for i, anc in enumerate(meta.anc_strict) for j in anc}
    solver = {(i, j) for i, anc in enumerate(meta.anc_solver) for j in anc}
    assert strict <= solver and cliques <= solver
    fill = solver - strict - cliques
    assert fill, "no fill-in"
    assert all(len(anc) == i for i, anc in enumerate(meta.anc_solver))  # dense


def _flat(out, n):
    dist, pos, frame = out
    vals = [dist, *pos, *frame[0], *frame[1], *frame[2]]
    return np.stack([np.broadcast_to(np.asarray(v, np.float64), (n,)) for v in vals], -1)


def test_h1_contact_geometry_matches_jax(models):
    """Every slot, from each side's own forward kinematics, on states where
    every kind and the slots that span both trees are active."""
    jm, tm = models
    n = 40
    qpos, _ = h1_crate_states(tm, np.random.default_rng(0), n)
    q_t = list(torch.as_tensor(qpos).unbind(-1))
    q_j = [jnp.asarray(qpos[:, i]) for i in range(tm.nq)]
    fk_t, fk_j = tfused._fk(tm, q_t), jfused._fk(jm, q_j)
    like = q_t[0]
    per_kind, two_trees = {kind: 0 for kind in tm.pairs}, 0
    for slot in tfused._meta(tm).contact_slots:
        got = _flat(tfused._contact_geometry(tm, fk_t, slot, like), n)
        want = _flat(jfused._contact_geometry(jm, fk_j, slot), n)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12,
                                   err_msg=f"{slot['kind']} sub {slot['sub']}")
        active = int((got[:, 0] < slot["includemargin"]).sum())
        per_kind[slot["kind"]] += active
        two_trees += active if tfused.spans_two_trees(tm, slot) else 0
    assert all(count > 0 for count in per_kind.values()) and two_trees > 0
    # the counters chip_smoke.py prints and checks
    assert tfused.active_contacts(tm, torch.as_tensor(qpos)) == per_kind
    assert tfused.active_two_tree_contacts(tm, torch.as_tensor(qpos)) == two_trees


def test_sliding_crate_pose_is_per_sample_and_constant_conditions_fold(models):
    """The crate slides along x only.  The JAX graph folds its y and z, and
    with them the crate–floor slot's corner depths, into double constants;
    the port keeps every component of a sliding body's position per sample
    (the kernel adds 0 * displacement in float32), equal in float64.  And a
    comparison of two constants gives a Python bool, which `swhere` folds,
    as jnp.where does."""
    jm, tm = models
    qpos, _ = h1_crate_states(tm, np.random.default_rng(1), 10)
    crate = tm.body_names.index("crate")
    xpos_t = tfused._fk(tm, list(torch.as_tensor(qpos).unbind(-1)))["xpos"][crate]
    xpos_j = jfused._fk(jm, [jnp.asarray(qpos[:, i]) for i in range(tm.nq)])["xpos"][crate]
    assert all(isinstance(x, torch.Tensor) and x.shape == (10,) for x in xpos_t)
    assert [tfused._isf(x) for x in xpos_j] == [False, True, True]
    for got, want in zip(xpos_t, xpos_j):
        np.testing.assert_array_equal(got.numpy(), np.broadcast_to(np.asarray(want), (10,)))
    like = torch.zeros(3)
    assert tfused.swhere(0.5 < 1.0, 2.0, 3.0, like) == 2.0
    assert tfused.swhere(False, like + 1.0, like) is like
