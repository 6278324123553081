"""The torch port's physics pipeline (tpu_dialmpc_torch/dynamics/{linalg,
kinematics,smooth,collision,constraint,solver,pipeline}.py) held stage by
stage against the JAX package's, in float64 on the CPU.

The test files tests/test_torch_physics_*.py import these cases and give
them their scenes (a module-scoped `scene` fixture), so that
`--dist loadfile` spreads the scenes over workers.  Per scene the JAX side
is one jitted function of one sample's (qpos, qvel, warmstart, ctrl) (XLA
traces and compiles it faster than its vmap), called per sample, that
returns every stage (kinematics, com_vel, crb, rne, passive, actuation,
qacc_smooth, collide, make_constraints, solve) and one pipeline substep
(`pipeline.step`, n_substeps=1) and `pipeline.init`: one XLA compile per
scene.  Eight substeps are that substep chained eight times, as JAX's
`pipeline.step(..., 8)` scans it.

Inputs (B samples, float64): the states that make every contact kind of
the scene active (tests/torch_port_helpers.py), ctrl within the motors'
range (on the servo scene targets about the joints); the warm start is the
JAX solver's own answer for the even samples and a large random one for the
odd samples, so that the solve takes it on some samples and not on others.

Tolerances, each relative to the output's largest magnitude (at least 1):
- 1e-12 for the stages and init: the same formulas; the port sums the tree
  passes and the Cholesky's columns as batched products, in another order;
- 1e-10 for the solve and one substep: the Newton solve of a contact-stiff
  system amplifies the stages' last-bit differences (qacc reaches 1e3);
- 1e-9 after 8 substeps, as tests/test_torch_slice.py's physics.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    crate_states,
    h1_crate_states,
    h1_floor_states,
    jax_standin_model,
    near_home_states,
    pair_kinds_states,
    port_model_from,
    servo_states,
)
from tpu_dialmpc.dynamics import collision as jcollision
from tpu_dialmpc.dynamics import constraint as jconstraint
from tpu_dialmpc.dynamics import kinematics as jkinematics
from tpu_dialmpc.dynamics import linalg as jlinalg
from tpu_dialmpc.dynamics import pipeline as jpipeline
from tpu_dialmpc.dynamics import smooth as jsmooth
from tpu_dialmpc.dynamics import solver as jsolver
from tpu_dialmpc_torch.dynamics import collision, constraint, kinematics, linalg, pipeline
from tpu_dialmpc_torch.dynamics import smooth, solver
from tpu_dialmpc_torch.dynamics.model import GEOM_BOX, GEOM_CAPSULE, GEOM_PLANE, GEOM_SPHERE

B = 6
STAGE_TOL, SOLVE_TOL, STEPS8_TOL = 1e-12, 1e-10, 1e-9
KIND_NAMES = {(GEOM_PLANE, GEOM_SPHERE): "plane-sphere", (GEOM_PLANE, GEOM_CAPSULE): "plane-capsule",
              (GEOM_PLANE, GEOM_BOX): "plane-box", (GEOM_SPHERE, GEOM_SPHERE): "sphere-sphere",
              (GEOM_SPHERE, GEOM_CAPSULE): "sphere-capsule", (GEOM_SPHERE, GEOM_BOX): "sphere-box",
              (GEOM_CAPSULE, GEOM_CAPSULE): "capsule-capsule",
              (GEOM_CAPSULE, GEOM_BOX): "capsule-box", (GEOM_BOX, GEOM_BOX): "box-box"}


def close(got, want, tol, where=""):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    assert got.shape == want.shape, (where, got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=where)


def _states(scene, model, rng):
    """(qpos, qvel, ctrl) of B samples for the scene."""
    if scene == "go2_position":
        qpos, qvel, _, ctrl = servo_states(model, rng, B)
        return qpos, qvel, ctrl
    if scene == "go2_force":
        qpos, qvel, _ = near_home_states(model, rng, B, scale_q=0.05, scale_v=0.2)
    else:
        states = {"go2_force_crate": crate_states, "h1_push_crate": h1_crate_states,
                  "h1_walk": h1_floor_states, "h1_loco": h1_floor_states,
                  "go2_pair_kinds": pair_kinds_states}[scene]
        qpos, qvel = states(model, rng, B)
    lim = np.abs(np.asarray(model.actuator_ctrlrange)).max(axis=1)
    return qpos, qvel, rng.uniform(-0.5, 0.5, (B, model.nu)) * lim


def _jax_all(jm, cp, qpos, qvel, ws, ctrl):
    """Every JAX stage at one sample, one pipeline substep and init."""
    kin = jkinematics.kinematics(jm, qpos)
    vel = jkinematics.com_vel(jm, kin, qvel)
    m_mat = jsmooth.crb_mass_matrix(jm, kin)
    act = jsmooth.actuator_force(jm, ctrl, qpos, qvel)
    bias = jsmooth.rne_bias(jm, kin, vel, qvel)
    passive = jsmooth.passive_force(jm, qvel)
    qacc_smooth = jlinalg.solve_psd(m_mat, passive + act - bias)
    contacts = jcollision.collide(jm, kin)
    con = jconstraint.make_constraints(jm, kin, qpos, qvel, contacts, cp)
    res = jsolver.solve(jm, m_mat, qacc_smooth, ws, con)
    state = jpipeline.PipelineState(qpos, qvel, ws, *([None] * 7))
    return dict(kin=kin, vel=vel, m_mat=m_mat, act=act, bias=bias, passive=passive,
                qacc_smooth=qacc_smooth, contacts=contacts, con=con, res=res,
                step=jpipeline.step(jm, state, ctrl, 1), init=jpipeline.init(jm, qpos, qvel))


@pytest.fixture(scope="module")
def ref(scene):
    """The scene's models, inputs and JAX outputs (numpy)."""
    mp = pytest.MonkeyPatch()
    try:
        jm = jax_standin_model(mp, scene)
    finally:
        mp.undo()
    tm = port_model_from(jm)
    qpos, qvel, ctrl = _states(scene, tm, np.random.default_rng(7))
    one = jax.jit(functools.partial(_jax_all, jm, jcollision.contact_params(jm)))

    def fn(*args):  # the batch, one sample at a time, stacked (numpy)
        outs = [one(*(a[i] for a in args)) for i in range(B)]
        return jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)

    # the warm start: the solver's own answer on the even samples, a far one
    # on the odd samples
    ws = fn(qpos, qvel, np.zeros_like(qvel), ctrl)["res"].qacc.copy()
    ws[1::2] = np.random.default_rng(8).normal(scale=50.0, size=ws[1::2].shape)
    out = fn(qpos, qvel, ws, ctrl)
    return dict(jm=jm, tm=tm, fn=fn, qpos=qpos, qvel=qvel, ws=ws, ctrl=ctrl, jax=out)


def _t(x):
    return torch.as_tensor(np.array(x))


def _port_stages(r):
    tm = r["tm"]
    q, v, w, c = (_t(r[k]) for k in ("qpos", "qvel", "ws", "ctrl"))
    kin = kinematics.kinematics(tm, q)
    vel = kinematics.com_vel(tm, kin, v)
    return tm, q, v, w, c, kin, vel


def test_kinematics_and_com_vel_match_jax(ref):
    tm, q, v, w, c, kin, vel = _port_stages(ref)
    j = ref["jax"]
    for f in kin._fields:
        close(getattr(kin, f), getattr(j["kin"], f), STAGE_TOL, f)
    for f in vel._fields:
        close(getattr(vel, f), getattr(j["vel"], f), STAGE_TOL, f)


def test_smooth_dynamics_match_jax(ref):
    """crb, rne, passive, actuation (motors, or the servos' affine bias with
    both clamps) and qacc_smooth."""
    tm, q, v, w, c, kin, vel = _port_stages(ref)
    j = ref["jax"]
    m_mat = smooth.crb_mass_matrix(tm, kin)
    close(m_mat, j["m_mat"], STAGE_TOL, "M")
    close(smooth.rne_bias(tm, kin, vel, v), j["bias"], STAGE_TOL, "bias")
    close(smooth.passive_force(tm, v), j["passive"], STAGE_TOL, "passive")
    act = smooth.actuator_force(tm, c, q, v)
    close(act, j["act"], STAGE_TOL, "actuation")
    assert float(act.abs().max()) > 1.0
    qfrc = smooth.passive_force(tm, v) + act - smooth.rne_bias(tm, kin, vel, v)
    close(linalg.solve_psd(m_mat, qfrc), j["qacc_smooth"], STAGE_TOL, "qacc_smooth")


def test_collide_matches_jax_with_every_kind_active(ref):
    tm, q, v, w, c, kin, vel = _port_stages(ref)
    j = ref["jax"]["contacts"]
    got = collision.collide(tm, kin)
    for f in got._fields:
        close(getattr(got, f), getattr(j, f), STAGE_TOL, f)
    cp = collision.contact_params(tm)
    active = (got.dist < _t(cp.includemargin)).numpy()
    k = 0
    for kind in sorted(tm.pairs):
        n = tm.pairs[kind].geom1.shape[0] * tm.pairs[kind].ncon
        assert active[:, k : k + n].any(), f"no active {KIND_NAMES[kind]} contact"
        k += n


def test_make_constraints_matches_jax(ref):
    tm, q, v, w, c, kin, vel = _port_stages(ref)
    j = ref["jax"]["con"]
    con = constraint.make_constraints(tm, kin, q, v, collision.collide(tm, kin),
                                      collision.contact_params(tm))
    for f in ("J", "pos", "aref", "D"):
        close(getattr(con, f), getattr(j, f), STAGE_TOL, f)
    for f in ("margin", "floss"):  # model constants per row
        close(getattr(con, f).expand(B, -1), getattr(j, f), 0.0, f)
    assert np.array_equal(con.active.numpy(), j.active)


def test_solve_matches_jax_with_and_without_the_warm_start(ref):
    """The solver on the JAX stages' own M, qacc_smooth and rows; the warm
    start is taken on some samples and not on others."""
    j = ref["jax"]
    jc = j["con"]
    con = constraint.Constraints(J=_t(jc.J), pos=_t(jc.pos), margin=_t(jc.margin[0]),
                                 aref=_t(jc.aref), D=_t(jc.D), active=_t(jc.active),
                                 floss=_t(jc.floss[0]))
    m_mat, qs, ws = _t(j["m_mat"]), _t(j["qacc_smooth"]), _t(ref["ws"])
    res = solver.solve(ref["tm"], m_mat, qs, ws, con)
    for f in res._fields:
        close(getattr(res, f), getattr(j["res"], f), SOLVE_TOL, f)

    def cost(a):  # the solver's objective, as solver.solve scores its start
        x = (con.J @ a[..., None])[..., 0] - con.aref
        s, _, _ = solver._s_terms(x, con.D, con.floss, con.active)
        da = a - qs
        return 0.5 * ((m_mat @ da[..., None])[..., 0] * da).sum(-1) + s.sum(-1)

    taken = (cost(ws) < cost(qs)).numpy()
    assert taken.any() and not taken.all(), taken


def test_pipeline_init_matches_jax(ref):
    tm = ref["tm"]
    got = pipeline.init(tm, _t(ref["qpos"]), _t(ref["qvel"]))
    want = ref["jax"]["init"]
    for f in ("qpos", "qvel", "qacc_warmstart", "xpos", "xquat", "site_xpos", "subtree_com",
              "cvel", "qfrc_actuator"):
        close(getattr(got, f), getattr(want, f), STAGE_TOL, f)
    close(got.efc_force, want.efc_force, SOLVE_TOL, "efc_force")


FIELDS = ("qpos", "qvel", "qacc_warmstart", "xpos", "xquat", "site_xpos", "subtree_com", "cvel",
          "qfrc_actuator", "efc_force")


def test_pipeline_step_matches_jax_at_1_and_8_substeps(ref):
    tm = ref["tm"]
    state = pipeline.PipelineState(*(_t(ref[k]) for k in ("qpos", "qvel", "ws")), *([None] * 6))
    c = _t(ref["ctrl"])
    one = pipeline.step(tm, state, c, 1)
    for f in FIELDS:
        close(getattr(one, f), getattr(ref["jax"]["step"], f), SOLVE_TOL, f)
    want = ref["jax"]["step"]
    for _ in range(7):
        want = ref["fn"](want.qpos, want.qvel, want.qacc_warmstart, ref["ctrl"])["step"]
    got = pipeline.step(tm, state, c, 8)
    for f in FIELDS:
        close(getattr(got, f), getattr(want, f), STEPS8_TOL, f)
    assert np.isfinite(got.qpos.numpy()).all()


def test_unbatched_state_steps_as_a_batch_of_one(ref):
    """pipeline.init and step take one unbatched state too."""
    tm = ref["tm"]
    q, v, w, c = (_t(ref[k][0]) for k in ("qpos", "qvel", "ws", "ctrl"))
    single = pipeline.step(tm, pipeline.init(tm, q, v), c, 1)
    batch = pipeline.step(tm, pipeline.init(tm, q[None], v[None]), c[None], 1)
    for f in FIELDS:
        assert torch.equal(getattr(single, f), getattr(batch, f)[0]), f
