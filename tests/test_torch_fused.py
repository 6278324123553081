"""torch port, dynamics/fused.py and fused_cuda.py: the plain substep chain
against the JAX package's fused scalar graph and its XLA pipeline, the
launch counter and device checks of the kernel wrapper, and the kernel
source's arithmetic through its host (g++) build, on the Go2 stand-in
(plane-sphere contacts) and on the crate stand-in (all six contact kinds,
on batches where every kind has an active contact).

Tolerances, with their reasons:
- float32 vs the eager JAX `fused._substep`: those of tests/test_fused.py
  (qpos 2e-5, qvel 5e-4, site/quat 2e-5, cvel 1e-3, qfrc_actuator 1e-4):
  the same graph in float32, whose truncated Newton solve amplifies
  last-bit differences of the two libraries' sin/cos/rsqrt.
- float64 vs `pipeline.step` and vs the JAX graph: 1e-9 / 1e-10 (see each
  test): the same math in float64, in another factorization order.  On the
  crate scene the warmstart output (the solver's qacc, up to ~1e3 in hard
  contact) is held to 1e-10 of its scale.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import crate_states, jax_standin_model, near_home_states, port_model_from
from tpu_dialmpc.dynamics import fused as jfused
from tpu_dialmpc.dynamics import pipeline
from tpu_dialmpc_torch.dynamics import fused as tfused
from tpu_dialmpc_torch.dynamics import fused_cuda

TORSO = 1  # "base"


@pytest.fixture(scope="module")
def models():
    mp = pytest.MonkeyPatch()
    try:
        jm = jax_standin_model(mp)
    finally:
        mp.undo()
    return jm, port_model_from(jm)


def _trials(model, n=3):
    """test_fused.py's three seeded single-sample trials."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(n):
        qpos, qvel, ws = near_home_states(model, rng, 1)
        ctrl = rng.uniform(-20, 20, size=(1, model.nu))
        out.append((qpos, qvel, ws, ctrl))
    return out


@pytest.fixture(scope="module")
def crate_models():
    mp = pytest.MonkeyPatch()
    try:
        jm = jax_standin_model(mp, "go2_force_crate")
    finally:
        mp.undo()
    return jm, port_model_from(jm)


def _crate_batch(model, seed, B=24):
    """Crate-scene inputs with every contact kind active (asserted)."""
    rng = np.random.default_rng(seed)
    qpos, qvel = crate_states(model, rng, B)
    ws = rng.normal(scale=0.5, size=(B, model.nv))
    ctrl = rng.uniform(-20, 20, size=(B, model.nu))
    active = tfused.active_contacts(model, torch.as_tensor(qpos))
    assert len(active) == 6 and all(n > 0 for n in active.values()), active
    return qpos, qvel, ws, ctrl


def _jax_substeps(jm, qpos, qvel, ws, ctrl, dtype, n_substeps=1):
    """The JAX fused scalar graph, eagerly, on (B,)-shaped scalars."""
    meta = jfused._meta(jm)
    spec = jfused.DerivedSpec(torso_body=TORSO)

    def cols(a):
        return [jnp.asarray(a[:, i], dtype) for i in range(a.shape[1])]

    q, v, w, c = cols(qpos), cols(qvel), cols(ws), cols(ctrl)
    for _ in range(n_substeps):
        q, v, w, der = jfused._substep(jm, meta, spec, q, v, w, c)
    B = qpos.shape[0]
    return [
        np.stack([np.broadcast_to(np.asarray(x, np.float64), (B,)) for x in xs], -1)
        for xs in (q, v, w, der)
    ]


def _port(tm, qpos, qvel, ws, ctrl, dtype, n_substeps=1):
    fn = tfused.build_fused_step(tm, n_substeps, tfused.DerivedSpec(torso_body=TORSO))
    out = fn(*(torch.as_tensor(a, dtype=dtype) for a in (qpos, qvel, ws, ctrl)))
    return [o.double().numpy() for o in out]


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_plain_substep_matches_jax_graph_float32(models, trial):
    jm, tm = models
    args = _trials(tm)[trial]
    q, v, _, d = _port(tm, *args, torch.float32)
    jq, jv, _, jd = _jax_substeps(jm, *args, jnp.float32)
    spec = tfused.DerivedSpec(torso_body=TORSO)
    got = tfused.split_derived(tm, spec, torch.as_tensor(d))
    want = tfused.split_derived(tm, spec, torch.as_tensor(jd))
    np.testing.assert_allclose(q, jq, atol=2e-5)
    np.testing.assert_allclose(v, jv, atol=5e-4)
    for key, atol in (("site_xpos", 2e-5), ("torso_xquat", 2e-5),
                      ("torso_cvel", 1e-3), ("qfrc_actuator", 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=atol)


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_plain_substep_matches_jax_graph_float64(models, trial):
    """Same graph, same op order, float64: equal to 1e-10."""
    jm, tm = models
    args = _trials(tm)[trial]
    for got, want in zip(_port(tm, *args, torch.float64), _jax_substeps(jm, *args, jnp.float64)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


def test_plain_matches_pipeline_step_float64(models):
    """Against the XLA physics pipeline (dense solves, another op order)."""
    jm, tm = models
    step = jax.jit(functools.partial(pipeline.step, jm, n_substeps=1))
    for qpos, qvel, ws, ctrl in _trials(tm):
        st = pipeline.PipelineState(
            qpos=jnp.asarray(qpos[0]), qvel=jnp.asarray(qvel[0]),
            qacc_warmstart=jnp.asarray(ws[0]), xpos=None, xquat=None,
            site_xpos=None, subtree_com=None, cvel=None, qfrc_actuator=None,
            efc_force=None,
        )
        ref = step(st, jnp.asarray(ctrl[0]))
        q, v, w, d = _port(tm, qpos, qvel, ws, ctrl, torch.float64)
        der = tfused.split_derived(tm, tfused.DerivedSpec(torso_body=TORSO), torch.as_tensor(d))
        np.testing.assert_allclose(q[0], np.asarray(ref.qpos), rtol=0, atol=1e-9)
        np.testing.assert_allclose(v[0], np.asarray(ref.qvel), rtol=0, atol=1e-9)
        np.testing.assert_allclose(w[0], np.asarray(ref.qacc_warmstart), rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(der["site_xpos"][0].numpy(), np.asarray(ref.site_xpos),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(der["torso_cvel"][0].numpy(), np.asarray(ref.cvel[TORSO]),
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(der["qfrc_actuator"][0].numpy(),
                                   np.asarray(ref.qfrc_actuator), rtol=0, atol=1e-9)


def test_substep_loop_matches_jax_graph(models):
    """n_substeps=2 inside one call equals two JAX substeps (float64)."""
    jm, tm = models
    rng = np.random.default_rng(3)
    qpos, qvel, ws = near_home_states(tm, rng, 4)
    ctrl = rng.uniform(-20, 20, size=(4, tm.nu))
    got = _port(tm, qpos, qvel, ws, ctrl, torch.float64, n_substeps=2)
    want = _jax_substeps(jm, qpos, qvel, ws, ctrl, jnp.float64, n_substeps=2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)


def test_split_derived_matches_jax(models):
    jm, tm = models
    spec_j = jfused.DerivedSpec(torso_body=TORSO)
    spec_t = tfused.DerivedSpec(torso_body=TORSO)
    nd = tfused.derived_size(tm, spec_t)
    assert nd == jfused.derived_size(jm, spec_j) == 16 + 3 * tm.nsite + tm.nv
    der = np.random.default_rng(4).normal(size=(3, nd))
    got = tfused.split_derived(tm, spec_t, torch.as_tensor(der))
    want = jfused.split_derived(jm, spec_j, jnp.asarray(der))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_wrapper_runs_plain_on_cpu_without_launching(models):
    _, tm = models
    fs = fused_cuda.FusedStep(tm, 2, tfused.DerivedSpec(torso_body=TORSO))
    rng = np.random.default_rng(5)
    qpos, qvel, ws = near_home_states(tm, rng, 3)
    args = [torch.as_tensor(a, dtype=torch.float32)
            for a in (qpos, qvel, ws, rng.uniform(-5, 5, size=(3, tm.nu)))]
    out = fs(*args)
    ref = fs.plain(*args)
    assert fs.launches == 0
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


@pytest.mark.parametrize("case", ["meta_device", "mixed_devices"])
def test_wrapper_raises_off_cpu_without_cuda(models, case):
    """Off the CPU the wrapper launches the kernel or raises; it never falls
    back to the plain version."""
    _, tm = models
    fs = fused_cuda.FusedStep(tm, 1, tfused.DerivedSpec(torso_body=TORSO))
    shapes = [(2, tm.nq), (2, tm.nv), (2, tm.nv), (2, tm.nu)]
    args = [torch.zeros(s, device="meta") for s in shapes]
    if case == "mixed_devices":
        args[0] = torch.zeros(shapes[0])
    with pytest.raises(ValueError):
        fs(*args)
    assert fs.launches == 0


def test_kernel_source_host_build_matches_plain(models, tmp_path):
    """csrc/fused_step.cu compiled as host C++ (g++) against the plain
    version, float32, 64 near-home samples, one substep.

    The kernel follows the plain version's op order; on the host its only
    deviations are last-bit differences between glibc's and torch's
    sin/cos, which the truncated Newton solve amplifies exactly as it
    amplifies float32 rounding.  So each output must agree with the plain
    version within 4x the plain version's own float32 error (its distance
    from the float64 run) plus 1e-6 of the output's scale; a wrong formula
    shows up orders of magnitude above that."""
    _, tm = models
    spec = tfused.DerivedSpec(torso_body=TORSO)
    lib, _, _ = fused_cuda.build_library(
        tm, tfused._meta(tm), spec, host=True, out_dir=tmp_path
    )
    rng = np.random.default_rng(6)
    B = 64
    qpos, qvel, _ = near_home_states(tm, rng, B, scale_q=0.05, scale_v=0.2)
    ws = np.zeros((B, tm.nv))
    ctrl = rng.uniform(-10, 10, size=(B, tm.nu))
    args = [torch.as_tensor(a, dtype=torch.float32).contiguous()
            for a in (qpos, qvel, ws, ctrl)]
    nd = tfused.derived_size(tm, spec)
    outs = tuple(torch.empty(B, n) for n in (tm.nq, tm.nv, tm.nv, nd))
    assert lib.launch(1, *args, outs, 0) == 0
    plain32 = tfused.build_fused_step(tm, 1, spec)(*args)
    plain64 = tfused.build_fused_step(tm, 1, spec)(*(a.double() for a in args))
    for name, k, p32, p64 in zip(("qpos", "qvel", "ws", "derived"), outs, plain32, plain64):
        envelope = (p32.double() - p64).abs().max().item()
        scale = p64.abs().max().item()
        err = (k - p32).abs().max().item()
        assert err <= 4 * envelope + 1e-6 * scale, (name, err, envelope, scale)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_crate_plain_substep_matches_jax_graph(crate_models, dtype):
    """All six contact kinds; one batched eager JAX call per dtype."""
    jm, tm = crate_models
    args = _crate_batch(tm, seed=0)
    q, v, w, d = _port(tm, *args, getattr(torch, dtype))
    jq, jv, jw, jd = _jax_substeps(jm, *args, getattr(jnp, dtype))
    if dtype == "float64":
        for got, want in ((q, jq), (v, jv), (d, jd)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
        np.testing.assert_allclose(w, jw, rtol=0, atol=1e-10 * np.abs(jw).max())
        return
    spec = tfused.DerivedSpec(torso_body=TORSO)
    got = tfused.split_derived(tm, spec, torch.as_tensor(d))
    want = tfused.split_derived(tm, spec, torch.as_tensor(jd))
    np.testing.assert_allclose(q, jq, atol=2e-5)
    np.testing.assert_allclose(v, jv, atol=5e-4)
    for key, atol in (("site_xpos", 2e-5), ("torso_xquat", 2e-5),
                      ("torso_cvel", 1e-3), ("qfrc_actuator", 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=atol)


def test_crate_plain_matches_pipeline_step_float64(crate_models):
    """All six kinds against the XLA physics pipeline (dense solves,
    another op order), one vmapped call."""
    jm, tm = crate_models
    qpos, qvel, ws, ctrl = _crate_batch(tm, seed=1, B=12)

    def one(q, v, w, c):
        st = pipeline.PipelineState(
            qpos=q, qvel=v, qacc_warmstart=w, xpos=None, xquat=None, site_xpos=None,
            subtree_com=None, cvel=None, qfrc_actuator=None, efc_force=None,
        )
        r = pipeline.step(jm, st, c, n_substeps=1)
        return r.qpos, r.qvel, r.qacc_warmstart, r.site_xpos, r.cvel[TORSO], r.qfrc_actuator

    ref = [np.asarray(x) for x in jax.jit(jax.vmap(one))(
        *(jnp.asarray(a) for a in (qpos, qvel, ws, ctrl)))]
    q, v, w, d = _port(tm, qpos, qvel, ws, ctrl, torch.float64)
    der = tfused.split_derived(tm, tfused.DerivedSpec(torso_body=TORSO), torch.as_tensor(d))
    np.testing.assert_allclose(q, ref[0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(v, ref[1], rtol=0, atol=1e-9)
    np.testing.assert_allclose(w, ref[2], rtol=1e-9, atol=1e-9)
    for key, r in (("site_xpos", ref[3]), ("torso_cvel", ref[4]), ("qfrc_actuator", ref[5])):
        np.testing.assert_allclose(der[key].numpy(), r, rtol=0, atol=1e-9)


def test_crate_kernel_source_host_build_matches_plain(crate_models, tmp_path):
    """The g++ build of csrc/fused_step.cu on the crate model against the
    plain version, float32, one substep, every kind active: the whole step
    within the envelope of the go2_force test above, and each slot's contact
    geometry (dist, pos, frame) within 1e-6 of the output's scale; the host
    forward kinematics differs from torch's only in the last bits of
    glibc's sin/cos, which the geometry passes on without amplification."""
    _, tm = crate_models
    spec = tfused.DerivedSpec(torso_body=TORSO)
    meta = tfused._meta(tm)
    lib, _, _ = fused_cuda.build_library(tm, meta, spec, host=True, out_dir=tmp_path)
    qpos, qvel, ws, ctrl = _crate_batch(tm, seed=2, B=48)
    args = [torch.as_tensor(a, dtype=torch.float32).contiguous()
            for a in (qpos, qvel, np.zeros_like(ws), ctrl / 2)]
    nd = tfused.derived_size(tm, spec)
    B = qpos.shape[0]
    outs = tuple(torch.empty(B, n) for n in (tm.nq, tm.nv, tm.nv, nd))
    assert lib.launch(1, *args, outs, 0) == 0
    plain32 = tfused.build_fused_step(tm, 1, spec)(*args)
    plain64 = tfused.build_fused_step(tm, 1, spec)(*(a.double() for a in args))
    for name, k, p32, p64 in zip(("qpos", "qvel", "ws", "derived"), outs, plain32, plain64):
        envelope = (p32.double() - p64).abs().max().item()
        scale = p64.abs().max().item()
        err = (k - p32).abs().max().item()
        assert err <= 4 * envelope + 1e-6 * scale, (name, err, envelope, scale)

    got = lib.contacts(args[0], len(meta.contact_slots))
    q = list(args[0].unbind(-1))
    fk = tfused._fk(tm, q)
    kinds = set()
    for si, slot in enumerate(meta.contact_slots):
        dist, pos, frame = tfused._contact_geometry(tm, fk, slot, q[0])
        want = tfused._stack([dist, *pos, *frame[0], *frame[1], *frame[2]], q[0])
        err = (got[:, si] - want).abs().max().item()
        assert err <= 1e-6 * max(1.0, want.abs().max().item()), (slot["kind"], slot["sub"], err)
        if bool((want[:, 0] < slot["includemargin"]).any()):
            kinds.add(slot["kind"])
    assert kinds == set(tm.pairs)
