"""torch port, the fused substep on the H1 push-crate stand-in: the plain
substep chain against the JAX package's fused scalar graph and its XLA
pipeline, and the kernel source's arithmetic through its host (g++) build,
on batches where every contact kind is active and so are slots whose rows
couple the robot's and the crate's kinematic trees (asserted).

Tolerances, with their reasons:
- float32 vs the eager JAX `fused._substep`: those of tests/test_fused.py
  (qpos 2e-5, qvel 5e-4, site/quat 2e-5, cvel 1e-3, qfrc_actuator 1e-4):
  the same graph in float32, whose truncated Newton solve amplifies
  last-bit differences of the two libraries' sin/cos/rsqrt.
- float64 vs the JAX graph: 1e-10 (the warmstart output, the solver's qacc
  of up to ~1e3 in hard contact, 1e-10 of its scale): the same math in the
  same order.
- float64 vs `pipeline.step`: 1e-9: the same math in another factorization
  order (dense solves).
- the host build against the plain float32 version: bit for bit once the
  plain version calls the host's own sinf, cosf and IEEE sqrt (the kernel's
  op order and rounding are the plain version's); with torch's own
  functions, within the envelope of test_torch_fused.py's host-build test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import h1_crate_states, jax_standin_model, port_model_from, use_host_math
from tpu_dialmpc.dynamics import fused as jfused
from tpu_dialmpc.dynamics import pipeline
from tpu_dialmpc_torch.dynamics import fused as tfused
from tpu_dialmpc_torch.dynamics import fused_cuda

TORSO = 1  # "pelvis"
SPEC = tfused.DerivedSpec(torso_body=TORSO)


@pytest.fixture(scope="module")
def models():
    mp = pytest.MonkeyPatch()
    try:
        jm = jax_standin_model(mp, "h1_push_crate")
    finally:
        mp.undo()
    return jm, port_model_from(jm)


def _batch(model, seed, B=20):
    """H1 push-crate inputs: every kind active, and cross-tree slots."""
    rng = np.random.default_rng(seed)
    qpos, qvel = h1_crate_states(model, rng, B)
    ws = rng.normal(scale=0.5, size=(B, model.nv))
    ctrl = rng.uniform(-20, 20, size=(B, model.nu))
    q = torch.as_tensor(qpos)
    active = tfused.active_contacts(model, q)
    assert len(active) == 6 and all(n > 0 for n in active.values()), active
    assert tfused.active_two_tree_contacts(model, q) > 0
    return qpos, qvel, ws, ctrl


def _jax_substeps(jm, qpos, qvel, ws, ctrl, dtype):
    """One substep of the JAX fused scalar graph, eagerly, on (B,) scalars."""
    meta = jfused._meta(jm)

    def cols(a):
        return [jnp.asarray(a[:, i], dtype) for i in range(a.shape[1])]

    q, v, w, der = jfused._substep(jm, meta, jfused.DerivedSpec(torso_body=TORSO),
                                   cols(qpos), cols(qvel), cols(ws), cols(ctrl))
    B = qpos.shape[0]
    return [
        np.stack([np.broadcast_to(np.asarray(x, np.float64), (B,)) for x in xs], -1)
        for xs in (q, v, w, der)
    ]


def _port(tm, args, dtype, n_substeps=1):
    fn = tfused.build_fused_step(tm, n_substeps, SPEC)
    out = fn(*(torch.as_tensor(a, dtype=dtype) for a in args))
    return [o.double().numpy() for o in out]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_h1_plain_substep_matches_jax_graph(models, dtype):
    """One batched eager JAX call per dtype."""
    jm, tm = models
    args = _batch(tm, seed=0)
    q, v, w, d = _port(tm, args, getattr(torch, dtype))
    jq, jv, jw, jd = _jax_substeps(jm, *args, getattr(jnp, dtype))
    if dtype == "float64":
        for got, want in ((q, jq), (v, jv), (d, jd)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
        np.testing.assert_allclose(w, jw, rtol=0, atol=1e-10 * np.abs(jw).max())
        return
    got = tfused.split_derived(tm, SPEC, torch.as_tensor(d))
    want = tfused.split_derived(tm, SPEC, torch.as_tensor(jd))
    np.testing.assert_allclose(q, jq, atol=2e-5)
    np.testing.assert_allclose(v, jv, atol=5e-4)
    for key, atol in (("site_xpos", 2e-5), ("torso_xquat", 2e-5),
                      ("torso_cvel", 1e-3), ("qfrc_actuator", 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=atol)


def test_h1_plain_matches_pipeline_step_float64(models):
    """Against the XLA physics pipeline (dense solves, another op order),
    one vmapped call."""
    jm, tm = models
    qpos, qvel, ws, ctrl = _batch(tm, seed=1, B=10)

    def one(q, v, w, c):
        st = pipeline.PipelineState(
            qpos=q, qvel=v, qacc_warmstart=w, xpos=None, xquat=None, site_xpos=None,
            subtree_com=None, cvel=None, qfrc_actuator=None, efc_force=None,
        )
        r = pipeline.step(jm, st, c, n_substeps=1)
        return r.qpos, r.qvel, r.qacc_warmstart, r.site_xpos, r.cvel[TORSO], r.qfrc_actuator

    ref = [np.asarray(x) for x in jax.jit(jax.vmap(one))(
        *(jnp.asarray(a) for a in (qpos, qvel, ws, ctrl)))]
    q, v, w, d = _port(tm, (qpos, qvel, ws, ctrl), torch.float64)
    der = tfused.split_derived(tm, SPEC, torch.as_tensor(d))
    np.testing.assert_allclose(q, ref[0], rtol=0, atol=1e-9)
    np.testing.assert_allclose(v, ref[1], rtol=0, atol=1e-9)
    np.testing.assert_allclose(w, ref[2], rtol=1e-9, atol=1e-9)
    for key, r in (("site_xpos", ref[3]), ("torso_cvel", ref[4]), ("qfrc_actuator", ref[5])):
        np.testing.assert_allclose(der[key].numpy(), r, rtol=0, atol=1e-9)


@pytest.fixture(scope="module")
def host_build(models, tmp_path_factory):
    _, tm = models
    lib, _, _ = fused_cuda.build_library(
        tm, tfused._meta(tm), SPEC, host=True, out_dir=tmp_path_factory.mktemp("h1_host")
    )
    return lib


def _host_inputs(tm, seed):
    qpos, qvel, _, ctrl = _batch(tm, seed=seed)
    return [torch.as_tensor(a, dtype=torch.float32).contiguous()
            for a in (qpos, qvel, np.zeros_like(qvel), ctrl / 2)]


def _host_step(lib, tm, args, n_substeps):
    B = args[0].shape[0]
    outs = tuple(torch.empty(B, n) for n in (tm.nq, tm.nv, tm.nv, tfused.derived_size(tm, SPEC)))
    assert lib.launch(n_substeps, *args, outs, 0) == 0
    return outs


def test_h1_kernel_source_host_build_matches_plain(models, host_build):
    """The whole step, and every slot's contact geometry (`fused_contacts`),
    kind by kind, within the envelope of test_torch_fused.py's host-build
    test: 4x the plain version's own float32 error plus 1e-6 of scale."""
    _, tm = models
    args = _host_inputs(tm, seed=2)
    outs = _host_step(host_build, tm, args, 1)
    plain32 = tfused.build_fused_step(tm, 1, SPEC)(*args)
    plain64 = tfused.build_fused_step(tm, 1, SPEC)(*(a.double() for a in args))
    for name, k, p32, p64 in zip(("qpos", "qvel", "ws", "derived"), outs, plain32, plain64):
        envelope = (p32.double() - p64).abs().max().item()
        scale = p64.abs().max().item()
        err = (k - p32).abs().max().item()
        assert err <= 4 * envelope + 1e-6 * scale, (name, err, envelope, scale)

    meta = tfused._meta(tm)
    got = host_build.contacts(args[0], len(meta.contact_slots))

    def geometry(qpos):
        q = list(qpos.unbind(-1))
        fk = tfused._fk(tm, q)
        for slot in meta.contact_slots:
            dist, pos, frame = tfused._contact_geometry(tm, fk, slot, q[0])
            yield tfused._stack([dist, *pos, *frame[0], *frame[1], *frame[2]], q[0])

    kinds = set()
    for si, (slot, w32, w64) in enumerate(zip(
            meta.contact_slots, geometry(args[0]), geometry(args[0].double()))):
        # near a box's edge the normal divides a small offset by its length,
        # which scales rounding up in either build alike: hence the envelope
        envelope = (w32.double() - w64).abs().max().item()
        err = (got[:, si] - w32).abs().max().item()
        assert err <= 4 * envelope + 1e-6 * max(1.0, w64.abs().max().item()), (
            slot["kind"], slot["sub"], err, envelope)
        if bool((w32[:, 0] < slot["includemargin"]).any()):
            kinds.add(slot["kind"])
    assert kinds == set(tm.pairs)


def _joint_limit_inputs(tm):
    """Inputs where every contact kind, slots across the two trees and four
    joint-limit rows a sample are active (both hip yaws and shoulder rolls a
    little past a limit), and the Newton solve's second iteration moves
    every sample."""
    qpos, qvel, ws, ctrl = _batch(tm, seed=4)
    qpos[:, [7, 12, 19, 23]] = (-0.44, 0.44, -0.35, 0.35)
    args = [torch.as_tensor(a, dtype=torch.float32).contiguous()
            for a in (qpos, qvel, ws, ctrl / 2)]
    q = args[0].double()
    limits = sum((r["sign"] * (q[:, r["qadr"]] - r["bound"]) < r["margin"]).int()
                 for r in tfused._meta(tm).limit_rows)
    assert bool((limits == 4).all()), limits
    active = tfused.active_contacts(tm, args[0])
    assert len(active) == 6 and all(n > 0 for n in active.values()), active
    assert tfused.active_two_tree_contacts(tm, args[0]) > 0
    assert tm.iterations == 2
    one = tfused.build_fused_step(tm.with_options(iterations=1), 1, SPEC)(*args)
    two = tfused.build_fused_step(tm, 1, SPEC)(*args)
    assert bool((one[1] != two[1]).any(1).all())
    return args


@pytest.mark.parametrize("inputs", ["crate", "joint_limits"])
def test_h1_kernel_source_host_build_bit_equal_to_plain(models, host_build, monkeypatch, inputs):
    """8 substeps: the host build equals the plain float32 version to the
    bit once the plain version's sin, cos and sqrt are the host's (glibc's
    sinf/cosf, IEEE sqrt; torch's CPU kernels round a few inputs in 1e3
    differently).  On the card both sides use the same CUDA math library,
    which is why the kernel equals the plain version there.  On the inputs
    at the joint limits every row kind and a second Newton iteration run, so
    the kernel's arrays that share bytes (Work's unions) are each read only
    in their own phase of a substep, or these outputs would differ."""
    _, tm = models
    use_host_math(monkeypatch)
    args = _host_inputs(tm, seed=3) if inputs == "crate" else _joint_limit_inputs(tm)
    outs = _host_step(host_build, tm, args, 8)
    plain = tfused.build_fused_step(tm, 8, SPEC)(*args)
    for name, k, p in zip(("qpos", "qvel", "ws", "derived"), outs, plain):
        assert bool(torch.isfinite(k).all()), name
        assert torch.equal(k, p), (name, (k - p).abs().max().item())
