"""torch port, the fused substep on models with more than 32 dofs, whose dof
masks take a second 32-bit word in the kernel (`FS_NW` words per mask in
csrc/fused_step.cu):

- h1_2_walk (tests/assets/unitree_h1/mjx_scene_h1_2_walk.xml, the H1-2
  joint layout, nv=33): the right hand's contact slot carries dof 32, so
  the slots' dof masks reach the second word whenever that hand touches
  the floor;
- go2_pair_kinds_fused (tests/assets/pairs/mjx_scene_pair_kinds_fused.xml,
  nv=36): the second stick's pattern rows (dofs 33-35) reach bits 30-34 and
  its slots' masks bit 35.

On each: the plain substep against the JAX package's fused graph
(`build_fused_step(..., backend="jax")` in float32, its scalar `_substep`
in float64), and the kernel source's g++ host build against the plain
version, bit for bit over 8 substeps, on inputs where the contacts whose
masks need the second word are active (asserted).  Then the build's limits
(`fused_cuda.kernel_limits`) and the env's choice of physics from them
(`fused_rollout.pick_physics`), without a card.

Tolerances, with their reasons: those of tests/test_torch_h1_fused.py.
- float32 vs the JAX graph: qpos 2e-5, qvel 5e-4, site/quat 2e-5, cvel
  1e-3, qfrc_actuator 1e-4 (tests/test_fused.py's): the same graph in
  float32, whose truncated Newton solve amplifies last-bit differences of
  the two libraries' sin/cos/rsqrt;
- float64 vs the JAX graph: 1e-10 (the warmstart output, the solver's qacc,
  1e-10 of its scale): the same math in the same order;
- the host build against the plain float32 version: bit for bit once the
  plain version calls the host's own sinf, cosf and IEEE sqrt.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import (
    h1_floor_states,
    jax_standin_model,
    pair_kinds_states,
    port_model_from,
    use_host_math,
)
from tpu_dialmpc.dynamics import fused as jfused
from tpu_dialmpc_torch.dynamics import fused as tfused
from tpu_dialmpc_torch.dynamics import fused_cuda
from tpu_dialmpc_torch.dynamics.model import load_scene
from tpu_dialmpc_torch.envs import fused_rollout

TORSO = 1  # "pelvis", "base"
SPEC = tfused.DerivedSpec(torso_body=TORSO)
SCENES = ("h1_2_walk", "go2_pair_kinds_fused")
STATES = {"h1_2_walk": h1_floor_states, "go2_pair_kinds_fused": pair_kinds_states}


@pytest.fixture(scope="module", params=SCENES)
def models(request):
    mp = pytest.MonkeyPatch()
    try:
        jm = jax_standin_model(mp, request.param)
    finally:
        mp.undo()
    return request.param, jm, port_model_from(jm)


def _batch(scene, model, seed, B=12):
    """Inputs where contacts in slots whose dof masks need a second word are
    active (the right hand on the floor; the second stick on the floor)."""
    rng = np.random.default_rng(seed)
    qpos, qvel = STATES[scene](model, rng, B)
    ws = rng.normal(scale=0.5, size=(B, model.nv))
    ctrl = rng.uniform(-20, 20, size=(B, model.nu))
    assert tfused.active_contacts_past(model, torch.as_tensor(qpos), 32) > 0
    return qpos, qvel, ws, ctrl


def test_the_masks_take_a_second_word(models):
    """pack_model takes nv > 32: two words per mask, the second one live
    in the slot masks (both models) and in the pattern rows (nv=36); the
    packed struct is model_bytes long."""
    scene, _, tm = models
    meta = tfused._meta(tm)
    defines, blob, _ = fused_cuda.pack_model(tm, meta, SPEC)
    assert tm.nv > 32 and fused_cuda.mask_words(tm.nv) == 2
    assert fused_cuda.model_bytes(defines) == len(blob)
    assert fused_cuda.kernel_limits(tm, SPEC) == []
    assert any(max(s["dofs"]) >= 32 for s in meta.contact_slots)
    wide_rows = [i for i, anc in enumerate(meta.anc_strict) if any(j >= 32 for j in anc)]
    assert wide_rows == ([33, 34, 35] if scene == "go2_pair_kinds_fused" else [])
    assert fused_cuda._bits([0, 31, 32, 35], 2) == [(1 << 31) | 1, (1 << 3) | 1]


def test_the_port_compiles_the_same_kernel_constants(models):
    """The port's own MJCF compile of the scene (what the envs and
    chip_smoke.py build from) packs to the kernel constants of the JAX
    compile carried over, byte for byte."""
    scene, _, tm = models
    from torch_port_helpers import OWN_SCENES, TIMESTEP

    own = load_scene(str(OWN_SCENES[scene])).with_options(timestep=TIMESTEP)
    for a, b in zip(fused_cuda.pack_model(own, tfused._meta(own), SPEC),
                    fused_cuda.pack_model(tm, tfused._meta(tm), SPEC)):
        assert a == b


def _jax_pallas_graph(jm, qpos, qvel, ws, ctrl):
    """The JAX package's fused step with backend="jax": the Pallas kernel's
    scalar graph run as plain (eager) XLA ops, float32, one substep."""
    fn = jfused.build_fused_step(jm, 1, jfused.DerivedSpec(torso_body=TORSO),
                                 tile=(1, qpos.shape[0]), backend="jax")
    out = fn(*(jnp.asarray(a) for a in (qpos, qvel, ws, ctrl)))
    return [np.asarray(x, np.float64) for x in out]


def _jax_substep64(jm, qpos, qvel, ws, ctrl):
    """The same scalar graph (`_substep`) in float64, eagerly."""
    meta = jfused._meta(jm)

    def cols(a):
        return [jnp.asarray(a[:, i], jnp.float64) for i in range(a.shape[1])]

    out = jfused._substep(jm, meta, jfused.DerivedSpec(torso_body=TORSO),
                          cols(qpos), cols(qvel), cols(ws), cols(ctrl))
    B = qpos.shape[0]
    return [np.stack([np.broadcast_to(np.asarray(x, np.float64), (B,)) for x in xs], -1)
            for xs in out]


def _port(tm, args, dtype, n_substeps=1):
    fn = tfused.build_fused_step(tm, n_substeps, SPEC)
    return [o.double().numpy() for o in fn(*(torch.as_tensor(a, dtype=dtype) for a in args))]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_wide_plain_substep_matches_jax_graph(models, dtype):
    scene, jm, tm = models
    args = _batch(scene, tm, seed=0)
    q, v, w, d = _port(tm, args, getattr(torch, dtype))
    if dtype == "float64":
        jq, jv, jw, jd = _jax_substep64(jm, *args)
        for got, want in ((q, jq), (v, jv), (d, jd)):
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
        np.testing.assert_allclose(w, jw, rtol=0, atol=1e-10 * np.abs(jw).max())
        return
    jq, jv, _, jd = _jax_pallas_graph(jm, *(a.astype(np.float32) for a in args))
    got = tfused.split_derived(tm, SPEC, torch.as_tensor(d))
    want = tfused.split_derived(tm, SPEC, torch.as_tensor(jd))
    np.testing.assert_allclose(q, jq, atol=2e-5)
    np.testing.assert_allclose(v, jv, atol=5e-4)
    for key, atol in (("site_xpos", 2e-5), ("torso_xquat", 2e-5),
                      ("torso_cvel", 1e-3), ("qfrc_actuator", 1e-4)):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=atol)


@pytest.fixture(scope="module")
def host_build(models, tmp_path_factory):
    _, _, tm = models
    lib, _, _ = fused_cuda.build_library(
        tm, tfused._meta(tm), SPEC, host=True, out_dir=tmp_path_factory.mktemp("wide_host"))
    return lib


def test_wide_host_build_reports_the_struct_sizes(models, host_build):
    """The host build's sizeof(Work) and samples per block are the ones
    work_bytes and launch_config compute with two mask words."""
    _, _, tm = models
    defines = fused_cuda.pack_model(tm, tfused._meta(tm), SPEC)[0]
    info = host_build.launch_info()
    assert (info["bytes_per_sample"], info["samples_per_block"]) == \
        fused_cuda.launch_config(defines)


def test_wide_kernel_source_host_build_bit_equal_to_plain(models, host_build, monkeypatch):
    """8 substeps, the host build against the plain float32 version with the
    host's sin, cos and sqrt: equal to the bit, on inputs where contacts
    whose slots carry dof 32 or past it are active."""
    scene, _, tm = models
    use_host_math(monkeypatch)
    qpos, qvel, _, ctrl = _batch(scene, tm, seed=3)
    args = [torch.as_tensor(a, dtype=torch.float32).contiguous()
            for a in (qpos, qvel, np.zeros_like(qvel), ctrl / 2)]
    B = qpos.shape[0]
    outs = tuple(torch.empty(B, n) for n in (tm.nq, tm.nv, tm.nv, tfused.derived_size(tm, SPEC)))
    assert host_build.launch(8, *args, outs, 0) == 0
    plain = tfused.build_fused_step(tm, 8, SPEC)(*args)
    for name, k, p in zip(("qpos", "qvel", "ws", "derived"), outs, plain):
        assert bool(torch.isfinite(k).all()), name
        assert torch.equal(k, p), (name, (k - p).abs().max().item())


# ---- the build's limits, checked once when an env is built ----

def _defines(scene="h1_2_walk"):
    from torch_port_helpers import OWN_SCENES

    m = load_scene(str(OWN_SCENES[scene]))
    return m, fused_cuda.kernel_sizes(m, tfused._meta(m), SPEC)[0]


BREAKS = {
    "work": (dict(FS_NCROW=3000, FS_NJ=60000), "working set (Work)"),
    "constant": (dict(FS_NGEOM=1200), "__constant__"),
    "slots": (dict(FS_NSLOT=256), "256 contact slots"),
    "dofs": (dict(FS_NV=256), "256 dofs"),
    "slot_dofs": (dict(FS_MAXD=300), "300 dofs in one contact slot"),
    "rows": (dict(FS_NFL=40000, FS_NLIM=30000), "constraint rows"),
    "row_rounds": (dict(FS_NCROW=1000), "in registers"),
    "jl": (dict(FS_NJ=70000), "Jacobian values"),
}


@pytest.mark.parametrize("limit", sorted(BREAKS))
def test_kernel_limits_name_each_limit(limit):
    """Sizes past one limit name that limit; the 33-dof model's name none."""
    _, defines = _defines()
    assert fused_cuda.limits_of(defines) == []
    change, words = BREAKS[limit]
    found = fused_cuda.limits_of(dict(defines, **change))
    assert len(found) >= 1 and any(words in f for f in found), found
    if limit in ("slots", "slot_dofs", "row_rounds"):  # nothing else moved past a limit
        assert len(found) == 1, found


@pytest.mark.parametrize("scene", ["go2_force", "go2_force_crate", "go2_position", "h1_walk",
                                   "h1_loco", "h1_push_crate", "h1_2_walk",
                                   "go2_pair_kinds_fused"])
def test_every_kernel_model_is_inside_the_limits(scene):
    """Every model the kernel runs: no limit, and model_bytes is the packed
    FusedModel's length (what the limit on the __constant__ bank reads)."""
    from torch_port_helpers import OWN_SCENES

    m = load_scene(str(OWN_SCENES.get(scene, scene)))
    defines, blob, _ = fused_cuda.pack_model(m, tfused._meta(m), SPEC)
    assert fused_cuda.model_bytes(defines) == len(blob)
    assert fused_cuda.kernel_limits(m, SPEC) == []


def test_pick_physics_checks_the_limits_at_build_on_a_cuda_device(monkeypatch):
    """With the __constant__ bank made smaller than the 33-dof model, on a
    CUDA device: "on" raises at build, naming the limit; "auto" warns,
    naming it, and picks the pipeline; "off" is the pipeline.  On the CPU
    the plain version has no limits: "on" and "auto" keep the fused
    substep."""
    m, _ = _defines()
    cuda = torch.device("cuda", 0)  # no card needed: nothing is allocated
    assert fused_rollout.pick_physics(m, "on", cuda, SPEC)
    monkeypatch.setattr(fused_cuda, "CONSTANT_BYTES", 4096)
    with pytest.raises(ValueError, match="__constant__"):
        fused_rollout.pick_physics(m, "on", cuda, SPEC)
    with pytest.warns(UserWarning, match="__constant__"):
        assert fused_rollout.pick_physics(m, "auto", cuda, SPEC) is False
    assert fused_rollout.pick_physics(m, "off", cuda, SPEC) is False
    for mode in ("on", "auto"):
        assert fused_rollout.pick_physics(m, mode, "cpu", SPEC) is True


def test_an_env_past_a_limit_is_built_on_its_choice(monkeypatch):
    """The env makes the choice once, when it is built, with its own device
    and reward inputs: a CPU env past a (patched) limit keeps the fused
    substep; the same choice on a CUDA device is the pipeline, and no
    kernel is built for it."""
    from torch_port_helpers import OWN_SCENES

    from tpu_dialmpc_torch.envs import get_env
    from tpu_dialmpc_torch.envs import h1 as th1

    monkeypatch.setattr(fused_cuda, "CONSTANT_BYTES", 4096)
    env = get_env("h1_walk", device="cpu", scene=str(OWN_SCENES["h1_2_walk"]), fused="on")
    assert env.on_fused_path and env.model.nv == 33
    seen = []

    def on_a_card(m, mode, device, spec):
        seen.append((mode, spec))
        return fused_rollout.pick_physics(m, mode, torch.device("cuda", 0), spec)

    monkeypatch.setattr(th1, "pick_physics", on_a_card)
    with pytest.warns(UserWarning, match="__constant__"):
        env = get_env("h1_walk", device="cpu", scene=str(OWN_SCENES["h1_2_walk"]))
    assert not env.on_fused_path and env._fused_step is None
    assert seen == [("auto", env._fused_spec())] and seen[0][1].want_sites
