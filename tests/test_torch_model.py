"""torch port, dynamics/model.py + fused._meta: the committed stand-in model
files, the crate tasks' patched models and the port's static metadata
against the JAX package.

Exact comparisons: both sides hold the same numpy values."""

import dataclasses

import pytest

from torch_port_helpers import (
    PORT_NPZ,
    assert_same as _assert_same,
    assert_same_model,
    jax_standin_model,
    port_model_from,
    standin_joint_names,
    use_standin_assets,
)
from tpu_dialmpc.dynamics import collision as jcollision
from tpu_dialmpc.dynamics import fused as jfused
from tpu_dialmpc_torch.dynamics import collision as tcollision
from tpu_dialmpc_torch.dynamics import fused as tfused
from tpu_dialmpc_torch.dynamics.model import load_model


@pytest.fixture
def jax_model(monkeypatch):
    return jax_standin_model(monkeypatch)


PLANE_KINDS = [(0, 2), (0, 3), (0, 6)]  # plane-sphere, plane-capsule, plane-box
SCENES = {  # scene: (nq, nv, nu), contact pair kinds, servos (affine bias) or motors
    "go2_force": ((19, 18, 12), [(0, 2)], False),
    "go2_force_crate": ((19, 18, 12), PLANE_KINDS + [(2, 6), (3, 6), (6, 6)], False),
    "go2_position": ((19, 18, 12), [(0, 2)], True),
    "h1_walk": ((26, 25, 19), PLANE_KINDS, False),
    "h1_loco": ((18, 17, 11), PLANE_KINDS, False),
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_committed_npz_equals_fresh_compile(monkeypatch, scene):
    """Each committed Go2/H1 model file equals a fresh compile of its
    stand-in, with the joint names, and the port's static metadata equals
    the JAX package's."""
    jm = jax_standin_model(monkeypatch, scene)
    port = load_model(str(PORT_NPZ.with_name(f"{scene}.npz")))
    assert_same_model(port, jm)
    assert port.jnt_names == standin_joint_names(monkeypatch, scene)
    widths, kinds, servos = SCENES[scene]
    assert (port.nq, port.nv, port.nu) == widths and sorted(port.pairs) == kinds
    assert tfused.supported(port) and jfused.supported(jm)
    for field in ("anc_strict", "m_keys", "anc_solver", "contact_slots", "limit_rows",
                  "floss_rows"):
        assert getattr(tfused._meta(port), field) == getattr(jfused._meta(jm), field), field
    if servos:
        # the servos' affine bias kp (ctrl - q) - kv qdot, clamped in ctrl and force
        assert port.actuator_biasprm.tolist() == [[0.0, -30.0, -0.65]] * 12
        assert port.actuator_gainprm.tolist() == [30.0] * 12
        assert port.actuator_ctrllimited.all() and port.actuator_forcelimited.all()
    else:
        assert not port.actuator_biasprm.any()


@pytest.mark.parametrize("task", ["go2_crate", "go2_crate_climb", "go2_jump"])
def test_crate_task_model_equals_jax_compile(monkeypatch, task):
    """The port moves the crate in the compiled model (crate_top_z: 0.30 for
    go2_crate_climb, crate_x: 30 for go2_jump); the JAX env moves it in the
    MjModel and compiles.  The two models are equal field by field.  The
    port's env loads the shipped model file here (TPU_DIALMPC_ASSETS unset):
    with the variable set it compiles the XML itself, which
    test_torch_mjcf.py holds to the JAX compile to 1e-12."""
    from tpu_dialmpc.envs import get_env as jget_env
    from tpu_dialmpc_torch.envs import get_env

    use_standin_assets(monkeypatch)
    jenv = jget_env(task)
    monkeypatch.delenv("TPU_DIALMPC_ASSETS")
    tenv = get_env(task, device="cpu")
    assert_same_model(tenv.model, jenv.model)
    assert tenv._crate == jenv._crate
    crate = tenv.model.body_names.index("box_body")
    assert tuple(tenv.model.body_pos[crate]) == {
        "go2_crate": (1.3, 0.0, 0.3), "go2_crate_climb": (1.3, 0.0, 0.0),
        "go2_jump": (30.0, 0.0, 0.3)}[task]


def test_from_numpy_fields_equals_load_model(jax_model):
    """Equal but for the joint names, which only the model file carries."""
    loaded = load_model(str(PORT_NPZ))
    assert loaded.jnt_names and port_model_from(jax_model).jnt_names == ()
    _assert_same(port_model_from(jax_model), dataclasses.replace(loaded, jnt_names=()), "model")


def test_standin_has_the_go2_widths(jax_model):
    m = jax_model
    assert (m.nq, m.nv, m.nu) == (19, 18, 12)
    assert list(m.pairs) == [(0, 2)]  # plane-sphere only
    assert m.pairs[(0, 2)].geom1.shape == (4,)
    assert jfused.supported(m) and tfused.supported(port_model_from(m))
    assert "home" in m.key_qpos and "base" in m.body_names
    for s in ("FL_foot", "FR_foot", "RL_foot", "RR_foot"):
        assert s in m.site_names


def test_contact_params_match(jax_model):
    _assert_same(
        tcollision.contact_params(port_model_from(jax_model))._asdict(),
        jcollision.contact_params(jax_model)._asdict(),
        "contact_params",
    )


@pytest.mark.parametrize(
    "field",
    ["anc_strict", "m_keys", "anc_solver", "contact_slots", "limit_rows", "floss_rows"],
)
def test_meta_matches(jax_model, field):
    want = getattr(jfused._meta(jax_model), field)
    got = getattr(tfused._meta(port_model_from(jax_model)), field)
    assert got == want
