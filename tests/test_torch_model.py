"""torch port, dynamics/model.py + fused._meta: the committed stand-in model
files, the crate tasks' patched models and the port's static metadata
against the JAX package.

Exact comparisons: both sides hold the same numpy values."""

import dataclasses

import numpy as np
import pytest

from torch_port_helpers import (
    CRATE_NPZ,
    PORT_NPZ,
    jax_standin_model,
    port_model_from,
    use_standin_assets,
)
from tpu_dialmpc.dynamics import collision as jcollision
from tpu_dialmpc.dynamics import fused as jfused
from tpu_dialmpc_torch.dynamics import collision as tcollision
from tpu_dialmpc_torch.dynamics import fused as tfused
from tpu_dialmpc_torch.dynamics.model import PhysicsModel, load_model


def _assert_same(a, b, where):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k}]")
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    else:
        assert a == b, where


@pytest.fixture
def jax_model(monkeypatch):
    return jax_standin_model(monkeypatch)


def test_committed_npz_equals_fresh_compile(jax_model):
    port = load_model(str(PORT_NPZ))
    for f in dataclasses.fields(PhysicsModel):
        _assert_same(getattr(port, f.name), getattr(jax_model, f.name), f.name)


def test_committed_crate_npz_equals_fresh_compile(monkeypatch):
    jax_crate = jax_standin_model(monkeypatch, "go2_force_crate")
    port = load_model(str(CRATE_NPZ))
    for f in dataclasses.fields(PhysicsModel):
        _assert_same(getattr(port, f.name), getattr(jax_crate, f.name), f.name)


@pytest.mark.parametrize("task", ["go2_crate", "go2_crate_climb", "go2_jump"])
def test_crate_task_model_equals_jax_compile(monkeypatch, task):
    """The port moves the crate in the compiled model (crate_top_z: 0.30 for
    go2_crate_climb, crate_x: 30 for go2_jump); the JAX env moves it in the
    MjModel and compiles.  The two models are equal field by field."""
    from tpu_dialmpc.envs import get_env as jget_env
    from tpu_dialmpc_torch.envs import get_env

    use_standin_assets(monkeypatch)
    jenv, tenv = jget_env(task), get_env(task)
    for f in dataclasses.fields(PhysicsModel):
        _assert_same(getattr(tenv.model, f.name), getattr(jenv.model, f.name), f.name)
    assert tenv._crate == jenv._crate
    crate = tenv.model.body_names.index("box_body")
    assert tuple(tenv.model.body_pos[crate]) == {
        "go2_crate": (1.3, 0.0, 0.3), "go2_crate_climb": (1.3, 0.0, 0.0),
        "go2_jump": (30.0, 0.0, 0.3)}[task]


def test_from_numpy_fields_equals_load_model(jax_model):
    _assert_same(port_model_from(jax_model), load_model(str(PORT_NPZ)), "model")


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
