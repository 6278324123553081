"""torch port, dynamics/model.py + fused._meta: the committed stand-in model
file and the port's static metadata against the JAX package.

Exact comparisons: both sides hold the same numpy values."""

import dataclasses

import numpy as np
import pytest

from torch_port_helpers import PORT_NPZ, jax_standin_model, port_model_from
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
