"""torch port, core/: spline matrices and quaternion ops against the JAX
package on the same numpy inputs, in float64.

Tolerance 1e-12: the same formulas in float64 on both sides; the only
differences are the last bits of transcendental functions and summation
order inside a library reduction.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_dialmpc.core import rotations as jrot
from tpu_dialmpc.core import spline as jspline
from tpu_dialmpc_torch.core import rotations as trot
from tpu_dialmpc_torch.core import spline as tspline

TOL = 1e-12


@pytest.mark.parametrize("fn", ["node2u_matrix", "u2node_matrix", "shift_matrix"])
@pytest.mark.parametrize("mode", ["ref", "natural", "linear"])
@pytest.mark.parametrize("hnode,hsample", [(5, 20), (2, 4), (8, 32)])
def test_spline_matrices_match_jax(fn, mode, hnode, hsample):
    want = getattr(jspline, fn)(hnode, hsample, 0.02, mode)
    got = getattr(tspline, fn)(hnode, hsample, 0.02, mode)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def _quats(n, seed):
    q = np.random.default_rng(seed).standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _vecs(n, seed):
    return np.random.default_rng(seed).standard_normal((n, 3))


_OPS = {
    "quat_mul": lambda m: m.quat_mul(*_args(m, _quats(64, 0), _quats(64, 1))),
    "quat_inv": lambda m: m.quat_inv(*_args(m, _quats(64, 2))),
    "rotate": lambda m: m.rotate(*_args(m, _vecs(64, 3), _quats(64, 4))),
    "inv_rotate": lambda m: m.inv_rotate(*_args(m, _vecs(64, 5), _quats(64, 6))),
    "global_to_body_velocity": lambda m: m.global_to_body_velocity(
        *_args(m, _vecs(64, 7), _quats(64, 8))
    ),
    "local_to_global_velocity": lambda m: m.local_to_global_velocity(
        *_args(m, _vecs(64, 9), _quats(64, 10))
    ),
    "quat_to_mat": lambda m: m.quat_to_mat(*_args(m, _quats(64, 11))),
    "normalize_quat": lambda m: m.normalize_quat(*_args(m, 3.0 * _quats(64, 12))),
    "quat_to_yaw": lambda m: m.quat_to_yaw(*_args(m, _quats(64, 13))),
    "quat_to_yaw_eigen": lambda m: m.quat_to_yaw_eigen(*_args(m, _quats(64, 14))),
    # includes angular velocities small enough for the small-angle branch
    "quat_integrate": lambda m: m.quat_integrate(
        *_args(m, _quats(64, 15), _vecs(64, 16) * np.logspace(-12, 1, 64)[:, None]),
        0.0025,
    ),
}


def _args(module, *arrays):
    if module is jrot:
        return [jnp.asarray(a) for a in arrays]
    return [torch.as_tensor(a) for a in arrays]


@pytest.mark.parametrize("op", sorted(_OPS))
def test_rotations_match_jax(op):
    want = np.asarray(_OPS[op](jrot))
    got = _OPS[op](trot)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_rotate_broadcasts_one_vector_over_a_batch():
    q = _quats(8, 17)
    up = np.array([0.0, 0.0, 1.0])
    got = trot.rotate(torch.as_tensor(up), torch.as_tensor(q)).numpy()
    want = np.asarray(jrot.rotate(jnp.asarray(up), jnp.asarray(q)))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
