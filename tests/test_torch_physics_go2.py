"""torch port, the physics pipeline against the JAX package's, stage by stage
in float64 (tests/torch_physics_cases.py), on the Go2 stand-ins go2_force
(plane-sphere) and go2_position (the servos' affine-bias actuation); and the
unrolled Cholesky's clamped pivot."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_physics_cases import *  # noqa: F401,F403 -- the cases, run on this file's scenes
from torch_physics_cases import STAGE_TOL, close
from tpu_dialmpc.dynamics import linalg as jlinalg
from tpu_dialmpc_torch.dynamics import linalg


@pytest.fixture(scope="module", params=["go2_force", "go2_position"])
def scene(request):
    return request.param


def test_solve_psd_clamps_a_pivot_as_jax_does():
    """A matrix whose second pivot is negative: the factor clamps it to
    1e-30 as the JAX factor does, where a library Cholesky reports failure
    (`info`)."""
    a = np.array([[[4.0, 2.0, 0.4], [2.0, 0.5, 0.3], [0.4, 0.3, 2.0]],
                  [[2.0, 0.1, 0.0], [0.1, 3.0, 0.2], [0.0, 0.2, 1.5]]])
    b = np.array([[1.0, -2.0, 0.5], [0.3, 0.2, -0.1]])
    L = linalg.chol_factor(torch.as_tensor(a))
    close(L, jax.vmap(jlinalg.chol_factor)(jnp.asarray(a)), STAGE_TOL, "L")
    # the pivot 0.5 - 1 = -0.5, clamped: L[1, 1] = -0.5 / sqrt(1e-30)
    assert float(L[0, 1, 1]) == -0.5 / 1e-15
    assert int(torch.linalg.cholesky_ex(torch.as_tensor(a))[1][0]) > 0
    want = jax.vmap(jlinalg.solve_psd)(jnp.asarray(a), jnp.asarray(b))
    got = linalg.solve_psd(torch.as_tensor(a), torch.as_tensor(b))
    assert np.isfinite(got.numpy()).all()
    close(got, want, STAGE_TOL, "x")
