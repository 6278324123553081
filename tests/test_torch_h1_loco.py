"""torch port, h1_loco (the arms-fixed H1: 11 motors, nq 18): one
`reverse_once` of the planner from the standing start, with injected noise,
against the JAX package's CPU path (XLA physics pipeline under
vmap(scan(env.step))), in float64, at a small size: Nsample=8, Hsample=4,
Hnode=2, n_substeps=2 (its step and reset: test_torch_h1_tasks.py).

Tolerances, those of test_torch_h1_slice.py: rewards 1e-9 (physics in
another factorization order), planner outputs 1e-7 (the softmax divides
reward gaps by std·temp_sample, which scales the physics rounding up).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import ASSETS
from tpu_dialmpc.envs import get_env as jget_env
from tpu_dialmpc.planner import dial as jdial
from tpu_dialmpc_torch.envs import dial_defaults, get_env
from tpu_dialmpc_torch.planner import dial as tdial

SIZE = dict(Nsample=8, Hsample=4, Hnode=2)
N_SUB = 2


def _close(got, want, atol):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
        rtol=0, atol=atol,
    )


def test_h1_loco_reverse_once_matches_jax():
    """One reverse_once of the arms-fixed robot from its standing start,
    with injected noise."""
    t = "h1_loco"
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_DIALMPC_ASSETS", str(ASSETS))
    try:
        jenv = jget_env(t, n_substeps=N_SUB, dtype="float64")
    finally:
        mp.undo()
    tenv = get_env(t, device="cpu", n_substeps=N_SUB, dtype="float64")
    kw = dict(dial_defaults(t), **SIZE)
    jmb = jdial.MBDPI(jdial.DialConfig(**kw), jenv)
    tmb = tdial.MBDPI(tdial.DialConfig(**kw), tenv)
    nu = tenv.action_size
    rng = np.random.default_rng(2)
    Y = rng.uniform(-0.3, 0.3, size=(SIZE["Hnode"] + 1, nu))
    noise = rng.normal(size=(SIZE["Nsample"], SIZE["Hnode"] + 1, nu))
    scale = tmb.sigma_control
    jY, jinfo = jax.jit(lambda s, Y, sc, n: jmb.reverse_once(s, None, Y, sc, noise=n))(
        jenv.reset(jax.random.PRNGKey(0)), jnp.asarray(Y), jnp.asarray(scale), jnp.asarray(noise))
    tY, tinfo = tmb.reverse_once(tenv.reset(), None, torch.as_tensor(Y), torch.as_tensor(scale),
                                 noise=torch.as_tensor(noise))
    _close(tinfo.rews, jinfo.rews, 1e-9)
    _close(tinfo.rew_Ybar, jinfo.rew_Ybar, 1e-9)
    _close(tinfo.weights, jinfo.weights, 1e-7)
    _close(tY, jY, 1e-7)
