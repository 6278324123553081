"""torch port, reference quirk Q1 (`DialConfig.compat_q1`): the candidates'
rollouts chained one after another through `env.step` (the physics
pipeline), against the JAX package's `reverse_once_compat` in float64 at a
tiny width (Nsample=3, Hsample=2, Hnode=1, one substep per step), under
injected noise.  The path is sequential over candidates by design: a parity
fixture, not for production.

Tolerances as tests/test_torch_slice.py's: physics and rewards 1e-9,
planner outputs 1e-7."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_port_helpers import ASSETS
from tpu_dialmpc.envs import get_env as jget_env
from tpu_dialmpc.planner import dial as jdial
from tpu_dialmpc_torch.envs import dial_defaults, get_env
from tpu_dialmpc_torch.planner import dial as tdial

SIZE = dict(Nsample=3, Hsample=2, Hnode=1, compat_q1=True)


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, dtype=np.float64),
                               np.asarray(want, dtype=np.float64), rtol=0, atol=atol)


@pytest.fixture(scope="module")
def compat():
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_DIALMPC_ASSETS", str(ASSETS))
    try:
        jenv = jget_env("go2_stand", n_substeps=1, dtype="float64")
    finally:
        mp.undo()
    kw = dict(dial_defaults("go2_stand"), **SIZE)
    jmb = jdial.MBDPI(jdial.DialConfig(**kw), jenv)
    tenv = get_env("go2_stand", device="cpu", n_substeps=1, dtype="float64")
    return dict(
        jmb=jmb, tmb=tdial.MBDPI(tdial.DialConfig(**kw), tenv), tenv=tenv,
        jstate=jax.jit(jenv.reset)(jax.random.PRNGKey(0)),
        jcompat=jax.jit(lambda s, Y, scale, noise: jmb.reverse_once_compat(
            s, None, Y, scale, noise=noise)),
    )


def test_reverse_once_compat_matches_jax(compat):
    tmb = compat["tmb"]
    rng = np.random.default_rng(4)
    Y = rng.uniform(-0.3, 0.3, size=(SIZE["Hnode"] + 1, 12))
    noise = rng.normal(size=(SIZE["Nsample"], SIZE["Hnode"] + 1, 12))
    scale = tmb.sigma_control
    jY, jinfo, jphys = compat["jcompat"](compat["jstate"], jnp.asarray(Y), jnp.asarray(scale),
                                         jnp.asarray(noise))
    state = compat["tenv"].reset()
    tY, tinfo, tphys = tmb.reverse_once_compat(state, None, torch.as_tensor(Y),
                                               torch.as_tensor(scale), noise=torch.as_tensor(noise))
    _close(tinfo.rews, jinfo.rews, 1e-9)
    _close(tinfo.weights, jinfo.weights, 1e-7)
    _close(tY, jY, 1e-7)
    for got, want in zip(tphys, jphys):  # the final chained qpos, qvel, warmstart
        _close(got, want, 1e-9)
    # the chain: the last candidate did not start from the snapshot
    assert not torch.equal(tphys[0], state.pipeline.qpos)
    # reverse_once under compat_q1 takes the same rollouts
    rY, rinfo = tmb.reverse_once(state, None, torch.as_tensor(Y), torch.as_tensor(scale),
                                 noise=torch.as_tensor(noise))
    assert torch.equal(rY, tY) and torch.equal(rinfo.rews, tinfo.rews)
