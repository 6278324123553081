"""torch port, the go2_stand slice end to end on the Go2 stand-in, against
the JAX package's CPU path, in float64, at a small size: Nsample=8,
Hsample=4, Hnode=2, n_substeps=2.

The JAX side is the CPU reference path (XLA physics pipeline under
vmap(scan(env.step))); the port runs its plain substep chain.  Each JAX
function is jitted once per module, to keep XLA-CPU compile time down; the
control step composes make_control_step's three lines (step, shift, the
annealed reverse_once calls of improve) from those functions.

Tolerances (float64), with their reasons:
- reset: 1e-12, the same forward kinematics formulas;
- physics after a step: 1e-9, the same math in two factorization orders
  (sparse LDL^T in the port, dense solves in the JAX pipeline);
- rewards 1e-9 and planner outputs 1e-7: the softmax divides reward gaps by
  std·temp_sample, which scales the physics rounding up.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import ASSETS
from tpu_dialmpc.envs import get_env as jget_env
from tpu_dialmpc.envs.registry import dial_defaults as jdial_defaults
from tpu_dialmpc.planner import dial as jdial
from tpu_dialmpc_torch.envs import dial_defaults, get_env
from tpu_dialmpc_torch.envs.base import to_lean
from tpu_dialmpc_torch.planner import dial as tdial
from tpu_dialmpc_torch.planner import runner as trunner

SIZE = dict(Nsample=8, Hsample=4, Hnode=2)
N_SUB = 2


@pytest.fixture(scope="module")
def slice_():
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_DIALMPC_ASSETS", str(ASSETS))
    try:
        jenv = jget_env("go2_stand", n_substeps=N_SUB, dtype="float64")
    finally:
        mp.undo()
    assert jdial_defaults("go2_stand") == dial_defaults("go2_stand")
    kw = dict(dial_defaults("go2_stand"), **SIZE)
    jmb = jdial.MBDPI(jdial.DialConfig(**kw), jenv)
    tenv = get_env("go2_stand", n_substeps=N_SUB, dtype="float64")
    tmb = tdial.MBDPI(tdial.DialConfig(**kw), tenv)
    jstate = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    return dict(
        jenv=jenv, jmb=jmb, tenv=tenv, tmb=tmb, jstate=jstate,
        tstate=tenv.reset(),
        jstep=jax.jit(jenv.step),
        jreverse_once=jax.jit(
            lambda s, Y, scale, noise: jmb.reverse_once(s, None, Y, scale, noise=noise)
        ),
    )


def _close(got, want, atol):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
        rtol=0, atol=atol,
    )


def test_reset_matches_jax(slice_):
    js, ts = slice_["jstate"], slice_["tstate"]
    _close(ts.obs, js.obs, 1e-12)
    for f in ("qpos", "qvel", "qacc_warmstart", "xpos", "xquat", "site_xpos",
              "subtree_com", "cvel", "qfrc_actuator"):
        _close(getattr(ts.pipeline, f), getattr(js.pipeline, f), 1e-12)
    assert int(ts.info.step) == int(js.info.step) == 0


def _action(nu):
    return np.random.default_rng(0).uniform(-0.6, 0.6, size=nu)


def test_env_step_matches_jax(slice_):
    a = _action(slice_["tenv"].action_size)
    js = slice_["jstep"](slice_["jstate"], jnp.asarray(a))
    ts = slice_["tenv"].step_lean(slice_["tstate"], torch.as_tensor(a))
    for f in ("qpos", "qvel", "qacc_warmstart"):
        _close(getattr(ts.pipeline, f), getattr(js.pipeline, f), 1e-9)
    _close(ts.obs, js.obs, 1e-9)
    _close(ts.reward, js.reward, 1e-9)
    assert bool(ts.done) == bool(js.done)
    for f in ("vel_tar", "ang_vel_tar", "yaw_tar", "z_feet", "z_feet_tar",
              "feet_air_time"):
        _close(getattr(ts.info, f), getattr(js.info, f), 1e-9)
    assert np.array_equal(ts.info.last_contact.numpy(), np.asarray(js.info.last_contact))
    assert int(ts.info.step) == int(js.info.step) == 1


def _noise(seed):
    return np.random.default_rng(seed).normal(
        size=(SIZE["Nsample"], SIZE["Hnode"] + 1, 12)
    )


def test_reverse_once_matches_jax(slice_):
    Y = np.random.default_rng(1).uniform(-0.3, 0.3, size=(SIZE["Hnode"] + 1, 12))
    scale = slice_["tmb"].sigma_control
    noise = _noise(2)
    jY, jinfo = slice_["jreverse_once"](
        slice_["jstate"], jnp.asarray(Y), jnp.asarray(scale), jnp.asarray(noise)
    )
    tY, tinfo = slice_["tmb"].reverse_once(
        slice_["tstate"], None, torch.as_tensor(Y), torch.as_tensor(scale),
        noise=torch.as_tensor(noise),
    )
    _close(tinfo.rews, jinfo.rews, 1e-9)
    _close(tinfo.rew_Ybar, jinfo.rew_Ybar, 1e-9)
    _close(tinfo.weights, jinfo.weights, 1e-7)
    _close(tY, jY, 1e-7)


def test_control_step_matches_jax(slice_):
    """make_control_step: execute Y0[0], shift, improve with Ndiffuse=2."""
    jmb, tmb = slice_["jmb"], slice_["tmb"]
    n_diffuse = tmb.args.Ndiffuse
    Y0 = np.random.default_rng(3).uniform(-0.3, 0.3, size=(SIZE["Hnode"] + 1, 12))
    noises = [_noise(10 + i) for i in range(n_diffuse)]

    # JAX: the three lines of runner.make_control_step, improve unrolled
    js = slice_["jstep"](slice_["jstate"], jnp.asarray(Y0[0]))
    jY = jmb.shift(jnp.asarray(Y0))
    jrews = []
    for i in range(n_diffuse):
        scale = jmb.sigma_control * jmb.args.traj_diffuse_factor**i
        jY, jinfo = slice_["jreverse_once"](js, jY, jnp.asarray(scale), jnp.asarray(noises[i]))
        jrews.append(jinfo.rews)

    it = iter(noises)
    orig = tmb._candidates
    tmb._candidates = lambda gen, Y, scale, noise: orig(gen, Y, scale, torch.as_tensor(next(it)))
    try:
        step = trunner.make_control_step(tmb, n_diffuse)
        ts, tY, tinfos = step(to_lean(slice_["tstate"]), torch.as_tensor(Y0), None)
    finally:
        del tmb._candidates
    _close(ts.pipeline.qpos, js.pipeline.qpos, 1e-9)
    _close(ts.reward, js.reward, 1e-9)
    _close(tinfos.rews, np.stack(jrews), 1e-9)
    _close(tY, jY, 1e-7)


def test_port_imports_neither_jax_nor_mujoco():
    """At run time the port imports torch and numpy only."""
    code = (
        "import sys\n"
        "import tpu_dialmpc_torch, tpu_dialmpc_torch.envs, tpu_dialmpc_torch.planner.runner\n"
        "import tpu_dialmpc_torch.dynamics.fused_cuda\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'mujoco', 'tpu_dialmpc'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
