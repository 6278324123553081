"""torch port, the h1_push_crate slice end to end on the H1 stand-in,
against the JAX package's CPU path, in float64, at a small size:
Nsample=8, Hsample=4, Hnode=2, n_substeps=2, planning from the reset state
with the crate slid back until its face meets the hands, so the rollouts
push it (contact rows that couple the robot's and the crate's trees).

The JAX side is the CPU reference path (XLA physics pipeline under
vmap(scan(env.step))); the port runs its plain substep chain.  Each JAX
function is jitted once per module (the XLA-CPU compile of the H1 contact
step dominates this file's time); the control step composes
make_control_step's three lines (step, shift, the annealed reverse_once
calls of improve) from those functions.

Tolerances (float64), those of test_torch_slice.py, with their reasons:
- reset: 1e-12, the same forward kinematics formulas;
- physics after a step: 1e-9, the same math in two factorization orders
  (sparse LDL^T in the port, dense solves in the JAX pipeline);
- rewards 1e-9 and planner outputs 1e-7: the softmax divides reward gaps by
  std·temp_sample, which scales the physics rounding up.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import ASSETS, H1_CRATE_AT_HANDS
from tpu_dialmpc.dynamics import pipeline as jpipeline
from tpu_dialmpc.envs import get_env as jget_env
from tpu_dialmpc.envs.base import EnvState as JEnvState
from tpu_dialmpc.envs.registry import dial_defaults as jdial_defaults
from tpu_dialmpc.planner import dial as jdial
from tpu_dialmpc_torch.dynamics import fused
from tpu_dialmpc_torch.envs import dial_defaults, get_env
from tpu_dialmpc_torch.envs.base import to_lean
from tpu_dialmpc_torch.planner import dial as tdial
from tpu_dialmpc_torch.planner import runner as trunner

TASK = "h1_push_crate"
SIZE = dict(Nsample=8, Hsample=4, Hnode=2)
N_SUB = 2
NU = 19


def _close(got, want, atol):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
        rtol=0, atol=atol,
    )


@pytest.fixture(scope="module")
def slice_():
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_DIALMPC_ASSETS", str(ASSETS))
    try:
        jenv = jget_env(TASK, n_substeps=N_SUB, dtype="float64")
    finally:
        mp.undo()
    kw = dict(dial_defaults(TASK), **SIZE)
    jmb = jdial.MBDPI(jdial.DialConfig(**kw), jenv)
    tenv = get_env(TASK, device="cpu", n_substeps=N_SUB, dtype="float64")
    tmb = tdial.MBDPI(tdial.DialConfig(**kw), tenv)
    jstate = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    tstate = tenv.reset()
    # the same reset state with the crate at the hands
    qpos = np.asarray(jstate.pipeline.qpos).copy()
    qpos[26] = H1_CRATE_AT_HANDS
    jcrate = JEnvState(
        pipeline=jpipeline.init(jenv.model, jnp.asarray(qpos), jstate.pipeline.qvel),
        obs=jstate.obs, reward=jstate.reward, done=jstate.done, info=jstate.info,
    )
    tcrate = dataclasses.replace(
        to_lean(tstate),
        pipeline=dataclasses.replace(to_lean(tstate).pipeline, qpos=torch.as_tensor(qpos)),
    )
    return dict(
        jenv=jenv, jmb=jmb, tenv=tenv, tmb=tmb, jstate=jstate, tstate=tstate,
        jcrate=jcrate, tcrate=tcrate,
        jstep=jax.jit(jenv.step),
        jreverse_once=jax.jit(
            lambda s, Y, scale, noise: jmb.reverse_once(s, None, Y, scale, noise=noise)
        ),
    )


def test_h1_dial_defaults_match_jax():
    assert dial_defaults(TASK) == jdial_defaults(TASK)
    assert (dial_defaults(TASK)["Hsample"], dial_defaults(TASK)["Hnode"]) == (32, 8)


def test_h1_reset_matches_jax(slice_):
    js, ts = slice_["jstate"], slice_["tstate"]
    _close(ts.obs, js.obs, 1e-12)
    for f in ("qpos", "qvel", "qacc_warmstart", "xpos", "xquat", "site_xpos",
              "subtree_com", "cvel", "qfrc_actuator"):
        _close(getattr(ts.pipeline, f), getattr(js.pipeline, f), 1e-12)
    for f in dataclasses.fields(ts.info):
        if f.name == "seed":  # the port's in place of JAX's rng key
            continue
        _close(getattr(ts.info, f.name), getattr(js.info, f.name), 1e-12)


def test_h1_start_touches_the_crate(slice_):
    """The planning start: the hands on the crate's face, contacts whose
    rows couple the robot's and the crate's trees."""
    qpos = slice_["tcrate"].pipeline.qpos[None]
    assert fused.active_two_tree_contacts(slice_["tenv"].model, qpos) > 0


def _action():
    return np.random.default_rng(0).uniform(-0.6, 0.6, size=NU)


def test_h1_env_step_matches_jax(slice_):
    """One env step with the hands on the crate."""
    a = _action()
    js = slice_["jstep"](slice_["jcrate"], jnp.asarray(a))
    ts = slice_["tenv"].step_lean(slice_["tcrate"], torch.as_tensor(a))
    for f in ("qpos", "qvel", "qacc_warmstart"):
        _close(getattr(ts.pipeline, f), getattr(js.pipeline, f), 1e-9)
    _close(ts.obs, js.obs, 1e-9)
    _close(ts.reward, js.reward, 1e-9)
    assert bool(ts.done) == bool(js.done)
    for f in ("pos_tar", "vel_tar", "ang_vel_tar", "yaw_tar", "z_feet", "z_feet_tar",
              "feet_air_time"):
        _close(getattr(ts.info, f), getattr(js.info, f), 1e-9)
    assert np.array_equal(ts.info.last_contact.numpy(), np.asarray(js.info.last_contact))


def _noise(seed):
    return np.random.default_rng(seed).normal(size=(SIZE["Nsample"], SIZE["Hnode"] + 1, NU))


def test_h1_reverse_once_matches_jax(slice_):
    """One reverse_once from the crate with injected noise."""
    Y = np.random.default_rng(1).uniform(-0.3, 0.3, size=(SIZE["Hnode"] + 1, NU))
    scale = slice_["tmb"].sigma_control
    noise = _noise(2)
    jY, jinfo = slice_["jreverse_once"](
        slice_["jcrate"], jnp.asarray(Y), jnp.asarray(scale), jnp.asarray(noise)
    )
    tY, tinfo = slice_["tmb"].reverse_once(
        slice_["tcrate"], None, torch.as_tensor(Y), torch.as_tensor(scale),
        noise=torch.as_tensor(noise),
    )
    _close(tinfo.rews, jinfo.rews, 1e-9)
    _close(tinfo.rew_Ybar, jinfo.rew_Ybar, 1e-9)
    _close(tinfo.weights, jinfo.weights, 1e-7)
    _close(tY, jY, 1e-7)


def test_h1_control_step_matches_jax(slice_):
    """make_control_step from the crate: execute Y0[0], shift, improve with
    Ndiffuse=2."""
    jmb, tmb = slice_["jmb"], slice_["tmb"]
    n_diffuse = tmb.args.Ndiffuse
    Y0 = np.random.default_rng(3).uniform(-0.3, 0.3, size=(SIZE["Hnode"] + 1, NU))
    noises = [_noise(10 + i) for i in range(n_diffuse)]

    js = slice_["jstep"](slice_["jcrate"], jnp.asarray(Y0[0]))
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
        ts, tY, tinfos = step(slice_["tcrate"], torch.as_tensor(Y0), None)
    finally:
        del tmb._candidates
    _close(ts.pipeline.qpos, js.pipeline.qpos, 1e-9)
    _close(ts.reward, js.reward, 1e-9)
    _close(tinfos.rews, np.stack(jrews), 1e-9)
    _close(tY, jY, 1e-7)


def test_h1_env_step_on_the_physics_pipeline_matches_jax(slice_):
    """env.step with fused="off", the hands on the crate (rows coupling the
    two trees), against the JAX env.step (the JAX package's CPU path)."""
    tenv = get_env(TASK, device="cpu", n_substeps=N_SUB, dtype="float64", fused="off")
    a = _action()
    js = slice_["jstep"](slice_["jcrate"], jnp.asarray(a))
    ts = tenv.step(slice_["tcrate"], torch.as_tensor(a))
    for f in ("qpos", "qvel", "qacc_warmstart", "xpos", "site_xpos", "cvel", "qfrc_actuator",
              "efc_force"):
        _close(getattr(ts.pipeline, f), getattr(js.pipeline, f), 1e-10)
    _close(ts.obs, js.obs, 1e-10)
    _close(ts.reward, js.reward, 1e-10)
    assert bool(ts.done) == bool(js.done)
    for f in ("pos_tar", "vel_tar", "z_feet", "feet_air_time"):
        _close(getattr(ts.info, f), getattr(js.info, f), 1e-10)
