"""torch port, the h1_walk slice on the 33-dof humanoid (the H1-2 joint
layout stand-in, tests/assets/unitree_h1/mjx_scene_h1_2_walk.xml), run by
path through the existing task in both packages,
`get_env("h1_walk", scene=<path>)`, against the JAX package's CPU path, in
float64, at a small size: Nsample=8, Hsample=4, Hnode=2, n_substeps=2,
planning from the reset state.

The JAX side: reset and the executed env.step are the JAX env's CPU
reference path (jitted; env.step runs the XLA physics pipeline).  The JAX
planner's reverse_once is its own code, with its rollouts
(`MBDPI.rollout_us_batch`) taken by `_jax_rollout`: the body of the JAX
env's fused rollout (envs/fused_rollout.py:rollout_batch, its TPU path:
`_ctrl_batch`, n_substeps of the fused kernel's scalar graph, the derived
reward inputs, `_post_physics` vmapped), run eagerly in float64, a Python
loop over the horizon.  Why not vmap(scan(env.step)) as in
test_torch_h1_slice.py: on this 33-dof model XLA:CPU runs the pipeline
step about 2,000 times slower than on the 25-dof H1 (on an AVX-512 x86
host with JAX 0.9: 150 s per vmapped step of 9 samples against 0.07 s; 7 s
per single step), so that reference takes over 20 minutes.  The port runs its plain substep
chain (on the card the same chain is the fused kernel, whose dof masks
take two words on this model).  The control step composes
make_control_step's three lines (step, shift, the annealed reverse_once
calls of improve) from those functions.

Tolerances (float64), those of test_torch_h1_slice.py, with their reasons:
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

from torch_port_helpers import OWN_SCENES
from tpu_dialmpc.dynamics import fused as jfused
from tpu_dialmpc.envs import get_env as jget_env
from tpu_dialmpc.planner import dial as jdial
from tpu_dialmpc_torch.envs import dial_defaults, get_env
from tpu_dialmpc_torch.envs.base import to_lean
from tpu_dialmpc_torch.planner import dial as tdial
from tpu_dialmpc_torch.planner import runner as trunner

TASK = "h1_walk"
SCENE = str(OWN_SCENES["h1_2_walk"])
SIZE = dict(Nsample=8, Hsample=4, Hnode=2)
N_SUB = 2
NU = 27


def _close(got, want, atol):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
        rtol=0, atol=atol,
    )


@pytest.fixture(scope="module")
def slice_():
    jenv = jget_env(TASK, scene=SCENE, n_substeps=N_SUB, dtype="float64")
    kw = dict(dial_defaults(TASK), **SIZE)
    jmb = jdial.MBDPI(jdial.DialConfig(**kw), jenv)
    tenv = get_env(TASK, device="cpu", scene=SCENE, n_substeps=N_SUB, dtype="float64")
    tmb = tdial.MBDPI(tdial.DialConfig(**kw), tenv)
    jmb.rollout_us_batch = lambda state, all_us: _jax_rollout(jenv, state, all_us)
    return dict(
        jenv=jenv, jmb=jmb, tenv=tenv, tmb=tmb,
        jstate=jax.jit(jenv.reset)(jax.random.PRNGKey(0)), tstate=tenv.reset(),
        jstep=jax.jit(jenv.step),
        jreverse_once=lambda s, Y, scale, noise: jmb.reverse_once(s, None, Y, scale, noise=noise),
    )


def _jax_rollout(jenv, state, all_us):
    """(B, T) rewards of the JAX env's fused rollout body, in float64: every
    candidate from `state`, each horizon step its controls, N_SUB substeps
    of the fused scalar graph, the derived reward inputs and the reward
    stack."""
    m = jenv.model
    meta = jfused._meta(m)
    spec = jfused.DerivedSpec(torso_body=jenv._torso_idx, want_sites=True,
                              want_qfrc_actuator=True)
    B = all_us.shape[0]

    def bcast(x):
        return jnp.broadcast_to(x, (B,) + jnp.shape(x))

    def stack(xs):
        return jnp.stack([jnp.broadcast_to(jnp.asarray(x, jnp.float64), (B,)) for x in xs],
                         axis=-1)

    post = jax.vmap(lambda qpos, qvel, der, info, ctrl: jenv._post_physics(
        qpos=qpos, qvel=qvel, site_xpos=der["site_xpos"], torso_xpos=der["torso_xpos"],
        torso_xquat=der["torso_xquat"], torso_cvel=der["torso_cvel"],
        root_com=der["root_com"], qfrc_actuator=der["qfrc_actuator"], info=info, ctrl=ctrl))
    ps = state.pipeline
    qpos, qvel, ws = bcast(ps.qpos), bcast(ps.qvel), bcast(ps.qacc_warmstart)
    info = jax.tree_util.tree_map(bcast, state.info)
    rews = []
    for t in range(all_us.shape[1]):
        ctrl = jenv._ctrl_batch(all_us[:, t], qpos, qvel)
        q, v, w = ([a[:, i] for i in range(a.shape[1])] for a in (qpos, qvel, ws))
        c = [ctrl[:, i] for i in range(ctrl.shape[1])]
        for _ in range(N_SUB):
            q, v, w, der = jfused._substep(m, meta, spec, q, v, w, c)
        qpos, qvel, ws = stack(q), stack(v), stack(w)
        reward, _, info = post(qpos, qvel, jfused.split_derived(m, spec, stack(der)), info, ctrl)
        rews.append(reward)
    return jnp.stack(rews, axis=1)


def test_h1_2_model_is_the_33_dof_layout(slice_):
    """Both packages build the same model by path: 27 motors, nv=33, on the
    fused path in the port, with the action ranges and termination box of
    the JAX env."""
    tenv, jenv = slice_["tenv"], slice_["jenv"]
    m = tenv.model
    assert (m.nq, m.nv, m.nu) == (34, 33, 27) == (jenv.model.nq, jenv.model.nv, jenv.model.nu)
    assert tenv.on_fused_path and tenv.action_size == NU
    for name in ("joint_range", "physical_joint_range", "joint_torque_range"):
        _close(getattr(tenv, name), getattr(jenv, name), 0.0)


def test_h1_2_reset_matches_jax(slice_):
    js, ts = slice_["jstate"], slice_["tstate"]
    _close(ts.obs, js.obs, 1e-12)
    for f in ("qpos", "qvel", "qacc_warmstart", "xpos", "xquat", "site_xpos",
              "subtree_com", "cvel", "qfrc_actuator"):
        _close(getattr(ts.pipeline, f), getattr(js.pipeline, f), 1e-12)
    for f in dataclasses.fields(ts.info):
        if f.name == "seed":  # the port's in place of JAX's rng key
            continue
        _close(getattr(ts.info, f.name), getattr(js.info, f.name), 1e-12)


def _action():
    return np.random.default_rng(0).uniform(-0.6, 0.6, size=NU)


def test_h1_2_env_step_matches_jax(slice_):
    """One executed step (the port's step_lean, on its fused substep chain)
    against the JAX env.step."""
    a = _action()
    js = slice_["jstep"](slice_["jstate"], jnp.asarray(a))
    ts = slice_["tenv"].step_lean(to_lean(slice_["tstate"]), torch.as_tensor(a))
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


def test_h1_2_reverse_once_matches_jax(slice_):
    """One reverse_once from the reset state with injected noise."""
    Y = np.random.default_rng(1).uniform(-0.3, 0.3, size=(SIZE["Hnode"] + 1, NU))
    scale = slice_["tmb"].sigma_control
    noise = _noise(2)
    jY, jinfo = slice_["jreverse_once"](
        slice_["jstate"], jnp.asarray(Y), jnp.asarray(scale), jnp.asarray(noise)
    )
    tY, tinfo = slice_["tmb"].reverse_once(
        to_lean(slice_["tstate"]), None, torch.as_tensor(Y), torch.as_tensor(scale),
        noise=torch.as_tensor(noise),
    )
    _close(tinfo.rews, jinfo.rews, 1e-9)
    _close(tinfo.rew_Ybar, jinfo.rew_Ybar, 1e-9)
    _close(tinfo.weights, jinfo.weights, 1e-7)
    _close(tY, jY, 1e-7)


def test_h1_2_control_step_matches_jax(slice_):
    """make_control_step from the reset state: execute Y0[0], shift, improve
    with Ndiffuse=2."""
    jmb, tmb = slice_["jmb"], slice_["tmb"]
    n_diffuse = tmb.args.Ndiffuse
    Y0 = np.random.default_rng(3).uniform(-0.3, 0.3, size=(SIZE["Hnode"] + 1, NU))
    noises = [_noise(10 + i) for i in range(n_diffuse)]

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
