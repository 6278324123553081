"""torch port, the go2_stand slice end to end on the Go2 stand-in, and the
go2_crate_climb slice on the crate stand-in, against the JAX package's CPU
path, in float64, at a small size: Nsample=8 (go2_stand) or 16
(go2_crate_climb), Hsample=4, Hnode=2, n_substeps=2.  The crate case plans
from a state 0.2 m before the crate's face, so the rollouts meet the crate.

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

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import ASSETS, use_eager_graphs
from tpu_dialmpc.dynamics import pipeline as jpipeline
from tpu_dialmpc.envs import get_env as jget_env
from tpu_dialmpc.envs.base import EnvState as JEnvState
from tpu_dialmpc.envs.registry import dial_defaults as jdial_defaults
from tpu_dialmpc.planner import dial as jdial
from tpu_dialmpc_torch.envs import dial_defaults, get_env
from tpu_dialmpc_torch.envs.base import map_tensors, to_lean
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
    tenv = get_env("go2_stand", device="cpu", n_substeps=N_SUB, dtype="float64")
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


CRATE_SIZE = dict(Nsample=16, Hsample=4, Hnode=2)
FACE_X = 0.79  # the base 0.2 m before the crate's face at x = 1.3 - 0.31


@pytest.fixture(scope="module")
def crate_slice():
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_DIALMPC_ASSETS", str(ASSETS))
    try:
        jenv = jget_env("go2_crate_climb", n_substeps=N_SUB, dtype="float64")
    finally:
        mp.undo()
    assert jdial_defaults("go2_crate_climb") == dial_defaults("go2_crate_climb")
    kw = dict(dial_defaults("go2_crate_climb"), **CRATE_SIZE)
    jmb = jdial.MBDPI(jdial.DialConfig(**kw), jenv)
    tenv = get_env("go2_crate_climb", device="cpu", n_substeps=N_SUB, dtype="float64")
    tmb = tdial.MBDPI(tdial.DialConfig(**kw), tenv)
    jstate = jax.jit(jenv.reset)(jax.random.PRNGKey(0))
    tstate = tenv.reset()
    # the same reset state, moved to the crate's face
    qpos = np.asarray(jstate.pipeline.qpos).copy()
    qpos[0] = FACE_X
    jface = JEnvState(
        pipeline=jpipeline.init(jenv.model, jnp.asarray(qpos), jstate.pipeline.qvel),
        obs=jstate.obs, reward=jstate.reward, done=jstate.done, info=jstate.info,
    )
    tface = dataclasses.replace(
        to_lean(tstate),
        pipeline=dataclasses.replace(to_lean(tstate).pipeline, qpos=torch.as_tensor(qpos)),
    )
    return dict(
        jenv=jenv, jmb=jmb, tenv=tenv, tmb=tmb, jstate=jstate, tstate=tstate,
        jface=jface, tface=tface,
        jstep=jax.jit(jenv.step),
        jreverse_once=jax.jit(
            lambda s, Y, scale, noise: jmb.reverse_once(s, None, Y, scale, noise=noise)
        ),
    )


def _crate_noise(seed):
    return np.random.default_rng(seed).normal(
        size=(CRATE_SIZE["Nsample"], CRATE_SIZE["Hnode"] + 1, 12)
    )


def test_crate_reset_matches_jax(crate_slice):
    js, ts = crate_slice["jstate"], crate_slice["tstate"]
    _close(ts.obs, js.obs, 1e-12)
    for f in ("qpos", "qvel", "qacc_warmstart", "xpos", "xquat", "site_xpos",
              "subtree_com", "cvel", "qfrc_actuator"):
        _close(getattr(ts.pipeline, f), getattr(js.pipeline, f), 1e-12)
    # the crate was moved so its top face is at 0.30 m
    crate = crate_slice["tenv"].model.body_names.index("box_body")
    _close(ts.pipeline.xpos[crate], [1.3, 0.0, 0.0], 0.0)


def test_crate_env_step_matches_jax(crate_slice):
    """One env step at the crate's face: the front feet and calves press on
    the crate."""
    a = _action(crate_slice["tenv"].action_size)
    js = crate_slice["jstep"](crate_slice["jface"], jnp.asarray(a))
    ts = crate_slice["tenv"].step_lean(crate_slice["tface"], torch.as_tensor(a))
    for f in ("qpos", "qvel", "qacc_warmstart"):
        _close(getattr(ts.pipeline, f), getattr(js.pipeline, f), 1e-9)
    _close(ts.obs, js.obs, 1e-9)
    _close(ts.reward, js.reward, 1e-9)
    assert bool(ts.done) == bool(js.done)
    for f in ("vel_tar", "ang_vel_tar", "z_feet", "z_feet_tar", "feet_air_time"):
        _close(getattr(ts.info, f), getattr(js.info, f), 1e-9)


def test_crate_reverse_once_matches_jax(crate_slice):
    """One reverse_once from the crate's face with injected noise."""
    Y = np.random.default_rng(21).uniform(-0.3, 0.3, size=(CRATE_SIZE["Hnode"] + 1, 12))
    scale = crate_slice["tmb"].sigma_control
    noise = _crate_noise(22)
    jY, jinfo = crate_slice["jreverse_once"](
        crate_slice["jface"], jnp.asarray(Y), jnp.asarray(scale), jnp.asarray(noise)
    )
    tY, tinfo = crate_slice["tmb"].reverse_once(
        crate_slice["tface"], None, torch.as_tensor(Y), torch.as_tensor(scale),
        noise=torch.as_tensor(noise),
    )
    _close(tinfo.rews, jinfo.rews, 1e-9)
    _close(tinfo.rew_Ybar, jinfo.rew_Ybar, 1e-9)
    _close(tinfo.weights, jinfo.weights, 1e-7)
    _close(tY, jY, 1e-7)


def test_crate_control_step_matches_jax(crate_slice):
    """make_control_step from the crate's face: execute Y0[0], shift,
    improve with Ndiffuse=2."""
    jmb, tmb = crate_slice["jmb"], crate_slice["tmb"]
    n_diffuse = tmb.args.Ndiffuse
    Y0 = np.random.default_rng(23).uniform(-0.3, 0.3, size=(CRATE_SIZE["Hnode"] + 1, 12))
    noises = [_crate_noise(30 + i) for i in range(n_diffuse)]

    js = crate_slice["jstep"](crate_slice["jface"], jnp.asarray(Y0[0]))
    jY = jmb.shift(jnp.asarray(Y0))
    jrews = []
    for i in range(n_diffuse):
        scale = jmb.sigma_control * jmb.args.traj_diffuse_factor**i
        jY, jinfo = crate_slice["jreverse_once"](js, jY, jnp.asarray(scale),
                                                 jnp.asarray(noises[i]))
        jrews.append(jinfo.rews)

    it = iter(noises)
    orig = tmb._candidates
    tmb._candidates = lambda gen, Y, scale, noise: orig(gen, Y, scale, torch.as_tensor(next(it)))
    try:
        step = trunner.make_control_step(tmb, n_diffuse)
        ts, tY, tinfos = step(crate_slice["tface"], torch.as_tensor(Y0), None)
    finally:
        del tmb._candidates
    _close(ts.pipeline.qpos, js.pipeline.qpos, 1e-9)
    _close(ts.reward, js.reward, 1e-9)
    _close(tinfos.rews, np.stack(jrews), 1e-9)
    _close(tY, jY, 1e-7)


def test_port_imports_neither_jax_nor_mujoco():
    """At run time the port imports torch and numpy only, also with the CLI,
    checkpoint, telemetry and physics pipeline modules loaded, the H1 and
    position envs built, a go2_stand env on the physics pipeline
    stepped, and scenes compiled from their MJCF (a path, and a name under
    TPU_DIALMPC_ASSETS)."""
    code = (
        "import sys, torch\n"
        "import tpu_dialmpc_torch, tpu_dialmpc_torch.envs, tpu_dialmpc_torch.planner.runner\n"
        "import tpu_dialmpc_torch.dynamics.fused_cuda, tpu_dialmpc_torch.envs.h1\n"
        "import tpu_dialmpc_torch.cli.main, tpu_dialmpc_torch.checkpoint\n"
        "import tpu_dialmpc_torch.telemetry\n"
        "from tpu_dialmpc_torch.dynamics import (collision, constraint, kinematics, linalg,\n"
        "                                        pipeline, smooth, solver)\n"
        "for task in ('h1_push_crate', 'go2_trot_position', 'h1_loco'):\n"
        "    tpu_dialmpc_torch.envs.get_env(task, device='cpu')  # reads no mujoco\n"
        "env = tpu_dialmpc_torch.envs.get_env('go2_stand', fused='off', device='cpu')\n"
        "state = env.step(env.reset(), torch.zeros(env.action_size))\n"
        "assert torch.isfinite(state.pipeline.qpos).all() and not env.on_fused_path\n"
        "from tpu_dialmpc_torch.dynamics import mjcf, model\n"
        "m = model.compile_model(mjcf.load('tests/assets/unitree_h1/mjx_scene_h1_push_crate.xml'))\n"
        "assert (m.nq, m.nv, m.nu) == (27, 26, 19)\n"
        "env = tpu_dialmpc_torch.envs.get_env(\n"
        "    'go2_stand', device='cpu', scene='tests/assets/unitree_go2/mjx_scene_force.xml')\n"
        "import os; os.environ['TPU_DIALMPC_ASSETS'] = 'tests/assets'\n"
        "tpu_dialmpc_torch.envs.get_env('h1_push_crate', device='cpu')  # from its XML\n"
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


# ---- the physics pipeline (fused="off") against the JAX package's XLA path,
# which is what the JAX package runs on the CPU: the same JAX compiles as
# above, no new one ----


@pytest.fixture(scope="module")
def off(slice_):
    kw = dict(dial_defaults("go2_stand"), **SIZE)
    tenv = get_env("go2_stand", device="cpu", n_substeps=N_SUB, dtype="float64", fused="off")
    cfg = tdial.DialConfig(**kw)
    return dict(tenv=tenv, cfg=cfg, tmb=tdial.MBDPI(cfg, tenv))


def test_env_step_on_the_physics_pipeline_matches_jax(slice_, off):
    """env.step (fused="off" too, and any other mode: step always runs the
    pipeline) against the JAX env.step, on one state and on a batch."""
    a = _action(12)
    js = slice_["jstep"](slice_["jstate"], jnp.asarray(a))
    tenv = off["tenv"]
    assert not tenv.on_fused_path
    ts = tenv.step(slice_["tstate"], torch.as_tensor(a))
    for f in ("qpos", "qvel", "qacc_warmstart", "xpos", "xquat", "site_xpos", "subtree_com",
              "cvel", "qfrc_actuator", "efc_force"):
        _close(getattr(ts.pipeline, f), getattr(js.pipeline, f), 1e-10)
    _close(ts.obs, js.obs, 1e-10)
    _close(ts.reward, js.reward, 1e-10)
    assert bool(ts.done) == bool(js.done)
    for f in ("vel_tar", "ang_vel_tar", "yaw_tar", "z_feet", "z_feet_tar", "feet_air_time"):
        _close(getattr(ts.info, f), getattr(js.info, f), 1e-10)
    assert int(ts.info.step) == 1
    # a batch of three copies steps as the one state (batched products may
    # round differently by batch size: 1e-12)
    tb = tenv.step(map_tensors(slice_["tstate"], lambda x: x.expand((3,) + x.shape)),
                   torch.as_tensor(a).expand(3, -1))
    for f in ("qpos", "qvel", "efc_force"):
        _close(getattr(tb.pipeline, f)[2], getattr(ts.pipeline, f), 1e-12)
    _close(tb.reward[1], ts.reward, 1e-12)
    _close(tb.obs[0], ts.obs, 1e-12)


@pytest.mark.parametrize("planner", ["off", "off_captured"])
def test_reverse_once_on_the_physics_pipeline_matches_jax(slice_, off, planner, monkeypatch):
    """reverse_once under injected noise on the fused="off" env's rollouts
    (the pipeline, batched): eagerly, and with each horizon step a unit of
    a planner that captures env steps (through the CPU stand-in for a CUDA
    graph: the first horizon step eager, the rest replays of the graph
    captured at the second)."""
    Y = np.random.default_rng(1).uniform(-0.3, 0.3, size=(SIZE["Hnode"] + 1, 12))
    if planner == "off":
        mb, graphs = off["tmb"], None
    else:
        graphs = use_eager_graphs(monkeypatch.setattr)
        mb = tdial.MBDPI(off["cfg"], off["tenv"])
        assert mb.captured and not mb.graphs.whole
    scale = mb.sigma_control
    noise = _noise(2)
    jY, jinfo = slice_["jreverse_once"](
        slice_["jstate"], jnp.asarray(Y), jnp.asarray(scale), jnp.asarray(noise)
    )
    tY, tinfo = mb.reverse_once(slice_["tstate"], None, torch.as_tensor(Y),
                                torch.as_tensor(scale), noise=torch.as_tensor(noise))
    _close(tinfo.rews, jinfo.rews, 1e-9)
    _close(tinfo.rew_Ybar, jinfo.rew_Ybar, 1e-9)
    _close(tinfo.weights, jinfo.weights, 1e-7)
    _close(tY, jY, 1e-7)
    if graphs is not None:
        (graph,) = graphs
        assert list(mb.graphs.units) == ["horizon step"]
        assert (graph.captures, graph.replays) == (1, SIZE["Hsample"])


def test_control_step_on_the_physics_pipeline_executes_with_env_step(slice_, off):
    """make_control_step on the fused="off" env executes Y0[0] through
    step_lean on the pipeline, then shifts and improves: against the JAX
    control step, which executes with env.step."""
    jmb, tmb = slice_["jmb"], off["tmb"]
    n_diffuse = tmb.args.Ndiffuse
    Y0 = np.random.default_rng(3).uniform(-0.3, 0.3, size=(SIZE["Hnode"] + 1, 12))
    noises = [_noise(10 + i) for i in range(n_diffuse)]
    js = slice_["jstep"](slice_["jstate"], jnp.asarray(Y0[0]))
    jY = jmb.shift(jnp.asarray(Y0))
    for i in range(n_diffuse):
        scale = jmb.sigma_control * jmb.args.traj_diffuse_factor**i
        jY, _ = slice_["jreverse_once"](js, jY, jnp.asarray(scale), jnp.asarray(noises[i]))
    it = iter(noises)
    orig = tmb._candidates
    tmb._candidates = lambda gen, Y, scale, noise: orig(gen, Y, scale, torch.as_tensor(next(it)))
    try:
        ts, tY, _ = trunner.make_control_step(tmb, n_diffuse)(slice_["tstate"],
                                                              torch.as_tensor(Y0), None)
    finally:
        del tmb._candidates
    _close(ts.pipeline.qpos, js.pipeline.qpos, 1e-10)
    _close(ts.reward, js.reward, 1e-10)
    _close(tY, jY, 1e-7)
