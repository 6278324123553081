"""torch port, go2_trot_position: position leg control over the Go2
position stand-in's `<position kp=30 kv=0.65>` servos (the fused substep's
affine-bias actuator branch), end to end against the JAX package's CPU
path, in float64, at a small size (Nsample=8, Hsample=4, Hnode=2,
n_substeps=2); `diag_states`' weighted rollout states against the JAX
planner's; and the kernel source's servo branch through its host (g++)
build.

The JAX side is its CPU reference path (XLA physics pipeline under
vmap(scan(env.step))), jitted once per module; the port runs its plain
substep chain.  Tolerances, those of test_torch_slice.py and
test_torch_h1_fused.py, with their reasons:
- reset 1e-12: the same forward kinematics formulas;
- physics after a step 1e-9: the same math in two factorization orders;
- rewards 1e-9, planner outputs (weights, Ybar, and the weighted states
  qbar/qdbar/xbar) 1e-7: the softmax divides reward gaps by
  std·temp_sample, which scales the physics rounding up;
- the host build against the plain float32 version: bit for bit, with the
  host's sin/cos/sqrt in the plain version (`use_host_math`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import ASSETS, servo_clamps, servo_states, use_host_math
from tpu_dialmpc.envs import get_env as jget_env
from tpu_dialmpc.planner import dial as jdial
from tpu_dialmpc_torch.dynamics import fused, fused_cuda
from tpu_dialmpc_torch.envs import dial_defaults, get_env
from tpu_dialmpc_torch.planner import dial as tdial

TASK = "go2_trot_position"
SIZE = dict(Nsample=8, Hsample=4, Hnode=2)
N_SUB = 2
NU = 12


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
    tenv = get_env(TASK, device="cpu", n_substeps=N_SUB, dtype="float64")
    jmb = jdial.MBDPI(jdial.DialConfig(**kw, diag_states=True), jenv)
    tmb = tdial.MBDPI(tdial.DialConfig(**kw, diag_states=True), tenv)
    return dict(
        jenv=jenv, tenv=tenv, jmb=jmb, tmb=tmb,
        tplain=tdial.MBDPI(tdial.DialConfig(**kw), tenv),
        jstate=jax.jit(jenv.reset)(jax.random.PRNGKey(0)),
        tstate=tenv.reset(),
        jstep=jax.jit(jenv.step),
        jreverse_once=jax.jit(
            lambda s, Y, scale, noise: jmb.reverse_once(s, None, Y, scale, noise=noise)
        ),
    )


def test_position_task_runs_on_the_servo_scene(slice_):
    tenv = slice_["tenv"]
    assert tenv.config.leg_control == "position" and tenv.config.scene == "go2_position"
    assert tenv.model.actuator_biasprm.tolist() == [[0.0, -30.0, -0.65]] * NU


def test_position_reset_matches_jax(slice_):
    js, ts = slice_["jstate"], slice_["tstate"]
    _close(ts.obs, js.obs, 1e-12)
    for f in ("qpos", "qvel", "qacc_warmstart", "xpos", "xquat", "site_xpos",
              "subtree_com", "cvel", "qfrc_actuator"):
        _close(getattr(ts.pipeline, f), getattr(js.pipeline, f), 1e-12)


def test_position_step_lean_matches_jax_env_step(slice_):
    """One executed step: the action's joint targets into the servos, whose
    force kp (target - q) - kv qdot moves the legs."""
    a = np.random.default_rng(0).uniform(-0.9, 0.9, size=NU)
    js = slice_["jstep"](slice_["jstate"], jnp.asarray(a))
    ts = slice_["tenv"].step_lean(slice_["tstate"], torch.as_tensor(a))
    for f in ("qpos", "qvel", "qacc_warmstart"):
        _close(getattr(ts.pipeline, f), getattr(js.pipeline, f), 1e-9)
    _close(ts.obs, js.obs, 1e-9)  # carries ctrl: the joint targets
    _close(ts.obs[6:6 + NU], slice_["tenv"].act2joint(torch.as_tensor(a)), 0.0)
    _close(ts.reward, js.reward, 1e-9)
    assert bool(ts.done) == bool(js.done)
    for f in ("vel_tar", "ang_vel_tar", "z_feet", "z_feet_tar", "feet_air_time"):
        _close(getattr(ts.info, f), getattr(js.info, f), 1e-9)
    # the servos moved the legs off home
    assert np.abs(ts.pipeline.qpos[7:].numpy() - slice_["tstate"].pipeline.qpos[7:].numpy()).max() > 1e-3


def _noise(seed):
    return np.random.default_rng(seed).normal(size=(SIZE["Nsample"], SIZE["Hnode"] + 1, NU))


def test_position_reverse_once_and_diag_states_match_jax(slice_):
    """One reverse_once with injected noise, diag_states on both sides: the
    rewards, weights and Ybar, and the softmax-weighted rollout qpos, qvel
    and torso positions; Ybar equals the port's run without diag_states to
    the bit."""
    Y = np.random.default_rng(1).uniform(-0.3, 0.3, size=(SIZE["Hnode"] + 1, NU))
    scale = slice_["tmb"].sigma_control
    noise = _noise(2)
    jY, jinfo = slice_["jreverse_once"](
        slice_["jstate"], jnp.asarray(Y), jnp.asarray(scale), jnp.asarray(noise)
    )
    args = (slice_["tstate"], None, torch.as_tensor(Y), torch.as_tensor(scale))
    tY, tinfo = slice_["tmb"].reverse_once(*args, noise=torch.as_tensor(noise))
    pY, pinfo = slice_["tplain"].reverse_once(*args, noise=torch.as_tensor(noise))
    _close(tinfo.rews, jinfo.rews, 1e-9)
    _close(tinfo.rew_Ybar, jinfo.rew_Ybar, 1e-9)
    _close(tinfo.weights, jinfo.weights, 1e-7)
    _close(tY, jY, 1e-7)
    T = SIZE["Hsample"] + 1
    assert tinfo.qbar.shape == (T, 19) and tinfo.qdbar.shape == (T, 18) and tinfo.xbar.shape == (T, 3)
    for f in ("qbar", "qdbar", "xbar"):
        _close(getattr(tinfo, f), getattr(jinfo, f), 1e-7)
    assert torch.equal(tY, pY) and torch.equal(tinfo.rews, pinfo.rews)
    assert pinfo.qbar.shape == (1, 1)


def test_servo_kernel_source_host_build_bit_equal_to_plain(tmp_path, monkeypatch):
    """csrc/fused_step.cu's affine-bias actuator branch, built as host C++
    (g++), against the plain float32 version over 8 substeps, on inputs
    where the servos' ctrl and force clamps bind for some samples and not
    for others: equal to the bit with the host's sin/cos/sqrt."""
    m = get_env(TASK, device="cpu").model
    spec = fused.DerivedSpec(torso_body=m.body_names.index("base"), want_sites=True,
                             want_qfrc_actuator=True)
    lib, _, _ = fused_cuda.build_library(m, fused._meta(m), spec, host=True, out_dir=tmp_path)
    qpos, qvel, ws, ctrl = servo_states(m, np.random.default_rng(3), 24)
    ctrl_clamped, force_clamped, bias = servo_clamps(m, qpos, qvel, ctrl)
    assert 0 < ctrl_clamped < ctrl.size and 0 < force_clamped < ctrl.size and bias > 1.0
    args = [torch.as_tensor(a, dtype=torch.float32).contiguous() for a in (qpos, qvel, ws, ctrl)]
    use_host_math(monkeypatch)
    outs = tuple(torch.empty(24, n) for n in (m.nq, m.nv, m.nv, fused.derived_size(m, spec)))
    assert lib.launch(8, *args, outs, 0) == 0
    plain = fused.build_fused_step(m, 8, spec)(*args)
    for name, k, p in zip(("qpos", "qvel", "ws", "derived"), outs, plain):
        assert bool(torch.isfinite(k).all()), name
        assert torch.equal(k, p), (name, (k - p).abs().max().item())
    # the servos' actuator forces are among the derived outputs
    der = fused.split_derived(m, spec, plain[3])
    assert der["qfrc_actuator"][:, 6:].abs().max() > 1.0


def test_position_env_step_on_the_physics_pipeline_matches_jax(slice_):
    """env.step with fused="off": the servos through the physics pipeline,
    against the JAX env.step (the JAX package's CPU path)."""
    tenv = get_env(TASK, device="cpu", n_substeps=N_SUB, dtype="float64", fused="off")
    a = np.random.default_rng(0).uniform(-0.9, 0.9, size=NU)
    js = slice_["jstep"](slice_["jstate"], jnp.asarray(a))
    ts = tenv.step(slice_["tstate"], torch.as_tensor(a))
    for f in ("qpos", "qvel", "qacc_warmstart", "xpos", "cvel", "qfrc_actuator", "efc_force"):
        _close(getattr(ts.pipeline, f), getattr(js.pipeline, f), 1e-10)
    _close(ts.obs, js.obs, 1e-10)
    _close(ts.reward, js.reward, 1e-10)
    assert bool(ts.done) == bool(js.done)
