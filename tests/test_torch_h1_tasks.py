"""torch port, the crate-free H1 tasks h1_walk (19 motors) and h1_loco (the
arms-fixed robot: 11 motors, nq 18) on their stand-in scenes, against the
JAX package's CPU path, in float64, with n_substeps=2: the reset state, the
executed step (`step_lean` against `env.step`) from the standing start with
the feet on the floor, the env's crate-free branches and the position ctrl
map, on both tasks (h1_loco's `reverse_once`: test_torch_h1_loco.py).

The JAX side is its CPU reference path (XLA physics pipeline), jitted once
per task per module.  Tolerances, those of test_torch_h1_slice.py: reset
1e-12 (the same forward kinematics), physics after a step 1e-9 (another
factorization order), rewards 1e-9, the ctrl map 1e-12 (the same
formulas).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import ASSETS
from tpu_dialmpc.envs import get_env as jget_env
from tpu_dialmpc_torch.envs import get_env

N_SUB = 2
WIDTHS = {"h1_walk": (26, 25, 19), "h1_loco": (18, 17, 11)}


def _close(got, want, atol):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64),
        rtol=0, atol=atol,
    )


def _jax_env(task, **kw):
    mp = pytest.MonkeyPatch()
    mp.setenv("TPU_DIALMPC_ASSETS", str(ASSETS))
    try:
        return jget_env(task, **kw)
    finally:
        mp.undo()


@pytest.fixture(scope="module", params=sorted(WIDTHS))
def task(request):
    t = request.param
    jenv = _jax_env(t, n_substeps=N_SUB, dtype="float64")
    tenv = get_env(t, device="cpu", n_substeps=N_SUB, dtype="float64")
    return dict(
        name=t, jenv=jenv, tenv=tenv,
        jstate=jax.jit(jenv.reset)(jax.random.PRNGKey(0)), tstate=tenv.reset(),
        jstep=jax.jit(jenv.step),
    )


def test_h1_task_widths_and_crate_free_branches(task):
    """The scene's widths, and no crate: no unactuated slide joint, so the
    crate velocity reward is inert and the crate anchor falls back to the
    integrated one, on both sides."""
    jenv, tenv = task["jenv"], task["tenv"]
    m = tenv.model
    assert (m.nq, m.nv, m.nu) == WIDTHS[task["name"]]
    assert tenv._crate_dof is None and jenv._crate_dof is None
    assert tenv._crate_qadr is None and jenv._crate_qadr is None
    np.testing.assert_array_equal(tenv._act_qadr.numpy(), jenv._act_qadr)
    assert list(tenv._act_qadr.numpy()) == list(range(7, m.nq))
    np.testing.assert_allclose(tenv._foot_contact_z.numpy(), jenv._foot_contact_z, rtol=0, atol=1e-12)


def test_h1_task_reset_matches_jax(task):
    js, ts = task["jstate"], task["tstate"]
    _close(ts.obs, js.obs, 1e-12)
    for f in ("qpos", "qvel", "qacc_warmstart", "xpos", "xquat", "site_xpos",
              "subtree_com", "cvel", "qfrc_actuator"):
        _close(getattr(ts.pipeline, f), getattr(js.pipeline, f), 1e-12)


def test_h1_task_step_lean_matches_jax_env_step(task):
    """One executed step from the standing start (feet capsules on the
    floor)."""
    nu = task["tenv"].action_size
    a = np.random.default_rng(0).uniform(-0.6, 0.6, size=nu)
    js = task["jstep"](task["jstate"], jnp.asarray(a))
    ts = task["tenv"].step_lean(task["tstate"], torch.as_tensor(a))
    for f in ("qpos", "qvel", "qacc_warmstart"):
        _close(getattr(ts.pipeline, f), getattr(js.pipeline, f), 1e-9)
    _close(ts.obs, js.obs, 1e-9)
    _close(ts.reward, js.reward, 1e-9)
    assert bool(ts.done) == bool(js.done)
    for f in ("pos_tar", "vel_tar", "ang_vel_tar", "yaw_tar", "z_feet", "z_feet_tar",
              "feet_air_time"):
        _close(getattr(ts.info, f), getattr(js.info, f), 1e-9)
    assert np.array_equal(ts.info.last_contact.numpy(), np.asarray(js.info.last_contact))
    assert ts.info.last_contact.all()  # both feet on the floor


def test_h1_task_position_ctrl_map_matches_jax(task):
    """With leg_control="position" the ctrl is the action's joint targets."""
    t = task["name"]
    jenv = _jax_env(t, leg_control="position", dtype="float64")
    tenv = get_env(t, device="cpu", leg_control="position", dtype="float64")
    rng = np.random.default_rng(1)
    act = rng.uniform(-1.2, 1.2, size=(16, tenv.action_size))
    qpos = np.tile(tenv._init_q, (16, 1)) + rng.normal(scale=0.1, size=(16, tenv.model.nq))
    qvel = rng.normal(size=(16, tenv.model.nv))
    want = jenv._ctrl_batch(jnp.asarray(act), jnp.asarray(qpos), jnp.asarray(qvel))
    got = tenv._ctrl_batch(torch.as_tensor(act), torch.as_tensor(qpos), torch.as_tensor(qvel))
    _close(got, want, 1e-12)
    assert torch.equal(got, tenv.act2joint(torch.as_tensor(act)))
