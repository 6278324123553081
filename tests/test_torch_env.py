"""torch port, envs/: the Go2 env's action maps, reward stack, termination
and gait targets against the JAX env on the same random batched inputs, for
each config option the port carries, in float64.

Tolerance 1e-12: the same formulas, no physics in between."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import use_standin_assets
from tpu_dialmpc.envs import get_env as jget_env
from tpu_dialmpc.envs.base import StateInfo as JStateInfo
from tpu_dialmpc_torch.envs import get_env
from tpu_dialmpc_torch.envs import gait as tgait
from tpu_dialmpc.envs import gait as jgait
from tpu_dialmpc_torch.envs.base import StateInfo

TOL = 1e-12
B = 16

VARIANTS = {
    "go2_stand": {},
    "trot_gait": dict(gait="trot"),
    "turn": dict(gait="trot", default_vyaw=1.5, turn_period=75),
    "yaw_eigen": dict(yaw_mode="eigen", default_vyaw=-0.7),
    "goal_x": dict(goal_x=0.01),
    "y_anchor": dict(y_anchor_weight=1.0),
    "energy": dict(energy_weight=0.5),
    "done_penalty": dict(done_penalty=2.0),
    "physical_termination": dict(termination_range_source="physical"),
    "model_ranges": dict(joint_range_source="model"),
    "model_eigen_ranges": dict(joint_range_source="model_eigen"),
    "vel_weight": dict(vel_weight=2.5, default_vy=0.3, ramp_up_time=0.5),
    # the crate scene: terrain-aware foot targets and the torso-height ramp
    # (crate_top_z), or the crate moved out of the way (crate_x)
    "crate_climb": dict(scene="go2_force_crate", crate_top_z=0.30, gait="climb", goal_x=1.35),
    "crate_x": dict(scene="go2_force_crate", crate_x=30.0, gait="pronk"),
}


def _envs(monkeypatch, overrides):
    use_standin_assets(monkeypatch)
    kw = dict(dtype="float64", **overrides)
    return jget_env("go2_stand", **kw), get_env("go2_stand", device="cpu", **kw)


def _inputs(env, seed):
    rng = np.random.default_rng(seed)
    m = env.model
    qpos = np.tile(np.asarray(m.key_qpos["home"]), (B, 1))
    # the first half near home, the second half often out of range
    qpos[:, 7:] += rng.normal(size=(B, m.nu)) * np.repeat([0.05, 0.4], B // 2)[:, None]
    quat = rng.normal(size=(B, 4))
    quat[: B // 2] = [1.0, 0.0, 0.0, 0.0] + 0.1 * quat[: B // 2]  # mostly upright
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    torso_xpos = rng.normal(scale=0.05, size=(B, 3)) + [0.0, 0.0, 0.25]
    torso_xpos[:3, 2] = 0.1  # below the 0.18 m termination height
    site_xpos = rng.normal(scale=0.02, size=(B, m.nsite, 3)) + [0.0, 0.0, 0.02]
    if env.config.scene == "go2_force_crate":
        # the crate's footprint is x in [0.99, 1.61], |y| < 0.46; the torso
        # ramp runs from x = 0.84 to 1.24: feet inside and outside the
        # footprint, the torso before, on and past the ramp
        site_xpos[..., 0] = rng.uniform(0.6, 2.0, size=(B, m.nsite))
        site_xpos[..., 1] = rng.uniform(-0.7, 0.7, size=(B, m.nsite))
        site_xpos[..., 2] = rng.uniform(0.0, 0.35, size=(B, m.nsite))
        torso_xpos[:, 0] = rng.uniform(0.6, 1.5, size=B)
    arrays = dict(
        qpos=qpos,
        qvel=rng.normal(size=(B, m.nv)),
        site_xpos=site_xpos,
        torso_xpos=torso_xpos,
        torso_xquat=quat,
        torso_cvel=rng.normal(size=(B, 6)),
        root_com=torso_xpos + rng.normal(scale=0.01, size=(B, 3)),
        qfrc_actuator=rng.normal(scale=10.0, size=(B, m.nv)),
        ctrl=rng.normal(scale=10.0, size=(B, m.nu)),
    )
    info = dict(
        pos_tar=np.tile([0.282, 0.0, 0.3], (B, 1)),
        vel_tar=rng.normal(size=(B, 3)),
        ang_vel_tar=rng.normal(size=(B, 3)),
        yaw_tar=rng.normal(size=B),
        step=rng.integers(0, 200, size=B).astype(np.int32),
        z_feet=rng.uniform(0, 0.05, size=(B, 4)),
        z_feet_tar=rng.uniform(0, 0.05, size=(B, 4)),
        last_contact=rng.uniform(size=(B, 4)) < 0.5,
        feet_air_time=rng.uniform(0, 0.2, size=(B, 4)),
    )
    return arrays, info


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_post_physics_matches_jax(monkeypatch, variant):
    jenv, tenv = _envs(monkeypatch, VARIANTS[variant])
    arrays, info = _inputs(tenv, seed=len(variant))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jinfo = JStateInfo(rng=keys, **{k: jnp.asarray(v) for k, v in info.items()})
    jr, jd, jinfo2 = jax.vmap(
        lambda a, i: jenv._post_physics(**a, info=i)
    )({k: jnp.asarray(v) for k, v in arrays.items()}, jinfo)
    tr, td, tinfo2 = tenv._post_physics(
        **{k: torch.as_tensor(v) for k, v in arrays.items()},
        info=StateInfo(**{k: torch.as_tensor(v) for k, v in info.items()},
                       seed=torch.zeros(B, dtype=torch.int64)),
    )
    if tenv._crate is not None:
        cx, cy, hx, hy, _ = tenv._crate
        feet = arrays["site_xpos"][:, tenv._feet_site_id]
        inside = (np.abs(feet[..., 0] - cx) < hx) & (np.abs(feet[..., 1] - cy) < hy)
        assert inside.any() and not inside.all()
        ramp = (arrays["torso_xpos"][:, 0] - (cx - hx - 0.15)) / tenv.config.crate_ramp
        assert (ramp < 0).any() and ((ramp > 0) & (ramp < 1)).any() and (ramp > 1).any()
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=TOL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    if variant == "model_eigen_ranges":
        # quirk Q10: the first range row is the freejoint's (0, 0), so every
        # sample with a nonzero first joint angle terminates
        assert td.all()
    else:
        assert td.any() and not td.all()  # both branches of termination exercised
    for f in dataclasses.fields(StateInfo):
        if f.name == "seed":  # the port's in place of JAX's rng key
            continue
        got = getattr(tinfo2, f.name).numpy()
        want = np.asarray(getattr(jinfo2, f.name))
        if got.dtype == bool or np.issubdtype(got.dtype, np.integer):
            np.testing.assert_array_equal(got, want, err_msg=f.name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=f.name)


@pytest.mark.parametrize("variant", ["go2_stand", "model_ranges", "model_eigen_ranges"])
def test_ctrl_map_matches_jax(monkeypatch, variant):
    jenv, tenv = _envs(monkeypatch, VARIANTS[variant])
    arrays, _ = _inputs(tenv, seed=1)
    act = np.random.default_rng(2).uniform(-1.2, 1.2, size=(B, tenv.action_size))
    want = jenv._ctrl_batch(jnp.asarray(act), jnp.asarray(arrays["qpos"]),
                            jnp.asarray(arrays["qvel"]))
    got = tenv._ctrl_batch(torch.as_tensor(act), torch.as_tensor(arrays["qpos"]),
                           torch.as_tensor(arrays["qvel"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    np.testing.assert_allclose(
        tenv.act2joint(torch.as_tensor(act)).numpy(),
        np.asarray(jax.vmap(jenv.act2joint)(jnp.asarray(act))), rtol=0, atol=TOL,
    )


@pytest.mark.parametrize("name", sorted(tgait.GAIT_PARAMS))
def test_foot_step_targets_match_jax(name):
    duty, cadence, amplitude = tgait.GAIT_PARAMS[name]
    phases = np.asarray(tgait.GAIT_PHASES[name])
    t = np.linspace(0.0, 3.0, 301)[:, None]
    want = jgait.get_foot_step(duty, cadence, amplitude, jnp.asarray(phases), jnp.asarray(t))
    got = tgait.get_foot_step(duty, cadence, amplitude, torch.as_tensor(phases),
                              torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    assert tgait.GAIT_PHASES[name] == jgait.GAIT_PHASES[name]


OPTIONS = {
    "position": dict(leg_control="position", scene="go2_position"),
    "climb_ranges": dict(joint_range_source="climb"),
    "climb_physical_termination": dict(joint_range_source="climb",
                                       termination_range_source="physical"),
    "other_ranges": dict(joint_range_source="other"),
}


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_unported_options_raise(monkeypatch, option):
    """Options the port once raised on now match the JAX env (randomize_tasks:
    test_torch_randomize.py).  Position leg control: the env builds on the
    position scene, and its ctrl map (the action's joint targets) matches
    the JAX env's.  joint_range_source: "climb" takes the widened table
    (12 motors), any unlisted value the model's ranges; the action table,
    the physical ranges, the termination box (the action table unless
    termination_range_source="physical") and the ctrl map match the JAX
    env's."""
    jenv, tenv = _envs(monkeypatch, OPTIONS[option])
    arrays, _ = _inputs(tenv, seed=3)
    act = np.random.default_rng(4).uniform(-1.2, 1.2, size=(B, tenv.action_size))
    want = jenv._ctrl_batch(jnp.asarray(act), jnp.asarray(arrays["qpos"]),
                            jnp.asarray(arrays["qvel"]))
    got = tenv._ctrl_batch(torch.as_tensor(act), torch.as_tensor(arrays["qpos"]),
                           torch.as_tensor(arrays["qvel"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    if option == "position":
        assert torch.equal(got, tenv.act2joint(torch.as_tensor(act)))
        return
    for name in ("joint_range", "physical_joint_range", "joint_torque_range"):
        np.testing.assert_array_equal(getattr(tenv, name).numpy(), getattr(jenv, name),
                                      err_msg=name)
    box = jenv.termination_joint_range
    np.testing.assert_array_equal(tenv.termination_joint_range.numpy(),
                                  jenv.joint_range if box is None else box)
    climb = np.array([[-0.6, 0.6], [0.0, 2.1], [-2.6, -0.7]] * 4)
    assert np.array_equal(tenv.joint_range.numpy(), climb) == option.startswith("climb")


def test_crate_options_need_the_crate_scene():
    """As in the JAX env: the crate options on a scene without `box_body`."""
    for kw in (dict(crate_top_z=0.3), dict(crate_x=30.0)):
        with pytest.raises(ValueError):
            get_env("go2_stand", device="cpu", **kw)
