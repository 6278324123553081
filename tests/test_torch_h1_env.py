"""torch port, envs/h1.py: the H1 env's action ranges, ground-contact
heights, crate dof, ctrl map and reward/termination stack against the JAX
env (`tpu_dialmpc/envs/h1.py`) on the H1 push-crate stand-in, on the same
random batched inputs, for each config option the port carries, in
float64; and the biped gait tables.

Tolerance 1e-12: the same formulas, no physics in between (the
ground-contact heights: the port's forward kinematics against MuJoCo's
mj_forward, both in float64)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import use_standin_assets
from tpu_dialmpc.envs import gait as jgait
from tpu_dialmpc.envs import get_env as jget_env
from tpu_dialmpc.envs.base import StateInfo as JStateInfo
from tpu_dialmpc_torch.envs import gait as tgait
from tpu_dialmpc_torch.envs import get_env
from tpu_dialmpc_torch.envs.base import StateInfo
from tpu_dialmpc_torch.envs.h1 import UnitreeH1EnvConfig

TASK = "h1_push_crate"
TOL = 1e-12
B = 24

VARIANTS = {
    # the task as registered: leashed anchor, capped crate velocity, done penalty
    "h1_push_crate": {},
    "crate_anchor": dict(pos_anchor_mode="crate"),
    "no_leash": dict(pos_anchor_leash=0.0, crate_vel_weight=0.0, done_penalty=0.0),
    "stand_gait": dict(gait="stand", default_vx=0.0, default_vy=0.2, default_vyaw=0.5),
    "jog_gait": dict(gait="jog", ramp_up_time=0.5),
    "yaw_eigen": dict(yaw_mode="eigen", default_vyaw=-0.7),
    "energy": dict(energy_weight=0.5),
    "model_ranges": dict(joint_range_source="model"),
    "halfwidths": dict(action_halfwidth=0.3, arm_halfwidth=0.6),
}


def _envs(monkeypatch, overrides):
    use_standin_assets(monkeypatch)
    kw = dict(dtype="float64", **overrides)
    return jget_env(TASK, **kw), get_env(TASK, device="cpu", **kw)


def test_config_fields_and_defaults_match_jax():
    from tpu_dialmpc.envs.h1 import UnitreeH1EnvConfig as JConfig

    assert dataclasses.asdict(UnitreeH1EnvConfig()) == dataclasses.asdict(JConfig())


@pytest.mark.parametrize("variant", ["h1_push_crate", "model_ranges", "halfwidths"])
def test_ranges_contact_heights_and_crate_dof_match_jax(monkeypatch, variant):
    jenv, tenv = _envs(monkeypatch, VARIANTS[variant])
    for name in ("joint_range", "physical_joint_range", "joint_torque_range"):
        np.testing.assert_array_equal(getattr(tenv, name).numpy(), getattr(jenv, name),
                                      err_msg=name)
    np.testing.assert_allclose(tenv._foot_contact_z.numpy(), jenv._foot_contact_z,
                               rtol=0, atol=TOL)
    assert (tenv._crate_dof, tenv._crate_qadr) == (jenv._crate_dof, jenv._crate_qadr) == (25, 26)
    np.testing.assert_array_equal(tenv._act_qadr.numpy(), jenv._act_qadr)
    np.testing.assert_array_equal(tenv._act_dadr.numpy(), jenv._act_dadr)
    assert tenv.observation_size == jenv.observation_size == 78
    assert tenv.action_size == jenv.action_size == 19


def _inputs(env, seed):
    """Batched reward inputs: the first half near home, the second often
    out of range; pos_tar a metre or more ahead of the torso in a third of
    the samples (the leash binds), the crate's velocity past its cap in
    either direction, and some samples fallen or low (done)."""
    rng = np.random.default_rng(seed)
    m = env.model
    qpos = np.tile(np.asarray(m.key_qpos["home"]), (B, 1))
    qpos[:, 7:26] += rng.normal(size=(B, 19)) * np.repeat([0.05, 0.6], B // 2)[:, None]
    qpos[:, 26] = rng.uniform(-0.5, 0.5, B)
    quat = rng.normal(size=(B, 4))
    quat[: B // 2] = [1.0, 0.0, 0.0, 0.0] + 0.1 * quat[: B // 2]
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    torso_xpos = rng.normal(scale=0.1, size=(B, 3)) + [0.0, 0.0, 0.95]
    torso_xpos[:3, 2] = 0.4  # below the 0.5 m termination height
    qvel = rng.normal(size=(B, m.nv))
    qvel[:, 25] = rng.uniform(-1.0, 1.0, B)  # the crate's velocity, capped at 0.3
    site_xpos = rng.normal(scale=0.02, size=(B, m.nsite, 3)) + [0.0, 0.0, 0.01]
    pos_tar = np.tile([0.0, 0.0, 0.98], (B, 1))
    pos_tar[::3, :2] += rng.uniform(-2.0, 2.0, size=(len(pos_tar[::3]), 2))
    arrays = dict(
        qpos=qpos,
        qvel=qvel,
        site_xpos=site_xpos,
        torso_xpos=torso_xpos,
        torso_xquat=quat,
        torso_cvel=rng.normal(size=(B, 6)),
        root_com=torso_xpos + rng.normal(scale=0.01, size=(B, 3)),
        qfrc_actuator=rng.normal(scale=10.0, size=(B, m.nv)),
        ctrl=rng.normal(scale=10.0, size=(B, m.nu)),
    )
    info = dict(
        pos_tar=pos_tar,
        vel_tar=rng.normal(size=(B, 3)),
        ang_vel_tar=rng.normal(size=(B, 3)),
        yaw_tar=rng.normal(size=B),
        step=rng.integers(0, 200, size=B).astype(np.int32),
        z_feet=rng.uniform(0, 0.05, size=(B, 2)),
        z_feet_tar=rng.uniform(0, 0.05, size=(B, 2)),
        last_contact=rng.uniform(size=(B, 2)) < 0.5,
        feet_air_time=rng.uniform(0, 0.2, size=(B, 2)),
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
    cfg = tenv.config
    if cfg.pos_anchor_leash > 0.0 and cfg.pos_anchor_mode == "integrate":
        lead = np.linalg.norm(tinfo2.pos_tar[:, :2].numpy() - arrays["torso_xpos"][:, :2], axis=-1)
        assert np.isclose(lead, cfg.pos_anchor_leash).any() and (lead < cfg.pos_anchor_leash).any()
    if cfg.pos_anchor_mode == "crate":
        np.testing.assert_allclose(tinfo2.pos_tar[:, 0].numpy(),
                                   arrays["qpos"][:, 26] - cfg.crate_standoff, rtol=0, atol=TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=TOL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
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


def test_crate_velocity_reward_is_capped(monkeypatch):
    """The crate's velocity pays up to the cap and no further (only the
    crate term differs between the two calls)."""
    _, tenv = _envs(monkeypatch, {})
    arrays, info = _inputs(tenv, seed=5)
    args = {k: torch.as_tensor(v) for k, v in arrays.items()}
    info = StateInfo(**{k: torch.as_tensor(v) for k, v in info.items()},
                       seed=torch.zeros(B, dtype=torch.int64))
    fast = dict(args, qvel=args["qvel"].clone())
    fast["qvel"][:, 25] = 1.0
    slow = dict(args, qvel=args["qvel"].clone())
    slow["qvel"][:, 25] = tenv.config.crate_vel_cap
    r_fast, _, _ = tenv._post_physics(**fast, info=info)
    r_slow, _, _ = tenv._post_physics(**slow, info=info)
    torch.testing.assert_close(r_fast, r_slow, rtol=0, atol=TOL)


@pytest.mark.parametrize("variant", ["h1_push_crate", "model_ranges"])
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


@pytest.mark.parametrize("name", sorted(tgait.BIPED_GAIT_PARAMS))
def test_biped_foot_step_targets_match_jax(name):
    assert tgait.BIPED_GAIT_PHASES == jgait.BIPED_GAIT_PHASES
    assert tgait.BIPED_GAIT_PARAMS == jgait.BIPED_GAIT_PARAMS
    duty, cadence, amplitude = tgait.BIPED_GAIT_PARAMS[name]
    phases = np.asarray(tgait.BIPED_GAIT_PHASES[name])
    t = np.linspace(0.0, 3.0, 301)[:, None]
    want = jgait.get_foot_step(duty, cadence, amplitude, jnp.asarray(phases), jnp.asarray(t))
    got = tgait.get_foot_step(duty, cadence, amplitude, torch.as_tensor(phases),
                              torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


H1_OPTIONS = {
    "position": dict(leg_control="position"),
    "fused_off": dict(fused="off"),
    "other_ranges": dict(joint_range_source="other"),
    "upstream_ranges": dict(joint_range_source="upstream"),  # a Go2 table name
}


@pytest.mark.parametrize("option", sorted(H1_OPTIONS))
def test_unported_h1_options_raise(monkeypatch, option):
    """Options the port once raised on now match the JAX env (randomize_tasks:
    test_torch_randomize.py).  Any range source but "centered" takes the
    model's ranges, as the JAX env does: the action table, the physical
    ranges and the ctrl map match it.  Position leg control: its ctrl map
    (the action's joint targets) matches the JAX env's.  The XLA physics
    path (fused="off"): the executed step runs the physics pipeline, as
    env.step does (its parity with the JAX env.step:
    test_torch_h1_slice.py)."""
    if option == "fused_off":
        env = get_env(TASK, device="cpu", n_substeps=1, **H1_OPTIONS[option])
        assert not env.on_fused_path
        state = env.reset()
        act = torch.as_tensor(np.random.default_rng(4).uniform(-0.5, 0.5, env.action_size),
                              dtype=torch.float32)
        lean, full = env.step_lean(state, act), env.step(state, act)
        assert torch.isfinite(full.pipeline.qpos).all() and env._fused_step is None
        for f in ("qpos", "qvel", "qacc_warmstart"):
            assert torch.equal(getattr(lean.pipeline, f), getattr(full.pipeline, f)), f
        return
    jenv, tenv = _envs(monkeypatch, H1_OPTIONS[option])
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
    np.testing.assert_array_equal(tenv.joint_range.numpy(), tenv.physical_joint_range.numpy())
