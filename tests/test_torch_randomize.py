"""torch port, `randomize_tasks` on the Go2 and H1 envs: the command redrawn
every 500 steps from the episode's seed (a counter-based hash of (seed,
step), `envs/legged.py:command_uniforms`), in place of the JAX package's
PRNG key split every step.

The draws cannot equal JAX's threefry draws and are not held to them.  What
is held against JAX: the schedule (a redraw exactly at step % 500 == 0), the
ranges (Go2: lin x ±1.5, lin y ±0.5, yaw rate ±1.5; H1: ±1.0, ±0.5, ±1.0),
and, on every step that is not a redraw, the reward stack, termination and
info update of JAX's `randomize_tasks=True` env given the same carried
command (float64, tolerance 1e-12: the same formulas).  Also: every rollout
candidate and the executed step see the same command at a redraw, and a
checkpoint carries the seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_env as go2_case
import test_torch_h1_env as h1_case
from tpu_dialmpc.envs.base import StateInfo as JStateInfo
from tpu_dialmpc_torch import checkpoint
from tpu_dialmpc_torch.envs import get_env
from tpu_dialmpc_torch.envs.base import StateInfo, to_lean
from tpu_dialmpc_torch.planner.dial import DialConfig

TOL = 1e-12
ENVS = {
    "go2": (go2_case, "go2_stand", (1.5, 0.5, 1.5)),
    "h1": (h1_case, h1_case.TASK, (1.0, 0.5, 1.0)),
}


def _port_info(info, seeds):
    return StateInfo(**{k: torch.as_tensor(v) for k, v in info.items()},
                     seed=torch.as_tensor(seeds, dtype=torch.int64))


@pytest.mark.parametrize("robot", sorted(ENVS))
def test_redraws_exactly_every_500_steps_within_the_ranges(robot):
    case, task, ranges = ENVS[robot]
    env = get_env(task, device="cpu", dtype="float64", randomize_tasks=True)
    assert env.COMMAND_RANGE == ranges
    arrays, info = case._inputs(env, seed=7)
    B = case.B
    steps = np.array([0, 500, 1000, 1500, 499, 501, 1, 250, 999, 1001, 2000, 2500, 17, 750,
                      3000, 3499, 4000, 4500, 4999, 5000, 5001, 333, 1250, 2499][:B],
                     dtype=np.int32)
    assert steps.shape == (B,)
    info["step"] = steps
    seeds = np.arange(B) * 7919 + 3
    _, _, out = env._post_physics(**{k: torch.as_tensor(v) for k, v in arrays.items()},
                                  info=_port_info(info, seeds))
    redraw = steps % 500 == 0
    vel, ang = out.vel_tar.numpy(), out.ang_vel_tar.numpy()
    np.testing.assert_array_equal(vel[~redraw], info["vel_tar"][~redraw])
    np.testing.assert_array_equal(ang[~redraw], info["ang_vel_tar"][~redraw])
    want_vel, want_ang = env.sample_command(torch.as_tensor(seeds), torch.as_tensor(steps))
    np.testing.assert_array_equal(vel[redraw], want_vel.numpy()[redraw])
    np.testing.assert_array_equal(ang[redraw], want_ang.numpy()[redraw])
    assert (vel[redraw, 2] == 0).all() and (ang[redraw, :2] == 0).all()
    np.testing.assert_array_equal(out.seed.numpy(), seeds)  # carried as it is

    # the ranges: 4096 episodes' first draws fill each interval
    n = 4096
    vel, ang = env.sample_command(torch.arange(n) * 104729 + 11, torch.zeros(n, dtype=torch.int32))
    draws = torch.stack([vel[:, 0], vel[:, 1], ang[:, 2]], dim=1).numpy()
    for k, r in enumerate(ranges):
        assert (-r <= draws[:, k]).all() and (draws[:, k] < r).all(), k
        assert draws[:, k].min() < -0.99 * r and draws[:, k].max() > 0.99 * r, k
        assert abs(draws[:, k].mean()) < 0.05 * r, k
    # the three components are not one draw scaled
    assert abs(np.corrcoef(draws.T)[np.triu_indices(3, 1)]).max() < 0.1
    # a redraw 500 steps later is another command
    vel2, _ = env.sample_command(torch.arange(n) * 104729 + 11, torch.full((n,), 500))
    assert (vel2 != vel).any(dim=1).all()


@pytest.mark.parametrize("robot,overrides", [
    ("go2", {}), ("go2", dict(goal_x=0.01)), ("h1", {}),
], ids=["go2_stand", "go2_goal_x", "h1_push_crate"])
def test_steps_off_the_redraw_match_the_jax_env(monkeypatch, robot, overrides):
    case = ENVS[robot][0]
    jenv, tenv = case._envs(monkeypatch, dict(overrides, randomize_tasks=True))
    arrays, info = case._inputs(tenv, seed=11)
    B = case.B
    rng = np.random.default_rng(12)
    info["step"] = (rng.integers(1, 500, size=B) + 500 * rng.integers(0, 4, size=B)).astype(np.int32)
    jinfo = JStateInfo(rng=jax.random.split(jax.random.PRNGKey(0), B),
                       **{k: jnp.asarray(v) for k, v in info.items()})
    jr, jd, jinfo2 = jax.vmap(
        lambda a, i: jenv._post_physics(**a, info=i)
    )({k: jnp.asarray(v) for k, v in arrays.items()}, jinfo)
    tr, td, tinfo2 = tenv._post_physics(**{k: torch.as_tensor(v) for k, v in arrays.items()},
                                        info=_port_info(info, rng.integers(0, 2**40, size=B)))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=TOL)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for f in dataclasses.fields(StateInfo):
        if f.name == "seed":
            continue
        got, want = getattr(tinfo2, f.name).numpy(), np.asarray(getattr(jinfo2, f.name))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=f.name)
    # the carried command is what both envs used (goal gating aside)
    np.testing.assert_array_equal(tinfo2.ang_vel_tar.numpy(), info["ang_vel_tar"])


@pytest.mark.parametrize("robot", sorted(ENVS))
def test_rollout_candidates_and_the_executed_step_agree_at_a_redraw(robot):
    """From a state at step 498: the executed step_lean (steps 498, 499,
    500) and every candidate of a rollout_batch over 4 steps see the same
    command at step 500, the seed's draw, and not the carried one."""
    _, task, _ = ENVS[robot]
    env = get_env(task, device="cpu", n_substeps=1, randomize_tasks=True)
    gen = torch.Generator().manual_seed(4)
    start = to_lean(env.reset(gen))
    assert int(start.info.seed) != 0
    start = dataclasses.replace(start, info=dataclasses.replace(
        start.info, step=torch.tensor(498, dtype=torch.int32),
        vel_tar=torch.tensor([0.2, -0.1, 0.0]), ang_vel_tar=torch.tensor([0.0, 0.0, 0.3])))

    seen = []  # (step, vel_tar, ang_vel_tar) of every _post_physics call
    post = env._post_physics

    def recording(**kw):
        reward, done, info2 = post(**kw)
        seen.append((kw["info"].step.clone(), info2.vel_tar.clone(), info2.ang_vel_tar.clone()))
        return reward, done, info2

    env._post_physics = recording
    state = start
    for _ in range(3):
        state = env.step_lean(state, torch.zeros(env.action_size))
    executed = [(int(s), v[0], a[0]) for s, v, a in seen]  # step_lean runs at B=1
    seen.clear()
    us = torch.rand((5, 4, env.action_size), generator=gen) * 0.6 - 0.3
    env.rollout_batch(start, us)
    rolled = seen

    want_vel, want_ang = env.sample_command(start.info.seed, torch.tensor(500))
    assert [s for s, _, _ in executed] == [498, 499, 500]
    assert torch.equal(executed[1][1], start.info.vel_tar)  # carried before 500
    assert torch.equal(executed[2][1], want_vel) and torch.equal(executed[2][2], want_ang)
    assert not torch.equal(want_vel, start.info.vel_tar)
    assert [s.tolist() for s, _, _ in rolled] == [[t] * 5 for t in (498, 499, 500, 501)]
    for t in (2, 3):  # step 500 and the one after: the drawn command, carried
        _, vel, ang = rolled[t]
        assert torch.equal(vel, want_vel.expand(5, 3)) and torch.equal(ang, want_ang.expand(5, 3))


def test_reset_draws_the_seed_and_a_checkpoint_carries_it(tmp_path):
    env = get_env("go2_stand", device="cpu", n_substeps=1, randomize_tasks=True)
    a = env.reset(torch.Generator().manual_seed(1)).info.seed
    b = env.reset(torch.Generator().manual_seed(2)).info.seed
    assert a.dtype == torch.int64 and a.shape == () and int(a) != int(b)
    assert int(env.reset().info.seed) == 0  # no generator: seed 0
    plain = get_env("go2_stand", device="cpu", n_substeps=1)
    gen = torch.Generator().manual_seed(1)
    assert int(plain.reset(gen).info.seed) == 0  # no randomize_tasks: no draw
    assert torch.equal(gen.get_state(), torch.Generator().manual_seed(1).get_state())

    cfg = DialConfig(Nsample=4, Hsample=2, Hnode=1)
    state = env.reset(torch.Generator().manual_seed(1))
    path = str(tmp_path / "ck.npz")
    checkpoint.save(path, state, torch.zeros((2, env.action_size)), torch.Generator(), cfg, 0)
    loaded = checkpoint.load(path, env)[0]
    assert torch.equal(loaded.info.seed, state.info.seed)
    # a checkpoint written before the seed existed loads with seed 0
    with np.load(path) as f:
        old = {k: f[k] for k in f.files if k != "info_seed"}
    np.savez(path, **old)
    assert int(checkpoint.load(path, env)[0].info.seed) == 0
