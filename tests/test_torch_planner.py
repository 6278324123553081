"""torch port, planner/: MBDPI (reverse_once, reverse, improve) and the
control step on a linear stub env, against the JAX package's MBDPI on
tests/stub_env.py, with the same noise injected on both sides.

Tolerance 1e-12 (float64): the same formulas; torch and JAX sum the softmax
and the einsums in their own orders."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stub_env import StubFusedEnv
from torch_port_helpers import TorchStubEnv
from tpu_dialmpc.planner import dial as jdial
from tpu_dialmpc.planner import runner as jrunner
from tpu_dialmpc_torch.envs.base import to_lean
from tpu_dialmpc_torch.planner import dial as tdial
from tpu_dialmpc_torch.planner import runner as trunner

TOL = 1e-12
CFG = dict(Nsample=16, Hsample=6, Hnode=3, Ndiffuse=3, temp_sample=0.1,
           horizon_diffuse_factor=0.9)


def _planners(**over):
    kw = dict(CFG, **over)
    return (
        jdial.MBDPI(jdial.DialConfig(**kw), StubFusedEnv()),
        tdial.MBDPI(tdial.DialConfig(**kw), TorchStubEnv()),
    )


def _jax_state(qpos):
    s = StubFusedEnv().reset()
    return s._replace(pipeline=s.pipeline._replace(qpos=jnp.asarray(qpos)))


def _torch_state(qpos):
    s = TorchStubEnv().reset()
    return dataclasses.replace(
        s, pipeline=dataclasses.replace(s.pipeline, qpos=torch.as_tensor(qpos))
    )


def _inject(tmb, noises):
    """Feed the torch planner's candidate draws from a list of noises."""
    it = iter(noises)
    orig = tmb._candidates
    tmb._candidates = lambda gen, Y, scale, noise: orig(
        gen, Y, scale, torch.as_tensor(np.array(next(it)))
    )


def _jax_noises(key, n, mb):
    a = mb.args
    keys = jax.random.split(key, n)
    return [jax.random.normal(k, (a.Nsample, a.Hnode + 1, mb.nu), jnp.float64) for k in keys]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("score_std", ["sample", "time"])
def test_reverse_once_matches_jax(score_std):
    jmb, tmb = _planners(score_std=score_std)
    rng = np.random.default_rng(0)
    qpos = rng.normal(size=4)
    Y = rng.uniform(-0.5, 0.5, size=(CFG["Hnode"] + 1, 4))
    noise = rng.normal(size=(CFG["Nsample"], CFG["Hnode"] + 1, 4))
    scale = np.linspace(0.2, 1.0, CFG["Hnode"] + 1)
    jY, jinfo = jmb.reverse_once(_jax_state(qpos), None, jnp.asarray(Y),
                                 jnp.asarray(scale), noise=jnp.asarray(noise))
    tY, tinfo = tmb.reverse_once(_torch_state(qpos), None, torch.as_tensor(Y),
                                 torch.as_tensor(scale), noise=torch.as_tensor(noise))
    _close(tY, jY)
    for f in ("rews", "rew_Ybar", "weights", "ess", "entropy", "new_noise_scale"):
        _close(getattr(tinfo, f), getattr(jinfo, f))


def test_candidates_match_jax():
    jmb, tmb = _planners()
    rng = np.random.default_rng(1)
    Y = rng.uniform(-1, 1, size=(CFG["Hnode"] + 1, 4))
    noise = 3.0 * rng.normal(size=(CFG["Nsample"], CFG["Hnode"] + 1, 4))  # hits the clip
    scale = np.full(CFG["Hnode"] + 1, 0.7)
    want = jmb._candidates(None, jnp.asarray(Y), jnp.asarray(scale), jnp.asarray(noise))
    got = tmb._candidates(None, torch.as_tensor(Y), torch.as_tensor(scale),
                          torch.as_tensor(noise))
    _close(got, want)
    _close(tmb.node2u(got), jmb.node2u(want))
    _close(tmb.shift(torch.as_tensor(Y)), jmb.shift(jnp.asarray(Y)))


def test_improve_matches_jax():
    jmb, tmb = _planners()
    key = jax.random.PRNGKey(3)
    qpos = np.random.default_rng(2).normal(size=4)
    Y = np.random.default_rng(3).uniform(-0.5, 0.5, size=(CFG["Hnode"] + 1, 4))
    jY, jinfos = jmb.improve(_jax_state(qpos), jnp.asarray(Y), key, 2)
    _inject(tmb, _jax_noises(key, 2, jmb))
    tY, tinfos = tmb.improve(_torch_state(qpos), torch.as_tensor(Y), None, 2)
    _close(tY, jY)
    _close(tinfos.weights, jinfos.weights)
    _close(tinfos.new_noise_scale, jinfos.new_noise_scale)


def test_reverse_matches_jax():
    jmb, tmb = _planners()
    key = jax.random.PRNGKey(4)
    qpos = np.random.default_rng(4).normal(size=4)
    Y = np.zeros((CFG["Hnode"] + 1, 4))
    jY = jmb.reverse(_jax_state(qpos), jnp.asarray(Y), key)
    _inject(tmb, _jax_noises(key, CFG["Ndiffuse"] - 1, jmb))
    tY = tmb.reverse(_torch_state(qpos), torch.as_tensor(Y), None)
    _close(tY, jY)


def test_control_step_matches_jax():
    jmb, tmb = _planners()
    key = jax.random.PRNGKey(5)
    qpos = np.random.default_rng(5).normal(size=4)
    Y = np.random.default_rng(6).uniform(-0.5, 0.5, size=(CFG["Hnode"] + 1, 4))
    js, jY, jinfos = jrunner.make_control_step(jmb, 2)(_jax_state(qpos), jnp.asarray(Y), key)
    _inject(tmb, _jax_noises(key, 2, jmb))
    ts, tY, tinfos = trunner.make_control_step(tmb, 2)(_torch_state(qpos), torch.as_tensor(Y), None)
    _close(ts.pipeline.qpos, js.pipeline.qpos)
    _close(ts.reward, js.reward)
    _close(tY, jY)
    _close(tinfos.rews, jinfos.rews)


def test_generator_draws_are_reproducible():
    _, tmb = _planners()
    s = _torch_state(np.zeros(4))
    Y = torch.zeros(CFG["Hnode"] + 1, 4, dtype=torch.float64)
    outs = [tmb.improve(s, Y, torch.Generator().manual_seed(7), 2)[0] for _ in range(2)]
    assert torch.equal(outs[0], outs[1])
    other = tmb.improve(s, Y, torch.Generator().manual_seed(8), 2)[0]
    assert not torch.equal(outs[0], other)


def test_run_is_the_control_loop_written_out():
    """runner.run: reset, the reverse warm start, then Ndiffuse_init
    iterations in the first control step and Ndiffuse in the rest, all drawing
    from one generator seeded with cfg.seed."""
    cfg = tdial.DialConfig(**dict(CFG, Ndiffuse_init=4, seed=3))
    env = TorchStubEnv()
    res = trunner.run(env, cfg, n_steps=3)

    mb = tdial.MBDPI(cfg, env)
    gen = torch.Generator().manual_seed(cfg.seed)
    state = to_lean(env.reset())
    Y = mb.reverse(state, torch.zeros(CFG["Hnode"] + 1, 4, dtype=torch.float64), gen)
    rewards, us = [], []
    for t in range(3):
        us.append(Y[0])
        n_diffuse = cfg.Ndiffuse_init if t == 0 else cfg.Ndiffuse
        state, Y, _ = trunner.make_control_step(mb, n_diffuse)(state, Y, gen)
        rewards.append(state.reward)
    assert torch.equal(res.us, torch.stack(us))
    assert torch.equal(res.rewards, torch.stack(rewards))
    assert torch.equal(res.final_Y0, Y)
    assert torch.equal(res.qpos[-1], state.pipeline.qpos)
    assert res.qpos.shape == (3, 4) and torch.equal(res.qpos0, torch.zeros(4, dtype=torch.float64))


@pytest.mark.parametrize("flag", ["compat_q1", "diag_states"])
def test_unported_flags_raise(flag):
    """Both flags are ported now.  compat_q1: the candidates chained through
    env.step match the JAX planner's reverse_once_compat (rewards, Ybar and
    the final chained physics).  diag_states: the weighted rollout states
    match the JAX planner's, and Ybar is the plain one."""
    if flag == "compat_q1":
        jmb, tmb = _planners(compat_q1=True)
        rng = np.random.default_rng(10)
        qpos = rng.normal(size=4)
        Y = rng.uniform(-0.5, 0.5, size=(CFG["Hnode"] + 1, 4))
        noise = rng.normal(size=(CFG["Nsample"], CFG["Hnode"] + 1, 4))
        scale = np.linspace(0.2, 1.0, CFG["Hnode"] + 1)
        jY, jinfo, jphys = jmb.reverse_once_compat(_jax_state(qpos), None, jnp.asarray(Y),
                                                   jnp.asarray(scale), noise=jnp.asarray(noise))
        tY, tinfo, tphys = tmb.reverse_once_compat(_torch_state(qpos), None, torch.as_tensor(Y),
                                                   torch.as_tensor(scale),
                                                   noise=torch.as_tensor(noise))
        _close(tY, jY)
        _close(tinfo.rews, jinfo.rews)
        for got, want in zip(tphys, jphys):
            _close(got, want)
        return
    jmb, tmb = _planners(diag_states=True)
    _, plain = _planners()
    rng = np.random.default_rng(9)
    qpos = rng.normal(size=4)
    Y = rng.uniform(-0.5, 0.5, size=(CFG["Hnode"] + 1, 4))
    noise = rng.normal(size=(CFG["Nsample"], CFG["Hnode"] + 1, 4))
    scale = np.linspace(0.2, 1.0, CFG["Hnode"] + 1)
    jY, jinfo = jmb.reverse_once(_jax_state(qpos), None, jnp.asarray(Y),
                                 jnp.asarray(scale), noise=jnp.asarray(noise))
    outs = [mb.reverse_once(_torch_state(qpos), None, torch.as_tensor(Y),
                            torch.as_tensor(scale), noise=torch.as_tensor(noise))
            for mb in (tmb, plain)]
    (tY, tinfo), (pY, pinfo) = outs
    _close(tY, jY)
    assert torch.equal(tY, pY) and pinfo.qbar.shape == (1, 1)
    assert tinfo.qbar.shape == (CFG["Hsample"] + 1, 4) and tinfo.xbar.shape == (CFG["Hsample"] + 1, 3)
    for f in ("qbar", "qdbar", "xbar"):
        _close(getattr(tinfo, f), getattr(jinfo, f))


@pytest.mark.parametrize("score_std", ["sample", "time"])
def test_a_diverged_rollout_weighs_nothing(score_std):
    """A candidate whose rollout diverged (non-finite rewards: the physics
    blew up under it, in the JAX package's engine too) gets no weight, and
    the plan and the info stay finite; the other candidates' plan is the
    one the planner makes without that candidate, to float64 rounding.
    Finite inputs score as before, bit for bit (test_reverse_once_matches_jax)."""
    _, tmb = _planners(score_std=score_std)
    rng = np.random.default_rng(7)
    n, h = CFG["Nsample"], CFG["Hsample"]
    rewss = torch.as_tensor(rng.normal(-1.0, 0.3, (n + 1, h + 1)))
    all_Y0s = torch.as_tensor(rng.normal(0.0, 1.0, (n + 1, CFG["Hnode"] + 1, tmb.nu)))
    scale = torch.as_tensor(tmb.sigma_control)
    bad = rewss.clone()
    bad[3, 4:] = torch.nan
    bad[5, 2] = -torch.inf
    Ybar, info = tmb._score_update(bad, all_Y0s, scale)
    assert bool(torch.isfinite(Ybar).all()) and bool(torch.isfinite(info.weights).all())
    assert info.weights[3].item() < 1e-12 and info.weights[5].item() < 1e-12
    keep = [i for i in range(n + 1) if i not in (3, 5)]
    sub = dataclasses.replace(tmb.args, Nsample=n - 2)
    smb = tdial.MBDPI(sub, TorchStubEnv())
    if score_std == "time":  # no shared std: the other weights are exactly theirs
        want, _ = smb._score_update(rewss[keep], all_Y0s[keep], scale)
        _close(Ybar, want)
    else:  # the worst score stays in the std: close, not equal
        want, _ = smb._score_update(rewss[keep], all_Y0s[keep], scale)
        np.testing.assert_allclose(Ybar.numpy(), want.numpy(), rtol=0, atol=0.05)
