"""torch port, systems/ and planner/cost_dial.py: the generic systems'
dynamics and costs and one `CostDialMPC.improve` against the JAX package on
the same inputs, in float64, and the planner's behaviour on its own.

`improve` is held against JAX's under JAX's own draws: the test splits the
key and draws each level's noise as `tpu_dialmpc/planner/cost_dial.py`
does, and injects the draws into the port.  Tolerances: 1e-12 on the
classic systems' dynamics and costs (the same formulas), 1e-9 on their
`improve` (the softmax of normalised costs amplifies rounding of the costs'
sum order a little), 1e-9 on the legged system's dynamics (one physics
step) and 1e-6 on its `improve` (20 rollouts of 4 physics steps each,
normalised and exponentiated).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_helpers import use_standin_assets
from tpu_dialmpc.planner import cost_dial as jcd
from tpu_dialmpc import systems as jsys
from tpu_dialmpc_torch import systems as tsys
from tpu_dialmpc_torch.planner import cost_dial as tcd

F64 = dict(device="cpu", dtype=torch.float64)
CLASSIC = {"pendulum": (jsys.InvertedPendulum, tsys.InvertedPendulum),
           "cartpole": (jsys.Cartpole, tsys.Cartpole)}


def _jax_draws(key, cfg, control_dim):
    """Each level's noise as JAX's improve draws it."""
    out = []
    for _ in range(cfg.diffusion_levels):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(
            sub, (cfg.num_samples, cfg.horizon, control_dim), jnp.float64)))
    return out


def _batch_matches(jsystem, tsystem, states, controls, tol):
    jd = jax.vmap(jsystem.dynamics)(jnp.asarray(states), jnp.asarray(controls))
    jc = jax.vmap(jsystem.running_cost)(jnp.asarray(states), jnp.asarray(controls))
    jt = jax.vmap(jsystem.terminal_cost)(jnp.asarray(states))
    ts, tu = torch.as_tensor(states), torch.as_tensor(controls)
    for got, want, name in ((tsystem.dynamics(ts, tu), jd, "dynamics"),
                            (tsystem.running_cost(ts, tu), jc, "running_cost"),
                            (tsystem.terminal_cost(ts), jt, "terminal_cost")):
        assert got.dtype == torch.float64, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=tol * max(1.0, np.abs(np.asarray(want)).max()),
                                   err_msg=name)


@pytest.mark.parametrize("name", sorted(CLASSIC))
def test_classic_dynamics_and_costs_match_jax(name):
    jcls, tcls = CLASSIC[name]
    js, ts = jcls(), tcls(**F64)
    rng = np.random.default_rng(0)
    states = rng.normal(size=(32, ts.state_dim)) * 2.0
    controls = rng.normal(size=(32, ts.control_dim)) * 3.0
    _batch_matches(js, ts, states, controls, 1e-12)
    assert (ts.state_dim, ts.control_dim, ts.dt) == (js.state_dim, js.control_dim, js.dt)


@pytest.mark.parametrize("name", sorted(CLASSIC))
def test_classic_improve_matches_jax_under_its_draws(name):
    jcls, tcls = CLASSIC[name]
    cfg = jcd.CostDialConfig(horizon=20, diffusion_levels=3, num_samples=64)
    js, ts = jcls(), tcls(**F64)
    x0 = np.array([0.3, -0.2] if ts.state_dim == 2 else [0.1, 0.0, 0.4, -0.1])
    seq0 = np.random.default_rng(1).normal(size=(cfg.horizon, ts.control_dim)) * 0.5
    key = jax.random.PRNGKey(3)
    want = jcd.CostDialMPC(js, cfg).improve(jnp.asarray(x0), jnp.asarray(seq0), key)
    noise = [torch.as_tensor(n) for n in _jax_draws(key, cfg, ts.control_dim)]
    got = tcd.CostDialMPC(ts, tcd.CostDialConfig(**cfg.__dict__)).improve(
        torch.as_tensor(x0), torch.as_tensor(seq0), None, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-9)
    assert np.abs(got.numpy() - seq0).max() > 1e-3  # it moved


def _legged(monkeypatch):
    use_standin_assets(monkeypatch)
    return jsys.LeggedRobot(), tsys.LeggedRobot(**F64)


def test_legged_dynamics_and_costs_match_jax(monkeypatch):
    js, ts = _legged(monkeypatch)
    m = ts.model
    rng = np.random.default_rng(2)
    home = np.asarray(m.key_qpos["home"])
    states = np.concatenate([home + np.r_[np.zeros(7), rng.normal(size=m.nq - 7) * 0.05],
                             np.zeros(m.nv)])[None].repeat(6, 0)
    states[:, m.nq:] = rng.normal(size=(6, m.nv)) * 0.3
    controls = rng.normal(size=(6, m.nu)) * 5.0
    _batch_matches(js, ts, states, controls, 1e-9)
    np.testing.assert_array_equal(np.diag(ts.Q.numpy()), np.diag(np.asarray(js.Q)))
    np.testing.assert_array_equal(np.diag(ts.Q_terminal.numpy()),
                                  np.diag(np.asarray(js.Q_terminal)))
    np.testing.assert_array_equal(ts.target_state.numpy(), np.asarray(js.target_state))


def test_legged_improve_matches_jax_under_its_draws(monkeypatch):
    js, ts = _legged(monkeypatch)
    cfg = jcd.CostDialConfig(horizon=4, diffusion_levels=2, num_samples=10)
    x0 = ts.target_state.numpy().copy()
    seq0 = np.zeros((cfg.horizon, ts.control_dim))
    key = jax.random.PRNGKey(5)
    want = jcd.CostDialMPC(js, cfg).improve(jnp.asarray(x0), jnp.asarray(seq0), key)
    noise = [torch.as_tensor(n) for n in _jax_draws(key, cfg, ts.control_dim)]
    got = tcd.CostDialMPC(ts, tcd.CostDialConfig(**cfg.__dict__)).improve(
        torch.as_tensor(x0), torch.as_tensor(seq0), None, noise=noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert np.abs(got.numpy()).max() > 1e-3


def test_pendulum_swing_up_and_improve_reduces_cost():
    """tests/test_cost_dial.py's pendulum cases on the port, with its own
    draws: the swing-up ends near (pi, 0), and one `improve` lowers the
    rollout cost of the zero sequence."""
    sys_ = tsys.InvertedPendulum(**F64)
    cfg = tcd.CostDialConfig(horizon=20, steps=60, diffusion_levels=3, num_samples=128)
    res = tcd.CostDialMPC(sys_, cfg).run([0.0, 0.0])
    assert res.trajectory.shape == (61, 2) and res.control_history.shape == (60, 1)
    assert res.costs.shape == (60,) and torch.isfinite(res.trajectory).all()
    theta, theta_dot = res.trajectory[-1].tolist()
    assert abs(theta - np.pi) < 0.35, theta
    assert abs(theta_dot) < 1.5

    cfg = tcd.CostDialConfig(horizon=15, diffusion_levels=4, num_samples=256)
    mpc = tcd.CostDialMPC(sys_, cfg)
    x0 = torch.zeros(2, dtype=torch.float64)
    zero = torch.zeros((cfg.horizon, 1), dtype=torch.float64)
    seq = mpc.improve(x0, zero, torch.Generator().manual_seed(0))
    c0 = float(mpc._rollout_cost(x0, zero[None])[0])
    c1 = float(mpc._rollout_cost(x0, seq[None])[0])
    assert c1 < c0
