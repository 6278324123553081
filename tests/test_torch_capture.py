"""torch port: the planner's units as captured CUDA graphs
(`planner/capture.py`): `reverse_once` and the control step on the fused
path, the env step on the physics pipeline and under compat_q1.

On the CPU (runs here):
- the choice: `capture=True` raises where capture cannot hold (a CPU env,
  a gloo process group), and holds on a CUDA env off the fused path and
  with compat_q1; "auto" runs eagerly on the CPU;
- the units through a stand-in for the CUDA graph
  (`torch_port_helpers.EagerGraph`: its capture runs the unit's function
  once on the static buffers and keeps the outputs, a replay runs it again
  and copies the results into those outputs, as a CUDA graph writes its
  buffers; `capture.Unit` puts back the launch counts the Python moved):
  `reverse_once` and the control step through their first (eager), second
  (capture) and later (replay) calls are equal to the eager planner's to
  the bit and leave the generator where the eager path leaves it; a 4-step
  `run` equals the eager `run` record for record (each record copied out of
  the graph's buffers) with the kernel launches `expected_launches` counts;
  another state layout raises;
- the same on go2_stand with fused="off" (the physics pipeline), where the
  graphs are env steps: the env's horizon step at B=Nsample+1 (the
  rollouts'), `step_lean` at B=1 (the executed step) and, under compat_q1,
  `env.step` at B=1 (its chain): the rollouts with and without their
  states, `reverse_once`, the control step, a 4-step `run` and
  `reverse_once_compat`, one capture per unit.
On the card (marked `cuda`, skipped without one; the file imports no jax,
so `python -m pytest --noconftest tests/test_torch_capture.py` runs it
there): the same equalities through real CUDA graphs at a small width, and
the launch counts.
Equalities are bit for bit (`torch.equal`): the same kernels on the same
inputs.
"""

import dataclasses
from types import SimpleNamespace

import pytest
import torch

from torch_port_helpers import use_eager_graphs
from tpu_dialmpc_torch.envs import get_env
from tpu_dialmpc_torch.envs.base import LeanEnvState, to_lean
from tpu_dialmpc_torch.planner import capture, runner
from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI

CFG = DialConfig(Nsample=8, Hsample=4, Hnode=2, Ndiffuse=2, Ndiffuse_init=3, seed=4)
PICK_CAPTURE = capture.pick_capture  # the rule itself: `standin` patches it


def expected_launches(cfg, n_steps):
    """The fused launches of `run`: the warm start's Ndiffuse-1
    reverse_once, the first step's B=1 step and Ndiffuse_init reverse_once,
    each later step's B=1 step and Ndiffuse reverse_once."""
    horizon = cfg.Hsample + 1
    return ((cfg.Ndiffuse - 1) * horizon + 1 + cfg.Ndiffuse_init * horizon
            + (n_steps - 1) * (1 + cfg.Ndiffuse * horizon))


class CountingPlain:
    """The env's FusedStep on the CPU (its plain version), with the launch
    count the kernel's wrapper keeps on the card (its wave count stays 0:
    the CPU has no SMs to fill)."""

    def __init__(self, fs):
        self.fs, self.spec, self.launches, self.waves = fs, fs.spec, 0, 0

    def __call__(self, *args):
        self.launches += 1
        return self.fs(*args)


@pytest.fixture(scope="module")
def env():
    e = get_env("go2_stand", device="cpu", n_substeps=1)
    e._fused_step = CountingPlain(e.fused_step)
    return e


@pytest.fixture()
def standin(monkeypatch):
    """Every planner built in the test captures, through `EagerGraph`s."""
    return use_eager_graphs(monkeypatch.setattr)


def _equal(a, b):
    la, lb = capture._flatten(a), capture._flatten(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ----------------------------------------------------------------------
def test_capture_true_raises_where_capture_cannot_hold():
    cpu = get_env("go2_stand", device="cpu", n_substeps=1)
    with pytest.raises(ValueError, match="not a CUDA device"):
        MBDPI(CFG, cpu, capture=True)
    with pytest.raises(ValueError, match="over a gloo process group"):
        capture.pick_capture(True, SimpleNamespace(device="cuda"), backend="gloo")
    assert capture.pick_capture("auto", SimpleNamespace(device="cuda"), backend="gloo") is False
    with pytest.raises(ValueError, match="expected one of"):
        MBDPI(CFG, cpu, capture="yes")


@pytest.mark.parametrize("case", ["the physics pipeline", "compat_q1"])
def test_pipeline_path_and_compat_q1_capture_on_a_cuda_env(case, standin):
    """Where capture was once refused (the physics pipeline, compat_q1), a
    CUDA env captures: `pick_capture` asks only for the device (and NCCL),
    and the planner's graphs are its env steps."""
    on_card = SimpleNamespace(device="cuda", on_fused_path=case == "compat_q1")
    assert PICK_CAPTURE(True, on_card) is True
    assert PICK_CAPTURE("auto", on_card, backend="nccl") is True
    if case == "compat_q1":
        env, cfg = get_env("go2_stand", device="cpu", n_substeps=1), \
            dataclasses.replace(CFG, compat_q1=True)
    else:
        env, cfg = get_env("go2_stand", device="cpu", n_substeps=1, fused="off"), CFG
    mb = MBDPI(cfg, env, capture=True)  # through the stand-in's choice
    assert mb.captured and not mb.graphs.whole
    assert MBDPI(CFG, get_env("go2_stand", device="cpu", n_substeps=1)).graphs.whole


def test_auto_runs_eagerly_on_the_cpu():
    cpu = get_env("go2_stand", device="cpu", n_substeps=1)
    for mode in ("auto", False):
        mb = MBDPI(CFG, cpu, capture=mode)
        assert mb.captured is False and mb.graphs is None
    assert runner.make_control_step(MBDPI(CFG, cpu), 2).__name__ == "control_step"


def _start(env):
    gen = torch.Generator().manual_seed(11)
    state = to_lean(env.reset(gen))
    Y = torch.linspace(-0.3, 0.3, (CFG.Hnode + 1) * env.action_size).reshape(
        CFG.Hnode + 1, env.action_size)
    return state, Y


def test_captured_reverse_once_equals_eager_and_leaves_the_generator_alike(env, standin):
    state, Y = _start(env)
    captured, eager = MBDPI(CFG, env), MBDPI(CFG, env, capture=False)
    assert captured.captured and not eager.captured
    scale = torch.as_tensor(captured.sigma_control, dtype=Y.dtype)
    gc, ge = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    outs = []
    for _ in range(4):  # eager first call, capture, replays
        got = captured.reverse_once(state, gc, Y, scale)
        want = eager.reverse_once(state, ge, Y, scale)
        assert _equal(got, want)
        outs.append(got)
        assert torch.equal(gc.get_state(), ge.get_state())
    assert not torch.equal(outs[0][0], outs[1][0])  # new noise every call
    (graph,) = standin
    assert (graph.captures, graph.replays) == (1, 3)
    # the copy-out: the first replay's outputs are not the graph's buffers
    assert _equal(outs[1], eager.reverse_once(state, None, Y, scale,
                                              noise=_noise(CFG, env, 5, 1)))
    # injected noise goes into the same graph
    noise = torch.randn((CFG.Nsample, CFG.Hnode + 1, env.action_size), dtype=Y.dtype)
    assert _equal(captured.reverse_once(state, None, Y, scale, noise=noise),
                  eager.reverse_once(state, None, Y, scale, noise=noise))
    assert graph.captures == 1
    # the warm start replays it
    assert torch.equal(captured.reverse(state, Y, gc), eager.reverse(state, Y, ge))


def _noise(cfg, env, seed, k):
    """The k-th draw (from 0) of MBDPI.draw_noise from a generator seeded
    with `seed`."""
    g = torch.Generator().manual_seed(seed)
    for _ in range(k + 1):
        n = torch.randn((cfg.Nsample, cfg.Hnode + 1, env.action_size), generator=g)
    return n


def test_captured_control_step_equals_eager(env, standin):
    state, Y = _start(env)
    captured, eager = MBDPI(CFG, env), MBDPI(CFG, env, capture=False)
    step_c = runner.make_control_step(captured, CFG.Ndiffuse)
    step_e = runner.make_control_step(eager, CFG.Ndiffuse)
    assert runner.make_control_step(captured, CFG.Ndiffuse) is not step_c
    gc, ge = torch.Generator().manual_seed(6), torch.Generator().manual_seed(6)
    sc, se, Yc, Ye = state, state, Y, Y
    for t in range(4):
        sc, Yc, ic = step_c(sc, Yc, gc)
        se, Ye, ie = step_e(se, Ye, ge)
        assert _equal((sc, Yc, ic), (se, Ye, ie)), t
        assert torch.equal(gc.get_state(), ge.get_state())
    # one graph for the planner's Ndiffuse steps, whichever wrapper calls it
    step_again = runner.make_control_step(captured, CFG.Ndiffuse)
    assert _equal(step_again(sc, Yc, gc), step_e(se, Ye, ge))
    (graph,) = standin
    assert (graph.captures, graph.replays) == (1, 4)


def test_captured_run_equals_eager_run_with_the_expected_launches(env, standin):
    n = 4
    env.fused_step.launches = 0
    eager = runner.run(env, CFG, n_steps=n, capture=False)
    assert env.fused_step.launches == expected_launches(CFG, n)
    env.fused_step.launches = 0
    captured = runner.run_scan(env, CFG, n_steps=n)
    assert env.fused_step.launches == expected_launches(CFG, n)
    for f in ("rewards", "dones", "qpos", "qvel", "us", "final_Y0", "qpos0"):
        assert torch.equal(getattr(captured, f), getattr(eager, f)), f
    assert not torch.equal(captured.qpos[-1], captured.qpos[-2])
    # the reverse warm start (one call) and the one Ndiffuse_init step ran
    # eagerly; the three Ndiffuse steps: warm, capture + replay, replay
    assert [(g.captures, g.replays) for g in standin] == [(0, 0), (0, 0), (1, 2)]


def test_another_state_layout_raises(env, standin):
    state, Y = _start(env)
    mb = MBDPI(CFG, env)
    scale = torch.as_tensor(mb.sigma_control, dtype=Y.dtype)
    mb.reverse_once(state, torch.Generator().manual_seed(0), Y, scale)
    wide = dataclasses.replace(state, info=dataclasses.replace(
        state.info, z_feet=torch.zeros(5, dtype=Y.dtype)))
    with pytest.raises(ValueError, match="captures one state layout"):
        mb.reverse_once(wide, torch.Generator().manual_seed(0), Y, scale)


# ----------------------------------------------------------------------
# the physics pipeline (fused="off"): the env step's graphs
@pytest.fixture(scope="module")
def off():
    return get_env("go2_stand", device="cpu", n_substeps=1, fused="off")


def _graphs_by_unit(mb, standin):
    """{unit name: its stand-in graph}; every unit's graph is one of
    `standin`'s."""
    by = {name: unit.graph for name, unit in mb.graphs.units.items()}
    assert all(any(g is h for h in standin) for g in by.values())
    return by


def test_pipeline_path_captured_rollouts_equal_eager(off, standin):
    """rollout_us_batch with and without the states, each horizon step of
    the env's rollout_batch a replay of the B=Nsample+1 graph (the first
    step of the first call eager, the second captured), equal the eager
    rollouts to the bit: the first state, a broadcast view, copied into the
    graph's buffers."""
    state, Y = _start(off)
    captured, eager = MBDPI(CFG, off), MBDPI(CFG, off, capture=False)
    assert captured.captured and not captured.graphs.whole
    us = torch.stack([captured.node2u(Y + 0.05 * k) for k in range(CFG.Nsample + 1)])
    for k in range(3):
        assert _equal(captured.rollout_us_batch(state, us + 0.01 * k),
                      eager.rollout_us_batch(state, us + 0.01 * k)), k
        assert _equal(captured.rollout_us_batch(state, us - 0.01 * k, want_states=True),
                      eager.rollout_us_batch(state, us - 0.01 * k, want_states=True)), k
    graph = _graphs_by_unit(captured, standin)["horizon step"]
    horizon = CFG.Hsample + 1
    assert (graph.captures, graph.replays) == (1, 6 * horizon - 1)
    assert list(captured.graphs.units) == ["horizon step"]


def test_pipeline_path_captured_reverse_once_and_control_step_equal_eager(off, standin):
    """reverse_once and chained control steps (the executed step through
    the B=1 graph of step_lean, from a full EnvState at first and its
    LeanEnvState after) equal the eager ones to the bit, the generators
    alike after; one capture per unit."""
    state, Y = _start(off)
    captured, eager = MBDPI(CFG, off), MBDPI(CFG, off, capture=False)
    scale = torch.as_tensor(captured.sigma_control, dtype=Y.dtype)
    gc, ge = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for _ in range(3):
        assert _equal(captured.reverse_once(state, gc, Y, scale),
                      eager.reverse_once(state, ge, Y, scale))
        assert torch.equal(gc.get_state(), ge.get_state())
    step_c = runner.make_control_step(captured, CFG.Ndiffuse)
    step_e = runner.make_control_step(eager, CFG.Ndiffuse)
    assert step_c.__name__ == "control_step"  # not a whole graph: its steps are
    full = off.reset(torch.Generator().manual_seed(11))
    sc, se, Yc, Ye = full, full, Y, Y
    for t in range(3):
        sc, Yc, ic = step_c(sc, Yc, gc)
        se, Ye, ie = step_e(se, Ye, ge)
        assert _equal((sc, Yc, ic), (se, Ye, ie)), t
        assert isinstance(sc, LeanEnvState)
        assert torch.equal(gc.get_state(), ge.get_state())
    graphs = _graphs_by_unit(captured, standin)
    assert list(graphs) == ["horizon step", "execute"]
    assert [(g.captures, g.replays) for g in graphs.values()] == [(1, 3 * 5 + 3 * 10 - 1),
                                                                   (1, 3 - 1)]
    assert captured.graphs.units["execute"].static[0].shape == (off.model.nq,)


def test_pipeline_path_captured_run_equals_eager_run(off, standin):
    n = 4
    eager = runner.run(off, CFG, n_steps=n, capture=False)
    captured = runner.run_scan(off, CFG, n_steps=n)
    assert captured.captured and not eager.captured
    for f in ("rewards", "dones", "qpos", "qvel", "us", "final_Y0", "qpos0"):
        assert torch.equal(getattr(captured, f), getattr(eager, f)), f
    assert _equal(captured.final_state, eager.final_state)
    assert [g.captures for g in standin] == [1, 1]


def test_pipeline_path_captured_reverse_once_compat_equals_eager(off, standin):
    """compat_q1's chain through its B=1 graph of env.step, in its
    sequential order: Ybar, info and the final chained physics equal the
    eager ones to the bit."""
    cfg = dataclasses.replace(CFG, compat_q1=True)
    state, Y = _start(off)
    captured, eager = MBDPI(cfg, off), MBDPI(cfg, off, capture=False)
    scale = torch.as_tensor(captured.sigma_control, dtype=Y.dtype)
    gc, ge = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    for _ in range(2):
        assert _equal(captured.reverse_once_compat(state, gc, Y, scale),
                      eager.reverse_once_compat(state, ge, Y, scale))
    assert torch.equal(gc.get_state(), ge.get_state())
    (graph,) = standin
    assert list(captured.graphs.units) == ["compat env.step"]
    calls = 2 * (CFG.Nsample + 1) * (CFG.Hsample + 1)
    assert (graph.captures, graph.replays) == (1, calls - 1)


def test_pipeline_path_another_layout_raises(off, standin):
    state, Y = _start(off)
    mb = MBDPI(CFG, off)
    scale = torch.as_tensor(mb.sigma_control, dtype=Y.dtype)
    mb.reverse_once(state, torch.Generator().manual_seed(0), Y, scale)
    us = torch.zeros((CFG.Nsample + 3, CFG.Hsample + 1, off.action_size))
    with pytest.raises(ValueError, match="captures one state layout"):
        mb.rollout_us_batch(state, us)


# ----------------------------------------------------------------------
# on the card
@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


CARD_CFG = DialConfig(Nsample=256, Hsample=8, Hnode=4, Ndiffuse=2, Ndiffuse_init=3, seed=2)


@pytest.mark.cuda
def test_on_the_card_captured_units_equal_eager(card):
    env = get_env("go2_stand", device=card, n_substeps=8)
    captured, eager = MBDPI(CARD_CFG, env), MBDPI(CARD_CFG, env, capture=False)
    assert captured.captured
    state = to_lean(env.reset())
    Y = torch.zeros((CARD_CFG.Hnode + 1, env.action_size), device=card)
    scale = torch.as_tensor(captured.sigma_control, dtype=Y.dtype, device=card)
    gc = torch.Generator(device=card).manual_seed(1)
    ge = torch.Generator(device=card).manual_seed(1)
    for _ in range(3):
        assert _equal(captured.reverse_once(state, gc, Y, scale),
                      eager.reverse_once(state, ge, Y, scale))
    step_c = runner.make_control_step(captured, CARD_CFG.Ndiffuse)
    step_e = runner.make_control_step(eager, CARD_CFG.Ndiffuse)
    sc, se, Yc, Ye = state, state, Y, Y
    for _ in range(3):
        sc, Yc, ic = step_c(sc, Yc, gc)
        se, Ye, ie = step_e(se, Ye, ge)
        assert _equal((sc, Yc, ic), (se, Ye, ie))
    assert torch.equal(gc.get_state(), ge.get_state())


@pytest.mark.cuda
def test_on_the_card_captured_run_scan_equals_eager_with_the_expected_launches(card):
    env = get_env("go2_stand", device=card, n_substeps=8)
    n = 3
    env.fused_step.launches = 0
    eager = runner.run_scan(env, CARD_CFG, n_steps=n, capture=False)
    assert env.fused_step.launches == expected_launches(CARD_CFG, n)
    env.fused_step.launches = 0
    captured = runner.run_scan(env, CARD_CFG, n_steps=n)
    torch.cuda.synchronize()
    assert env.fused_step.launches == expected_launches(CARD_CFG, n)
    for f in ("rewards", "dones", "qpos", "qvel", "us", "final_Y0"):
        assert torch.equal(getattr(captured, f), getattr(eager, f)), f


CARD_OFF_CFG = DialConfig(Nsample=64, Hsample=4, Hnode=2, Ndiffuse=2, Ndiffuse_init=3, seed=2)


@pytest.mark.cuda
def test_on_the_card_pipeline_path_captured_units_equal_eager(card):
    """go2_stand with fused="off", 2 substeps: the env-step graphs (the
    horizon step at B=65, step_lean at B=1) through real CUDA graphs,
    reverse_once and chained control steps bit-equal to the eager
    planner's, the generators alike."""
    env = get_env("go2_stand", device=card, n_substeps=2, fused="off")
    captured, eager = MBDPI(CARD_OFF_CFG, env), MBDPI(CARD_OFF_CFG, env, capture=False)
    assert captured.captured and not captured.graphs.whole
    state = env.reset()
    Y = torch.zeros((CARD_OFF_CFG.Hnode + 1, env.action_size), device=card)
    scale = torch.as_tensor(captured.sigma_control, dtype=Y.dtype, device=card)
    gc = torch.Generator(device=card).manual_seed(1)
    ge = torch.Generator(device=card).manual_seed(1)
    for _ in range(3):
        assert _equal(captured.reverse_once(state, gc, Y, scale),
                      eager.reverse_once(state, ge, Y, scale))
    step_c = runner.make_control_step(captured, CARD_OFF_CFG.Ndiffuse)
    step_e = runner.make_control_step(eager, CARD_OFF_CFG.Ndiffuse)
    sc, se, Yc, Ye = state, state, Y, Y
    for _ in range(3):
        sc, Yc, ic = step_c(sc, Yc, gc)
        se, Ye, ie = step_e(se, Ye, ge)
        assert _equal((sc, Yc, ic), (se, Ye, ie))
    assert torch.equal(gc.get_state(), ge.get_state())
    assert sorted(captured.graphs.units) == ["execute", "horizon step"]
    assert all(u.graph.capture_s is not None for u in captured.graphs.units.values())
