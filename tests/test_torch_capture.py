"""torch port: `reverse_once` and the control step as captured CUDA graphs
(`planner/capture.py`).

On the CPU (runs here):
- the choice: `capture=True` raises where capture cannot hold (a CPU env,
  the physics pipeline, compat_q1), "auto" runs eagerly on the CPU;
- the units through a stand-in for the CUDA graph (`EagerGraph`: its
  capture runs the unit's function once on the static buffers and keeps the
  outputs, a replay runs it again and copies the results into those
  outputs, as a CUDA graph writes its buffers, and puts back the launch
  counts the Python moved): `reverse_once` and the control step through
  their first (eager), second (capture) and later (replay) calls are equal
  to the eager planner's to the bit and leave the generator where the eager
  path leaves it; a 4-step `run` equals the eager `run` record for record
  (each record copied out of the graph's buffers) with the kernel launches
  `expected_launches` counts; another state layout raises.
On the card (marked `cuda`, skipped without one; the file imports no jax,
so `python -m pytest --noconftest tests/test_torch_capture.py` runs it
there): the same equalities through real CUDA graphs at a small width, and
the launch counts.
Equalities are bit for bit (`torch.equal`): the same kernels on the same
inputs.
"""

import dataclasses

import pytest
import torch

from tpu_dialmpc_torch.envs import get_env
from tpu_dialmpc_torch.envs.base import to_lean
from tpu_dialmpc_torch.planner import capture, runner
from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI

CFG = DialConfig(Nsample=8, Hsample=4, Hnode=2, Ndiffuse=2, Ndiffuse_init=3, seed=4)


def expected_launches(cfg, n_steps):
    """The fused launches of `run`: the warm start's Ndiffuse-1
    reverse_once, the first step's B=1 step and Ndiffuse_init reverse_once,
    each later step's B=1 step and Ndiffuse reverse_once."""
    horizon = cfg.Hsample + 1
    return ((cfg.Ndiffuse - 1) * horizon + 1 + cfg.Ndiffuse_init * horizon
            + (n_steps - 1) * (1 + cfg.Ndiffuse * horizon))


class CountingPlain:
    """The env's FusedStep on the CPU (its plain version), with the launch
    count the kernel's wrapper keeps on the card."""

    def __init__(self, fs):
        self.fs, self.spec, self.launches = fs, fs.spec, 0

    def __call__(self, *args):
        self.launches += 1
        return self.fs(*args)


class EagerGraph:
    """A stand-in for `capture.CudaGraph` (module docstring)."""

    def __init__(self, counters):
        self.counters = counters
        self.fn = self.out = None
        self.captures = self.replays = 0

    def warm(self, fn):
        return fn()

    def capture(self, fn):
        self.fn, self.captures = fn, self.captures + 1
        self.out = fn()
        return self.out

    def replay(self):
        counts = [c.launches for c in self.counters]
        new = capture._flatten(self.fn())
        for dst, src in zip(capture._flatten(self.out), new):
            dst.copy_(src)
        for c, n in zip(self.counters, counts):  # a replay runs no Python
            c.launches = n
        self.replays += 1


@pytest.fixture(scope="module")
def env():
    e = get_env("go2_stand", device="cpu", n_substeps=1)
    e._fused_step = CountingPlain(e.fused_step)
    return e


@pytest.fixture()
def standin(monkeypatch, env):
    """Every planner built in the test captures, through `EagerGraph`s."""
    graphs = []

    def make(device):
        graphs.append(EagerGraph([env.fused_step]))
        return graphs[-1]

    monkeypatch.setattr(capture, "pick_capture", lambda mode, env, cfg: mode is not False)
    monkeypatch.setattr(capture, "CudaGraph", make)
    return graphs


def _equal(a, b):
    la, lb = capture._flatten(a), capture._flatten(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


# ----------------------------------------------------------------------
def test_capture_true_raises_where_capture_cannot_hold():
    cpu = get_env("go2_stand", device="cpu", n_substeps=1)
    with pytest.raises(ValueError, match="not a CUDA device"):
        MBDPI(CFG, cpu, capture=True)
    off = get_env("go2_stand", device="cpu", n_substeps=1, fused="off")
    with pytest.raises(ValueError, match="fused substep's path"):
        MBDPI(CFG, off, capture=True)
    with pytest.raises(ValueError, match="compat_q1"):
        MBDPI(dataclasses.replace(CFG, compat_q1=True), cpu, capture=True)
    with pytest.raises(ValueError, match="expected one of"):
        MBDPI(CFG, cpu, capture="yes")


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
