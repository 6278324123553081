"""torch port: the tracer (`telemetry/spans.py`) and its spans in the
control step, on the CPU.

- One control step at N8/H4/Hnode2, one substep, gives the span tree the
  layers' boundaries make: `execute{ctrl,physics,reward}`, `shift`, then
  per annealing iteration `candidates`, (H+1) x `rollout{ctrl,physics,
  reward}` and `score_update`, each with its parent; a capture makes the
  marks the sharing rule says (a horizon step's ctrl, physics and reward on
  three new marks, and its end).
- Under the stand-in graph of `test_torch_capture.py` (a replay runs the
  captured function again), a unit's own graph is captured with device
  spans held off, and a second one holds them: its replays are counted to
  the spans it owns, read at `collect`, and a replay not collected is
  reported unread; with host spans alone the unit replays its own graph.
- With the tracer off nothing is recorded and a captured unit owns no span.
- Outputs are bit-equal with the tracer on and off.
- The set-up spans appear once per env and per unit; host self time.
Device spans here run on the host clock (CPU ops are synchronous); the card's
events are held in tests/test_torch_cuda.py.
"""

import collections
import time

import pytest
import torch

from torch_port_helpers import use_eager_graphs
from tpu_dialmpc_torch.envs import get_env
from tpu_dialmpc_torch.envs.base import to_lean
from tpu_dialmpc_torch.planner import capture, runner
from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI
from tpu_dialmpc_torch.telemetry import spans

CFG = DialConfig(Nsample=8, Hsample=4, Hnode=2, Ndiffuse=2, Ndiffuse_init=3, seed=3)
H = CFG.Hsample + 1  # horizon steps per rollout


@pytest.fixture()
def tracer():
    spans.reset()
    spans.enable()
    yield spans
    spans.disable()
    spans.reset()


@pytest.fixture(scope="module")
def env():
    return get_env("go2_stand", device="cpu", n_substeps=1)


def _start(env):
    gen = torch.Generator().manual_seed(7)
    state = to_lean(env.reset(gen))
    Y = torch.linspace(-0.2, 0.2, (CFG.Hnode + 1) * env.action_size).reshape(
        CFG.Hnode + 1, env.action_size)
    return state, Y, gen


def _tree():
    """The control step's spans, (path, parent) in the order they open."""
    step = [("execute", None)] + [(f"execute/{c}", "execute")
                                  for c in ("ctrl", "physics", "reward")]
    step.append(("shift", None))
    horizon = [("rollout", None)] + [(f"rollout/{c}", "rollout")
                                     for c in ("ctrl", "physics", "reward")]
    for _ in range(CFG.Ndiffuse):
        step += [("candidates", None)] + horizon * H + [("score_update", None)]
    return step


def _equal(a, b):
    la, lb = capture._flatten(a), capture._flatten(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def test_control_step_gives_the_span_tree(env, tracer):
    state, Y, gen = _start(env)
    step = runner.make_control_step(MBDPI(CFG, env, capture=False), CFG.Ndiffuse)
    tracer.reset()
    step(state, Y, gen)
    assert [(r.path, r.parent) for r in tracer.records()] == _tree()
    assert all(r.device and r.end >= r.start for r in tracer.records())
    assert tracer.collect() == 0
    got = tracer.summary()
    want = collections.Counter(p for p, _ in _tree())
    assert {p: s["count"] for p, s in got.items()} == dict(want)
    assert all(s["device_s"] > 0 for s in got.values())
    for parent in ("execute", "rollout"):
        kids = sum(got[f"{parent}/{c}"]["device_s"] for c in ("ctrl", "physics", "reward"))
        assert kids <= got[parent]["device_s"]


def test_a_capture_shares_the_marks_of_spans_that_follow_each_other(env, tracer):
    """Marks of one control step recorded as a capture records them: the
    first child on its parent's start, a sibling on the one before's end,
    at the top level only a rollout on the rollout before it."""
    state, Y, gen = _start(env)
    step = runner.make_control_step(MBDPI(CFG, env, capture=False), CFG.Ndiffuse)
    with tracer.capturing() as owned:
        step(state, Y, gen)
    per_iteration = 2 + (1 + 4 * H) + 2  # candidates, rollouts, score_update
    assert len(owned.marks) == 5 + 2 + CFG.Ndiffuse * per_iteration
    assert len(owned.entries) == len(_tree())
    entries = {}
    for path, start, end in owned.entries:
        entries.setdefault(path, []).append((start, end))
    (ex,), (ctrl,), (phys,), (rew,) = (entries[p] for p in (
        "execute", "execute/ctrl", "execute/physics", "execute/reward"))
    assert ctrl[0] is ex[0] and phys[0] is ctrl[1] and rew[0] is phys[1] and ex[1] is not rew[1]
    rollouts = entries["rollout"]
    assert all(rollouts[t][0] is rollouts[t - 1][1] for t in range(1, H))
    assert rollouts[H][0] is not rollouts[H - 1][1]  # the next iteration's first
    assert entries["shift"][0][0] is not ex[1]
    assert tracer.collect() == 0 and tracer.summary() == {}  # a capture's spans are owned


def test_replays_are_counted_to_the_captured_unit(env, tracer, monkeypatch):
    graphs = use_eager_graphs(monkeypatch.setattr)
    state, Y, gen = _start(env)
    mb = MBDPI(CFG, env)
    step = runner.make_control_step(mb, CFG.Ndiffuse)
    step(state, Y, gen)  # eager first call: its spans as they run
    step(state, Y, gen)  # the unit's graph, spans held; the traced one, owned
    (unit,) = mb.graphs.units.values()
    assert graphs == [unit.graph, unit.traced]
    assert len(unit.owned.entries) == len(_tree())
    assert [g.replays for g in graphs] == [0, 1]
    # Python's records: the eager call, the traced capture and its replay
    assert sum(r.path == "execute" for r in tracer.records()) == 3
    tracer.collect()
    first = tracer.summary()
    assert first["execute"]["count"] == 2  # the eager call and the first replay
    tracer.reset()
    for _ in range(2):
        step(state, Y, gen)
        assert tracer.collect() == 0
    got = tracer.summary()
    assert {p: s["count"] for p, s in got.items() if "device_s" in s} == {
        p: 2 * n for p, n in collections.Counter(p for p, _ in _tree()).items()}
    assert all(s["device_s"] > 0 for s in got.values() if "device_s" in s)
    assert got["graph/load"]["count"] == got["graph/clone"]["count"] == 2
    step(state, Y, gen)
    step(state, Y, gen)
    assert tracer.collect() == 1  # one replay's marks were stamped over
    assert tracer.summary()["execute"]["count"] == 2 * 1 + 1


def test_host_spans_alone_replay_the_units_own_graph(env, tracer, monkeypatch):
    graphs = use_eager_graphs(monkeypatch.setattr)
    tracer.enable(device=False)
    assert tracer.span("x", device=torch.device("cpu")) is tracer.NOOP
    state, Y, gen = _start(env)
    step = runner.make_control_step(MBDPI(CFG, env), CFG.Ndiffuse)
    for _ in range(3):
        step(state, Y, gen)
    assert len(graphs) == 1 and graphs[0].replays == 2
    tracer.collect()
    got = tracer.summary()
    assert sorted(got) == ["graph/clone", "graph/load", "setup/first_call"]
    assert got["graph/load"]["count"] == 3 and got["setup/first_call"]["count"] == 1


def test_with_the_tracer_off_nothing_is_recorded(env, monkeypatch):
    spans.reset()
    assert not spans.enabled() and spans.span("x") is spans.NOOP
    assert spans.span("x", device=torch.device("cpu")) is spans.NOOP
    use_eager_graphs(monkeypatch.setattr)
    state, Y, gen = _start(env)
    mb = MBDPI(CFG, env)
    step = runner.make_control_step(mb, CFG.Ndiffuse)
    for _ in range(3):
        step(state, Y, gen)
    get_env("go2_stand", device="cpu", n_substeps=1)
    assert spans.collect() == 0
    assert spans.summary() == {} and spans.records() == []
    assert all(u.owned is None and u.traced is None for u in mb.graphs.units.values())


@pytest.mark.parametrize("captured", [False, True])
def test_outputs_are_bit_equal_with_the_tracer_on_and_off(env, captured, monkeypatch):
    if captured:
        use_eager_graphs(monkeypatch.setattr)
    outs = {}
    for on in (False, True):
        spans.reset()
        (spans.enable if on else spans.disable)()
        try:
            state, Y, gen = _start(env)
            mb = MBDPI(CFG, env, capture=captured)
            step = runner.make_control_step(mb, CFG.Ndiffuse)
            scale = torch.as_tensor(mb.sigma_control, dtype=Y.dtype)
            got = []
            for _ in range(3):
                state, Y, info = step(state, Y, gen)
                got.append((state, Y, info, mb.reverse_once(state, gen, Y, scale)))
            outs[on] = got
        finally:
            spans.disable()
            spans.reset()
    assert _equal(outs[False], outs[True])


def test_setup_spans_once_per_env_and_unit(tracer, monkeypatch):
    use_eager_graphs(monkeypatch.setattr)
    env = get_env("go2_stand", device="cpu", n_substeps=1)
    state, Y, gen = _start(env)
    mb = MBDPI(CFG, env)
    step = runner.make_control_step(mb, CFG.Ndiffuse)
    scale = torch.as_tensor(mb.sigma_control, dtype=Y.dtype)
    for _ in range(3):
        step(state, Y, gen)
        mb.reverse_once(state, gen, Y, scale)
    got = tracer.summary()
    assert got["setup/env"]["count"] == 1 and len(mb.graphs.units) == 2
    assert got["setup/first_call"]["count"] == 2
    for name in ("setup/env", "setup/first_call"):
        assert 0 < got[name]["self_s"] <= got[name]["host_s"]
    first_calls = [r for r in tracer.records() if r.path == "setup/first_call"]
    inside = [r for r in tracer.records()
              if r.parent == "setup/first_call" and r.path == "execute"]
    assert len(first_calls) == 2 and len(inside) == 1


def test_host_self_time_leaves_out_the_host_spans_inside(tracer):
    with tracer.span("outer"):
        with tracer.span("inner"):
            pass
        t0 = time.perf_counter()
        t1 = time.perf_counter()
        tracer.record_host("timed", t0, t1)
    got = tracer.summary()
    outer, inner = got["outer"], got["inner"]
    assert outer["self_s"] == pytest.approx(outer["host_s"] - inner["host_s"] - (t1 - t0))
    assert got["timed"] == dict(count=1, host_s=t1 - t0, self_s=t1 - t0)
    assert [(r.path, r.parent) for r in tracer.records()] == [
        ("outer", None), ("inner", "outer"), ("timed", "outer")]
