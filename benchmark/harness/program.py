"""The system under test: `tpu_dialmpc_torch`'s captured control step, built
from a configuration file, and the plain snapshots of its state and outputs
that the comparison reads.

This is the only module of the harness that imports the program, and it
imports it inside functions, so the rest of the harness and the reference
load without it.  The `spans_*` functions drive the program's tracer
(`tpu_dialmpc_torch/telemetry/spans.py`); on a program without it each
returns None.
"""

from __future__ import annotations

import dataclasses
import importlib
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark.harness.cells import ROOT


def build(config: dict, device, capture) -> SimpleNamespace:
    """The task's env and planner on `device` as the configuration states
    them, and the control step: `step(state, Y, noise)` -> (state', Y',
    infos), one CUDA graph replay where the planner captures."""
    from tpu_dialmpc_torch.envs.registry import get_env
    from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI
    from tpu_dialmpc_torch.planner.runner import make_control_step

    env_cfg = dict(config["env"])
    scene = Path(env_cfg["scene"])
    env_cfg["scene"] = str(scene if scene.is_absolute() else ROOT / scene)
    env = get_env(config["task"], device=device, **env_cfg)
    mbdpi = MBDPI(DialConfig(**config["planner"]), env, capture=capture)
    control_step = make_control_step(mbdpi, config["planner"]["Ndiffuse"])

    def step(state, Y, noise):
        return control_step(state, Y, None, noise=noise)

    return SimpleNamespace(env=env, mbdpi=mbdpi, step=step)


def reset(prog):
    """(the reset state as the control loop carries it, the zero plan)."""
    from tpu_dialmpc_torch.envs.base import to_lean

    state = to_lean(prog.env.reset())
    Y = torch.zeros((prog.mbdpi.args.Hnode + 1, prog.env.action_size),
                    dtype=state.pipeline.qpos.dtype, device=prog.mbdpi.device)
    return state, Y


def fused_launches(prog) -> int:
    """The program's count of physics-kernel launches (`FusedStep.launches`)."""
    return prog.env.fused_step.launches


def launch_counts(prog) -> dict:
    """The program's kernel launch counters by `<class>.<attribute>` (the
    env's `launch_counters()`: the physics kernel's and, on a CUDA Go2 env,
    the PD map's and reward stack's); {} where the env has none."""
    counters = getattr(prog.env, "launch_counters", None)
    if counters is None:
        return {}
    return {f"{type(o).__name__}.{a}": getattr(o, a) for o, a in counters()}


def capture_seconds(prog) -> float | None:
    """Host seconds the planner's graphs took to capture and instantiate."""
    graphs = prog.mbdpi.graphs
    if graphs is None:
        return None
    spans = [(u.graph.capture_s, u.graph.instantiate_s) for u in graphs.units.values()]
    if not spans or any(c is None for pair in spans for c in pair):
        return None
    return sum(c + i for c, i in spans)


def _tracer():
    """The program's tracer module, or None where the program has none."""
    name = "tpu_dialmpc_torch.telemetry.spans"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name is None or not (name + ".").startswith(e.name + "."):
            raise  # a module that the tracer itself imports is missing
        return None


def spans_on(device: bool) -> bool | None:
    """Turn the tracer on: its host spans, and its device spans too where
    `device` (a unit then replays its traced graph)."""
    tr = _tracer()
    if tr is None:
        return None
    tr.enable(device=device)
    return True


def spans_collect() -> int | None:
    """Read the device spans of every replay since the last collect (waits
    for the device); the replays that a later one overwrote unread."""
    tr = _tracer()
    return None if tr is None else tr.collect()


def spans_summary() -> dict | None:
    """Collect, then the spans since the last reset by path (count and host
    and self seconds of a host span, count and device seconds of a device
    span); the tracer starts afresh."""
    tr = _tracer()
    if tr is None:
        return None
    tr.collect()
    out = tr.summary()
    tr.reset()
    return out


def spans_off() -> bool | None:
    """Turn the tracer off and forget what it holds."""
    tr = _tracer()
    if tr is None:
        return None
    tr.disable()
    tr.reset()
    return True


def state_dict(state) -> dict:
    """A carried state's live fields as plain tensors: qpos, qvel, ws, the
    reward and the info fields by name."""
    ps = state.pipeline
    info = {f.name: getattr(state.info, f.name) for f in dataclasses.fields(state.info)}
    return dict(qpos=ps.qpos, qvel=ps.qvel, ws=ps.qacc_warmstart, reward=state.reward,
                info=info)


def outputs(out) -> dict:
    """A control step's outputs as plain tensors: the state, the plan, and
    each annealing iteration's mean rewards and weights."""
    state, Y, infos = out
    return dict(state=state_dict(state), Y=Y, rews=infos.rews, weights=infos.weights)


def non_finite(outs) -> int:
    """Control steps whose new plan or state holds a value that is not
    finite (one reduction per step, read back once)."""
    if not outs:
        return 0
    flags = torch.stack([~(torch.isfinite(Y).all() & torch.isfinite(st.pipeline.qpos).all()
                           & torch.isfinite(st.pipeline.qvel).all()) for st, Y, _ in outs])
    return int(flags.sum())
