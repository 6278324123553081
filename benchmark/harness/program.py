"""The system under test: `tpu_dialmpc_torch`'s captured control step, built
from a configuration file, and the plain snapshots of its state and outputs
that the comparison reads.

This is the only module of the harness that imports the program, and it
imports it inside functions, so the rest of the harness and the reference
load without it.
"""

from __future__ import annotations

import dataclasses
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


def capture_seconds(prog) -> float | None:
    """Host seconds the planner's graphs took to capture and instantiate."""
    graphs = prog.mbdpi.graphs
    if graphs is None:
        return None
    spans = [(u.graph.capture_s, u.graph.instantiate_s) for u in graphs.units.values()]
    if not spans or any(c is None for pair in spans for c in pair):
        return None
    return sum(c + i for c, i in spans)


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
