"""torch port: no host data and no host read inside a warm `reverse_once` or
control step, on every fused path, and inside a warm batched horizon step
(`horizon_step`), `reverse_once` and control step on the physics pipeline (what a CUDA graph
of each needs, and what keeps the host out of the horizon loop).

A `TorchFunctionMode` records, inside the window:
- `torch.tensor`, `torch.as_tensor`, `torch.asarray` or `Tensor.new_tensor`
  of data that is not a tensor (a host-to-device copy on the card);
- `Tensor.item`, `.tolist`, `.cpu`, `.numpy`, `bool()`, `float()`,
  `int()` (a device-to-host read);
- `__getitem__` / `__setitem__` with a list or an ndarray in the index
  (PyTorch builds the index on the host and copies it).

On the CPU the fused substep runs its plain version, which the card does
not run (the kernel takes its place): the recorder is paused inside it.
The physics pipeline is the code the card runs, so nothing is paused there:
go2_stand with fused="off", and the pair-kinds scene (sphere-sphere,
sphere-capsule and capsule-capsule pairs, which the fused substep lacks).
Tiny widths (N8/H4/Hnode2, 1 substep); the window is the second call of
each unit, the first one having made every cached constant.  With the
tracer on (`telemetry/spans.py`) its spans add neither, on either physics.
"""

import traceback

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from tpu_dialmpc_torch.envs import get_env
from tpu_dialmpc_torch.envs.base import map_tensors, to_lean
from tpu_dialmpc_torch.planner.dial import DialConfig, MBDPI
from tpu_dialmpc_torch.planner.runner import make_control_step
from tpu_dialmpc_torch.telemetry import spans

H1_2_WALK = "tests/assets/unitree_h1/mjx_scene_h1_2_walk.xml"

_DATA = {torch.tensor: 0, torch.as_tensor: 0, torch.asarray: 0, torch.Tensor.new_tensor: 1}
_READS = {torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.cpu, torch.Tensor.numpy,
          torch.Tensor.__bool__, torch.Tensor.__float__, torch.Tensor.__int__,
          torch.Tensor.__index__}
_INDEX = {torch.Tensor.__getitem__, torch.Tensor.__setitem__}


def _host_index(idx) -> bool:
    parts = idx if isinstance(idx, tuple) else (idx,)
    return any(isinstance(p, (list, np.ndarray)) for p in parts)


class HostUses(TorchFunctionMode):
    """Records every use of host data or host read (module docstring), with
    where it was made; `paused` turns it off."""

    def __init__(self):
        super().__init__()
        self.uses = []
        self.paused = False

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.paused:
            what = None
            if func in _DATA:
                data = args[_DATA[func]] if len(args) > _DATA[func] else kwargs.get("data")
                if not isinstance(data, torch.Tensor):
                    what = f"{func.__name__} of {type(data).__name__}"
            elif func in _READS:
                what = func.__name__
            elif func in _INDEX and _host_index(args[1]):
                what = f"{func.__name__} with a host index"
            if what is not None:
                where = traceback.extract_stack(limit=4)[-3]
                self.uses.append(f"{what} at {where.filename}:{where.lineno}")
        return func(*args, **kwargs)


class _PausedPlain:
    """The env's FusedStep with the recorder paused inside its plain version
    (the kernel takes its place on the card)."""

    def __init__(self, fs, probe):
        self.fs, self.probe = fs, probe
        self.spec = fs.spec

    def __call__(self, *args):
        self.probe.paused = True
        try:
            return self.fs(*args)
        finally:
            self.probe.paused = False


PATHS = {
    "go2_stand": ("go2_stand", {}),
    "go2_crate_climb": ("go2_crate_climb", {}),
    "go2_trot_position": ("go2_trot_position", {}),
    "go2_turn_randomized": ("go2_turn", {"randomize_tasks": True}),
    "h1_walk": ("h1_walk", {}),
    "h1_loco": ("h1_loco", {}),
    "h1_push_crate": ("h1_push_crate", {}),
    "h1_walk[h1_2_walk]": ("h1_walk", {"scene": H1_2_WALK}),
}
CFG = DialConfig(Nsample=8, Hsample=4, Hnode=2, Ndiffuse=2, Ndiffuse_init=3, seed=0)


def _windows(env, probe, batch_step=False):
    """A warm reverse_once and a warm control step, each recorded alone, and
    with `batch_step` a warm horizon step of Nsample+1 states (the env's
    `horizon_step`, a captured planner's unit off the fused path): {unit:
    uses}."""
    mb = MBDPI(CFG, env, capture=False)
    gen = torch.Generator().manual_seed(0)
    state = to_lean(env.reset(gen))
    Y = torch.zeros((CFG.Hnode + 1, env.action_size), dtype=env._dtype)
    scale = torch.as_tensor(mb.sigma_control, dtype=env._dtype)
    step = make_control_step(mb, CFG.Ndiffuse)
    units = {"reverse_once": lambda: mb.reverse_once(state, gen, Y, scale),
             "control_step": lambda: step(state, Y, gen)}
    if batch_step:
        B = CFG.Nsample + 1
        batch = map_tensors(state, lambda x: x.expand((B,) + tuple(x.shape)).contiguous())
        us = 0.3 * torch.randn((B, env.action_size), dtype=env._dtype, generator=gen)
        units = {"horizon step": lambda: env.horizon_step(batch, us), **units}
    out = {}
    for name, fn in units.items():
        fn()  # warm: the cached constants are made here
        probe.uses = []
        with probe:
            fn()
        out[name] = probe.uses
    return out


@pytest.mark.parametrize("name", list(PATHS))
def test_no_host_data_or_read_in_a_warm_reverse_once_or_control_step(name):
    task, overrides = PATHS[name]
    env = get_env(task, device="cpu", n_substeps=1, **overrides)
    assert env.on_fused_path
    probe = HostUses()
    env._fused_step = _PausedPlain(env.fused_step, probe)
    uses = _windows(env, probe)
    assert uses == {"reverse_once": [], "control_step": []}


PIPELINE_PATHS = {
    "go2_stand[fused=off]": ("go2_stand", {"fused": "off"}),
    "go2_stand[go2_pair_kinds]": ("go2_stand", {"scene": "go2_pair_kinds"}),
}


@pytest.mark.parametrize("name", list(PIPELINE_PATHS))
def test_no_host_data_or_read_on_the_physics_pipeline(name):
    """The units a captured planner replays off the fused path (the horizon
    step at a batch, and `step_lean` at B=1 inside the control step) and
    what runs between them: no host data and no
    host read anywhere in the window."""
    task, overrides = PIPELINE_PATHS[name]
    env = get_env(task, device="cpu", n_substeps=1, **overrides)
    assert not env.on_fused_path
    uses = _windows(env, HostUses(), batch_step=True)
    assert uses == {"horizon step": [], "reverse_once": [], "control_step": []}


TRACED_PATHS = {"go2_stand": ("go2_stand", {}),
                "go2_stand[fused=off]": ("go2_stand", {"fused": "off"})}


@pytest.mark.parametrize("name", list(TRACED_PATHS))
def test_no_host_data_or_read_with_the_tracer_on(name):
    task, overrides = TRACED_PATHS[name]
    env = get_env(task, device="cpu", n_substeps=1, **overrides)
    probe = HostUses()
    if env.on_fused_path:
        env._fused_step = _PausedPlain(env.fused_step, probe)
    spans.reset()
    spans.enable()
    try:
        uses = _windows(env, probe, batch_step=not env.on_fused_path)
        spans.collect()
        traced = spans.summary()
    finally:
        spans.disable()
        spans.reset()
    assert all(u == [] for u in uses.values()), uses
    assert {"execute", "rollout/ctrl", "rollout/reward", "score_update"} <= set(traced)


def test_the_probe_sees_host_data_in_the_window():
    """The probe is live: a scratch constant and a host-indexed gather made
    inside the window are both recorded."""
    probe = HostUses()
    x = torch.randn(4, 3)
    with probe:
        torch.tensor([0.0, 0.0, 1.0])
        x[..., [0, 2]]
        x.sum().item()
        x[..., 0:2]  # a slice is no host data
    assert [u.split(" at ")[0] for u in probe.uses] == [
        "tensor of list", "__getitem__ with a host index", "item"]
