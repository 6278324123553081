"""The planner's device programs: `reverse_once` and the control step as
captured CUDA graphs.

Counterpart of the JAX package's compiled programs: the jitted control step
(`tpu_dialmpc/planner/runner.py:63`), the jitted warm start (`:112`),
`run_scan`'s jitted chunk (`:267`) and the root bench's jitted chains of
`reverse_once` (`bench.py:87`, `:139`).  PyTorch's form of a device
program with no host in it is a CUDA graph: each unit's kernels are recorded
once and replayed with one launch.

- The choice is made once, when the planner is built (`pick_capture`, as
  `envs/fused_rollout.pick_physics` chooses the physics): "auto" captures
  where the env is on a CUDA device and on the fused substep's path and
  `compat_q1` is off; True raises where those do not hold; False runs
  eagerly, as `jax.disable_jit` does.  The physics pipeline stays eager
  (~2,900 kernels per substep would make one `reverse_once` ~490k graph
  nodes), and so does `ShardedMBDPI` (its collectives).
- A unit (`reverse_once`, or the control step of one `n_diffuse`) runs
  eagerly at its first call, on the side stream its capture will use: the
  call builds and loads the kernel library (nvcc cannot run inside a
  capture) and settles the stream's cuBLAS workspace.  The second call
  captures it and every call from then on replays it.  A capture that fails
  raises; nothing falls back to the eager path.
- Inputs live in static buffers, filled by device-to-device copies before
  each call: the state's qpos, qvel, warmstart and every `StateInfo` field,
  Ybar, the noise scale, and the noise.  A state of another layout (shape,
  dtype, device) raises: a planner captures one layout.
- The noise is drawn outside the graph, from the caller's generator, into
  the static noise buffer (`torch.randn(..., out=)`), in the order the
  eager path draws it (one draw per annealing iteration), so the generator's
  sequence, and checkpoints that save it, stay what they are eagerly.
- Outputs are cloned out of the graph's buffers at every call: the next
  replay overwrites them, and some alias the static inputs.
- `FusedStep.launches` counts launches in Python, which a replay does not
  run: each graph keeps the count its capture made (taken back out of the
  counter: a captured launch runs nothing) and adds it at every replay.

`graph` is the backend: `CudaGraph` on the card; the tests give a stand-in
that replays by calling the captured function into the same buffers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List

import torch

from tpu_dialmpc_torch.envs.base import LeanEnvState, LeanPipelineState

CAPTURE_MODES = ("auto", True, False)


def pick_capture(mode, env, cfg) -> bool:
    """Whether a planner on `env` with config `cfg` captures its units
    (module docstring)."""
    if not (mode is True or mode is False or mode == "auto"):
        raise ValueError(f"capture={mode!r}: expected one of {CAPTURE_MODES}")
    if mode is False:
        return False
    why = []
    if torch.device(env.device).type != "cuda":
        why.append(f"the env is on {torch.device(env.device)}, not a CUDA device")
    if not getattr(env, "on_fused_path", False):
        why.append("the env is not on the fused substep's path (the physics pipeline "
                   "runs eagerly)")
    if cfg.compat_q1:
        why.append("compat_q1 chains the candidates through env.step")
    if why and mode is True:
        raise ValueError("capture=True, but " + "; ".join(why))
    return not why


# ----------------------------------------------------------------------
# pytrees of tensors: tuples, NamedTuples and dataclasses
def _flatten(obj) -> List[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj) for t in _flatten(getattr(obj, f.name))]
    if isinstance(obj, tuple):
        return [t for x in obj for t in _flatten(x)]
    return []


def _rebuild(template, leaves):
    """`template` with its tensors replaced, in `_flatten`'s order, by the
    items of the iterator `leaves`."""
    if isinstance(template, torch.Tensor):
        return next(leaves)
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), leaves)
            for f in dataclasses.fields(template)})
    if isinstance(template, tuple):
        items = [_rebuild(x, leaves) for x in template]
        return type(template)(*items) if hasattr(template, "_fields") else tuple(items)
    return template


def _layout(leaves):
    return [(tuple(t.shape), t.dtype, t.device) for t in leaves]


# ----------------------------------------------------------------------
class CudaGraph:
    """One unit's CUDA graph: its eager first call and its capture on one
    side stream, its replays on the caller's stream."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.graph = torch.cuda.CUDAGraph()

    def warm(self, fn):
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        return out

    def capture(self, fn):
        # thread_local: another thread's host reads (a telemetry writer's)
        # do not break this capture
        with torch.cuda.graph(self.graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            return fn()

    def replay(self):
        self.graph.replay()


class Unit:
    """One captured unit: `fn()` reads the static inputs and returns its
    outputs; `__call__(inputs)` copies `inputs` (tensors in the static
    inputs' order) into them, then warms, captures or replays (module
    docstring) and returns clones of the outputs."""

    def __init__(self, name, fn: Callable, static: List[torch.Tensor], counters, graph,
                 owner):
        self.name = name
        self.fn = fn
        self.static = static
        self.counters = counters  # objects with a `launches` count
        self.graph = graph
        self.owner = owner  # the PlannerGraphs: eager inside a unit's fn
        self.calls = 0
        self.out = None  # the graph's outputs, after the capture
        self.launches = None  # per replay, counter by counter

    def _busy(self, thunk):
        self.owner.busy = True
        try:
            return thunk()
        finally:
            self.owner.busy = False

    def load(self, inputs):
        """Copy `inputs` into the static buffers; another layout raises."""
        if _layout(inputs) != _layout(self.static):
            raise ValueError(
                f"{self.name} was captured for the inputs {_layout(self.static)}, got "
                f"{_layout(inputs)}: a planner captures one state layout (build a new MBDPI "
                "for another)")
        for dst, src in zip(self.static, inputs):
            dst.copy_(src)

    def __call__(self, inputs):
        self.load(inputs)
        self.calls += 1
        if self.calls == 1:
            return _clone(self._busy(lambda: self.graph.warm(self.fn)))
        if self.out is None:
            before = [c.launches for c in self.counters]
            self.out = self._busy(lambda: self.graph.capture(self.fn))
            # a captured launch runs nothing: the count goes back, and each
            # replay adds it
            self.launches = [c.launches - b for c, b in zip(self.counters, before)]
            for c, b in zip(self.counters, before):
                c.launches = b
        self._busy(self.graph.replay)
        for c, k in zip(self.counters, self.launches):
            c.launches += k
        return _clone(self.out)


def _clone(out):
    return _rebuild(out, iter([t.clone() for t in _flatten(out)]))


class PlannerGraphs:
    """The captured units of one planner: `reverse_once` and a control step
    per `n_diffuse`.  `busy` is True while a unit runs (its eager first
    call, its capture or a replay): the planner's own calls then run
    eagerly, inside it."""

    def __init__(self, mbdpi, graph=None):
        self.mbdpi = mbdpi
        self.graph = graph or CudaGraph
        self.busy = False
        self.units = {}
        fs = getattr(mbdpi.env, "fused_step", None)
        self.counters = [fs] if fs is not None else []

    # the static state: the live part (`to_lean`'s pipeline and info)
    @staticmethod
    def _state_leaves(state):
        ps = state.pipeline
        return [ps.qpos, ps.qvel, ps.qacc_warmstart] + _flatten(state.info)

    def _static_state(self, state, leaves):
        qpos, qvel, ws, *info = leaves
        return LeanEnvState(
            pipeline=LeanPipelineState(qpos=qpos, qvel=qvel, qacc_warmstart=ws),
            obs=None, reward=None, done=None, info=_rebuild(state.info, iter(info)))

    def _noise_like(self, Ybar):
        args = self.mbdpi.args
        return torch.empty((args.Nsample, args.Hnode + 1, self.mbdpi.nu), dtype=Ybar.dtype,
                           device=Ybar.device)

    def _unit(self, key, make):
        if key not in self.units:
            self.units[key] = make()
        return self.units[key]

    def reverse_once(self, state, generator, Ybar_i, noise_scale, noise=None):
        def make():
            leaves = [t.clone() for t in self._state_leaves(state)]
            Y, scale, eps = Ybar_i.clone(), noise_scale.clone(), self._noise_like(Ybar_i)
            st = self._static_state(state, leaves)
            fn = lambda: self.mbdpi._reverse_once(st, None, Y, scale, noise=eps)  # noqa: E731
            return Unit("reverse_once", fn, leaves + [Y, scale, eps], self.counters,
                        self.graph(Ybar_i.device), self)

        unit = self._unit("reverse_once", make)
        eps = _draw(generator, unit.static[-1]) if noise is None else noise
        return unit(self._state_leaves(state) + [Ybar_i, noise_scale, eps])

    def control_step(self, eager, n_diffuse: int):
        """The captured form of `eager(state, Y0, generator, noise=)`, the
        runner's control step with `n_diffuse` annealing iterations."""
        def step(state, Y0, generator, noise=None):
            def make():
                leaves = [t.clone() for t in self._state_leaves(state)]
                Y = Y0.clone()
                eps = torch.stack([self._noise_like(Y0)] * n_diffuse)
                st = self._static_state(state, leaves)
                fn = lambda: eager(st, Y, None, noise=eps)  # noqa: E731
                return Unit(f"control step (n_diffuse={n_diffuse})", fn, leaves + [Y, eps],
                            self.counters, self.graph(Y0.device), self)

            unit = self._unit(("control_step", n_diffuse), make)
            if noise is None:
                eps = unit.static[-1]
                for i in range(n_diffuse):  # one draw per iteration, in order
                    _draw(generator, eps[i])
            else:
                eps = torch.stack(list(noise))
            return unit(self._state_leaves(state) + [Y0, eps])

        return step


def _draw(generator, out: torch.Tensor) -> torch.Tensor:
    """`MBDPI.draw_noise`'s draw, into `out`."""
    return torch.randn(out.shape, generator=generator, out=out)
