"""The planner's device programs as captured CUDA graphs: `reverse_once`
and the control step on the fused path, one env step elsewhere.  The env
owns the physics and the horizon loop (`envs/fused_rollout.py`); the
planner owns the graphs, and `PlannerGraphs.whole` is where it reads the
env's physics.

Counterpart of the JAX package's compiled programs: the jitted control step
(`tpu_dialmpc/planner/runner.py:63`), the jitted warm start (`:112`),
`run_scan`'s jitted chunk (`:267`), the root bench's jitted chains of
`reverse_once` (`bench.py:87`, `:139`), XLA's compile of the physics
pipeline's scan over substeps (`tpu_dialmpc/dynamics/pipeline.py:192`) and
the GSPMD program of the sharded planner (`tpu_dialmpc/shard/planner.py`).
PyTorch's form of a device program with no host in it is a CUDA graph: each
unit's kernels are recorded once and replayed with one launch.

- The choice is made once, when the planner is built (`pick_capture`, as
  `envs/fused_rollout.pick_physics` chooses the physics): "auto" captures
  where the env is on a CUDA device and the planner's collectives, if it
  has any (`ShardedMBDPI`), go over NCCL, which a graph can hold (gloo's are
  host round trips); True raises where those do not hold; False runs
  eagerly, as `jax.disable_jit` does.
- What a unit is depends on the physics (`PlannerGraphs.whole`).  On the
  fused substep's path, with `compat_q1` off: `reverse_once` and the
  control step of one `n_diffuse`, whole.  Elsewhere (the physics pipeline,
  ~2,900 kernels per substep, which would make one `reverse_once` ~490k
  graph nodes; and `compat_q1`, which chains the candidates through
  `env.step` one at a time): one env step (the ctrl map, `n_substeps` of
  physics and the reward stack) per unit, each replayed once per step: the
  env's `horizon_step` at B = the planner's block + 1 ("horizon step",
  which the planner hands the env's `rollout_batch`), `step_lean` of one
  state ("execute", the executed step) and, under `compat_q1`, `env.step`
  of one state ("compat env.step", its chain); the planner's ops between
  the steps (noise, `node2u`, scoring, `shift`) run eagerly.
- A unit runs eagerly at its first call, on the side stream its capture
  will use: the call builds and loads the kernel library (nvcc cannot run
  inside a capture), makes the model's cached constants, settles the
  stream's cuBLAS workspace and creates the NCCL communicator.  The second
  call captures it and every call from then on replays it.  A capture that
  fails raises; nothing falls back to the eager path.
- Inputs live in static, contiguous buffers, filled by device-to-device
  copies before each call: the state's qpos, qvel, warmstart and every
  `StateInfo` field (a batch broadcast from one state, a stride-0 view, is
  copied whole), Ybar, the noise scale, the noise, the action.  Inputs of
  another layout (shape, dtype, device) raise: a planner captures one
  layout per unit.
- The noise is drawn outside the graph, from the caller's generator, into
  the static noise buffer (`torch.randn(..., out=)`), in the order the
  eager path draws it (one draw per annealing iteration), so the generator's
  sequence, and checkpoints that save it, stay what they are eagerly.  The
  buffer holds every sample's noise; a `ShardedMBDPI`'s graph slices its
  rank's block, as the eager planner does.
- Outputs are cloned out of the graph's buffers at every call: the next
  replay overwrites them, and some alias the static inputs.
- Python counters do not run in a replay: the env's launch counters
  (`launch_counters()`: `FusedStep.launches` and `waves`, the Go2 env kernels') and
  `ShardedMBDPI.reduced_bytes`.  Each graph keeps what its capture added
  to them (taken back out: a captured launch runs nothing) and adds it at
  every replay.
- Spans (`telemetry/spans.py`), where the tracer is on: a unit's first
  call is `setup/first_call`, its capture `setup/capture` and
  `setup/instantiate` (the same clock reads as `capture_s` and
  `instantiate_s`), each call's input copies `graph/load`, its launch
  `graph/replay` and its output clones `graph/clone`.  A unit's graph
  holds no span, whether the tracer is on or off: its device spans are
  held off while it is captured.  While the tracer's device spans are on,
  a unit replays a second graph of the same function (`traced`), captured
  at the first such call with the spans' timing events as event-record
  nodes; the unit owns those (`owned`) and each replay hands them to the
  tracer.  The second graph is kept apart because a graph with events
  costs its launches (on an H100, go2_stand: ~1.1 % a step, and a launch
  waits for the graph's previous replay, which stalls a queue of steps).

`graph` is the backend: `CudaGraph` on the card; the tests give a stand-in
that replays by calling the captured function into the same buffers.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List

import torch

from tpu_dialmpc_torch.envs.base import LeanEnvState, LeanPipelineState
from tpu_dialmpc_torch.telemetry import spans

CAPTURE_MODES = ("auto", True, False)


def pick_capture(mode, env, backend=None) -> bool:
    """Whether a planner on `env` captures its units (module docstring);
    `backend` names the process group the planner all-reduces over, None
    where it has no collective."""
    if not (mode is True or mode is False or mode == "auto"):
        raise ValueError(f"capture={mode!r}: expected one of {CAPTURE_MODES}")
    if mode is False:
        return False
    why = []
    if torch.device(env.device).type != "cuda":
        why.append(f"the env is on {torch.device(env.device)}, not a CUDA device")
    if backend not in (None, "nccl"):
        why.append(f"the planner all-reduces over a {backend} process group, whose host "
                   "round trips a CUDA graph cannot hold (NCCL's collectives it can)")
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
    side stream, its replays on the caller's stream.  `capture_s` and
    `instantiate_s` time its capture; `graph.raw_cuda_graph()` stays valid
    for counting its nodes."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        # keep_graph: the capture ends without instantiating, so the two
        # are timed apart and the graph can be read after
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.capture_s = self.instantiate_s = None

    def warm(self, fn):
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = fn()
        cur.wait_stream(self.stream)
        return out

    def capture(self, fn, setup=True):
        """Capture `fn()`; `setup`: its two times are set-up spans."""
        t0 = time.perf_counter()
        # thread_local: another thread's host reads (a telemetry writer's)
        # do not break this capture
        with torch.cuda.graph(self.graph, stream=self.stream,
                              capture_error_mode="thread_local"):
            out = fn()
        t1 = time.perf_counter()
        self.graph.instantiate()
        t2 = time.perf_counter()
        self.capture_s, self.instantiate_s = t1 - t0, t2 - t1
        if setup:
            spans.record_host("setup/capture", t0, t1)
            spans.record_host("setup/instantiate", t1, t2)
        return out

    def replay(self):
        with spans.span("graph/replay"):
            self.graph.replay()


class Unit:
    """One captured unit: `fn()` reads the static inputs and returns its
    outputs; `__call__(inputs)` copies `inputs` (tensors in the static
    inputs' order) into them, then warms, captures or replays (module
    docstring) and returns clones of the outputs.  `counters` are
    (object, attribute) pairs of the Python counters the unit adds to."""

    def __init__(self, name, fn: Callable, static: List[torch.Tensor], counters, graph,
                 owner):
        self.name = name
        self.fn = fn
        self.static = static
        self.counters = counters
        self.graph = graph
        self.owner = owner  # the PlannerGraphs: eager inside a unit's fn
        self.calls = 0
        self.out = None  # the graph's outputs, after the capture
        self.per_replay = None  # what a replay adds to each counter
        # the graph with the tracer's device spans, its outputs and its spans
        # (spans.Owned), made at the first call with those spans on
        self.traced = self.traced_out = self.owned = None

    def _busy(self, thunk):
        self.owner.busy = True
        try:
            return thunk()
        finally:
            self.owner.busy = False

    def _counts(self):
        return [getattr(obj, name) for obj, name in self.counters]

    def _set_counts(self, values):
        for (obj, name), v in zip(self.counters, values):
            setattr(obj, name, v)

    def load(self, inputs):
        """Copy `inputs` into the static buffers; another layout raises."""
        if _layout(inputs) != _layout(self.static):
            raise ValueError(
                f"{self.name} was captured for the inputs {_layout(self.static)}, got "
                f"{_layout(inputs)}: a planner captures one state layout (build a new MBDPI "
                "for another)")
        with spans.span("graph/load"):
            for dst, src in zip(self.static, inputs):
                dst.copy_(src)

    def __call__(self, inputs):
        self.load(inputs)
        self.calls += 1
        if self.calls == 1:
            with spans.span("setup/first_call"):
                out = self._busy(lambda: self.graph.warm(self.fn))
            return _clone(out)
        if self.out is None:
            with spans.held():
                self.out = self._capture(self.graph)
        graph, out, owned = self.graph, self.out, None
        if spans.device_on():
            if self.traced is None:
                self.traced = self.owner.graph(self.static[0].device)
                with spans.capturing() as self.owned:
                    self.traced_out = self._capture(self.traced, setup=False)
            graph, out, owned = self.traced, self.traced_out, self.owned
        before = self._counts()
        with spans.replaying(owned):
            self._busy(graph.replay)
        self._set_counts([b + k for b, k in zip(before, self.per_replay)])
        return _clone(out)

    def _capture(self, graph, setup=True):
        before = self._counts()
        out = self._busy(lambda: graph.capture(self.fn, setup))
        # the capture ran nothing: its counts go back, and each replay adds
        # them
        self.per_replay = [c - b for c, b in zip(self._counts(), before)]
        self._set_counts(before)
        return out


def _clone(out):
    with spans.span("graph/clone"):
        return _rebuild(out, iter([t.clone() for t in _flatten(out)]))


def _static(t: torch.Tensor) -> torch.Tensor:
    """A static buffer for `t`: a contiguous copy (of a broadcast view too)."""
    return t.clone(memory_format=torch.contiguous_format)


class PlannerGraphs:
    """The captured units of one planner (module docstring): with `whole`,
    `reverse_once` and a control step per `n_diffuse`; else each env step
    the planner runs (`step`).  `busy` is True while a unit runs (its eager
    first call, its capture or a replay): the planner's own calls then run
    eagerly, inside it."""

    def __init__(self, mbdpi, graph=None):
        self.mbdpi = mbdpi
        self.graph = graph or CudaGraph
        self.busy = False
        self.units = {}
        env = mbdpi.env
        # the planner's one reader of the env's physics: what a unit is
        self.whole = env.on_fused_path and not mbdpi.args.compat_q1
        self.counters = list(env.launch_counters())
        self.counters += [(mbdpi, name) for name in mbdpi.COUNTERS]

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

    def step(self, name, fn, state, action):
        """The captured form of `fn(state, action)`, an env step (module
        docstring): one graph per `name`, each for one batch layout."""
        def make():
            leaves = [_static(t) for t in self._state_leaves(state)]
            a = _static(action)
            st = self._static_state(state, leaves)
            return Unit(name, lambda: fn(st, a), leaves + [a], self.counters,
                        self.graph(action.device), self)

        return self._unit(name, make)(self._state_leaves(state) + [action])

    def reverse_once(self, state, generator, Ybar_i, noise_scale, noise=None):
        def make():
            leaves = [_static(t) for t in self._state_leaves(state)]
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
                leaves = [_static(t) for t in self._state_leaves(state)]
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
