"""Batched rollouts and the executed step, on the physics the env's config
picks: the env owns the physics and the horizon loop, the planner owns the
CUDA graphs (`planner/capture.py`).

Counterpart of `tpu_dialmpc/envs/fused_rollout.py`:

- `rollout_batch(state, all_us)` rolls every candidate control sequence
  (B, T, nu) through the physics and the env's reward stack and returns the
  (B, T) reward matrix the planner scores, the horizon a Python loop over
  `horizon_step`; with `want_states` also the rollouts' qpos, qvel and
  torso positions (the planner's `diag_states` diagnostics).  It is the
  port's one horizon loop, on either physics; a planner that captures each
  horizon step hands it that step's graph replay (`step=`).
- `step_lean(state, action)` is the executed control step: the same chain at
  B=1, on either physics.

The physics (`on_fused_path`, from the config's `fused`):
- "on": the fused substep (`dynamics/fused_cuda.py`: the CUDA kernel on
  CUDA tensors, its plain PyTorch version on CPU tensors, one launch per
  horizon step for all B candidates); a model `fused.supported` rejects,
  or on a CUDA device one past a limit of the kernel's build
  (`fused_cuda.kernel_limits`), raises when the env is built;
- "off": the physics pipeline (`dynamics/pipeline.step`, batched PyTorch
  ops), the JAX package's XLA path;
- "auto": the fused substep where `fused.supported(model)` holds and, on a
  CUDA device, the kernel's build has no limit in the way; else the
  pipeline, with a warning naming the limit.
Both are choices made once, from the model, when the env is built.  A kernel
that fails to build or launch raises; it never gives way to the pipeline.

Device spans (`telemetry/spans.py`): an env step's `ctrl` (the PD map),
`physics` and `reward` (the reward and termination stack), and in
`rollout_batch` each horizon step's `rollout` around them.

Requires the host env to provide:
  model, config, device, _torso_idx, _dtype, _on_fused (`pick_physics`),
  _ctrl_batch(action (B,nu), qpos (B,nq), qvel (B,nv)) -> ctrl (B,nu)
  _post_physics(qpos, qvel, site_xpos, torso_xpos, torso_xquat, torso_cvel,
                root_com, qfrc_actuator, info, ctrl) -> (reward, done, info')
  _get_obs(qpos, qvel, torso_xpos, torso_xquat, torso_cvel, root_com, info, ctrl)
"""

from __future__ import annotations

import warnings

import torch

from tpu_dialmpc_torch.dynamics import fused, fused_cuda, pipeline
from tpu_dialmpc_torch.dynamics.fused_cuda import FusedStep
from tpu_dialmpc_torch.envs.base import LeanEnvState, LeanPipelineState, map_tensors
from tpu_dialmpc_torch.telemetry import spans

FUSED_MODES = ("auto", "on", "off")


def pick_physics(model, mode: str, device, spec: fused.DerivedSpec) -> bool:
    """True for the fused substep, False for the physics pipeline, as the
    config's `fused` mode asks, for an env on `device` whose substep
    returns `spec`'s reward inputs (see the module docstring)."""
    if mode not in FUSED_MODES:
        raise ValueError(f"fused={mode!r}: expected one of {FUSED_MODES}")
    if mode == "off":
        return False
    ok = fused.supported(model)
    if mode == "on" and not ok:
        raise ValueError("fused='on', but the fused substep does not support this model "
                         "(fused.supported); use 'auto' or 'off' for the physics pipeline")
    if not ok or torch.device(device).type != "cuda":
        return ok
    limits = fused_cuda.kernel_limits(model, spec)
    if not limits:
        return True
    why = "the fused substep's CUDA kernel cannot be built for this model: " + "; ".join(limits)
    if mode == "on":
        raise ValueError(f"fused='on', but {why}; use 'auto' or 'off' for the physics pipeline")
    warnings.warn(f"{why}; fused='auto' runs the physics pipeline")
    return False


class FusedRolloutMixin:
    _fused_step = None

    @property
    def on_fused_path(self) -> bool:
        """Whether `step_lean` and `rollout_batch` run the fused substep
        (else the physics pipeline); fixed when the env is built."""
        return self._on_fused

    def launch_counters(self):
        """The (object, attribute) pairs of the Python launch counters an
        env step adds to (`planner/capture.py` adds a graph's share at each
        replay): the fused kernel's launches and waves, on its path."""
        if not self.on_fused_path:
            return []
        return [(self.fused_step, "launches"), (self.fused_step, "waves")]

    def _fused_spec(self) -> fused.DerivedSpec:
        """The reward inputs the env's substep returns."""
        return fused.DerivedSpec(
            torso_body=self._torso_idx, want_sites=True, want_qfrc_actuator=True
        )

    @property
    def fused_step(self) -> FusedStep:
        """The env's substep chain: n_substeps per call, reward inputs out.
        Its `launches` counts the CUDA kernel's launches."""
        if self._fused_step is None:
            self._fused_step = FusedStep(self.model, self.config.n_substeps, self._fused_spec())
        return self._fused_step

    def _derived(self, ps) -> dict:
        """The reward inputs of a (batched) PipelineState, by name."""
        b = self._torso_idx
        return dict(
            site_xpos=ps.site_xpos,
            torso_xpos=ps.xpos[..., b, :],
            torso_xquat=ps.xquat[..., b, :],
            torso_cvel=ps.cvel[..., b, :],
            root_com=ps.subtree_com[..., int(self.model.body_rootid[b]), :],
            qfrc_actuator=ps.qfrc_actuator,
        )

    def _physics(self, qpos, qvel, ws, ctrl, use_fused):
        """n_substeps of physics for a batch: (qpos', qvel', ws', the reward
        inputs by name, the pipeline's state or None)."""
        if use_fused:
            fs = self.fused_step
            qpos2, qvel2, ws2, der_flat = fs(qpos, qvel, ws, ctrl)
            return qpos2, qvel2, ws2, fused.split_derived(self.model, fs.spec, der_flat), None
        ps = pipeline.step(self.model, LeanPipelineState(qpos=qpos, qvel=qvel, qacc_warmstart=ws),
                           ctrl, self.config.n_substeps)
        return ps.qpos, ps.qvel, ps.qacc_warmstart, self._derived(ps), ps

    def _step_batch(self, qpos, qvel, ws, info, action, use_fused=None):
        """One env step for a batch: (B, ...) state, (B, nu) action, on the
        env's physics unless `use_fused` says which."""
        device = qpos.device
        with spans.span("ctrl", device=device, follows=True):
            ctrl = self._ctrl_batch(action, qpos, qvel)
        with spans.span("physics", device=device, follows=True):
            qpos2, qvel2, ws2, der, ps = self._physics(
                qpos, qvel, ws, ctrl, self._on_fused if use_fused is None else use_fused)
        with spans.span("reward", device=device, follows=True):
            reward, done, info2 = self._post_physics(qpos=qpos2, qvel=qvel2, **der, info=info,
                                                     ctrl=ctrl)
        return qpos2, qvel2, ws2, der, ctrl, reward, done, info2, ps

    def step_lean(self, state, action) -> LeanEnvState:
        """The executed control step (B=1).  Accepts an EnvState or a
        LeanEnvState (only .pipeline.{qpos,qvel,qacc_warmstart} and .info are
        read) and returns a LeanEnvState."""
        ps = state.pipeline
        dtype = self._dtype

        def one(x):
            return x.to(dtype)[None].contiguous()

        info = map_tensors(state.info, lambda x: x[None])
        qpos2, qvel2, ws2, der, ctrl, reward, done, info2, _ = self._step_batch(
            one(ps.qpos), one(ps.qvel), one(ps.qacc_warmstart), info,
            one(action),
        )
        info2 = map_tensors(info2, lambda x: x[0])
        obs = self._get_obs(
            qpos2[0], qvel2[0], der["torso_xpos"][0], der["torso_xquat"][0],
            der["torso_cvel"][0], der["root_com"][0], info2, ctrl[0],
        )
        return LeanEnvState(
            pipeline=LeanPipelineState(qpos=qpos2[0], qvel=qvel2[0], qacc_warmstart=ws2[0]),
            obs=obs,
            reward=reward[0],
            done=done[0],
            info=info2,
        )

    def horizon_step(self, state, us):
        """One horizon step of `rollout_batch` for a batch: (the next live
        state, the rewards (B,), the torso's world position (B, 3))."""
        ps = state.pipeline
        qpos, qvel, ws, der, _, reward, _, info, _ = self._step_batch(
            ps.qpos, ps.qvel, ps.qacc_warmstart, state.info, us)
        return _live(qpos, qvel, ws, info), reward, der["torso_xpos"]

    def rollout_batch(self, state, all_us, want_states=False, step=None):
        """Batched rollout (B, T, nu) -> per-step rewards (B, T).

        Every candidate starts from `state`; rewards, termination and info
        updates are the code path `step_lean` uses.  With `want_states`,
        returns (rewss (B,T), qss (B,T,nq), qdss (B,T,nv), xss (B,T,3)): the
        states after each step and the torso's world position.  `step` runs
        each horizon step in place of `horizon_step`: the planner's replay of
        its CUDA graph, where it captures env steps."""
        step = step or self.horizon_step
        B, T = all_us.shape[0], all_us.shape[1]
        dtype = self._dtype
        ps = state.pipeline

        def bcast(x):
            return x.to(dtype).expand((B,) + tuple(x.shape)).contiguous()

        s = _live(bcast(ps.qpos), bcast(ps.qvel), bcast(ps.qacc_warmstart),
                  map_tensors(state.info, lambda x: x.expand((B,) + tuple(x.shape))))
        us = all_us.to(dtype)
        outs = []
        for t in range(T):
            with spans.span("rollout", device=us.device, follows=t > 0):
                s, reward, x = step(s, us[:, t])
            ps = s.pipeline
            outs.append((reward, ps.qpos, ps.qvel, x) if want_states else (reward,))
        stacked = tuple(torch.stack(x, dim=1) for x in zip(*outs))
        return stacked if want_states else stacked[0]


def _live(qpos, qvel, ws, info) -> LeanEnvState:
    """The state a horizon step reads and returns: the physics and info."""
    return LeanEnvState(pipeline=LeanPipelineState(qpos=qpos, qvel=qvel, qacc_warmstart=ws),
                        obs=None, reward=None, done=None, info=info)
