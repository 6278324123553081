"""What the Go2 and H1 envs share: the reset state from the plain forward
stages, `step` through the physics pipeline, the PD torque map, the torso's
body-frame velocities and the observation.  The JAX package writes these
out in each env (`tpu_dialmpc/envs/go2.py`, `h1.py`) with the same
formulas."""

from __future__ import annotations

import numpy as np
import torch

from tpu_dialmpc_torch.core import rotations as rot
from tpu_dialmpc_torch.dynamics import fused
from tpu_dialmpc_torch.envs.base import EnvState, PipelineState, StateInfo, map_tensors
from tpu_dialmpc_torch.envs.fused_rollout import FusedRolloutMixin


# SplitMix64's constants, as int64 (torch has no uint64 arithmetic): the
# products wrap modulo 2^64 as unsigned ones would
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)
REDRAW_PERIOD = 500  # randomize_tasks: a new command every 500 steps


def _lsr(z: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 (torch's >> is arithmetic)."""
    return (z >> s) & ((1 << (64 - s)) - 1)


def _mix64(z: torch.Tensor) -> torch.Tensor:
    """SplitMix64's output function: a bijective avalanche of 64 bits."""
    z = (z ^ _lsr(z, 30)) * _MIX1
    z = (z ^ _lsr(z, 27)) * _MIX2
    return z ^ _lsr(z, 31)


def command_uniforms(seed: torch.Tensor, step: torch.Tensor, n: int, dtype) -> list:
    """n uniforms in [0, 1) for each (seed, step), elementwise over any
    shape: a counter-based stream (SplitMix64 at counter step * n + k under
    the mixed seed), integer ops on the tensors' device, no host sync.  Each
    is a multiple of 2^-24, exact in float32 and float64, so the card and
    the CPU draw the same values."""
    base = _mix64(seed.to(torch.int64))
    counter = step.to(torch.int64) * n
    return [(_lsr(_mix64(base + (counter + k + 1) * _GOLDEN), 40).to(dtype) * 2.0**-24)
            for k in range(n)]


class LeggedEnv(FusedRolloutMixin):
    """Needs from the subclass: model, config (kp, kd, action_scale,
    timestep, n_substeps, fused, randomize_tasks), device, _dtype,
    _torso_idx, _init_q, FEET_SITES, COMMAND_RANGE, _on_fused
    (`fused_rollout.pick_physics`), and the tensors joint_range,
    physical_joint_range, joint_torque_range."""

    @property
    def action_size(self) -> int:
        return self.model.nu

    @property
    def dt(self) -> float:
        """Env step duration (= timestep when n_substeps=1)."""
        return self.config.timestep * self.config.n_substeps

    @property
    def observation_size(self) -> int:
        # [vel_tar(3), ang_vel_tar(3), ctrl(nu), qpos(nq), vb(3), ab(3), qvel[6:]]
        return 6 + self.model.nu + self.model.nq + 6 + (self.model.nv - 6)

    def _zeros(self, *shape, dtype=None):
        return torch.zeros(shape, dtype=dtype or self._dtype, device=self.device)

    def _tensor(self, x, dtype=None):
        """A constant on the env's device, made once (in __init__)."""
        return torch.as_tensor(np.asarray(x), dtype=dtype or self._dtype, device=self.device)

    def full_state(self, qpos, qvel, qacc_warmstart, info: StateInfo, reward, done) -> EnvState:
        """The EnvState at (qpos, qvel): the derived fields from the plain
        forward stages of the fused substep (FK, CoM velocities, actuation at
        zero ctrl), the port's counterpart of `pipeline.init`; the warmstart
        as given; the observation at zero ctrl.  `reset` and
        `checkpoint.load` build their states with it."""
        m = self.model
        q = list(qpos[None].unbind(-1))
        v = list(qvel[None].unbind(-1))
        like = q[0]
        fk = fused._fk(m, q)
        cvel, _ = fused._com_vel(m, fk, v)
        qfrc_act = fused._actuator_force(m, [torch.zeros_like(like)] * m.nu, q, v)

        def stack(rows):  # list of per-body scalar tuples -> (n, k)
            return torch.stack([fused._stack(r, like)[0] for r in rows])

        ps = PipelineState(
            qpos=qpos,
            qvel=qvel,
            qacc_warmstart=qacc_warmstart,
            xpos=stack(fk["xpos"]),
            xquat=stack(fk["xquat"]),
            site_xpos=stack(fk["site_xpos"]),
            subtree_com=stack(fk["subtree_com"]),
            cvel=stack(cvel),
            qfrc_actuator=fused._stack(qfrc_act, like)[0],
        )
        b = self._torso_idx
        root = int(m.body_rootid[b])
        obs = self._get_obs(
            ps.qpos, ps.qvel, ps.xpos[b], ps.xquat[b], ps.cvel[b], ps.subtree_com[root],
            info, self._zeros(m.nu),
        )
        return EnvState(pipeline=ps, obs=obs, reward=reward, done=done, info=info)

    def step(self, state, action) -> EnvState:
        """One env step through the physics pipeline (`dynamics/pipeline.py`,
        the JAX envs' `step`), whatever the config's `fused`: the action's
        ctrl, n_substeps of physics, then the reward stack.  `state` is one
        state or a batch (an EnvState or a LeanEnvState: only
        .pipeline.{qpos,qvel,qacc_warmstart} and .info are read), `action`
        (nu,) or (B, nu); returns an EnvState with the pipeline's derived
        fields, of the same shape."""
        dtype = self._dtype
        single = state.pipeline.qpos.dim() == 1
        add = (lambda x: x[None]) if single else (lambda x: x)
        ps = state.pipeline
        qpos, qvel, ws = (add(x.to(dtype)) for x in (ps.qpos, ps.qvel, ps.qacc_warmstart))
        qpos2, qvel2, _, der, ctrl, reward, done, info2, ps2 = self._step_batch(
            qpos, qvel, ws, map_tensors(state.info, add), add(torch.as_tensor(action, dtype=dtype, device=self.device)),
            use_fused=False,
        )
        obs = self._get_obs(qpos2, qvel2, der["torso_xpos"], der["torso_xquat"],
                            der["torso_cvel"], der["root_com"], info2, ctrl)
        out = EnvState(pipeline=ps2, obs=obs, reward=reward, done=done, info=info2)
        return map_tensors(out, lambda x: x[0]) if single else out

    def _reset_state(self, pos_tar, generator=None) -> EnvState:
        """Keyframe "home" at rest, zero warmstart (as after
        mj_resetData).  Under `randomize_tasks` the episode's command seed
        is drawn from `generator` (on the env's device; no draw without
        one, and none without randomize_tasks, which reads no seed): 0
        otherwise."""
        m = self.model
        n_feet = len(self.FEET_SITES)
        if self.config.randomize_tasks and generator is not None:
            seed = torch.randint(0, 2**62, (), generator=generator, device=self.device)
        else:
            seed = self._zeros(dtype=torch.int64)
        info = StateInfo(
            pos_tar=torch.tensor(pos_tar, dtype=self._dtype, device=self.device),
            vel_tar=self._zeros(3),
            ang_vel_tar=self._zeros(3),
            yaw_tar=self._zeros(),
            step=self._zeros(dtype=torch.int32),
            z_feet=self._zeros(n_feet),
            z_feet_tar=self._zeros(n_feet),
            last_contact=self._zeros(n_feet, dtype=torch.bool),
            feet_air_time=self._zeros(n_feet),
            seed=seed,
        )
        qpos = torch.as_tensor(self._init_q, dtype=self._dtype, device=self.device)
        return self.full_state(
            qpos, self._zeros(m.nv), self._zeros(m.nv), info,
            reward=self._zeros(), done=self._zeros(dtype=torch.bool),
        )

    def sample_command(self, seed: torch.Tensor, step: torch.Tensor):
        """The `randomize_tasks` command for (seed, step), over any batch
        shape: (vel_tar [lx, ly, 0], ang_vel_tar [0, 0, yaw rate]), each
        uniform in the env's COMMAND_RANGE (the JAX env's sample_command)."""
        u = command_uniforms(seed, step, 3, self._dtype)
        lo_hi = [(-r, r) for r in self.COMMAND_RANGE]
        lx, ly, yw = (lo + (hi - lo) * x for (lo, hi), x in zip(lo_hi, u))
        zero = torch.zeros_like(lx)
        return torch.stack([lx, ly, zero], dim=-1), torch.stack([zero, zero, yw], dim=-1)

    def _redrawn_command(self, info: StateInfo):
        """`randomize_tasks`' schedule: at step % 500 == 0 a new command,
        else the carried one."""
        redraw = ((info.step % REDRAW_PERIOD) == 0)[..., None]
        new_vel, new_ang = self.sample_command(info.seed, info.step)
        return (torch.where(redraw, new_vel, info.vel_tar),
                torch.where(redraw, new_ang, info.ang_vel_tar))

    def act2joint(self, act: torch.Tensor) -> torch.Tensor:
        """Normalized action (..., nu) in [-1, 1] -> joint targets."""
        jr, pr = self.joint_range, self.physical_joint_range
        act_normalized = (act * self.config.action_scale + 1.0) / 2.0
        targets = jr[:, 0] + act_normalized * (jr[:, 1] - jr[:, 0])
        return torch.minimum(torch.maximum(targets, pr[:, 0]), pr[:, 1])

    def _act2tau_qv(self, act, q, qd):
        """PD torque map toward the action's joint targets."""
        target = self.act2joint(act)
        tau = self.config.kp * (target - q) - self.config.kd * qd
        tr = self.joint_torque_range
        return torch.minimum(torch.maximum(tau, tr[:, 0]), tr[:, 1])

    def _body_velocities(self, torso_xpos, torso_xquat, torso_cvel, root_com):
        """Torso body-frame linear/angular velocity."""
        offset = torso_xpos - root_com
        cvel_ang = torso_cvel[..., :3]
        cvel_lin = torso_cvel[..., 3:]
        vel_lin = cvel_lin - torch.linalg.cross(offset, cvel_ang, dim=-1)
        vb = rot.global_to_body_velocity(vel_lin, torso_xquat)
        ab = rot.global_to_body_velocity(cvel_ang, torso_xquat)
        return vb, ab

    def _get_obs(self, qpos, qvel, torso_xpos, torso_xquat, torso_cvel, root_com, info, ctrl):
        """[vel_tar, ang_vel_tar, ctrl, qpos, vb, ab, qvel[6:]]."""
        vb, ab = self._body_velocities(torso_xpos, torso_xquat, torso_cvel, root_com)
        return torch.cat(
            [info.vel_tar, info.ang_vel_tar, ctrl, qpos, vb, ab, qvel[..., 6:]], dim=-1
        )
