"""Unitree Go2 quadruped environment (batched torch).

Counterpart of `tpu_dialmpc/envs/go2.py`: the same config fields, action
maps, reward stack (with the crate tasks' terrain-aware targets),
termination and observation.  `step` runs the physics pipeline
(`dynamics/pipeline.py`, the JAX package's XLA path) on one state or a
batch; the executed step `step_lean` and the planner's rollouts
`rollout_batch` run the physics the config's `fused` picks
(`envs/fused_rollout.py`): the fused substep, as on the JAX package's TPU
path, or the pipeline.

On CUDA tensors the PD map and the reward stack are one launch each, the
hand-written kernels of `csrc/go2_env_step.cu` (`envs/go2_cuda.py`); on CPU
tensors they run as the PyTorch ops below, their plain version.

Legs are torque-controlled (the PD map onto `<motor>`s) or, with
`leg_control="position"`, position-controlled: the action's joint targets go
to the model's `<position>` servos as ctrl (the go2_position scene).

With `randomize_tasks` the command is redrawn every 500 steps, uniform in
lin x ±1.5, lin y ±0.5, yaw rate ±1.5 (the JAX env's ranges), from the
episode's seed (`LeggedEnv.sample_command`); the draws are not the JAX
package's threefry ones.  `joint_range_source` takes the JAX env's values:
the upstream and "climb" tables (12 motors), "model_eigen", and the model's
ranges for any other value.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from tpu_dialmpc_torch.core import rotations as rot
from tpu_dialmpc_torch.dynamics.model import JNT_HINGE, PhysicsModel, load_scene
from tpu_dialmpc_torch.envs import gait
from tpu_dialmpc_torch.envs.base import EnvState, StateInfo
from tpu_dialmpc_torch.envs.fused_rollout import pick_physics
from tpu_dialmpc_torch.envs.go2_cuda import Go2EnvKernels
from tpu_dialmpc_torch.envs.legged import LeggedEnv


@dataclasses.dataclass(frozen=True)
class UnitreeGo2EnvConfig:
    """The JAX package's UnitreeGo2EnvConfig fields, with the same defaults
    (see tpu_dialmpc/envs/go2.py for each field's story)."""

    kp: float = 30.0
    kd: float = 1.0
    action_scale: float = 1.0
    default_vx: float = 0.0
    default_vy: float = 0.0
    default_vyaw: float = 0.0
    ramp_up_time: float = 1.0
    gait: str = "stand"
    timestep: float = 0.0025
    randomize_tasks: bool = False
    leg_control: str = "torque"  # "torque" | "position"
    n_substeps: int = 1
    scene: str = "go2_force"
    energy_weight: float = 0.0
    dtype: str = "float32"
    fused: str = "auto"  # "auto" | "on" | "off" (envs/fused_rollout.py)
    joint_range_source: str = "upstream"  # "upstream" | "climb" | "model_eigen"; else "model"
    termination_range_source: str = "action"  # "action" | "physical"
    turn_period: int = 0
    yaw_mode: str = "atan2"  # "atan2" | "eigen"
    crate_top_z: float = 0.0
    crate_ramp: float = 0.40
    crate_x: float = 0.0
    goal_x: float = 0.0
    y_anchor_weight: float = 0.0
    vel_weight: float = 1.0
    done_penalty: float = 0.0


class UnitreeGo2Env(LeggedEnv):
    """Go2 env on one device; its methods take batched tensors."""

    FEET_SITES = ("FL_foot", "FR_foot", "RL_foot", "RR_foot")
    TORSO_BODY = "base"
    COMMAND_RANGE = (1.5, 0.5, 1.5)  # randomize_tasks: |lin x|, |lin y|, |yaw rate|

    def __init__(
        self,
        config: UnitreeGo2EnvConfig = UnitreeGo2EnvConfig(),
        device: torch.device | str = "cuda",
        model: PhysicsModel | None = None,
    ):
        self.config = config
        self.device = torch.device(device)
        self._dtype = {"float32": torch.float32, "float64": torch.float64}[config.dtype]
        if model is None:
            model = load_scene(config.scene)
        self._crate = None  # (cx, cy, hx, hy, top_z) when crate_top_z > 0
        if config.crate_top_z > 0.0 or config.crate_x != 0.0:
            model = self._place_crate(model, config)
        self.model: PhysicsModel = model.with_options(timestep=config.timestep)
        self._torso_idx = self.model.body_names.index(self.TORSO_BODY)
        feet = [self.model.site_names.index(s) for s in self.FEET_SITES]
        key_qpos = self.model.key_qpos.get("home")
        self._init_q = np.asarray(key_qpos if key_qpos is not None else self.model.qpos0)

        hinge = [j for j in range(self.model.njnt) if self.model.jnt_type[j] == JNT_HINGE]
        model_range = np.asarray(self.model.jnt_range)[hinge]
        nu = self.model.nu
        if config.joint_range_source == "upstream" and nu == 12:
            # upstream dial-mpc table (dial_mpc/include/UnitreeGo2Env.h:276-288)
            joint_range = np.array(
                [[-0.5, 0.5], [0.4, 1.4], [-2.3, -0.85]] * 2
                + [[-0.5, 0.5], [0.4, 1.4], [-2.3, -1.3]] * 2
            )
            physical = model_range.copy()
        elif config.joint_range_source == "climb" and nu == 12:
            # the upstream table widened for mounting an obstacle (thigh
            # flexion and calf extension past it, inside the model's ranges)
            joint_range = np.array([[-0.6, 0.6], [0.0, 2.1], [-2.6, -0.7]] * 4)
            physical = model_range.copy()
        elif config.joint_range_source == "model_eigen":
            # quirk Q10: jnt_range rows 0..nu-1, including the freejoint's row
            joint_range = np.asarray(self.model.jnt_range)[:nu]
            physical = joint_range.copy()
        else:
            joint_range = model_range
            physical = model_range.copy()
        # torque limits from actuator ctrlrange; (0,0) -> unlimited
        cr = np.asarray(self.model.actuator_ctrlrange)
        unlimited = np.all(np.abs(cr) < 1e-6, axis=1)
        torque_range = np.where(unlimited[:, None], np.array([[-np.inf, np.inf]]), cr)
        termination = (
            model_range[:nu] if config.termination_range_source == "physical" else joint_range
        )
        self._foot_radius = 0.0175
        gait_name = config.gait if config.gait in gait.GAIT_PHASES else "trot"
        self._gait_params = tuple(float(x) for x in gait.GAIT_PARAMS[gait_name])

        self.joint_range = self._tensor(joint_range)
        self.physical_joint_range = self._tensor(physical)
        self.joint_torque_range = self._tensor(torque_range)
        self.termination_joint_range = self._tensor(termination)
        self._gait_phases = self._tensor(gait.GAIT_PHASES[gait_name])
        # every index and constant the per-step ops need, on the device, once
        self._feet_site_id = self._tensor(feet, torch.long)
        self._up_global = self._tensor([0.0, 0.0, 1.0])
        self._on_fused = pick_physics(self.model, config.fused, self.device, self._fused_spec())
        # the PD map's and the reward stack's CUDA kernels, with the config
        # packed once, on a CUDA env (built at their first launch)
        self._env_kernels = Go2EnvKernels(self) if self.device.type == "cuda" else None

    def launch_counters(self):
        """The Python launch counters a captured env step adds to: the fused
        kernel's on its path, and on a CUDA env the env kernels'."""
        out = super().launch_counters()
        return out + self._env_kernels.counters if self._env_kernels is not None else out

    def _place_crate(self, model: PhysicsModel, config) -> PhysicsModel:
        """Move the mocap crate `box_body` as the JAX env does before
        `compile_model`: its x to `crate_x`, and its z so the top face sits
        at `crate_top_z`.  The compiled model reads the pose only from
        `body_pos`, so patching that row equals compiling the moved scene."""
        if "box_body" not in model.body_names:
            raise ValueError(
                f"crate_top_z/crate_x set but scene {config.scene!r} has no "
                "'box_body' (use the go2_force_crate scene)"
            )
        bid = model.body_names.index("box_body")
        gid = int(np.flatnonzero(np.asarray(model.geom_bodyid) == bid)[0])
        body_pos = np.array(model.body_pos, copy=True)
        if config.crate_x != 0.0:
            body_pos[bid, 0] = config.crate_x
        if config.crate_top_z > 0.0:
            half_z = float(model.geom_size[gid, 2])
            body_pos[bid, 2] = config.crate_top_z - half_z
            self._crate = (
                float(body_pos[bid, 0]),
                float(body_pos[bid, 1]),
                float(model.geom_size[gid, 0]),
                float(model.geom_size[gid, 1]),
                float(config.crate_top_z),
            )
        return model.with_options(body_pos=body_pos)

    # ------------------------------------------------------------------
    def reset(self, generator: torch.Generator | None = None) -> EnvState:
        """Keyframe "home" at rest (`LeggedEnv._reset_state`; `generator`
        draws the randomize_tasks seed)."""
        return self._reset_state([0.282, 0.0, 0.3], generator)

    def _ctrl_batch(self, action, qpos, qvel):
        """Batched action (..., nu) -> ctrl (..., nu): the joint targets in
        position mode, else the PD torque map.  CUDA tensors: one launch of
        `go2_ctrl`; CPU tensors: `_ctrl_batch_plain`."""
        if action.device.type == "cuda":
            flat = (x.reshape(-1, x.shape[-1]) for x in (action, qpos, qvel))
            return self._env_kernels.ctrl(*flat).reshape(action.shape)
        return self._ctrl_batch_plain(action, qpos, qvel)

    def _ctrl_batch_plain(self, action, qpos, qvel):
        """`_ctrl_batch` as PyTorch ops, on any device."""
        if self.config.leg_control == "position":
            return self.act2joint(action)
        nu = self.model.nu
        return self._act2tau_qv(action, qpos[..., 7 : 7 + nu], qvel[..., 6 : 6 + nu])

    # ------------------------------------------------------------------
    def _foot_step_target(self, step):
        duty, cadence, amplitude = self._gait_params
        t = step.to(self._dtype) * self.dt
        return gait.get_foot_step(
            duty, cadence, amplitude, self._gait_phases, t[..., None]
        ).to(self._dtype)

    def _support_z(self, x, y):
        """Support-surface height under (x, y): the crate top inside the
        box footprint, the ground elsewhere.  Elementwise over any shape."""
        cx, cy, hx, hy, top = self._crate
        inside = (torch.abs(x - cx) < hx) & (torch.abs(y - cy) < hy)
        return inside.to(self._dtype) * top

    def _post_physics(
        self,
        qpos,
        qvel,
        site_xpos,
        torso_xpos,
        torso_xquat,
        torso_cvel,
        root_com,
        qfrc_actuator,
        info: StateInfo,
        ctrl,
    ):
        """Command schedule + rewards + termination + info update, over a
        leading batch shape (...) — the JAX package's `_post_physics`, which
        `step_lean` and `rollout_batch` both call.  CUDA tensors: one launch of
        `go2_post_physics`; CPU tensors: `_post_physics_plain`."""
        if qpos.device.type == "cuda":
            return self._post_physics_kernel(qpos, qvel, site_xpos, torso_xpos, torso_xquat,
                                             torso_cvel, root_com, qfrc_actuator, info)
        return self._post_physics_plain(qpos, qvel, site_xpos, torso_xpos, torso_xquat,
                                        torso_cvel, root_com, qfrc_actuator, info)

    def _post_physics_plain(self, qpos, qvel, site_xpos, torso_xpos, torso_xquat, torso_cvel,
                            root_com, qfrc_actuator, info: StateInfo):
        """`_post_physics` as PyTorch ops, on any device."""
        cfg = self.config
        dtype = self._dtype
        dt = self.dt

        # command schedule: the randomize_tasks redraw, or the exact
        # reference ramp min(v·t/T, v)
        if cfg.randomize_tasks:
            vel_tar, ang_vel_tar = self._redrawn_command(info)
        else:
            t = info.step.to(dtype) * dt
            frac = t / cfg.ramp_up_time
            vx = torch.clamp(cfg.default_vx * frac, max=cfg.default_vx)
            vy = torch.clamp(cfg.default_vy * frac, max=cfg.default_vy)
            if cfg.turn_period:
                sign = (1.0 - 2.0 * ((info.step // cfg.turn_period) % 2)).to(dtype)
                mag = torch.clamp(abs(cfg.default_vyaw) * frac, max=abs(cfg.default_vyaw))
                vyaw = mag * sign
            else:
                vyaw = torch.clamp(cfg.default_vyaw * frac, max=cfg.default_vyaw)
            vel_tar = torch.stack([vx, vy, info.vel_tar[..., 2]], dim=-1)
            ang_vel_tar = torch.stack(
                [info.ang_vel_tar[..., 0], info.ang_vel_tar[..., 1], vyaw], dim=-1
            )
        if cfg.goal_x > 0.0:
            gate = (torso_xpos[..., 0] < cfg.goal_x).to(dtype)
            vel_tar = torch.cat([vel_tar[..., :1] * gate[..., None], vel_tar[..., 1:]], dim=-1)

        # rewards
        feet = site_xpos[..., self._feet_site_id, :]
        z_feet = feet[..., 2]
        z_feet_tar = self._foot_step_target(info.step)
        if self._crate is not None:
            # terrain-aware foot targets: the max of the ground-referenced
            # swing profile and the support under each foot
            z_feet_tar = torch.maximum(z_feet_tar, self._support_z(feet[..., 0], feet[..., 1]))
        reward_gaits = -torch.sum(((z_feet_tar - z_feet) / 0.05) ** 2, dim=-1)

        up_global = self._up_global
        up_body = rot.rotate(up_global, torso_xquat)
        reward_upright = -torch.sum((up_body - up_global) ** 2, dim=-1)

        if cfg.turn_period:
            yaw_tar = info.yaw_tar + ang_vel_tar[..., 2] * dt
        else:
            yaw_tar = info.yaw_tar + ang_vel_tar[..., 2] * dt * info.step.to(dtype)
        if cfg.yaw_mode == "eigen":
            yaw = rot.quat_to_yaw_eigen(torso_xquat)
        else:
            yaw = rot.quat_to_yaw(torso_xquat)
        d_yaw = yaw - yaw_tar
        wrapped = torch.atan2(torch.sin(d_yaw), torch.cos(d_yaw))
        reward_yaw = -(wrapped**2)

        vb, ab = self._body_velocities(torso_xpos, torso_xquat, torso_cvel, root_com)
        reward_vel = -torch.sum((vb[..., :2] - vel_tar[..., :2]) ** 2, dim=-1)
        reward_ang_vel = -((ab[..., 2] - ang_vel_tar[..., 2]) ** 2)

        z_torso = torso_xpos[..., 2]
        z_tar = info.pos_tar[..., 2]
        if self._crate is not None:
            # the torso target ramps onto the crate from 0.15 m before the
            # front edge over crate_ramp
            cx, _, hx, _, top = self._crate
            frac = torch.clamp(
                (torso_xpos[..., 0] - (cx - hx - 0.15)) / cfg.crate_ramp, 0.0, 1.0
            )
            z_tar = z_tar + top * frac
        reward_height = -((z_torso - z_tar) ** 2)

        reward_energy = torch.zeros_like(reward_height)
        if cfg.energy_weight != 0.0:
            tau = qfrc_actuator[..., 6:]
            qd = qvel[..., 6:]
            reward_energy = -torch.sum(torch.clamp(tau * qd / 160.0, min=0.0) ** 2, dim=-1)

        reward = (
            0.1 * reward_gaits
            + 0.5 * reward_upright
            + 0.3 * reward_yaw
            + cfg.vel_weight * reward_vel
            + 1.0 * reward_ang_vel
            + 1.0 * reward_height
            + cfg.energy_weight * reward_energy
        )
        if cfg.y_anchor_weight != 0.0:
            reward = reward - cfg.y_anchor_weight * (
                (torso_xpos[..., 1] - info.pos_tar[..., 1]) ** 2
            )

        # termination
        jr = self.termination_joint_range
        joint_angles = qpos[..., 7 : 7 + self.model.nu]
        out_of_range = torch.any((joint_angles < jr[:, 0]) | (joint_angles > jr[:, 1]), dim=-1)
        done = (torch.sum(up_body * up_global, dim=-1) < 0.0) | out_of_range | (z_torso < 0.18)
        if cfg.done_penalty != 0.0:
            reward = reward - cfg.done_penalty * done.to(dtype)

        # contact / air-time tracking
        contact = (z_feet - self._foot_radius) < 1e-3
        contact_filt = contact | info.last_contact
        feet_air_time = torch.where(contact_filt, 0.0, info.feet_air_time + dt)

        new_info = StateInfo(
            pos_tar=info.pos_tar,
            vel_tar=vel_tar,
            ang_vel_tar=ang_vel_tar,
            yaw_tar=yaw_tar if cfg.turn_period else info.yaw_tar,
            step=info.step + 1,
            z_feet=z_feet,
            z_feet_tar=z_feet_tar,
            last_contact=contact,
            feet_air_time=feet_air_time,
            seed=info.seed,
        )
        return reward, done, new_info

    def _post_physics_kernel(self, qpos, qvel, site_xpos, torso_xpos, torso_xquat, torso_cvel,
                             root_com, qfrc_actuator, info: StateInfo):
        """`_post_physics` as one launch of `go2_post_physics`: the inputs as
        (B, ...) views over the leading batch shape, the outputs back in it."""
        lead = tuple(qpos.shape[:-1])
        m = self.model

        def b(x, *inner):  # a view where lead is one dimension; stride 0 stays 0
            return x.expand(lead + inner).reshape((math.prod(lead),) + inner)

        flat_info = dataclasses.replace(
            info, pos_tar=b(info.pos_tar, 3), vel_tar=b(info.vel_tar, 3),
            ang_vel_tar=b(info.ang_vel_tar, 3), yaw_tar=b(info.yaw_tar), step=b(info.step),
            last_contact=b(info.last_contact, 4), feet_air_time=b(info.feet_air_time, 4),
            seed=b(info.seed))
        reward, done, out = self._env_kernels.post_physics(
            b(qpos, m.nq), b(qvel, m.nv), b(site_xpos, m.nsite, 3), b(torso_xpos, 3),
            b(torso_xquat, 4), b(torso_cvel, 6), b(root_com, 3), b(qfrc_actuator, m.nv),
            flat_info)
        out = {k: v.reshape(lead + v.shape[1:]) for k, v in out.items()}
        new_info = dataclasses.replace(info, step=out.pop("step"),
                                       yaw_tar=out.pop("yaw_tar", info.yaw_tar), **out)
        return reward.reshape(lead), done.reshape(lead), new_info
