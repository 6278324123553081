"""Unitree H1 humanoid environment (batched torch).

Counterpart of `tpu_dialmpc/envs/h1.py`: the same config fields, action
ranges (home-centered, with narrower arm and torso authority), PD torque
map, reward stack (gait, upright, yaw, velocity, height, the xy position
anchor with its leash or crate mode, energy, the capped crate velocity),
termination and observation.  As in the Go2 env, `step` runs the physics
pipeline (`dynamics/pipeline.py`) on one state or a batch, and the executed
step `step_lean` and the planner's rollouts `rollout_batch` run the physics
the config's `fused` picks (`envs/fused_rollout.py`).

Two things the JAX env reads through mujoco come from the compiled model
instead: the joint names (`jnt_names`, from the MJCF, or the model file's
entry that `tests/assets/export_npz.py` writes) and the feet sites'
ground-contact heights, which the plain forward kinematics computes at the
home keyframe in float64.

Legs are torque-controlled (the PD map), or with `leg_control="position"`
the action's joint targets go to the model's actuators as ctrl, as in the
JAX env.  The walking and arms-fixed scenes (h1_walk, h1_loco) have no
crate: the env finds no unactuated slide joint, so the crate terms stay
inert and the crate anchor falls back to the integrated one.

With `randomize_tasks` the command is redrawn every 500 steps, uniform in
lin x ±1.0, lin y ±0.5, yaw rate ±1.0 (the JAX env's ranges), from the
episode's seed (`LeggedEnv.sample_command`); the draws are not the JAX
package's threefry ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from tpu_dialmpc_torch.core import rotations as rot
from tpu_dialmpc_torch.dynamics import fused
from tpu_dialmpc_torch.dynamics.model import JNT_SLIDE, PhysicsModel, load_scene
from tpu_dialmpc_torch.envs import gait
from tpu_dialmpc_torch.envs.base import EnvState, StateInfo
from tpu_dialmpc_torch.envs.fused_rollout import pick_physics
from tpu_dialmpc_torch.envs.legged import LeggedEnv


@dataclasses.dataclass(frozen=True)
class UnitreeH1EnvConfig:
    """The JAX package's UnitreeH1EnvConfig fields, with the same defaults
    (see tpu_dialmpc/envs/h1.py for each field's story)."""

    kp: float = 200.0
    kd: float = 5.0
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
    scene: str = "h1_walk"
    pos_tar_z: float = 0.98
    dtype: str = "float32"
    fused: str = "auto"  # "auto" | "on" | "off" (envs/fused_rollout.py)
    joint_range_source: str = "centered"  # "centered"; else the model's ranges
    action_halfwidth: float = 0.7
    arm_halfwidth: float = 0.25
    energy_weight: float = 0.0
    yaw_mode: str = "atan2"  # "atan2" | "eigen"
    pos_anchor_weight: float = 1.0
    pos_anchor_leash: float = 0.0
    crate_vel_weight: float = 0.0
    crate_vel_cap: float = 0.3
    pos_anchor_mode: str = "integrate"  # "integrate" | "crate"
    crate_standoff: float = 0.75
    done_penalty: float = 0.0


class UnitreeH1Env(LeggedEnv):
    """H1 env on one device; its methods take batched tensors."""

    FEET_SITES = ("left_foot", "right_foot")
    TORSO_BODY = "pelvis"
    COMMAND_RANGE = (1.0, 0.5, 1.0)  # randomize_tasks: |lin x|, |lin y|, |yaw rate|

    def __init__(
        self,
        config: UnitreeH1EnvConfig = UnitreeH1EnvConfig(),
        device: torch.device | str = "cuda",
        model: PhysicsModel | None = None,
    ):
        self.config = config
        self.device = torch.device(device)
        self._dtype = {"float32": torch.float32, "float64": torch.float64}[config.dtype]
        if model is None:
            model = load_scene(config.scene)
        m = self.model = model.with_options(timestep=config.timestep)
        self._torso_idx = m.body_names.index(self.TORSO_BODY)
        feet = [m.site_names.index(s) for s in self.FEET_SITES]
        key_qpos = m.key_qpos.get("home")
        self._init_q = np.asarray(key_qpos if key_qpos is not None else m.qpos0)

        # actuated joints: actuator -> (joint, qpos address, dof address)
        dof_to_jnt = {int(m.jnt_dofadr[j]): j for j in range(m.njnt)}
        act_jnt = [dof_to_jnt[int(d)] for d in m.actuator_dofadr]
        act_qadr = np.array([int(m.jnt_qposadr[j]) for j in act_jnt])
        act_dadr = np.array(m.actuator_dofadr)
        model_range = np.asarray(m.jnt_range)[act_jnt]
        if config.joint_range_source == "centered":
            if not m.jnt_names:
                raise ValueError(
                    "joint_range_source='centered' reads the joint names; this model "
                    "carries none (compile it from its MJCF, or re-export it with "
                    "tests/assets/export_npz.py)"
                )
            # symmetric about home so act=0 targets exactly the home pose
            home_j = self._init_q[act_qadr]
            halfwidth = np.array([
                config.arm_halfwidth
                if any(k in m.jnt_names[j] for k in ("shoulder", "elbow", "torso"))
                else config.action_halfwidth
                for j in act_jnt
            ])
            w = np.minimum(
                halfwidth, np.minimum(home_j - model_range[:, 0], model_range[:, 1] - home_j)
            )
            w = np.maximum(w, 0.05)
            joint_range = np.stack(
                [np.maximum(home_j - w, model_range[:, 0]),
                 np.minimum(home_j + w, model_range[:, 1])],
                axis=1,
            )
        else:  # "model", and any other value, as the JAX env takes it
            joint_range = model_range
        cr = np.asarray(m.actuator_ctrlrange)
        unlimited = np.all(np.abs(cr) < 1e-6, axis=1)
        torque_range = np.where(unlimited[:, None], np.array([[-np.inf, np.inf]]), cr)
        g = config.gait if config.gait in gait.BIPED_GAIT_PHASES else "walk"
        self._gait_params = tuple(float(x) for x in gait.BIPED_GAIT_PARAMS[g])

        # the feet sites' ground-contact heights: their height at home
        q = [torch.tensor([float(x)], dtype=torch.float64) for x in self._init_q[: m.nq]]
        site_xpos = fused._fk(m, q)["site_xpos"]
        foot_contact_z = [float(site_xpos[s][2]) for s in feet]

        # the unactuated slide joint is the crate's dof (None without a crate)
        act_dofs = {int(d) for d in m.actuator_dofadr}
        free_slides = [
            j for j in range(m.njnt)
            if int(m.jnt_type[j]) == JNT_SLIDE and int(m.jnt_dofadr[j]) not in act_dofs
        ]
        self._crate_dof = int(m.jnt_dofadr[free_slides[0]]) if free_slides else None
        self._crate_qadr = int(m.jnt_qposadr[free_slides[0]]) if free_slides else None

        # every index and constant the per-step ops need, on the device, once
        self._act_qadr = self._tensor(act_qadr, torch.long)
        self._act_dadr = self._tensor(act_dadr, torch.long)
        self._feet_idx = self._tensor(feet, torch.long)
        self.joint_range = self._tensor(joint_range)
        self.physical_joint_range = self._tensor(model_range)
        self.joint_torque_range = self._tensor(torque_range)
        self._gait_phases = self._tensor(gait.BIPED_GAIT_PHASES[g])
        self._up_global = self._tensor([0.0, 0.0, 1.0])
        self._foot_contact_z = self._tensor(foot_contact_z)
        self._on_fused = pick_physics(m, config.fused, self.device, self._fused_spec())

    # ------------------------------------------------------------------
    def reset(self, generator: torch.Generator | None = None) -> EnvState:
        """Keyframe "home" at rest (`LeggedEnv._reset_state`; `generator`
        draws the randomize_tasks seed)."""
        return self._reset_state([0.0, 0.0, self.config.pos_tar_z], generator)

    def _ctrl_batch(self, action, qpos, qvel):
        """Batched action (..., nu) -> ctrl (..., nu): the joint targets in
        position mode, else the PD torque map."""
        if self.config.leg_control == "position":
            return self.act2joint(action)
        return self._act2tau_qv(action, qpos[..., self._act_qadr], qvel[..., self._act_dadr])

    # ------------------------------------------------------------------
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
        `step_lean` and `rollout_batch` both call."""
        cfg = self.config
        dtype = self._dtype
        dt = self.dt
        step = info.step.to(dtype)

        # command schedule: the randomize_tasks redraw, or the ramp
        # min(v·t/T, v)
        if cfg.randomize_tasks:
            vel_tar, ang_vel_tar = self._redrawn_command(info)
        else:
            frac = step * dt / cfg.ramp_up_time
            vel_tar = torch.stack([
                torch.clamp(cfg.default_vx * frac, max=cfg.default_vx),
                torch.clamp(cfg.default_vy * frac, max=cfg.default_vy),
                info.vel_tar[..., 2],
            ], dim=-1)
            ang_vel_tar = torch.stack([
                info.ang_vel_tar[..., 0],
                info.ang_vel_tar[..., 1],
                torch.clamp(cfg.default_vyaw * frac, max=cfg.default_vyaw),
            ], dim=-1)

        z_feet = site_xpos[..., self._feet_idx, 2]
        duty, cadence, amplitude = self._gait_params
        z_feet_tar = gait.get_foot_step(
            duty, cadence, amplitude, self._gait_phases, (step * dt)[..., None]
        ).to(dtype)
        reward_gaits = -torch.sum(((z_feet_tar - z_feet) / 0.05) ** 2, dim=-1)

        up_global = self._up_global
        up_body = rot.rotate(up_global, torso_xquat)
        reward_upright = -torch.sum((up_body - up_global) ** 2, dim=-1)

        yaw_tar = info.yaw_tar + ang_vel_tar[..., 2] * dt * step
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
        reward_height = -((z_torso - info.pos_tar[..., 2]) ** 2)

        # the xy position anchor: at the crate minus a standoff, or integrated
        # open-loop by the commanded velocity (and leashed to the torso)
        crate_anchored = cfg.pos_anchor_mode == "crate" and self._crate_qadr is not None
        if crate_anchored:
            pos_tar = torch.stack([
                qpos[..., self._crate_qadr] - cfg.crate_standoff,
                torch.zeros_like(z_torso),
                info.pos_tar[..., 2],
            ], dim=-1)
        else:
            pos_tar = info.pos_tar + vel_tar * dt
        if not crate_anchored and cfg.pos_anchor_leash > 0.0:
            err = pos_tar[..., :2] - torso_xpos[..., :2]
            n = torch.sqrt(torch.sum(err**2, dim=-1))
            scale = torch.clamp(cfg.pos_anchor_leash / torch.clamp(n, min=1e-6), max=1.0)
            pos_tar = torch.cat(
                [torso_xpos[..., :2] + err * scale[..., None], pos_tar[..., 2:]], dim=-1
            )
        reward_pos = -torch.sum((torso_xpos[..., :2] - pos_tar[..., :2]) ** 2, dim=-1)

        reward_energy = torch.zeros_like(reward_height)
        if cfg.energy_weight != 0.0:
            tau = qfrc_actuator[..., 6:]
            qd = qvel[..., 6:]
            reward_energy = -torch.sum(torch.clamp(tau * qd / 160.0, min=0.0) ** 2, dim=-1)

        reward_crate = torch.zeros_like(reward_height)
        if cfg.crate_vel_weight != 0.0 and self._crate_dof is not None:
            cap = cfg.crate_vel_cap
            reward_crate = torch.clamp(qvel[..., self._crate_dof], -cap, cap)

        reward = (
            0.1 * reward_gaits
            + 0.5 * reward_upright
            + 0.3 * reward_yaw
            + 1.0 * reward_vel
            + 1.0 * reward_ang_vel
            + 1.0 * reward_height
            + cfg.energy_weight * reward_energy
            + cfg.pos_anchor_weight * reward_pos
            + cfg.crate_vel_weight * reward_crate
        )

        # termination on the physical joint ranges, 0.05 rad of slack
        jr = self.physical_joint_range
        joint_angles = qpos[..., self._act_qadr]
        out_of_range = torch.any(
            (joint_angles < jr[:, 0] - 0.05) | (joint_angles > jr[:, 1] + 0.05), dim=-1
        )
        done = (torch.sum(up_body * up_global, dim=-1) < 0.0) | out_of_range | (z_torso < 0.5)
        if cfg.done_penalty != 0.0:
            reward = reward - cfg.done_penalty * done.to(dtype)

        # foot contact: the site's height against its height at home
        contact = (z_feet - self._foot_contact_z) < 1e-3
        feet_air_time = torch.where(
            contact | info.last_contact, 0.0, info.feet_air_time + dt
        )

        new_info = StateInfo(
            pos_tar=pos_tar,
            vel_tar=vel_tar,
            ang_vel_tar=ang_vel_tar,
            yaw_tar=info.yaw_tar,
            step=info.step + 1,
            z_feet=z_feet,
            z_feet_tar=z_feet_tar,
            last_contact=contact,
            feet_air_time=feet_air_time,
            seed=info.seed,
        )
        return reward, done, new_info
