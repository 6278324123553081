"""The Go2 and H1 tasks' action map, reward stack and info update, over the
physics pipeline: the plain form of one env step that the benchmark's
comparison holds the program's against.

Copied from `tpu_dialmpc_torch/envs/{go2,h1,legged}.py` at commit ce76357
(the constructors' constants, `_ctrl_batch`, `_post_physics` and their
helpers), with the physics always the pipeline (`pipeline.py`, the frozen
copy beside this file) and the state's info a plain dict.  The task's
config is the dict that the benchmark's configuration file gives both
sides.  Options that neither configuration uses (the randomized commands,
the Go2 crate, position servos) raise.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from . import gait, kinematics, pipeline
from . import rotations as rot
from .model import JNT_HINGE, JNT_SLIDE, PhysicsModel


class _Legged:
    """What both robots share; subclasses set the constants."""

    def __init__(self, cfg: dict, model: PhysicsModel, device, dtype):
        if cfg.get("randomize_tasks"):
            raise NotImplementedError("the reference does not model randomize_tasks")
        if cfg.get("leg_control", "torque") != "torque":
            raise NotImplementedError("the reference models the PD torque map only")
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = dtype
        self.model = model.with_options(timestep=cfg["timestep"])
        self.dt = cfg["timestep"] * cfg["n_substeps"]
        self._torso_idx = self.model.body_names.index(self.TORSO_BODY)
        key_qpos = self.model.key_qpos.get("home")
        self.init_q = np.asarray(key_qpos if key_qpos is not None else self.model.qpos0)

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(np.asarray(x), dtype=dtype or self.dtype, device=self.device)

    def act2joint(self, act):
        jr, pr = self.joint_range, self.physical_joint_range
        act_normalized = (act * self.cfg["action_scale"] + 1.0) / 2.0
        targets = jr[:, 0] + act_normalized * (jr[:, 1] - jr[:, 0])
        return torch.minimum(torch.maximum(targets, pr[:, 0]), pr[:, 1])

    def _act2tau_qv(self, act, q, qd):
        target = self.act2joint(act)
        tau = self.cfg["kp"] * (target - q) - self.cfg["kd"] * qd
        tr = self.joint_torque_range
        return torch.minimum(torch.maximum(tau, tr[:, 0]), tr[:, 1])

    def _body_velocities(self, torso_xpos, torso_xquat, torso_cvel, root_com):
        offset = torso_xpos - root_com
        cvel_ang = torso_cvel[..., :3]
        cvel_lin = torso_cvel[..., 3:]
        vel_lin = cvel_lin - torch.linalg.cross(offset, cvel_ang, dim=-1)
        vb = rot.global_to_body_velocity(vel_lin, torso_xquat)
        ab = rot.global_to_body_velocity(cvel_ang, torso_xquat)
        return vb, ab

    def step(self, qpos, qvel, ws, info: dict, action):
        """One env step of a batch: (B, ...) state and info, (B, nu) action ->
        (qpos', qvel', warmstart', reward, done, info')."""
        ctrl = self.ctrl(action, qpos, qvel)
        ps = pipeline.step(self.model, SimpleNamespace(qpos=qpos, qvel=qvel, qacc_warmstart=ws),
                           ctrl, self.cfg["n_substeps"])
        b = self._torso_idx
        reward, done, info2 = self.post_physics(
            ps.qpos, ps.qvel, ps.site_xpos, ps.xpos[..., b, :], ps.xquat[..., b, :],
            ps.cvel[..., b, :], ps.subtree_com[..., int(self.model.body_rootid[b]), :],
            ps.qfrc_actuator, info)
        return ps.qpos, ps.qvel, ps.qacc_warmstart, reward, done, info2


class Go2(_Legged):
    FEET_SITES = ("FL_foot", "FR_foot", "RL_foot", "RR_foot")
    TORSO_BODY = "base"

    def __init__(self, cfg, model, device, dtype):
        super().__init__(cfg, model, device, dtype)
        if cfg.get("crate_top_z", 0.0) > 0.0 or cfg.get("crate_x", 0.0) != 0.0:
            raise NotImplementedError("the reference does not model the Go2 crate")
        m = self.model
        feet = [m.site_names.index(s) for s in self.FEET_SITES]
        hinge = [j for j in range(m.njnt) if m.jnt_type[j] == JNT_HINGE]
        model_range = np.asarray(m.jnt_range)[hinge]
        nu = m.nu
        src = cfg["joint_range_source"]
        if src == "upstream" and nu == 12:
            joint_range = np.array(
                [[-0.5, 0.5], [0.4, 1.4], [-2.3, -0.85]] * 2
                + [[-0.5, 0.5], [0.4, 1.4], [-2.3, -1.3]] * 2
            )
            physical = model_range.copy()
        elif src == "climb" and nu == 12:
            joint_range = np.array([[-0.6, 0.6], [0.0, 2.1], [-2.6, -0.7]] * 4)
            physical = model_range.copy()
        elif src == "model_eigen":
            joint_range = np.asarray(m.jnt_range)[:nu]
            physical = joint_range.copy()
        else:
            joint_range = model_range
            physical = model_range.copy()
        cr = np.asarray(m.actuator_ctrlrange)
        unlimited = np.all(np.abs(cr) < 1e-6, axis=1)
        torque_range = np.where(unlimited[:, None], np.array([[-np.inf, np.inf]]), cr)
        termination = model_range[:nu] if cfg["termination_range_source"] == "physical" \
            else joint_range
        gait_name = cfg["gait"] if cfg["gait"] in gait.GAIT_PHASES else "trot"
        self._gait_params = tuple(float(x) for x in gait.GAIT_PARAMS[gait_name])
        self.joint_range = self._tensor(joint_range)
        self.physical_joint_range = self._tensor(physical)
        self.joint_torque_range = self._tensor(torque_range)
        self.termination_joint_range = self._tensor(termination)
        self._gait_phases = self._tensor(gait.GAIT_PHASES[gait_name])
        self._feet_site_id = self._tensor(feet, torch.long)
        self._up_global = self._tensor([0.0, 0.0, 1.0])
        self.pos_tar = [0.282, 0.0, 0.3]

    def ctrl(self, action, qpos, qvel):
        nu = self.model.nu
        return self._act2tau_qv(action, qpos[..., 7: 7 + nu], qvel[..., 6: 6 + nu])

    def post_physics(self, qpos, qvel, site_xpos, torso_xpos, torso_xquat, torso_cvel,
                     root_com, qfrc_actuator, info):
        cfg, dtype, dt = self.cfg, self.dtype, self.dt
        step = info["step"]
        t = step.to(dtype) * dt
        frac = t / cfg["ramp_up_time"]
        vx = torch.clamp(cfg["default_vx"] * frac, max=cfg["default_vx"])
        vy = torch.clamp(cfg["default_vy"] * frac, max=cfg["default_vy"])
        if cfg["turn_period"]:
            sign = (1.0 - 2.0 * ((step // cfg["turn_period"]) % 2)).to(dtype)
            mag = torch.clamp(abs(cfg["default_vyaw"]) * frac, max=abs(cfg["default_vyaw"]))
            vyaw = mag * sign
        else:
            vyaw = torch.clamp(cfg["default_vyaw"] * frac, max=cfg["default_vyaw"])
        vel_tar = torch.stack([vx, vy, info["vel_tar"][..., 2]], dim=-1)
        ang_vel_tar = torch.stack(
            [info["ang_vel_tar"][..., 0], info["ang_vel_tar"][..., 1], vyaw], dim=-1)
        if cfg["goal_x"] > 0.0:
            gate = (torso_xpos[..., 0] < cfg["goal_x"]).to(dtype)
            vel_tar = torch.cat([vel_tar[..., :1] * gate[..., None], vel_tar[..., 1:]], dim=-1)

        feet = site_xpos[..., self._feet_site_id, :]
        z_feet = feet[..., 2]
        duty, cadence, amplitude = self._gait_params
        z_feet_tar = gait.get_foot_step(
            duty, cadence, amplitude, self._gait_phases, t[..., None]).to(dtype)
        reward_gaits = -torch.sum(((z_feet_tar - z_feet) / 0.05) ** 2, dim=-1)

        up_global = self._up_global
        up_body = rot.rotate(up_global, torso_xquat)
        reward_upright = -torch.sum((up_body - up_global) ** 2, dim=-1)

        if cfg["turn_period"]:
            yaw_tar = info["yaw_tar"] + ang_vel_tar[..., 2] * dt
        else:
            yaw_tar = info["yaw_tar"] + ang_vel_tar[..., 2] * dt * step.to(dtype)
        yaw = rot.quat_to_yaw_eigen(torso_xquat) if cfg["yaw_mode"] == "eigen" \
            else rot.quat_to_yaw(torso_xquat)
        d_yaw = yaw - yaw_tar
        wrapped = torch.atan2(torch.sin(d_yaw), torch.cos(d_yaw))
        reward_yaw = -(wrapped**2)

        vb, ab = self._body_velocities(torso_xpos, torso_xquat, torso_cvel, root_com)
        reward_vel = -torch.sum((vb[..., :2] - vel_tar[..., :2]) ** 2, dim=-1)
        reward_ang_vel = -((ab[..., 2] - ang_vel_tar[..., 2]) ** 2)

        z_torso = torso_xpos[..., 2]
        reward_height = -((z_torso - info["pos_tar"][..., 2]) ** 2)

        reward_energy = torch.zeros_like(reward_height)
        if cfg["energy_weight"] != 0.0:
            tau = qfrc_actuator[..., 6:]
            qd = qvel[..., 6:]
            reward_energy = -torch.sum(torch.clamp(tau * qd / 160.0, min=0.0) ** 2, dim=-1)

        reward = (0.1 * reward_gaits + 0.5 * reward_upright + 0.3 * reward_yaw
                  + cfg["vel_weight"] * reward_vel + 1.0 * reward_ang_vel
                  + 1.0 * reward_height + cfg["energy_weight"] * reward_energy)
        if cfg["y_anchor_weight"] != 0.0:
            reward = reward - cfg["y_anchor_weight"] * (
                (torso_xpos[..., 1] - info["pos_tar"][..., 1]) ** 2)

        jr = self.termination_joint_range
        joint_angles = qpos[..., 7: 7 + self.model.nu]
        out_of_range = torch.any((joint_angles < jr[:, 0]) | (joint_angles > jr[:, 1]), dim=-1)
        done = (torch.sum(up_body * up_global, dim=-1) < 0.0) | out_of_range | (z_torso < 0.18)
        if cfg["done_penalty"] != 0.0:
            reward = reward - cfg["done_penalty"] * done.to(dtype)

        contact = (z_feet - 0.0175) < 1e-3
        feet_air_time = torch.where(contact | info["last_contact"], 0.0,
                                    info["feet_air_time"] + dt)
        info2 = dict(info, vel_tar=vel_tar, ang_vel_tar=ang_vel_tar,
                     yaw_tar=yaw_tar if cfg["turn_period"] else info["yaw_tar"],
                     step=step + 1, z_feet=z_feet, z_feet_tar=z_feet_tar,
                     last_contact=contact, feet_air_time=feet_air_time)
        return reward, done, info2


class H1(_Legged):
    FEET_SITES = ("left_foot", "right_foot")
    TORSO_BODY = "pelvis"

    def __init__(self, cfg, model, device, dtype):
        super().__init__(cfg, model, device, dtype)
        m = self.model
        feet = [m.site_names.index(s) for s in self.FEET_SITES]
        dof_to_jnt = {int(m.jnt_dofadr[j]): j for j in range(m.njnt)}
        act_jnt = [dof_to_jnt[int(d)] for d in m.actuator_dofadr]
        act_qadr = np.array([int(m.jnt_qposadr[j]) for j in act_jnt])
        act_dadr = np.array(m.actuator_dofadr)
        model_range = np.asarray(m.jnt_range)[act_jnt]
        if cfg["joint_range_source"] == "centered":
            home_j = self.init_q[act_qadr]
            halfwidth = np.array([
                cfg["arm_halfwidth"]
                if any(k in m.jnt_names[j] for k in ("shoulder", "elbow", "torso"))
                else cfg["action_halfwidth"]
                for j in act_jnt
            ])
            w = np.minimum(halfwidth,
                           np.minimum(home_j - model_range[:, 0], model_range[:, 1] - home_j))
            w = np.maximum(w, 0.05)
            joint_range = np.stack([np.maximum(home_j - w, model_range[:, 0]),
                                    np.minimum(home_j + w, model_range[:, 1])], axis=1)
        else:
            joint_range = model_range
        cr = np.asarray(m.actuator_ctrlrange)
        unlimited = np.all(np.abs(cr) < 1e-6, axis=1)
        torque_range = np.where(unlimited[:, None], np.array([[-np.inf, np.inf]]), cr)
        g = cfg["gait"] if cfg["gait"] in gait.BIPED_GAIT_PHASES else "walk"
        self._gait_params = tuple(float(x) for x in gait.BIPED_GAIT_PARAMS[g])

        # the feet sites' ground-contact heights: their height at home, from
        # the pipeline's kinematics in float64
        q0 = torch.as_tensor(self.init_q[None, : m.nq], dtype=torch.float64)
        site_xpos = kinematics.kinematics(m, q0).site_xpos[0]
        foot_contact_z = [float(site_xpos[s, 2]) for s in feet]

        act_dofs = {int(d) for d in m.actuator_dofadr}
        free_slides = [j for j in range(m.njnt)
                       if int(m.jnt_type[j]) == JNT_SLIDE and int(m.jnt_dofadr[j]) not in act_dofs]
        self._crate_dof = int(m.jnt_dofadr[free_slides[0]]) if free_slides else None
        self._crate_qadr = int(m.jnt_qposadr[free_slides[0]]) if free_slides else None

        self._act_qadr = self._tensor(act_qadr, torch.long)
        self._act_dadr = self._tensor(act_dadr, torch.long)
        self._feet_idx = self._tensor(feet, torch.long)
        self.joint_range = self._tensor(joint_range)
        self.physical_joint_range = self._tensor(model_range)
        self.joint_torque_range = self._tensor(torque_range)
        self._gait_phases = self._tensor(gait.BIPED_GAIT_PHASES[g])
        self._up_global = self._tensor([0.0, 0.0, 1.0])
        self._foot_contact_z = self._tensor(foot_contact_z)
        self.pos_tar = [0.0, 0.0, cfg["pos_tar_z"]]

    def ctrl(self, action, qpos, qvel):
        return self._act2tau_qv(action, qpos[..., self._act_qadr], qvel[..., self._act_dadr])

    def post_physics(self, qpos, qvel, site_xpos, torso_xpos, torso_xquat, torso_cvel,
                     root_com, qfrc_actuator, info):
        cfg, dtype, dt = self.cfg, self.dtype, self.dt
        step = info["step"].to(dtype)
        frac = step * dt / cfg["ramp_up_time"]
        vel_tar = torch.stack([
            torch.clamp(cfg["default_vx"] * frac, max=cfg["default_vx"]),
            torch.clamp(cfg["default_vy"] * frac, max=cfg["default_vy"]),
            info["vel_tar"][..., 2],
        ], dim=-1)
        ang_vel_tar = torch.stack([
            info["ang_vel_tar"][..., 0],
            info["ang_vel_tar"][..., 1],
            torch.clamp(cfg["default_vyaw"] * frac, max=cfg["default_vyaw"]),
        ], dim=-1)

        z_feet = site_xpos[..., self._feet_idx, 2]
        duty, cadence, amplitude = self._gait_params
        z_feet_tar = gait.get_foot_step(
            duty, cadence, amplitude, self._gait_phases, (step * dt)[..., None]).to(dtype)
        reward_gaits = -torch.sum(((z_feet_tar - z_feet) / 0.05) ** 2, dim=-1)

        up_global = self._up_global
        up_body = rot.rotate(up_global, torso_xquat)
        reward_upright = -torch.sum((up_body - up_global) ** 2, dim=-1)

        yaw_tar = info["yaw_tar"] + ang_vel_tar[..., 2] * dt * step
        yaw = rot.quat_to_yaw_eigen(torso_xquat) if cfg["yaw_mode"] == "eigen" \
            else rot.quat_to_yaw(torso_xquat)
        d_yaw = yaw - yaw_tar
        wrapped = torch.atan2(torch.sin(d_yaw), torch.cos(d_yaw))
        reward_yaw = -(wrapped**2)

        vb, ab = self._body_velocities(torso_xpos, torso_xquat, torso_cvel, root_com)
        reward_vel = -torch.sum((vb[..., :2] - vel_tar[..., :2]) ** 2, dim=-1)
        reward_ang_vel = -((ab[..., 2] - ang_vel_tar[..., 2]) ** 2)

        z_torso = torso_xpos[..., 2]
        reward_height = -((z_torso - info["pos_tar"][..., 2]) ** 2)

        crate_anchored = cfg["pos_anchor_mode"] == "crate" and self._crate_qadr is not None
        if crate_anchored:
            pos_tar = torch.stack([
                qpos[..., self._crate_qadr] - cfg["crate_standoff"],
                torch.zeros_like(z_torso),
                info["pos_tar"][..., 2],
            ], dim=-1)
        else:
            pos_tar = info["pos_tar"] + vel_tar * dt
        if not crate_anchored and cfg["pos_anchor_leash"] > 0.0:
            err = pos_tar[..., :2] - torso_xpos[..., :2]
            n = torch.sqrt(torch.sum(err**2, dim=-1))
            scale = torch.clamp(cfg["pos_anchor_leash"] / torch.clamp(n, min=1e-6), max=1.0)
            pos_tar = torch.cat([torso_xpos[..., :2] + err * scale[..., None], pos_tar[..., 2:]],
                                dim=-1)
        reward_pos = -torch.sum((torso_xpos[..., :2] - pos_tar[..., :2]) ** 2, dim=-1)

        reward_energy = torch.zeros_like(reward_height)
        if cfg["energy_weight"] != 0.0:
            tau = qfrc_actuator[..., 6:]
            qd = qvel[..., 6:]
            reward_energy = -torch.sum(torch.clamp(tau * qd / 160.0, min=0.0) ** 2, dim=-1)

        reward_crate = torch.zeros_like(reward_height)
        if cfg["crate_vel_weight"] != 0.0 and self._crate_dof is not None:
            cap = cfg["crate_vel_cap"]
            reward_crate = torch.clamp(qvel[..., self._crate_dof], -cap, cap)

        reward = (0.1 * reward_gaits + 0.5 * reward_upright + 0.3 * reward_yaw
                  + 1.0 * reward_vel + 1.0 * reward_ang_vel + 1.0 * reward_height
                  + cfg["energy_weight"] * reward_energy
                  + cfg["pos_anchor_weight"] * reward_pos
                  + cfg["crate_vel_weight"] * reward_crate)

        jr = self.physical_joint_range
        joint_angles = qpos[..., self._act_qadr]
        out_of_range = torch.any(
            (joint_angles < jr[:, 0] - 0.05) | (joint_angles > jr[:, 1] + 0.05), dim=-1)
        done = (torch.sum(up_body * up_global, dim=-1) < 0.0) | out_of_range | (z_torso < 0.5)
        if cfg["done_penalty"] != 0.0:
            reward = reward - cfg["done_penalty"] * done.to(dtype)

        contact = (z_feet - self._foot_contact_z) < 1e-3
        feet_air_time = torch.where(contact | info["last_contact"], 0.0,
                                    info["feet_air_time"] + dt)
        info2 = dict(info, pos_tar=pos_tar, vel_tar=vel_tar, ang_vel_tar=ang_vel_tar,
                     step=info["step"] + 1, z_feet=z_feet, z_feet_tar=z_feet_tar,
                     last_contact=contact, feet_air_time=feet_air_time)
        return reward, done, info2


ROBOTS = {"go2": Go2, "h1": H1}
