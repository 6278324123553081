"""LeggedRobot system: full-state quadratic tracking over the physics pipeline.

Counterpart of `tpu_dialmpc/systems/legged.py` (the reference prototype's
LeggedRobot, dial_mpc/src/control_sequence.cpp:188-269): state = [qpos(nq);
qvel(nv)], control = the actuators' ctrl (torques on go2_force), one
physics step per dynamics call (`pipeline.step`, one substep, from a zero
warm start as after `pipeline.init`), and diagonal Q/R costs (base position
50 / the rest of qpos 5 / qvel 1 running; 50 / 10 / 5 terminal; R = 0.1 I).
The model is the scene as `dynamics/model.py:load_scene` resolves it (a name,
an MJCF or a model-file path).
Every sample is stepped independently (the reference steps one shared
mjData for all of them).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from tpu_dialmpc_torch.dynamics import pipeline
from tpu_dialmpc_torch.dynamics.model import load_scene
from tpu_dialmpc_torch.envs.base import LeanPipelineState
from tpu_dialmpc_torch.systems.base import System


class LeggedRobot(System):
    def __init__(
        self,
        scene: str = "go2_force",
        target_state: Optional[np.ndarray] = None,
        timestep: float = 0.0025,
        device="cuda",
        dtype: torch.dtype = torch.float32,
    ):
        self.model = load_scene(scene).with_options(timestep=timestep)
        nq, nv, nu = self.model.nq, self.model.nv, self.model.nu
        if target_state is None:
            home = self.model.key_qpos.get("home", np.asarray(self.model.qpos0))
            target_state = np.concatenate([np.asarray(home), np.zeros(nv)])
        super().__init__(nq + nv, nu, timestep, target_state, device, dtype)
        q = np.ones(nq + nv)
        q[:3] = 50.0
        q[3:nq] = 5.0
        q[nq:] = 1.0
        qf = np.ones(nq + nv)
        qf[:3] = 50.0
        qf[3:nq] = 10.0
        qf[nq:] = 5.0
        self.Q = self.tensor(np.diag(q))
        self.Q_terminal = self.tensor(np.diag(qf))
        self.R = self.tensor(0.1 * np.eye(nu))

    def dynamics(self, state, control):
        nq = self.model.nq
        qvel = state[:, nq:]
        ps = LeanPipelineState(qpos=state[:, :nq], qvel=qvel,
                               qacc_warmstart=torch.zeros_like(qvel))
        ps2 = pipeline.step(self.model, ps, control, n_substeps=1)
        return torch.cat([ps2.qpos, ps2.qvel], dim=-1)
