"""Inverted pendulum and cartpole systems.

Counterpart of `tpu_dialmpc/systems/classic.py`: the reference prototype's
constants, costs and explicit Euler integration
(dial_mpc/src/control_sequence.cpp:52-107 pendulum, :110-180 cartpole), on
batches of states.
"""

from __future__ import annotations

import math

import torch

from tpu_dialmpc_torch.systems.base import System


class InvertedPendulum(System):
    """theta=0 is down; target (pi, 0) is the swing-up goal
    (Q=diag(10,1), R=0.1, Qf=diag(50,5), dt=0.1)."""

    def __init__(self, target_state=(math.pi, 0.0), dt: float = 0.1, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__(2, 1, dt, target_state, device, dtype)
        self.Q = self.tensor(torch.diag(torch.tensor([10.0, 1.0], dtype=torch.float64)))
        self.R = self.tensor([[0.1]])
        self.Q_terminal = self.tensor(torch.diag(torch.tensor([50.0, 5.0], dtype=torch.float64)))
        self.g, self.l, self.m = 9.81, 1.0, 1.0

    def dynamics(self, state, control):
        theta, theta_dot = state[:, 0], state[:, 1]
        torque = control[:, 0]
        theta_ddot = (torque - self.m * self.g * self.l * torch.sin(theta)) / (
            self.m * self.l * self.l
        )
        return torch.stack(
            [theta + theta_dot * self.dt, theta_dot + theta_ddot * self.dt], dim=-1
        )


class Cartpole(System):
    """Classic cartpole (Q=diag(1,1,10,1), R=0.1, Qf=diag(10,10,50,5),
    dt=0.05); the target is upright at the origin."""

    def __init__(self, target_state=(0.0, 0.0, 0.0, 0.0), dt: float = 0.05, device="cuda",
                 dtype: torch.dtype = torch.float32):
        super().__init__(4, 1, dt, target_state, device, dtype)
        self.Q = self.tensor(torch.diag(torch.tensor([1.0, 1.0, 10.0, 1.0], dtype=torch.float64)))
        self.R = self.tensor([[0.1]])
        self.Q_terminal = self.tensor(
            torch.diag(torch.tensor([10.0, 10.0, 50.0, 5.0], dtype=torch.float64)))

    def dynamics(self, state, control):
        g, m_cart, m_pole, l = 9.81, 1.0, 0.1, 0.5
        total_mass = m_cart + m_pole
        polemass_length = m_pole * l
        x, x_dot, theta, theta_dot = state.unbind(-1)
        force = control[:, 0]
        sin_t, cos_t = torch.sin(theta), torch.cos(theta)
        temp = (force + polemass_length * theta_dot**2 * sin_t) / total_mass
        theta_ddot = (g * sin_t - cos_t * temp) / (
            l * (4.0 / 3.0 - m_pole * cos_t * cos_t / total_mass)
        )
        x_ddot = temp - polemass_length * theta_ddot * cos_t / total_mass
        dt = self.dt
        return torch.stack(
            [x + x_dot * dt, x_dot + x_ddot * dt, theta + theta_dot * dt,
             theta_dot + theta_ddot * dt], dim=-1,
        )
