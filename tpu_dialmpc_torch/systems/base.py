"""Abstract dynamical system for the cost-based DIAL-MPC prototype.

Counterpart of `tpu_dialmpc/systems/base.py` (the reference's `System`,
dial_mpc/src/control_sequence.cpp:27-49): `dynamics` advances states by dt
under controls, `running_cost` and `terminal_cost` are quadratic tracking
costs.  Where the JAX methods take one sample and are vmapped, these take a
batch: states (B, state_dim), controls (B, control_dim), costs (B,).
Constants live on the system's device in its dtype.
"""

from __future__ import annotations

from typing import Optional

import torch


class System:
    state_dim: int
    control_dim: int
    dt: float

    def __init__(self, state_dim: int, control_dim: int, dt: float,
                 target_state: Optional[object] = None, device="cuda",
                 dtype: torch.dtype = torch.float32):
        self.state_dim = state_dim
        self.control_dim = control_dim
        self.dt = dt
        self.device = torch.device(device)
        self.dtype = dtype
        self.target_state = (
            self.tensor(torch.zeros(state_dim)) if target_state is None
            else self.tensor(target_state)
        )
        # quadratic weights, set by subclasses
        self.Q = self.tensor(torch.eye(state_dim))
        self.R = self.tensor(0.1 * torch.eye(control_dim))
        self.Q_terminal = self.tensor(torch.eye(state_dim))

    def tensor(self, x) -> torch.Tensor:
        """A constant on the system's device, in its dtype."""
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    # -- to implement --------------------------------------------------
    def dynamics(self, state: torch.Tensor, control: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    # -- shared quadratic costs (control_sequence.cpp:89-106 etc.) -----
    def running_cost(self, state: torch.Tensor, control: torch.Tensor) -> torch.Tensor:
        d = state - self.target_state
        return (torch.einsum("bi,bi->b", d, d @ self.Q.T)
                + torch.einsum("bi,bi->b", control, control @ self.R.T))

    def terminal_cost(self, state: torch.Tensor) -> torch.Tensor:
        d = state - self.target_state
        return torch.einsum("bi,bi->b", d, d @ self.Q_terminal.T)
