"""Cost-based DIAL-MPC over generic systems (the reference ROS prototype).

Counterpart of `tpu_dialmpc/planner/cost_dial.py` (DIAL_MPC in
dial_mpc/src/control_sequence.cpp:430-538, commented out there): the
candidate rollouts are one batch over the samples with a Python loop over
the horizon, and the receding-horizon loop is a Python loop.

Algorithm (the reference's math, as the JAX module writes it):
  two-level annealing, i = 0..diffusion_levels-1:
    sigma_outer(i)    = sigma_initial * exp(-beta_outer * i)
    sigma_inner(i, t) = sigma_outer * exp(-(t/H) / beta_inner)
  sample num_samples control sequences ~ N(control_seq, sigma_inner(t))
  roll out, cost = sum running_cost + terminal_cost
  normalized = (cost - mean) / (std + 1e-6)        (std over the samples)
  weights ∝ exp(-normalized / sigma_outer), control_seq = Σ w_j U_j
  execute the first control, shift the sequence with a zero tail
with beta_inner = log(sigma_i/sigma_f)/H / 10 and beta_outer =
(log(sigma_i/sigma_f)/H + 0.2) / 10.  As in the JAX module, the schedule is
computed in float32, the std is the population std, and the weights are
exponentiated without subtracting their max.

Noise comes from an explicit `torch.Generator`; `improve(..., noise=)`
takes injected draws instead, one (num_samples, H, control_dim) tensor per
level, which is how the tests hold it against the JAX module's own draws.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, NamedTuple, Optional

import torch

from tpu_dialmpc_torch.systems.base import System


@dataclasses.dataclass(frozen=True)
class CostDialConfig:
    horizon: int = 20
    steps: int = 100
    diffusion_levels: int = 3
    num_samples: int = 256
    sigma_initial: float = 1.0
    sigma_final: float = 0.1
    seed: int = 0


class CostDialResult(NamedTuple):
    trajectory: torch.Tensor  # (steps+1, state_dim)
    control_history: torch.Tensor  # (steps, control_dim)
    costs: torch.Tensor  # (steps,) executed running cost per step


class CostDialMPC:
    def __init__(self, system: System, config: CostDialConfig = CostDialConfig()):
        self.system = system
        self.cfg = config
        H = config.horizon
        # annealing schedule constants (control_sequence.cpp:448-452)
        base = math.log(config.sigma_initial / config.sigma_final) / H
        self.beta_inner = base / 10.0
        self.beta_outer = (base + 0.2) / 10.0

    # ------------------------------------------------------------------
    def _rollout_cost(self, state0, controls):
        """Total cost of each control sequence (B, H, cd) from state0
        (state_dim,): (B,)."""
        sys = self.system
        s = state0.expand(controls.shape[0], -1)
        costs = []
        for t in range(controls.shape[1]):
            costs.append(sys.running_cost(s, controls[:, t]))
            s = sys.dynamics(s, controls[:, t])
        return torch.stack(costs, dim=1).sum(dim=1) + sys.terminal_cost(s)

    def _sigmas(self, device):
        """(sigma_outer (L,), sigma_inner (L, H)) in float32, as the JAX
        module computes them."""
        cfg = self.cfg
        H = cfg.horizon
        t_grid = torch.arange(H, dtype=torch.float32, device=device) / H
        i = torch.arange(cfg.diffusion_levels, dtype=torch.float32, device=device)
        sigma_outer = cfg.sigma_initial * torch.exp(-self.beta_outer * i)
        sigma_inner = sigma_outer[:, None] * torch.exp(-t_grid / self.beta_inner)[None]
        return sigma_outer, sigma_inner

    def improve(self, state, control_sequence, generator: Optional[torch.Generator],
                noise: Optional[List[torch.Tensor]] = None):
        """diffusion_levels annealing sweeps on one control sequence (H, cd).
        Each level's standard-normal draw comes from `generator`, on the
        generator's device (the system's, unless the caller passes another),
        or from `noise` if given."""
        cfg = self.cfg
        H, cd = cfg.horizon, self.system.control_dim
        seq = control_sequence
        sigma_outer, sigma_inner = self._sigmas(seq.device)
        draw_on = generator.device if generator is not None else seq.device
        for i in range(cfg.diffusion_levels):
            if noise is None:
                eps = torch.randn((cfg.num_samples, H, cd), generator=generator,
                                  dtype=seq.dtype, device=draw_on).to(seq.device)
            else:
                eps = noise[i].to(seq.dtype)
            samples = seq[None] + eps * sigma_inner[i].to(seq.dtype)[None, :, None]
            costs = self._rollout_cost(state, samples)
            mean, std = costs.mean(), costs.std(correction=0)
            normalized = (costs - mean) / (std + 1e-6)
            w = torch.exp(-normalized / sigma_outer[i].to(costs.dtype))
            w = w / w.sum()
            seq = torch.einsum("s,shd->hd", w, samples)
        return seq

    # ------------------------------------------------------------------
    def run(self, initial_state, generator: Optional[torch.Generator] = None) -> CostDialResult:
        """The receding-horizon solve (:430-538): improve, execute the first
        control, shift with a zero tail, `steps` times; the noise from
        `generator`, by default one on the system's device seeded with
        cfg.seed."""
        cfg = self.cfg
        sys = self.system
        H, cd = cfg.horizon, sys.control_dim
        state = sys.tensor(initial_state)
        if generator is None:
            generator = torch.Generator(device=state.device).manual_seed(cfg.seed)
        seq = state.new_zeros((H, cd))
        traj, us, costs = [state], [], []
        for _ in range(cfg.steps):
            seq = self.improve(state, seq, generator)
            u0 = seq[0]
            costs.append(sys.running_cost(state[None], u0[None])[0])
            state = sys.dynamics(state[None], u0[None])[0]
            seq = torch.cat([seq[1:], seq.new_zeros((1, cd))])
            traj.append(state)
            us.append(u0)
        return CostDialResult(trajectory=torch.stack(traj), control_history=torch.stack(us),
                              costs=torch.stack(costs))
