"""Gait reference generation (counterpart of `tpu_dialmpc/envs/gait.py`).

`step_height` is the phase-wrapped clipped-cosine swing profile;
`get_foot_step` evaluates it per foot at T = 2π·cadence·t + π.  Batched torch
ops; the gait tables are the JAX package's.
"""

from __future__ import annotations

import math

import torch

# phases per foot (FL, FR, RL, RR order of feet sites), and
# (duty_ratio, cadence, amplitude)
GAIT_PHASES = {
    "stand": (0.0, 0.0, 0.0, 0.0),
    "walk": (0.0, 0.5, 0.75, 0.25),
    "trot": (0.0, 0.5, 0.5, 0.0),
    "canter": (0.0, 0.33, 0.33, 0.66),
    "gallop": (0.0, 0.05, 0.4, 0.35),
    "pronk": (0.0, 0.0, 0.0, 0.0),
    "climb": (0.0, 0.5, 0.75, 0.25),
}
GAIT_PARAMS = {
    "stand": (1.0, 1.0, 0.0),
    "walk": (0.75, 1.0, 0.08),
    "trot": (0.45, 2.0, 0.08),
    "canter": (0.4, 4.0, 0.06),
    "gallop": (0.3, 3.5, 0.10),
    "pronk": (0.4, 1.5, 0.18),
    "climb": (0.55, 1.0, 0.35),
}

# biped gaits for H1: phases per foot (left_foot, right_foot), and
# (duty_ratio, cadence, amplitude)
BIPED_GAIT_PHASES = {
    "stand": (0.0, 0.0),
    "walk": (0.0, 0.5),
    "jog": (0.0, 0.5),
}
BIPED_GAIT_PARAMS = {
    "stand": (1.0, 1.0, 0.0),
    "walk": (0.5, 1.0, 0.1),
    "jog": (0.3, 2.0, 0.1),
}


def step_height(t, footphase, duty_ratio):
    """Swing height profile, branch-free."""
    t = torch.as_tensor(t)
    duty = torch.as_tensor(duty_ratio, dtype=t.dtype, device=t.device)
    angle = torch.remainder(t + math.pi - footphase, 2.0 * math.pi) - math.pi
    angle = torch.where(duty < 1.0, angle * 0.5 / (1.0 - duty + 1e-12), angle)
    clipped = torch.clamp(angle, -math.pi / 2.0, math.pi / 2.0)
    value = torch.where(duty < 1.0, torch.cos(clipped), 0.0)
    return torch.where(torch.abs(value) >= 1e-6, torch.abs(value), 0.0)


def get_foot_step(duty_ratio, cadence, amplitude, phases, time):
    """Per-foot target heights."""
    t = time * 2.0 * math.pi * cadence + math.pi
    return amplitude * step_height(t, 2.0 * math.pi * phases, duty_ratio)
