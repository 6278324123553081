# Frozen copy of tpu_dialmpc_torch/envs/gait.py at commit ce76357, imports made relative.
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


_SWING_WIDTH = {}  # (duty, dtype, device) -> 1 - duty + 1e-12, 0-dim


def _swing_width(duty: float, dtype, device) -> torch.Tensor:
    """1 - duty + 1e-12 as a 0-dim tensor on `device`, computed in `dtype`
    as the branch-free formula computes it (a 0-dim divisor on the device,
    not a Python float, which a CUDA division would turn into a multiply
    by its reciprocal); made once per (duty, dtype, device)."""
    key = (duty, dtype, device)
    if key not in _SWING_WIDTH:
        _SWING_WIDTH[key] = (1.0 - torch.tensor(duty, dtype=dtype) + 1e-12).to(device)
    return _SWING_WIDTH[key]


def step_height(t, footphase, duty_ratio: float):
    """Swing height profile; `duty_ratio` is a Python float, so its branch
    is taken here rather than per element (a duty of 1 or more never lifts
    a foot)."""
    t = torch.as_tensor(t)
    angle = torch.remainder(t + math.pi - footphase, 2.0 * math.pi) - math.pi
    if duty_ratio >= 1.0:
        return torch.zeros_like(angle)
    angle = angle * 0.5 / _swing_width(duty_ratio, t.dtype, t.device)
    value = torch.cos(torch.clamp(angle, -math.pi / 2.0, math.pi / 2.0))
    return torch.where(torch.abs(value) >= 1e-6, torch.abs(value), 0.0)


def get_foot_step(duty_ratio, cadence, amplitude, phases, time):
    """Per-foot target heights."""
    t = time * 2.0 * math.pi * cadence + math.pi
    return amplitude * step_height(t, 2.0 * math.pi * phases, duty_ratio)
