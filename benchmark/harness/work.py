"""The yardstick's arithmetic: the physics work of one control step, counted
from the configuration's frozen op count, and the device's published peak.

A control step executes one action (one substep-chain call at B=1), then
runs `Ndiffuse` annealing iterations, each rolling out Nsample+1 candidates
over Hsample+1 horizon steps; every call is `n_substeps` substeps.  The op
count per sample-substep is frozen in the configuration's file, so the work
per step is the same whatever implements the physics.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, dense, at
# the card's full 700 W power limit
PEAK_FP32_OPS_PER_S = 67e12


def sample_substeps_per_step(planner: dict, n_substeps: int) -> int:
    """((N+1)·(H+1)·Ndiffuse + 1) × n_substeps."""
    n, h, nd = planner["Nsample"], planner["Hsample"], planner["Ndiffuse"]
    return ((n + 1) * (h + 1) * nd + 1) * n_substeps


def ops_per_step(config: dict) -> float:
    """The fp32 operations of one control step's physics."""
    return float(config["ops_per_sample_substep"]["value"]) * sample_substeps_per_step(
        config["planner"], config["env"]["n_substeps"])
