"""Named task registry: env config + planner defaults per task.

Counterpart of `tpu_dialmpc/envs/registry.py`, for the tasks the port runs:
`go2_stand` (the reference benchmark workload), the Go2 crate tasks
`go2_crate`, `go2_crate_climb` and `go2_jump`, and the H1 humanoid's
`h1_push_crate`, with the JAX package's exact config dicts (see that file
for each setting's story).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

_REGISTRY: Dict[str, Callable[..., object]] = {}
_DIAL_DEFAULTS: Dict[str, dict] = {}

# Per-task planner defaults (DialConfig kwargs), as in the JAX package.
_DIAL_COMMON = dict(
    Nsample=2048,
    Ndiffuse=2,
    Ndiffuse_init=10,
    temp_sample=0.05,
    horizon_diffuse_factor=0.9,
    traj_diffuse_factor=0.5,
    ctrl_dt=0.02,
    n_steps=400,
)
_GO2_DIAL = dict(_DIAL_COMMON, Hsample=20, Hnode=5)
# the biped needs a longer lookahead (0.64 s)
_H1_DIAL = dict(_DIAL_COMMON, Hsample=32, Hnode=8)


def get_env(name: str, device="cuda", **overrides):
    """Instantiate a registered task env on `device` (the card unless the
    caller asks for the CPU), with config-field overrides."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](device=device, **overrides)


def list_envs():
    return sorted(_REGISTRY)


def dial_defaults(name: str) -> dict:
    """Planner (DialConfig) defaults for a registered task."""
    if name not in _DIAL_DEFAULTS:
        raise KeyError(f"unknown task {name!r}; known: {sorted(_DIAL_DEFAULTS)}")
    return dict(_DIAL_DEFAULTS[name])


def _go2(defaults):
    from tpu_dialmpc_torch.envs.go2 import UnitreeGo2Env, UnitreeGo2EnvConfig

    # registered tasks substep ctrl_dt / timestep = 8 times per control
    defaults.setdefault("n_substeps", 8)

    def factory(device="cuda", **overrides):
        cfg = dataclasses.replace(UnitreeGo2EnvConfig(**defaults), **overrides)
        return UnitreeGo2Env(cfg, device=device)

    return factory


def _h1(defaults):
    from tpu_dialmpc_torch.envs.h1 import UnitreeH1Env, UnitreeH1EnvConfig

    defaults.setdefault("n_substeps", 8)  # see _go2

    def factory(device="cuda", **overrides):
        cfg = dataclasses.replace(UnitreeH1EnvConfig(**defaults), **overrides)
        return UnitreeH1Env(cfg, device=device)

    return factory


def _register(name: str, factory, dial: dict):
    _REGISTRY[name] = factory
    _DIAL_DEFAULTS[name] = dict(dial)


# the reference benchmark config (dial-core-test.cpp:8-32: gait=stand, vx=0.8,
# kp=30, kd=0.65, torque mode)
_register("go2_stand", _go2(
    dict(gait="stand", default_vx=0.8, kp=30.0, kd=0.65, leg_control="torque")
), _GO2_DIAL)

# the crate scene (the collision-capable robot and a static mocap crate):
# press against the crate ...
_register("go2_crate", _go2(
    dict(
        gait="trot",
        default_vx=0.5,
        kp=30.0,
        kd=0.65,
        leg_control="torque",
        scene="go2_force_crate",
        done_penalty=2.0,
    )
), _GO2_DIAL)
# ... climb onto it, its top face moved to 0.30 m ...
_register("go2_crate_climb", _go2(
    dict(
        gait="climb",
        default_vx=0.5,
        kp=30.0,
        kd=0.65,
        leg_control="torque",
        scene="go2_force_crate",
        crate_top_z=0.30,
        goal_x=1.35,
        termination_range_source="physical",
        done_penalty=2.0,
        y_anchor_weight=1.0,
        vel_weight=2.5,
    )
), dict(_GO2_DIAL, Hsample=25, n_steps=600))
# ... or pronk on flat ground with the crate parked down-range
_register("go2_jump", _go2(
    dict(
        gait="pronk",
        default_vx=0.5,
        kp=30.0,
        kd=0.65,
        leg_control="torque",
        scene="go2_force_crate",
        crate_x=30.0,
        done_penalty=2.0,
    )
), _GO2_DIAL)

# push the 30 kg crate on its slide joint: the anchor leash bounds the
# blocked-progress penalty, the capped crate-velocity reward makes steady
# pushing pay, and done_penalty prices falling in the sampler
_register("h1_push_crate", _h1(
    dict(
        gait="walk",
        default_vx=0.3,
        scene="h1_push_crate",
        pos_anchor_leash=0.4,
        crate_vel_weight=6.0,
        done_penalty=2.0,
    )
), _H1_DIAL)
