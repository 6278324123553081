"""Named task registry: env config + planner defaults per task.

Counterpart of `tpu_dialmpc/envs/registry.py`, with all of its 13 tasks and
the JAX package's exact config dicts (see that file for each setting's
story): the Go2 gaits `go2_stand` (the reference benchmark workload),
`go2_trot`, `go2_walk`, `go2_canter`, `go2_gallop`, `go2_turn` and
`go2_trot_position` (position servos), the Go2 crate tasks `go2_crate`,
`go2_crate_climb` and `go2_jump`, and the H1 humanoid's `h1_walk`,
`h1_loco` (arms fixed) and `h1_push_crate`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from tpu_dialmpc_torch.telemetry import spans

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


def register_env(name: str, dial: dict | None = None):
    """Register a task factory, optionally with its planner defaults.

    The factory takes `device` and config-field overrides as keywords.
    `dial` is a DialConfig kwargs dict (see `dial_defaults`); a task
    registered without one falls back to the quadruped defaults with a
    warning, since a wrong lookahead can silently make a task fail (a biped
    needs ~0.64 s; the quadruped default is 0.4 s)."""

    def deco(factory):
        _REGISTRY[name] = factory
        if dial is not None:
            _DIAL_DEFAULTS[name] = dict(dial)
        return factory

    return deco


def get_env(name: str, device="cuda", **overrides):
    """Instantiate a registered task env on `device` (the card unless the
    caller asks for the CPU), with config-field overrides."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; known: {sorted(_REGISTRY)}")
    with spans.span("setup/env"):
        return _REGISTRY[name](device=device, **overrides)


def list_envs():
    return sorted(_REGISTRY)


def dial_defaults(name: str) -> dict:
    """Planner (DialConfig) defaults for a registered task; the quadruped
    baseline, with a warning, for a task registered without them."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown task {name!r}; known: {sorted(_REGISTRY)}")
    if name not in _DIAL_DEFAULTS:
        import warnings

        warnings.warn(
            f"task {name!r} registered without planner defaults; using the "
            "quadruped baseline (Hsample=20/Hnode=5) — pass dial= to "
            "register_env if the task needs a different lookahead"
        )
        return dict(_GO2_DIAL)
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
_register("go2_trot", _go2(
    dict(gait="trot", default_vx=0.8, kp=30.0, kd=0.65, leg_control="torque")
), _GO2_DIAL)
_register("go2_walk", _go2(
    dict(gait="walk", default_vx=0.5, kp=30.0, kd=0.65, leg_control="torque")
), _GO2_DIAL)
# the fast gaits price termination in the sampler (done_penalty)
_register("go2_canter", _go2(
    dict(gait="canter", default_vx=1.0, kp=30.0, kd=0.65,
         leg_control="torque", done_penalty=2.0)
), _GO2_DIAL)
_register("go2_gallop", _go2(
    dict(gait="gallop", default_vx=1.2, kp=30.0, kd=0.65,
         leg_control="torque", done_penalty=2.0)
), _GO2_DIAL)
# position leg control over the <position kp=30 kv=0.65> servos: the env
# writes joint targets into ctrl and the model's servos close the loop
_register("go2_trot_position", _go2(
    dict(gait="trot", default_vx=0.8, leg_control="position", scene="go2_position")
), _GO2_DIAL)
# the "fast turn": trot with the yaw-rate command flipping sign every 75
# steps at +-1.5 rad/s
_register("go2_turn", _go2(
    dict(
        gait="trot",
        default_vx=0.3,
        default_vyaw=1.5,
        turn_period=75,
        kp=30.0,
        kd=0.65,
        leg_control="torque",
        done_penalty=2.0,
    )
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

_register("h1_walk", _h1(
    dict(gait="walk", default_vx=0.5, scene="h1_walk")
), _H1_DIAL)
# the arms-fixed robot: 11 motors, legs and torso
_register("h1_loco", _h1(
    dict(gait="walk", default_vx=0.5, scene="h1_loco")
), _H1_DIAL)
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
