"""Control-quality gates: the gate table, the metrics and one gate's run.

Counterpart of `tpu_dialmpc/quality.py`, with its gate table copied field
for field (tasks, steps, planner overrides, thresholds, quick lanes and the
recorded envelopes, which were measured on the published scenes).  Every
headline task has a *gate*: a fixed closed-loop workload (the receding
horizon loop `runner.run_scan` runs) plus named threshold checks on the
executed trajectory.  The harness that runs the gates and writes the
round artifacts is `tpu_dialmpc_torch/quality_main.py`:

    python -m tpu_dialmpc_torch.quality --quick --gates go2_trot go2_jump

Three things differ from the JAX module:

- `extra_metrics` takes the env as well as the trajectory:
  `extra_metrics(env, qpos) -> dict`.  The foot-site metrics of go2_jump
  and go2_crate_climb run the port's own forward kinematics
  (`dynamics/kinematics.py`) over the whole trajectory as one batch, in
  float64 on the trajectory's device, where the JAX module runs mujoco's
  `mj_kinematics` row by row: their counts are thresholds, which float32
  rounding could flip;
- `_climb_metrics` reads the crate's footprint and top from the env it
  scores (`env._crate`), not from literals;
- `run_all` is the one gate loop; the harness calls it with a progress
  callback.

`run_gate` runs on the card unless given `device="cpu"`, and its result
carries the card's name and power limit besides the JAX module's keys.
"""

from __future__ import annotations

import dataclasses
import functools
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Gate:
    task: str
    n_steps: int = 400
    dial: Optional[Dict] = None  # DialConfig overrides
    env_over: Optional[Dict] = None
    # checks: metric name -> (op, threshold); ops: ">" or "<"
    checks: Tuple[Tuple[str, str, float], ...] = ()
    # recorded envelope note (documentation only)
    recorded: str = ""
    extra_metrics: Optional[Callable] = None  # (env, qpos) -> dict
    # quick audit lane (--quick): a 150-step (3 s) run with re-derived
    # thresholds.  Distance/count thresholds shrink with the horizon (minus
    # the ~1 s command ramp); posture/termination thresholds are unchanged.
    quick_n_steps: int = 150
    quick_checks: Tuple[Tuple[str, str, float], ...] = ()


FEET_SITES = ("FL_foot", "FR_foot", "RL_foot", "RR_foot")


def _host(x) -> np.ndarray:
    """A trajectory as a host array in its own dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _range64(t) -> np.ndarray:
    """An env's range tensor as float64 on the host."""
    return t.detach().cpu().to(torch.float64).numpy()


def _crate_disp(env, qpos):
    # h1_push_crate: the crate's slide dof is qpos[:, 26]
    qpos = _host(qpos)
    return {"crate_disp": float(qpos[-1, 26] - qpos[0, 26])}


def termination_breakdown(env, qpos) -> Dict[str, float]:
    """Per-cause termination rates recomputed from the executed trajectory.

    The env's done flag is the OR of three predicates: torso inverted, any
    joint outside its termination range, torso below the height floor.  The
    env returns only the OR; this recomputes each predicate from qpos (all
    three are qpos-only for a root freejoint body) so quality gates can
    distinguish a benign joint-range graze from a fall.  The boxes are the
    env's own (H1: `physical_joint_range` with the 0.05 rad soft-limit
    margin on the `_act_qadr` joints, z floor 0.5; Go2:
    `termination_joint_range`, z floor 0.18).

    Returns rates plus `done_run_max`, the longest consecutive run of done
    steps — 1 means every flag was a single-step transient with instant
    recovery.
    """
    qpos = _host(qpos)
    quat = qpos[:, 3:7]
    # world-z component of the rotated up axis = R[2,2] = 1 - 2(qx^2+qy^2)
    up_z = 1.0 - 2.0 * (quat[:, 1] ** 2 + quat[:, 2] ** 2)
    inverted = up_z < 0.0

    if hasattr(env, "_act_qadr"):  # H1 (envs/h1.py termination block)
        jr = _range64(env.physical_joint_range)
        tol = 0.05
        joints = qpos[:, env._act_qadr.cpu().numpy()]
        z_floor = 0.5
    else:  # Go2 (envs/go2.py termination block)
        jr = _range64(env.termination_joint_range)
        tol = 0.0
        joints = qpos[:, 7 : 7 + env.model.nu]
        z_floor = 0.18
    oor_per_joint = (joints < jr[:, 0] - tol) | (joints > jr[:, 1] + tol)
    out_of_range = oor_per_joint.any(axis=1)
    low = qpos[:, 2] < z_floor
    done = inverted | out_of_range | low

    # longest consecutive done run (0 when no step flagged)
    run_max = run = 0
    for d in done:
        run = run + 1 if d else 0
        run_max = max(run_max, run)

    # which joints graze (diagnostic: index into the actuated-joint order)
    worst = oor_per_joint.mean(axis=0)
    return {
        "dones_recomputed_mean": float(done.mean()),
        "dones_inverted_mean": float(inverted.mean()),
        "dones_joint_mean": float(out_of_range.mean()),
        "dones_height_mean": float(low.mean()),
        "done_run_max": float(run_max),
        "joint_graze_rates": [round(float(r), 4) for r in worst],
    }


def foot_positions(env, qpos) -> torch.Tensor:
    """(T, 4, 3) world positions of the Go2 foot sites (`FEET_SITES`, by
    name from the env's model) over a (T, nq) trajectory: the port's
    forward kinematics in float64, one batch, on the trajectory's device."""
    from tpu_dialmpc_torch.dynamics import kinematics

    q = torch.as_tensor(qpos).to(torch.float64)
    ids = [env.model.site_names.index(s) for s in FEET_SITES]
    return kinematics.kinematics(env.model, q).site_xpos[:, ids]


def _flight_metrics(env, qpos):
    """Flight-phase metrics for go2_jump, from FK over the executed
    trajectory: a step is airborne when ALL four foot sites clear the
    ground by >5 mm beyond the 0.0175 m foot radius."""
    feet = foot_positions(env, qpos)
    airborne = _host((feet[..., 2] > 0.0175 + 5e-3).all(dim=-1))
    run = run_max = n_flights = 0
    for a in airborne:
        run = run + 1 if a else 0
        if run == 3:  # a real flight phase: >=3 steps (60 ms) airborne
            n_flights += 1
        run_max = max(run_max, run)
    return {
        "airborne_frac": float(np.mean(airborne)),
        "flight_run_max": float(run_max),
        "n_flights": float(n_flights),
        "apex_z": float(_host(qpos)[:, 2].max()),
    }


def _climb_metrics(env, qpos):
    """Crate-mounting metrics for go2_crate_climb, FK over the executed
    trajectory.  The crate's footprint and top are the env's (`_crate`:
    centre x, y, half-extents x, y and the top's height, set from the
    task's crate_x/crate_top_z).  A step counts as "on the crate" when ALL
    FOUR feet are inside the footprint in (x, y) and above the crate top
    minus the foot radius."""
    if env._crate is None:
        raise ValueError(
            f"{env.config.scene!r} env has no crate top (crate_top_z=0): "
            "_climb_metrics scores the go2_crate_climb task"
        )
    cx, cy, hx, hy, top = env._crate
    p = foot_positions(env, qpos)
    inside = (
        (torch.abs(p[..., 0] - cx) < hx)
        & (torch.abs(p[..., 1] - cy) < hy)
        & (p[..., 2] > top - 0.05)
    )
    on_crate = _host(inside.all(dim=-1))
    return {
        "feet_on_crate_last100": float(on_crate[-100:].mean()),
        "first_mounted_step": float(
            np.argmax(on_crate) if on_crate.any() else -1
        ),
    }


def _turn_metrics(env, qpos):
    """Heading-tracking metrics for go2_turn (must mirror the registry's
    turn task: vyaw=1.5, turn_period=75, ramp 1 s, ctrl_dt 0.02)."""
    qpos = _host(qpos)
    quat = qpos[:, 3:7]
    yaw = np.unwrap(
        np.arctan2(
            2 * (quat[:, 0] * quat[:, 3] + quat[:, 1] * quat[:, 2]),
            1 - 2 * (quat[:, 2] ** 2 + quat[:, 3] ** 2),
        )
    )
    steps = np.arange(len(yaw))
    dt = 0.02
    sign = 1 - 2 * ((steps // 75) % 2)
    mag = np.minimum(1.5 * steps * dt / 1.0, 1.5)
    yaw_tar = np.cumsum(mag * sign * dt)
    err = np.abs(np.arctan2(np.sin(yaw - yaw_tar), np.cos(yaw - yaw_tar)))
    return {
        "yaw_err_p90": float(np.quantile(err, 0.9)),
        "yaw_swing": float(yaw.max() - yaw.min()),
    }


GATES: Dict[str, Gate] = {
    "go2_trot": Gate(
        task="go2_trot",
        dial=dict(Hsample=20, Hnode=5),
        checks=(("z_min", ">", 0.15), ("x_final", ">", 3.5),
                ("dones_mean", "<", 0.05)),
        recorded="5.0 m/8 s, z in [0.25, 0.28], transient dones only",
        quick_checks=(("z_min", ">", 0.15), ("x_final", ">", 0.8),
                      ("dones_mean", "<", 0.05)),
    ),
    "h1_loco": Gate(
        task="h1_loco",
        checks=(("z_last100_mean", ">", 0.85), ("z_min", ">", 0.6),
                ("x_final", ">", 3.0), ("dones_mean", "<", 0.1)),
        recorded="pelvis 0.91 m sustained, 4.7 m traveled",
        quick_checks=(("z_last100_mean", ">", 0.85), ("z_min", ">", 0.6),
                      ("x_final", ">", 0.5), ("dones_mean", "<", 0.1)),
    ),
    "h1_walk": Gate(
        task="h1_walk",
        checks=(("z_last100_mean", ">", 0.8), ("z_min", ">", 0.5),
                ("x_final", ">", 2.0)),
        recorded="19-dof arms variant: stays up, ~3 m",
        quick_checks=(("z_last100_mean", ">", 0.8), ("z_min", ">", 0.5),
                      ("x_final", ">", 0.3)),
    ),
    "h1_push_crate": Gate(
        task="h1_push_crate",
        checks=(("z_last100_mean", ">", 0.75), ("z_min", ">", 0.6),
                ("crate_disp", ">", 0.1)),
        recorded="crate +0.49 m, pelvis z min 0.83 (400-step gate, "
                 "QUALITY_r04; done_penalty=2.0)",
        extra_metrics=_crate_disp,
        quick_checks=(("z_last100_mean", ">", 0.75), ("z_min", ">", 0.6),
                      ("crate_disp", ">", 0.02)),
    ),
    "go2_turn": Gate(
        task="go2_turn",
        dial=dict(Hsample=20, Hnode=5),
        checks=(("z_min", ">", 0.15), ("yaw_err_p90", "<", 0.5),
                ("yaw_swing", ">", 1.5), ("dones_mean", "<", 0.05)),
        recorded="BASELINE configs[3] fast-turn: heading tracks the "
                 "sign-flipping +-1.5 rad/s command (1.5 s segments); "
                 "measured: yaw_err_p90 0.057 rad, swing 2.20 rad, "
                 "z_min 0.218, dones 1.25%",
        extra_metrics=_turn_metrics,
        quick_checks=(("z_min", ">", 0.15), ("yaw_err_p90", "<", 0.5),
                      ("yaw_swing", ">", 0.7), ("dones_mean", "<", 0.05)),
    ),
    "go2_crate": Gate(
        task="go2_crate",
        dial=dict(Hsample=20, Hnode=5),
        checks=(("z_min", ">", 0.15), ("x_final", ">", 0.5),
                ("dones_mean", "<", 0.05), ("dones_height_mean", "<", 0.01),
                ("dones_inverted_mean", "<", 0.01)),
        recorded="presses the unclimbable 0.6 m wall at x=0.99; with "
                 "done_penalty=2.0: x 0.67, z_min 0.207, dones 0.0% "
                 "(was 18.5% joint-graze, QUALITY_r03)",
        quick_checks=(("z_min", ">", 0.15), ("x_final", ">", 0.25),
                      ("dones_mean", "<", 0.05),
                      ("dones_height_mean", "<", 0.01),
                      ("dones_inverted_mean", "<", 0.01)),
    ),
    "go2_jump": Gate(
        task="go2_jump",
        dial=dict(Hsample=20, Hnode=5),
        checks=(("z_min", ">", 0.14), ("flight_run_max", ">", 6),
                ("n_flights", ">", 8), ("apex_z", ">", 0.33),
                ("x_final", ">", 2.0),
                ("dones_mean", "<", 0.05),
                ("dones_height_mean", "<", 0.01),
                ("dones_inverted_mean", "<", 0.01)),
        recorded="BASELINE configs[3] fast-jump: pronking with ballistic "
                 "flight phases (all four feet >5 mm off the ground) that "
                 "TRAVELS (round-4 audit: vx=0.3 pronked in place, "
                 "+0.63 m).  Measured at vx=0.5 with the crate parked "
                 "down-range: +2.97 m in 400 steps, 12 flights (one per "
                 "1.5 Hz pronk cycle), longest 14 steps (0.28 s) "
                 "airborne, apex 0.419 m (standing 0.27), airborne 37%, "
                 "zero terminations, z_min 0.185",
        extra_metrics=_flight_metrics,
        quick_checks=(("z_min", ">", 0.14), ("flight_run_max", ">", 6),
                      ("n_flights", ">", 2), ("apex_z", ">", 0.33),
                      ("x_final", ">", 0.4),
                      ("dones_mean", "<", 0.05),
                      ("dones_height_mean", "<", 0.01),
                      ("dones_inverted_mean", "<", 0.01)),
    ),
    "go2_crate_climb": Gate(
        task="go2_crate_climb",
        n_steps=600,  # approach ~4 s + mount ~5 s + settle on top
        dial=dict(Hsample=25, Hnode=5),
        checks=(("z_last100_mean", ">", 0.45),
                ("feet_on_crate_last100", ">", 0.6),
                ("x_final", ">", 1.1),
                ("z_min", ">", 0.15),
                ("dones_mean", "<", 0.05),
                ("dones_height_mean", "<", 0.01),
                ("dones_inverted_mean", "<", 0.01)),
        recorded="mounts the reference crate (mjx_scene_force_crate.xml "
                 "box at a climbable 0.30 m top).  Measured: approach + "
                 "front-feet mount by step ~250, rear-kick full mount at "
                 "step ~513, then stands ON the crate at the goal — "
                 "x 1.36, torso settled 0.50-0.51 (z_last100 0.516), "
                 "feet-on-crate 87% of the last 100 steps, zero "
                 "terminations of any cause (physical termination box)",
        extra_metrics=_climb_metrics,
        # 150 steps (3 s) is approach + first mount attempt: require real
        # forward progress toward the crate without terminations; the
        # mounted-stand envelope only exists in the full lane
        quick_checks=(("x_final", ">", 0.4), ("z_min", ">", 0.15),
                      ("dones_mean", "<", 0.05),
                      ("dones_height_mean", "<", 0.01),
                      ("dones_inverted_mean", "<", 0.01)),
    ),
    "go2_canter": Gate(
        task="go2_canter",
        dial=dict(Hsample=20, Hnode=5),
        checks=(("z_min", ">", 0.15), ("x_final", ">", 4.5),
                ("dones_mean", "<", 0.05), ("dones_height_mean", "<", 0.01),
                ("dones_inverted_mean", "<", 0.01)),
        recorded="with done_penalty=2.0: 5.1 m, z_min 0.242, dones 0.0% "
                 "(was 26.5% joint-graze before the penalty, QUALITY_r03)",
        quick_checks=(("z_min", ">", 0.15), ("x_final", ">", 1.0),
                      ("dones_mean", "<", 0.05),
                      ("dones_height_mean", "<", 0.01),
                      ("dones_inverted_mean", "<", 0.01)),
    ),
    "go2_gallop": Gate(
        task="go2_gallop",
        dial=dict(Hsample=20, Hnode=5),
        checks=(("z_min", ">", 0.15), ("x_final", ">", 5.5),
                ("dones_mean", "<", 0.05), ("dones_height_mean", "<", 0.01),
                ("dones_inverted_mean", "<", 0.01)),
        recorded="with done_penalty=2.0: 6.3 m, z_min 0.248, dones 0.0% "
                 "(was 26.5% joint-graze before the penalty, QUALITY_r03)",
        quick_checks=(("z_min", ">", 0.15), ("x_final", ">", 1.2),
                      ("dones_mean", "<", 0.05),
                      ("dones_height_mean", "<", 0.01),
                      ("dones_inverted_mean", "<", 0.01)),
    ),
}


@functools.lru_cache(maxsize=None)
def card_identity(index: int) -> Tuple[str, Optional[str]]:
    """(name, power limit) of card `index`: torch's name, and the power
    limit as `nvidia-smi --query-gpu=name,power.limit` gives it (None
    where nvidia-smi does not answer)."""
    name = torch.cuda.get_device_name(index)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        lines = out.stdout.strip().splitlines() if out.returncode == 0 else []
    except (OSError, subprocess.TimeoutExpired):
        lines = []
    power = lines[index].rsplit(",", 1)[1].strip() if index < len(lines) else None
    return name, power


def device_identity(device) -> Tuple[str, Optional[str]]:
    """("cpu", None) on the CPU, else the card's name and power limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type, None
    index = device.index if device.index is not None else torch.cuda.current_device()
    return card_identity(index)


def run_gate(name: str, quick: bool = False, seed: Optional[int] = None,
             device="cuda") -> Dict:
    """Run one gate's workload; return measured metrics + per-check results.

    quick=True runs the 150-step audit lane (same task, planner, and
    metrics; re-derived thresholds — see Gate.quick_n_steps).  seed
    overrides DialConfig.seed (planner noise + reset draw) so gates can be
    re-run under a different noise realization — thresholds are envelopes,
    not single-trajectory fits, and must hold across seeds.  The result has
    the JAX module's keys, then `device` (the card's name, or "cpu") and
    `power_limit` (nvidia-smi's, None on the CPU)."""
    from tpu_dialmpc_torch.envs import get_env
    from tpu_dialmpc_torch.planner import runner
    from tpu_dialmpc_torch.planner.dial import DialConfig

    t_start = time.time()
    g = GATES[name]
    n_steps = g.quick_n_steps if quick else g.n_steps
    checks_spec = g.quick_checks if quick else g.checks
    dial = dict(g.dial or {})
    if seed is not None:
        dial["seed"] = seed
    env = get_env(g.task, device=device, n_substeps=8, **(g.env_over or {}))
    cfg = DialConfig(
        Hsample=dial.pop("Hsample", 32),
        Hnode=dial.pop("Hnode", 8),
        Nsample=dial.pop("Nsample", 2048),
        Ndiffuse=2,
        Ndiffuse_init=10,
        temp_sample=0.05,
        horizon_diffuse_factor=0.9,
        traj_diffuse_factor=0.5,
        ctrl_dt=0.02,
        n_steps=n_steps,
        **dial,
    )
    res = runner.run_scan(env, cfg)
    qpos = _host(res.qpos)
    rewards = _host(res.rewards)
    dones = _host(res.dones)
    z = qpos[:, 2]
    metrics = {
        "z_min": float(z.min()),
        "z_last100_mean": float(z[-100:].mean()),
        "x_final": float(qpos[-1, 0]),
        "dones_mean": float(dones.mean()),
        "reward_mean": float(rewards.mean()),
    }
    causes = termination_breakdown(env, qpos)
    joint_graze = causes.pop("joint_graze_rates")
    metrics.update(causes)
    if g.extra_metrics:
        metrics.update(g.extra_metrics(env, res.qpos))
    checks = []
    for metric, op, thr in checks_spec:
        v = metrics[metric]
        ok = v > thr if op == ">" else v < thr
        checks.append(
            {"metric": metric, "op": op, "threshold": thr,
             "measured": v, "passed": bool(ok)}
        )
    card, power = device_identity(env.device)
    return {
        "gate": name,
        "task": g.task,
        "n_steps": n_steps,
        "lane": "quick" if quick else "full",
        "seed": cfg.seed,
        # per-gate provenance: with per-gate stamps a merged artifact
        # stays auditable
        "measured_at": time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime(t_start)
        ),
        "wall_s": round(time.time() - t_start, 1),
        "metrics": metrics,
        "joint_graze_rates": joint_graze,
        "checks": checks,
        "passed": all(c["passed"] for c in checks),
        "recorded": g.recorded,
        "device": card,
        "power_limit": power,
    }


def run_all(
    names: Optional[List[str]] = None,
    quick: bool = False,
    seeds: Optional[List[int]] = None,
    on_result: Optional[Callable] = None,
    device="cuda",
) -> List[Dict]:
    """Every gate in `names` (default: all) once per seed in `seeds`
    (default: the gates' own seed), seed by seed; `on_result(result, i, n)`
    is called after each run (i of n)."""
    names = list(names or GATES)
    seeds = list(seeds) if seeds else [None]
    results = []
    for s in seeds:
        for n in names:
            results.append(run_gate(n, quick=quick, seed=s, device=device))
            if on_result is not None:
                on_result(results[-1], len(results), len(seeds) * len(names))
    return results


def main(argv=None) -> int:
    """The harness (`quality_main.main`): run the gates or the scaling
    report and write the round artifact."""
    from tpu_dialmpc_torch import quality_main

    return quality_main.main(argv)


if __name__ == "__main__":
    sys.exit(main())
