"""CLI: run a DIAL-MPC task in closed loop from the registry, YAML or flags;
replay, plot or render a saved trajectory; smoke-test an env; profile and
benchmark the planner; probe keyframes with IK.

Counterpart of `tpu_dialmpc/cli/main.py`'s `run`, `replay`, `plot`,
`render`, `env-test`, `ik`, `profile`, `bench` and `scaling` subcommands,
with their flags, the config
precedence (the task's registry defaults < the YAML file's `dial:` / `env:`
sections < flags), their printed lines and `run`'s `--out` trajectory keys;
plus `--device` (default `cuda`, the card; `cpu` runs the plain PyTorch
versions) and `run --telemetry-backend` (`auto`, `native`, `python`).

  python -m tpu_dialmpc_torch.cli.main run --task go2_trot --n-steps 100
  python -m tpu_dialmpc_torch.cli.main run --config configs/h1_walk.yaml
  python -m tpu_dialmpc_torch.cli.main run --task go2_stand --device cpu \\
      --nsample 16 --hsample 4 --n-steps 3
  python -m tpu_dialmpc_torch.cli.main replay --task go2_stand --trajectory out.npz
  python -m tpu_dialmpc_torch.cli.main env-test --task h1_walk --n-steps 20
  python -m tpu_dialmpc_torch.cli.main plot --trajectory out.npz --out plots.png
  python -m tpu_dialmpc_torch.cli.main ik --task go2_stand --dz -0.03
  python -m tpu_dialmpc_torch.cli.main profile --task go2_stand --out trace_dir
  python -m tpu_dialmpc_torch.cli.main bench --task go2_stand --full
  python -m tpu_dialmpc_torch.cli.main scaling --task go2_stand
  python -m tpu_dialmpc_torch.cli.main bench --task go2_stand --full \
      --out BENCH_TORCH_LAST_GOOD.json

`run`: `--checkpoint` writes the loop's state every 50 steps and at the end,
`--resume` continues from such a file, `--telemetry` streams one JSONL
record per step (through the native sink where it builds, unless
`--telemetry-backend` says otherwise), and `--scan` runs the bare loop
(`runner.run_scan`: `run` with nothing attached), which takes none of those
three.  `replay` steps a `run --out` file's actions through `env.step` (the
physics pipeline) from its saved start state (`qpos0`, `qvel0`,
`warmstart0`) and prints the final qpos drift; `plot` draws its state,
reward and control charts (matplotlib); `env-test` steps zero actions from
the reset state.  `ik` solves the feet IK for a base offset (`--mode ik`) or
settles the PD-held home pose under the physics (`--mode settle`).
`profile` prints the amortized phase timings of one annealing iteration and
the fused kernel's roofline (`telemetry/profile.py`) and, with `--out`,
writes a profiler trace of one `reverse_once`.  `bench` prints the
`reverse_once` row of the JAX package's benchmark schema as one JSON line
(`tpu_dialmpc_torch/bench.py`), with `--full` also the control-step and
roofline rows under `extra`; `scaling` prints the sample-parallel planner's
strong-scaling rows (`shard/scaling.py`), one JSON line per mesh size (the
card count's sizes on the card; one rank with `--device cpu`); `bench --out
PATH` also writes the line, with its time, card and power limit, to PATH
(BENCH_TORCH_LAST_GOOD.json at the repository root is what
`tools/readme_table.py` reads).  `render` draws a `run --out` trajectory to
MP4/GIF offscreen, or replays it in a window with `--interactive`, with
the executed joint torques as arrows with `--torques`
(`tools/render.py`): it runs on a host with mujoco and an EGL or GL
display, not on the card's machine.

  python -m tpu_dialmpc_torch.cli.main render --task go2_trot --device cpu \
      --trajectory traj.npz --out traj.mp4 --torques
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def _load_yaml(path):
    import yaml  # only with --config: PyYAML is optional

    with open(path) as f:
        return yaml.safe_load(f)


def _build(args):
    """(env, DialConfig, task) for the parsed flags."""
    from tpu_dialmpc_torch.envs import dial_defaults, get_env
    from tpu_dialmpc_torch.planner.dial import DialConfig

    env_overrides = {}
    if args.config:
        cfg = _load_yaml(args.config)
        task = cfg.get("task", args.task)
        # registry task defaults < yaml dial section < explicit flags
        dial_kwargs = dial_defaults(task)
        env_overrides.update(cfg.get("env", {}))
        dial_kwargs.update(cfg.get("dial", {}))
    else:
        task = args.task
        dial_kwargs = dial_defaults(task)
    if args.nsample:
        dial_kwargs["Nsample"] = args.nsample
    if args.hsample:
        dial_kwargs["Hsample"] = args.hsample
    if args.n_steps:
        dial_kwargs["n_steps"] = args.n_steps
    if args.substeps:
        env_overrides["n_substeps"] = args.substeps
    env = get_env(task, device=args.device, **env_overrides)
    return env, DialConfig(**dial_kwargs), task


def _host(x):
    return x.detach().cpu().numpy()


def cmd_run(args):
    from tpu_dialmpc_torch import checkpoint
    from tpu_dialmpc_torch.planner import runner
    from tpu_dialmpc_torch.telemetry import TelemetryStream

    if args.scan and (args.resume or args.checkpoint or args.telemetry):
        raise SystemExit(
            "--scan is incompatible with --resume/--checkpoint/--telemetry "
            "(those need the host-loop driver)"
        )
    env, dial_cfg, task = _build(args)
    resume = None
    if args.resume:
        state, Y0, generator, ckpt_cfg, step = checkpoint.load(args.resume, env)
        resume = (state, Y0, generator, step)
        # the checkpoint's planner config is authoritative (the restored Y0
        # has its Hnode+1 shape); --n-steps only extends the run
        dial_cfg = ckpt_cfg
        if args.n_steps:
            dial_cfg = dataclasses.replace(dial_cfg, n_steps=args.n_steps)
        print(f"resumed from {args.resume} at step {step}")
    stream = (TelemetryStream(args.telemetry, backend=args.telemetry_backend)
              if args.telemetry else None)
    t0 = time.time()
    try:
        if args.scan:
            res = runner.run_scan(env, dial_cfg)
        else:
            res = runner.run(env, dial_cfg, telemetry=stream, resume=resume,
                             checkpoint_path=args.checkpoint)
        rewards = _host(res.rewards)  # waits for the run's last step
        wall = time.time() - t0
    finally:
        if stream:
            stream.close()
    print(f"task={task} steps={rewards.shape[0]} wall={wall:.2f}s")
    print(f"average reward: {rewards.mean():.6f}")  # dial-core-test.cpp:101-106
    if args.out:
        np.savez(
            args.out,
            rewards=rewards,
            qpos=_host(res.qpos),
            qvel=_host(res.qvel),
            us=_host(res.us),
            dones=_host(res.dones),
            # the state us[0] was executed from, with its warmstart (exact
            # replay), and the control period the run used
            qpos0=_host(res.qpos0),
            qvel0=_host(res.qvel0),
            warmstart0=_host(res.warmstart0),
            dt=float(env.dt),
        )
        print(f"trajectory saved to {args.out}")
    return 0


def cmd_replay(args):
    """Replay a saved trajectory through the physics, print the qpos drift."""
    import torch

    from tpu_dialmpc_torch.dynamics import pipeline

    env, _, _ = _build(args)
    with np.load(args.trajectory) as f:
        data = {k: f[k] for k in f.files}
    state = env.reset()

    def t(x):
        return torch.as_tensor(x, dtype=state.obs.dtype, device=env.device)

    if "qpos0" in data:
        # us[0] was executed from the saved start state (a resumed run's is
        # its checkpoint's), with its warmstart: the truncated Newton solve's
        # starting point is observable, and pipeline.init zeroes it
        ps = pipeline.init(env.model, t(data["qpos0"]), t(data["qvel0"]))
        if "warmstart0" in data:
            ps = dataclasses.replace(ps, qacc_warmstart=t(data["warmstart0"]))
        state = dataclasses.replace(state, pipeline=ps)
    us, qpos = t(data["us"]), t(data["qpos"])
    drift = []
    for k in range(us.shape[0]):
        state = env.step(state, us[k])
        drift.append(torch.linalg.vector_norm(state.pipeline.qpos - qpos[k]))
    drift = _host(torch.stack(drift))
    print(f"replayed {len(drift)} steps; final qpos drift {drift[-1]:.3e}")
    return 0


def cmd_env_test(args):
    """Env smoke test: reset, then zero-action steps, printing the torso
    height, reward and termination (the reference's go2_env_test loop,
    headless)."""
    import torch

    env, _, _ = _build(args)
    state = env.reset()
    zero = torch.zeros(env.action_size, dtype=state.obs.dtype, device=env.device)
    n = args.n_steps or 100
    for t in range(n):
        state = env.step(state, zero)
        if t % max(1, n // 10) == 0:
            print(f"step {t}: z={float(state.pipeline.qpos[2]):.4f} "
                  f"reward={float(state.reward):+.4f} done={bool(state.done)}")
        if bool(state.done):
            print(f"terminated at step {t}")
            break
    print(f"final qpos[:7]: {_host(state.pipeline.qpos[:7]).round(4)}")
    return 0


def cmd_plot(args):
    """The reference plotting fork's 6 state charts of a `run --out`
    trajectory (base position and orientation, joint positions, base linear
    and angular velocity, joint velocities), its per-step reward and the
    executed controls, as one PNG (the JAX CLI's `plot`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    with np.load(args.trajectory) as f:
        data = {k: f[k] for k in f.files}
    qpos, qvel = data["qpos"], data["qvel"]
    fig, axes = plt.subplots(2, 4, figsize=(22, 9))
    panels = [
        ("Graph 1: Base Position (x,y,z)", qpos[:, 0:3], ("x", "y", "z")),
        ("Graph 5: Base Orientation", qpos[:, 3:7], ("qw", "qx", "qy", "qz")),
        ("Graph 2: Joints Position", qpos[:, 7:], None),
        ("Graph 3: Base Velocity", qvel[:, 0:3], ("vx", "vy", "vz")),
        ("Graph 6: Base Angular Velocity", qvel[:, 3:6], ("wx", "wy", "wz")),
        ("Graph 4: Joints Velocity", qvel[:, 6:], None),
        ("Reward", data["rewards"][:, None], ("reward",)),
        ("Executed controls", data["us"], None),
    ]
    for ax, (title, series, labels) in zip(axes.ravel(), panels):
        for i in range(series.shape[1]):
            ax.plot(series[:, i], label=labels[i] if labels else f"{i}", linewidth=0.9)
        ax.set_title(title)
        ax.set_xlabel("control step")
        if series.shape[1] <= 4:
            ax.legend(fontsize=7)
    fig.tight_layout()
    out = args.out or "trajectory_plots.png"
    fig.savefig(out, dpi=120)
    plt.close(fig)
    print(f"plots saved to {out}")
    return 0


def cmd_ik(args):
    """IK / keyframe probe (the reference's legged_robot_ik.cpp): `--mode ik`
    holds the feet while shifting the base; `--mode settle` shifts the base,
    PD-holds the home pose and steps the physics to settle."""
    from tpu_dialmpc_torch.tools import ik as ik_mod

    env, _, _ = _build(args)
    offset = [args.dx, args.dy, args.dz]
    if args.mode == "ik":
        q, res = ik_mod.solve_feet_ik(env, offset)
        print(f"feet-position residual: {float(res):.2e} m")
    else:
        q = ik_mod.settle_probe(env, offset)
    q = _host(q)
    print(f"base: {q[:3].round(4)} quat: {q[3:7].round(4)}")
    print(f"joint angles: {q[7:].round(4)}")
    return 0


def cmd_profile(args):
    """Per-phase timings and the fused kernel's roofline
    (telemetry/profile.py); with --out, a profiler trace of one
    reverse_once after a warm call."""
    import torch

    from tpu_dialmpc_torch.envs.base import to_lean
    from tpu_dialmpc_torch.planner.dial import MBDPI
    from tpu_dialmpc_torch.telemetry import profile as prof

    width = dict(task=args.task, nsample=args.nsample or 2048, hsample=args.hsample or 20,
                 n_substeps=args.substeps or 8, device=args.device)
    print("phase timings (amortized, ms):")
    for k, v in prof.phase_timings(**width).items():
        print(f"  {k}: {v:.3f}")
    try:
        roof = prof.fused_kernel_roofline(**width)
        print("fused kernel roofline:")
        for k, v in roof.items():
            print(f"  {k}: {v}")
    except prof.FusedPathUnavailable as e:
        print(f"roofline skipped: {e}")
    if args.out:
        env, dial_cfg, _ = _build(args)
        mbdpi = MBDPI(dial_cfg, env)
        state = to_lean(env.reset())
        dtype = state.obs.dtype
        Y0 = torch.zeros((dial_cfg.Hnode + 1, env.action_size), dtype=dtype, device=env.device)
        scale = torch.as_tensor(mbdpi.sigma_control, dtype=dtype, device=env.device)
        gen = torch.Generator(device=env.device).manual_seed(1)
        mbdpi.reverse_once(state, gen, Y0, scale)  # warm: builds the kernel
        prof.capture_trace(args.out, mbdpi.reverse_once, state, gen, Y0, scale)
        print(f"profiler trace written to {args.out}")
    return 0


def cmd_bench(args):
    """The benchmark's reverse_once row, with --full also the control step's
    and the roofline's (tpu_dialmpc_torch/bench.py), as one JSON line."""
    from tpu_dialmpc_torch import bench as bench_mod
    from tpu_dialmpc_torch.telemetry.profile import FusedPathUnavailable

    kw = dict(task=args.task, nsample=args.nsample or 2048, hsample=args.hsample or 20,
              iters=args.iters, device=args.device)
    if args.hnode is not None:
        kw["hnode"] = args.hnode
    if args.substeps is not None:
        kw["n_substeps"] = args.substeps
    line = bench_mod.run_bench(**kw)
    if args.full:
        extra = [bench_mod.run_control_step_bench(**kw)]
        try:
            extra.append(bench_mod.run_roofline(
                task=kw["task"], nsample=kw["nsample"], hsample=kw["hsample"],
                n_substeps=kw.get("n_substeps", 8), device=args.device))
        except FusedPathUnavailable as e:  # the CPU: no kernel to hold to the roof
            extra.append({"metric": "skipped", "error": str(e)[:200]})
        line["extra"] = extra
    print(json.dumps(line))
    if args.out:
        from tpu_dialmpc_torch.quality import device_identity

        card, power = device_identity(args.device)
        doc = dict(line, measured_at=time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
                   device=card, power_limit=power)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
        print(f"wrote {args.out}")
    return 0


def _executed_torques(env, data):
    """Per-step executed joint torques (T, nu) from a saved trajectory.

    `us[t]` was applied to the state BEFORE step t (the runner records the
    post-step qpos with the pre-step action), so each action pairs with
    (qpos[t-1], qvel[t-1]); the t=0 predecessor is the saved qpos0/qvel0
    (the reset state, or the resume checkpoint's), falling back to the
    reset state for files without them.  The action maps to ctrl through
    the env's own `_ctrl_batch` (PD torque or position target), and the
    actuator force is `smooth.actuator_force` (gain·ctrl + affine bias,
    force and ctrl ranges, gear).  Torque mode is exact (ctrl IS the applied
    force, constant over the control step); position mode is the
    start-of-step servo force kp·(ctrl−q)−kv·qd, which drifts within the
    step's substeps, so the arrows show the torque at step entry."""
    import torch

    from tpu_dialmpc_torch.dynamics import smooth

    if "qpos0" in data:
        q0, v0 = data["qpos0"], data["qvel0"]
    else:
        ps0 = env.reset().pipeline
        q0, v0 = _host(ps0.qpos), _host(ps0.qvel)
    qpos_prev = np.concatenate([q0[None], np.asarray(data["qpos"])[:-1]])
    qvel_prev = np.concatenate([v0[None], np.asarray(data["qvel"])[:-1]])

    def t(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=env.device)

    us, qpos, qvel = t(data["us"]), t(qpos_prev), t(qvel_prev)
    qfrc = smooth.actuator_force(env.model, env._ctrl_batch(us, qpos, qvel), qpos, qvel)
    dofadr = torch.as_tensor(np.asarray(env.model.actuator_dofadr), dtype=torch.long,
                             device=env.device)
    return _host(qfrc.index_select(1, dofadr))


def cmd_render(args):
    """Offscreen-render a saved trajectory to MP4/GIF, or replay it in a
    window (tools/render.py), on the env's host mujoco model: the scene the
    port's model was exported from, with the task's crate placement."""
    from tpu_dialmpc_torch.dynamics import assets
    from tpu_dialmpc_torch.tools.render import render_trajectory, view_trajectory

    if not args.trajectory:
        raise SystemExit("render needs --trajectory <traj.npz>")
    with np.load(args.trajectory) as f:
        data = {k: f[k] for k in f.files}
    env, _, _ = _build(args)
    # the recording's own control period (saved by `run --out`): the rebuilt
    # env's dt follows the current flags, which need not match the run's
    dt = float(data["dt"]) if "dt" in data else env.dt
    if args.interactive:
        try:
            view_trajectory(assets.host_mj_model(env), data["qpos"], dt)
        except RuntimeError as e:
            raise SystemExit(str(e))
        return 0
    out = args.out or (args.trajectory.rsplit(".", 1)[0] + ".mp4")
    tau = _executed_torques(env, data) if args.torques else None
    written = render_trajectory(
        assets.host_mj_model(env),
        data["qpos"],
        out,
        fps=1.0 / max(dt, 1e-9),
        track_body=env.TORSO_BODY,
        tau=tau,
    )
    print(f"rendered {data['qpos'].shape[0]} frames to {written}")
    return 0


def cmd_scaling(args):
    """Strong-scaling report over mesh sizes (shard/scaling.py)."""
    from tpu_dialmpc_torch.shard.scaling import scaling_report

    rows = scaling_report(task=args.task, nsample=args.nsample or 2048,
                          hsample=args.hsample or 20, hnode=args.hnode or 5,
                          n_substeps=args.substeps or 8, device=args.device)
    for r in rows:
        print(json.dumps(r))
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpu_dialmpc_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    parsers = {}
    for name, fn, help_ in (("run", cmd_run, "run a task in closed loop"),
                            ("replay", cmd_replay, "replay a run's --out trajectory"),
                            ("env-test", cmd_env_test, "step an env with zero actions"),
                            ("ik", cmd_ik, "feet IK or a settle probe for a base offset"),
                            ("profile", cmd_profile, "phase timings and the kernel's roofline"),
                            ("bench", cmd_bench, "the benchmark's rows as one JSON line"),
                            ("scaling", cmd_scaling, "strong scaling of the sharded planner"),
                            ("render", cmd_render, "draw a run's --out trajectory (mujoco)")):
        sp = parsers[name] = sub.add_parser(name, help=help_)
        sp.add_argument("--task", default="go2_stand")
        sp.add_argument("--config", default=None, help="YAML file: task, env:, dial:")
        sp.add_argument("--nsample", type=int, default=None)
        sp.add_argument("--hsample", type=int, default=None)
        sp.add_argument("--n-steps", type=int, default=None)
        sp.add_argument("--substeps", type=int, default=None)
        sp.add_argument("--device", default="cuda", help="torch device (default: the card)")
        sp.set_defaults(fn=fn)
    sp = parsers["run"]
    sp.add_argument("--scan", action="store_true", help="the bare loop, records on the device")
    sp.add_argument("--checkpoint", default=None, help="checkpoint .npz path")
    sp.add_argument("--resume", default=None, help="resume from checkpoint")
    sp.add_argument("--telemetry", default=None, help="JSONL output path")
    sp.add_argument("--telemetry-backend", default="auto", choices=("auto", "native", "python"),
                    help="the native C++ sink, the Python writer, or the sink where it builds")
    sp.add_argument("--out", default=None, help="trajectory .npz output")
    parsers["replay"].add_argument("--trajectory", required=True, help="a run --out .npz")
    sp = parsers["ik"]
    sp.add_argument("--mode", default="ik", choices=("ik", "settle"))
    sp.add_argument("--dx", type=float, default=0.0)
    sp.add_argument("--dy", type=float, default=0.0)
    sp.add_argument("--dz", type=float, default=0.0)
    parsers["profile"].add_argument("--out", default=None, help="profiler trace directory")
    for name in ("bench", "scaling"):
        parsers[name].add_argument("--hnode", type=int, default=None)
    sp = parsers["bench"]
    sp.add_argument("--iters", type=int, default=20, help="repetitions of each chain length")
    sp.add_argument("--full", action="store_true", help="also the control-step and roofline rows")
    sp.add_argument("--out", default=None, help="also write the line, with its time and card, here")
    sp = parsers["render"]
    sp.add_argument("--trajectory", default=None, help="a run --out .npz")
    sp.add_argument("--out", default=None, help="MP4/GIF path (default: the trajectory's, .mp4)")
    sp.add_argument("--torques", action="store_true",
                    help="draw the executed joint torques as arrows")
    sp.add_argument("--interactive", action="store_true",
                    help="replay in a window (needs a display) instead of writing a video")
    sp = sub.add_parser("plot", help="plot a run's --out trajectory")
    sp.add_argument("--trajectory", required=True, help="a run --out .npz")
    sp.add_argument("--out", default=None, help="PNG path (default trajectory_plots.png)")
    sp.set_defaults(fn=cmd_plot)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
