"""torch port, tpu_dialmpc_torch/quality.py and its harness (quality_main.py),
on the CPU, against the JAX package's tpu_dialmpc/quality.py and the root
quality.py harness on the stand-in scenes:

- the gate table, field by field, and the structural checks of
  tests/test_quality_defs.py on the port's copy;
- every gate metric on the same trajectory: termination_breakdown, the
  turn and crate-displacement metrics exactly; the foot-site metrics (the
  port's float64 forward kinematics against mujoco's mj_kinematics) with
  exactly the same counts, on a trajectory with no foot within 1e-9 of a
  threshold;
- run_gate at a tiny width (8 samples, Hsample 2, Hnode 1, 3 steps, one
  substep): JAX's keys in JAX's order, the metrics and checks the JAX
  run_gate computes from the same trajectory, one seed's result
  reproduced to the bit, another seed's different;
- the harness: _seed_spread against the root quality.py's, the --seed /
  --seeds validation, run_all as the one gate loop, and --scaling on the
  CPU (an artifact with no BENCH_LAST_GOOD input).
"""

import dataclasses
import importlib.util
import json
import math
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

import torch_shard_ranks as ranks
from torch_port_helpers import use_standin_assets
from tpu_dialmpc import quality as jq
from tpu_dialmpc.envs import registry as jregistry
from tpu_dialmpc_torch import quality as q
from tpu_dialmpc_torch import quality_main as qm
from tpu_dialmpc_torch.envs import get_env
from tpu_dialmpc_torch.telemetry import profile as prof

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(Hsample=2, Hnode=1, Nsample=8)
TINY_STEPS = 3


def _root_quality():
    spec = importlib.util.spec_from_file_location("quality_root", ROOT / "quality.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------- the table


def test_gates_equal_jax_field_by_field():
    assert list(q.GATES) == list(jq.GATES)
    assert [f.name for f in dataclasses.fields(q.Gate)] == [
        f.name for f in dataclasses.fields(jq.Gate)]
    for name, jg in jq.GATES.items():
        g = q.GATES[name]
        for f in dataclasses.fields(jq.Gate):
            a, b = getattr(g, f.name), getattr(jg, f.name)
            if f.name == "extra_metrics":  # by function
                assert (a and a.__name__) == (b and b.__name__), name
            else:
                assert a == b, f"{name}.{f.name}"


@pytest.mark.parametrize("name", list(q.GATES))
def test_gate_structure(name):
    """tests/test_quality_defs.py's three checks on the port's gate: a
    quick lane, its metrics a subset of the full lane's, and no posture or
    termination threshold loosened in it."""
    g = q.GATES[name]
    assert g.quick_checks, f"{name} has no quick_checks"
    assert 0 < g.quick_n_steps < g.n_steps
    full = {c[0]: (c[1], c[2]) for c in g.checks}
    quick = {c[0] for c in g.quick_checks}
    assert quick <= set(full), f"{name}: quick metrics {quick - set(full)} not in full"
    safety = ("z_min", "dones_mean", "dones_height_mean", "dones_inverted_mean",
              "z_last100_mean")
    for metric, op, thr in g.quick_checks:
        if metric not in safety or metric not in full:
            continue
        fop, fthr = full[metric]
        assert op == fop, f"{name}.{metric}: op flipped in quick lane"
        assert (thr >= fthr) if op == ">" else (thr <= fthr), f"{name}.{metric} loosened"


# ---------------------------------------------------------------- the metrics


def _wild_trajectory(model, rng, T=300):
    """Home keyframe with large joint, height and attitude perturbations,
    float32 as the runner records it: some steps graze a joint range, some
    are low, some inverted."""
    qpos = np.tile(np.asarray(model.key_qpos["home"], np.float64), (T, 1))
    qpos[:, 0] += np.cumsum(rng.normal(0.01, 0.01, T))
    qpos[:, 2] *= rng.uniform(0.4, 1.2, T)
    quat = rng.normal(0.0, 1.0, (T, 4)) * np.array([3.0, 1.0, 1.0, 1.0])
    qpos[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    qpos[:, 7:] += rng.normal(0.0, 0.35, (T, model.nq - 7))
    return qpos.astype(np.float32)


@pytest.mark.parametrize("task", ["go2_trot", "go2_crate_climb", "h1_walk", "h1_loco",
                                  "h1_push_crate"])
def test_termination_breakdown_equals_jax(monkeypatch, task):
    """The Go2 action box (go2_trot), the physical box (go2_crate_climb),
    H1's physical ranges with their margin: the same rates, run and graze
    rates as the JAX function on the same trajectory, exactly."""
    use_standin_assets(monkeypatch)
    env, jenv = get_env(task, device="cpu"), jregistry.get_env(task)
    qpos = _wild_trajectory(env.model, np.random.default_rng(3))
    got, want = q.termination_breakdown(env, qpos), jq.termination_breakdown(jenv, qpos)
    assert got == want
    # the trajectory exercises every cause, and both done and clear steps
    for k in ("dones_inverted_mean", "dones_joint_mean", "dones_height_mean"):
        assert 0.0 < got[k] < 1.0, k
    # and it reads a torch trajectory the same way
    assert q.termination_breakdown(env, torch.as_tensor(qpos)) == want


def test_turn_and_crate_metrics_equal_jax():
    rng = np.random.default_rng(5)
    T = 400
    yaw = np.cumsum(rng.normal(0.0, 0.08, T))
    roll, pitch = rng.normal(0.0, 0.1, T), rng.normal(0.0, 0.1, T)
    cy, sy, cr, sr, cp, sp = (np.cos(yaw / 2), np.sin(yaw / 2), np.cos(roll / 2),
                              np.sin(roll / 2), np.cos(pitch / 2), np.sin(pitch / 2))
    qpos = np.zeros((T, 27), np.float32)
    qpos[:, 3:7] = np.stack([cr * cp * cy + sr * sp * sy, sr * cp * cy - cr * sp * sy,
                             cr * sp * cy + sr * cp * sy, cr * cp * sy - sr * sp * cy], 1)
    qpos[:, 26] = np.cumsum(rng.normal(0.002, 0.003, T))
    assert q._turn_metrics(None, qpos) == jq._turn_metrics(qpos)
    assert q._crate_disp(None, qpos) == jq._crate_disp(qpos)
    assert q._crate_disp(None, torch.as_tensor(qpos)) == jq._crate_disp(qpos)


def _jump_and_climb_trajectory(model, rng, T=240):
    """The stand-in keyframe in blocks of 1-8 steps: on the floor, lifted
    (feet airborne for lifts past ~5 mm), or over the crate at x=1.3 lifted
    by its 0.30 m top (all four feet on it), with small noise on every
    coordinate; float32 as the runner records it."""
    home = np.asarray(model.key_qpos["home"], np.float64)
    rows = []
    while len(rows) < T:
        on_crate = rng.random() < 0.35
        base_x = 1.3 + rng.uniform(-0.08, 0.08) if on_crate else rng.uniform(-0.5, 2.5)
        lift = (0.30 if on_crate else 0.0) + rng.uniform(-0.03, 0.08)
        for _ in range(int(rng.integers(1, 9))):
            qr = home.copy()
            qr[0] = base_x + rng.normal(0.0, 0.005)
            qr[1] = rng.normal(0.0, 0.05)
            qr[2] += lift + rng.normal(0.0, 0.004)
            yaw = rng.normal(0.0, 0.1)
            qr[3:7] = [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]
            qr[7:] += rng.normal(0.0, 0.05, model.nq - 7)
            rows.append(qr)
    return np.asarray(rows[:T], np.float32)


def _mujoco_feet(monkeypatch, qpos):
    import mujoco

    from tpu_dialmpc.dynamics import assets

    use_standin_assets(monkeypatch)
    m = assets.load_mj_model("go2_force_crate")
    d = mujoco.MjData(m)
    ids = [mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_SITE, s) for s in q.FEET_SITES]
    out = []
    for row in qpos:
        d.qpos[:] = row
        mujoco.mj_kinematics(m, d)
        out.append(d.site_xpos[ids].copy())
    return np.asarray(out)


def test_flight_and_climb_metrics_equal_jax_mujoco(monkeypatch):
    """The port's float64 FK against mujoco: the same foot positions (to
    1e-12 m), no foot within 1e-9 of a threshold, and exactly the JAX
    functions' metrics (airborne steps, flights, on-crate steps)."""
    use_standin_assets(monkeypatch)
    jump, climb = get_env("go2_jump", device="cpu"), get_env("go2_crate_climb", device="cpu")
    qpos = _jump_and_climb_trajectory(jump.model, np.random.default_rng(11))
    feet = q.foot_positions(jump, qpos)
    assert feet.dtype == torch.float64 and feet.shape == (len(qpos), 4, 3)
    np.testing.assert_allclose(feet.numpy(), _mujoco_feet(monkeypatch, qpos), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(q.foot_positions(climb, qpos).numpy(), feet.numpy())

    cx, cy, hx, hy, top = climb._crate
    assert (cx, cy, hx, hy, top) == (1.3, 0.0, 0.31, 0.46, 0.30)  # JAX's literals
    f = feet.numpy()
    margins = np.concatenate([
        np.abs(f[..., 2] - (0.0175 + 5e-3)).ravel(),
        np.abs(np.abs(f[..., 0] - cx) - hx).ravel(),
        np.abs(np.abs(f[..., 1] - cy) - hy).ravel(),
        np.abs(f[..., 2] - (top - 0.05)).ravel(),
    ])
    assert margins.min() > 1e-9

    got, want = q._flight_metrics(jump, qpos), jq._flight_metrics(qpos)
    assert got == want
    assert 0.0 < got["airborne_frac"] < 1.0 and got["n_flights"] > 0
    got, want = q._climb_metrics(climb, qpos), jq._climb_metrics(qpos)
    assert got == want
    assert 0.0 < got["feet_on_crate_last100"] < 1.0 and got["first_mounted_step"] >= 0


def test_climb_metrics_read_the_crate_from_the_env():
    """Another crate_x moves the footprint: the trajectory over the crate at
    x=1.3 is off a crate at x=2.0, and on it when shifted by +0.7; an env
    with no crate top refuses."""
    base = get_env("go2_crate_climb", device="cpu")
    moved = get_env("go2_crate_climb", device="cpu", crate_x=2.0)
    assert moved._crate[0] == 2.0 and moved._crate[1:] == base._crate[1:]
    qpos = _jump_and_climb_trajectory(base.model, np.random.default_rng(11))
    at_base = q._climb_metrics(base, qpos)
    assert at_base["feet_on_crate_last100"] > 0.0
    assert q._climb_metrics(moved, qpos)["feet_on_crate_last100"] == 0.0
    shifted = qpos.copy()
    shifted[:, 0] += np.float32(0.7)
    assert q._climb_metrics(moved, shifted)["first_mounted_step"] == at_base["first_mounted_step"]
    with pytest.raises(ValueError, match="no crate top"):
        q._climb_metrics(get_env("go2_jump", device="cpu"), qpos)


# ---------------------------------------------------------------- run_gate


class _Scan(NamedTuple):
    qpos: np.ndarray
    rewards: np.ndarray
    dones: np.ndarray


@pytest.fixture(scope="module")
def tiny_runs():
    """go2_trot's quick lane at a tiny width on the CPU, one substep per
    control step (the plain substep chain costs ~0.1 s per substep here):
    seed 0 twice and seed 5 once, each result with its trajectory."""
    import tpu_dialmpc_torch.envs as envs_mod
    from tpu_dialmpc_torch.planner import runner

    get, scan, trajs = envs_mod.get_env, runner.run_scan, []

    def one_substep(task, **kw):
        return get(task, **dict(kw, n_substeps=1))

    def recording_scan(env, cfg, n_steps=None):
        res = scan(env, cfg, n_steps)
        trajs.append(_Scan(*(x.numpy() for x in (res.qpos, res.rewards, res.dones))))
        return res

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(q.GATES, "go2_trot", dataclasses.replace(
            q.GATES["go2_trot"], dial=TINY, quick_n_steps=TINY_STEPS))
        mp.setattr(envs_mod, "get_env", one_substep)
        mp.setattr(runner, "run_scan", recording_scan)
        runs = [q.run_gate("go2_trot", quick=True, seed=s, device="cpu") for s in (0, 0, 5)]
    return list(zip(runs, trajs))


def test_run_gate_matches_jax_run_gate_on_its_trajectory(monkeypatch, tiny_runs):
    """The JAX run_gate, its scan replaced by the port's trajectory: the
    same keys in the same order (the port adds device and power_limit), the
    same metrics, graze rates and checks in the gate's check order."""
    from tpu_dialmpc.planner import runner as jrunner

    use_standin_assets(monkeypatch)
    got, traj = tiny_runs[0]
    monkeypatch.setitem(jq.GATES, "go2_trot", dataclasses.replace(
        jq.GATES["go2_trot"], dial=TINY, quick_n_steps=TINY_STEPS))
    monkeypatch.setattr(jrunner, "run_scan", lambda env, cfg: traj)
    want = jq.run_gate("go2_trot", quick=True, seed=0)
    assert list(got) == list(want) + ["device", "power_limit"]
    assert (got["device"], got["power_limit"]) == ("cpu", None)
    for k in ("gate", "task", "n_steps", "lane", "seed", "metrics", "joint_graze_rates",
              "checks", "passed", "recorded"):
        assert got[k] == want[k], k
    assert [c["metric"] for c in got["checks"]] == [
        c[0] for c in jq.GATES["go2_trot"].quick_checks]
    assert got["n_steps"] == TINY_STEPS and traj.qpos.shape == (TINY_STEPS, 19)
    assert all(math.isfinite(v) for v in got["metrics"].values())


def test_run_gate_is_reproducible_by_seed(tiny_runs):
    (a, ta), (b, tb), (c, tc) = tiny_runs
    np.testing.assert_array_equal(ta.qpos, tb.qpos)
    assert a["metrics"] == b["metrics"] and a["checks"] == b["checks"]
    assert (a["seed"], c["seed"]) == (0, 5)
    assert not np.array_equal(ta.qpos, tc.qpos)
    assert a["metrics"] != c["metrics"]


# ---------------------------------------------------------------- the harness


def _result(gate, seed, z_min, passed, x=1.0):
    return {
        "gate": gate, "seed": seed,
        "metrics": {"z_min": z_min, "x_final": x, "note_str": "x"},
        "checks": [{"metric": "z_min", "op": ">", "threshold": 0.15, "measured": z_min,
                    "passed": passed},
                   {"metric": "x_final", "op": ">", "threshold": 0.5, "measured": x,
                    "passed": x > 0.5}],
        "passed": passed and x > 0.5,
    }


def test_seed_spread_equals_root_quality():
    results = [_result("a", 0, 0.20, True), _result("a", 7, 0.14, False, 0.4),
               _result("a", 21, 0.18, True, 0.9), _result("b", 0, 0.3, True),
               _result("b", 7, 0.31, True), _result("c", 0, 0.1, False)]
    root = _root_quality()
    assert qm._seed_spread(results) == root._seed_spread(results)
    spread, sensitive = qm._seed_spread(results)
    assert set(spread) == {"a", "b"}
    assert [s["metric"] for s in sensitive] == ["z_min", "x_final"]


@pytest.mark.parametrize("argv,message", [
    (["--seeds", "1", "2", "1"], "--seeds repeats [1]"),
    (["--seed", "3", "--seeds", "1", "2"], "--seed and --seeds are exclusive"),
    (["--gates", "go2_trot", "go2_moonwalk"], "unknown gates ['go2_moonwalk']"),
])
def test_main_rejects_bad_seed_and_gate_arguments(argv, message, capsys):
    with pytest.raises(SystemExit) as e:
        qm.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_run_quality_goes_through_run_all(monkeypatch, tmp_path):
    """The harness's one gate loop is run_all (every seed, every gate, a
    progress line each), and --seeds writes the spread; the artifact is
    QUALITY_TORCH_QUICK_r{N}.json at the root, N from BENCH_r*.json."""
    calls = []

    def fake_gate(name, quick=False, seed=None, device="cuda"):
        calls.append((name, quick, seed, device))
        return dict(_result(name, seed, 0.2 if seed != 7 else 0.1, seed != 7),
                    wall_s=0.0, device="cpu", power_limit=None)

    run_all = q.run_all
    loops = []
    monkeypatch.setattr(q, "run_gate", fake_gate)
    monkeypatch.setattr(q, "run_all", lambda *a, **kw: loops.append(kw) or run_all(*a, **kw))
    monkeypatch.setattr(qm, "ROOT", str(tmp_path))
    (tmp_path / "BENCH_r04.json").write_text("{}")
    assert qm.main(["--quick", "--gates", "go2_trot", "go2_jump", "--seeds", "0", "7",
                    "--device", "cpu"]) == 1
    assert len(loops) == 1 and loops[0]["seeds"] == [0, 7]
    assert calls == [("go2_trot", True, 0, "cpu"), ("go2_jump", True, 0, "cpu"),
                     ("go2_trot", True, 7, "cpu"), ("go2_jump", True, 7, "cpu")]
    doc = json.loads((tmp_path / "QUALITY_TORCH_QUICK_r05.json").read_text())
    assert (doc["platform"], doc["device"], doc["power_limit"]) == ("cpu", "cpu", None)
    assert doc["lane"] == "quick" and doc["seeds"] == [0, 7] and not doc["all_passed"]
    assert [s["metric"] for s in doc["seed_sensitive_checks"]] == ["z_min", "z_min"]
    assert set(doc["seed_spread"]) == {"go2_trot", "go2_jump"}


def test_port_artifact_names_do_not_match_the_jax_readme_glob(tmp_path):
    import glob

    for name in ("QUALITY_TORCH_r06.json", "QUALITY_TORCH_QUICK_r06.json",
                 "SCALING_TORCH_r06.json"):
        (tmp_path / name).write_text("{}")
    assert glob.glob(str(tmp_path / "QUALITY_r*.json")) == []


def test_scaling_on_the_cpu_takes_nothing_from_bench_last_good(monkeypatch, tmp_path):
    """--scaling --device cpu at a tiny width: the native row, the gloo
    group over 1 and 2 CPU ranks, the overhead of 2 ranks, and predicted
    rows whose compute time is the native row's; no input from the root's
    BENCH_LAST_GOOD.json (its TPU numbers appear nowhere)."""
    orig = prof._amortized
    monkeypatch.setattr(prof, "_amortized",
                        lambda fn, args, **kw: orig(fn, args, r_lo=1, r_hi=2, reps=1))
    monkeypatch.setattr(qm, "NATIVE", dict(task="go2_stand", nsample=8, hsample=2, hnode=1,
                                           n_substeps=1))
    # the ranks' processes run the stub env (torch_shard_ranks.py), as
    # test_torch_scaling.py's groups do: its linear dynamics keep their
    # untruncated timing chains short
    monkeypatch.setattr(qm, "CPU_GROUP", dict(task="go2_stand", nsample=6, hsample=2, hnode=1,
                                              n_substeps=1, mesh_sizes=[1, 2],
                                              env=ranks.stub_env))
    monkeypatch.setattr(qm, "CPU_OVERHEAD_RANKS", 2)
    monkeypatch.setattr(qm, "ROOT", str(tmp_path))
    opened = []
    real_open = open

    def watching_open(path, *a, **kw):
        opened.append(str(path))
        return real_open(path, *a, **kw)

    monkeypatch.setattr("builtins.open", watching_open)
    assert qm.main(["--scaling", "--device", "cpu"]) == 0
    assert not any("BENCH_LAST_GOOD" in p for p in opened)
    doc = json.loads((tmp_path / "SCALING_TORCH_r01.json").read_text())
    native = doc["native"]
    assert (native["platform"], native["device"], native["power_limit"]) == ("cpu", "cpu", None)
    assert [r["devices"] for r in native["rows"]] == [1]
    assert [r["devices"] for r in doc["cpu_group_gloo"]["rows"]] == [1, 2]
    over = doc["collective_overhead_cpu_group"]
    assert over["n_devices_virtual"] == 2 and over["sharded_ms"] > 0
    # the payload formula is what the ranks measured reducing (the stub:
    # nu 4, float64)
    assert over["port_payload_bytes_per_iteration"] == qm.port_payload_bytes(6, 1, 4, 8)
    (pred,) = doc["predicted_multihost"].values()
    ms = native["rows"][0]["ms_per_iteration"]
    assert pred["per_chip_compute_ms"] == ms
    assert pred["payload_bytes"] == qm.port_payload_bytes(8, 1, 12)
    assert {r["compute_ms"] for r in pred["rows"]} == {ms}
    assert pred["compute_basis"]["platform"] == "cpu"
