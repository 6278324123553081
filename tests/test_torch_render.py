"""torch port, rendering on the host: dynamics/assets.py (the scenes as
mujoco models, `host_mj_model`'s crate placement against the port env's
compiled model), tools/render.py (the checks of tests/test_render.py on the
port's copy; headless drawing skips where EGL is absent, as there) and the
CLI's `render` with `_executed_torques` against the JAX CLI's on a port
`run --out` trajectory, in torque and in position mode.
"""

import os

import numpy as np
import pytest

from torch_port_helpers import use_standin_assets
from tpu_dialmpc_torch.cli import main as tcli
from tpu_dialmpc_torch.dynamics import assets
from tpu_dialmpc_torch.envs import get_env
from tpu_dialmpc_torch.tools.render import render_trajectory


@pytest.fixture(autouse=True)
def standins(monkeypatch):
    """The stand-in MJCF, which the port's model files were exported from,
    whatever TPU_DIALMPC_ASSETS says outside the tests."""
    use_standin_assets(monkeypatch)


@pytest.mark.parametrize("task", ["go2_crate_climb", "go2_jump", "go2_crate", "go2_stand"])
def test_host_model_places_the_crate_as_the_env_does(task):
    """The host model's bodies sit where the port env's compiled model puts
    them: box_body moved by crate_x / crate_top_z, nothing else moved."""
    env = get_env(task, device="cpu")
    m = assets.host_mj_model(env)
    assert m.nbody == env.model.nbody
    np.testing.assert_array_equal(np.asarray(m.body_pos), np.asarray(env.model.body_pos))
    if env.config.crate_top_z > 0.0:
        bid = env.model.body_names.index("box_body")
        assert m.geom_rgba[m.body_geomadr[bid], 3] == 1.0  # drawn opaque


def test_scenes_resolve_against_the_env_variable(monkeypatch, tmp_path):
    assert assets.models_root() == assets.STANDINS  # the fixture's path is the default's
    monkeypatch.delenv("TPU_DIALMPC_ASSETS")
    assert assets.models_root() == assets.STANDINS
    monkeypatch.setenv("TPU_DIALMPC_ASSETS", str(tmp_path))
    assert assets.scene_path("go2_force") == tmp_path / assets.SCENES["go2_force"]
    with pytest.raises(FileNotFoundError, match="TPU_DIALMPC_ASSETS"):
        assets.load_mj_model("go2_force")


@pytest.mark.parametrize("scene", ["go2_force", "h1_walk"])
def test_render_trajectory_headless(scene, tmp_path):
    m = assets.load_mj_model(scene)
    T = 8
    qpos = np.tile(np.asarray(m.key_qpos[0]), (T, 1))
    qpos[:, 0] += np.linspace(0.0, 0.1, T)
    try:
        written = render_trajectory(scene, qpos, str(tmp_path / f"{scene}.mp4"), fps=25)
    except Exception as e:  # no EGL device in some sandboxes
        pytest.skip(f"offscreen GL unavailable: {e}")
    assert os.path.exists(written) and os.path.getsize(written) > 1000


def test_render_torque_arrows(tmp_path):
    m = assets.load_mj_model("go2_force")
    T = 6
    qpos = np.tile(np.asarray(m.key_qpos[0]), (T, 1))
    tau = np.random.default_rng(0).normal(scale=10.0, size=(T, m.nu))
    out = str(tmp_path / "torques.mp4")
    with pytest.raises(ValueError, match="tau must be"):
        render_trajectory("go2_force", qpos, out, tau=np.zeros((T + 1, m.nu)))
    try:
        written = render_trajectory("go2_force", qpos, out, fps=25, tau=tau)
    except Exception as e:
        pytest.skip(f"offscreen GL unavailable: {e}")
    assert os.path.exists(written) and os.path.getsize(written) > 1000


def test_render_rejects_bad_shape(tmp_path):
    with pytest.raises(ValueError):
        render_trajectory("go2_force", np.zeros((5, 3)), str(tmp_path / "x.mp4"))


def test_render_rejects_empty_trajectory(tmp_path):
    m = assets.load_mj_model("go2_force")
    with pytest.raises(ValueError, match="empty"):
        render_trajectory("go2_force", np.zeros((0, m.nq)), str(tmp_path / "x.mp4"))


def test_open_writer_streams_and_validates(tmp_path):
    from tpu_dialmpc_torch.tools.render import _open_writer

    frame = np.zeros((32, 48, 3), np.uint8)
    frame[8:16, 8:16] = 255
    w = _open_writer(str(tmp_path / "a.gif"), fps=10, width=48, height=32)
    for _ in range(3):
        w.add(frame)
    path = w.close()
    assert path.endswith(".gif") and os.path.getsize(path) > 100
    w = _open_writer(str(tmp_path / "b.mp4"), fps=10, width=48, height=32)
    for _ in range(3):
        w.add(frame)
    path = w.close()
    # either a real mp4 or the documented .gif downgrade when no codec
    assert path.endswith((".mp4", ".gif")) and os.path.getsize(path) > 100
    with pytest.raises(ValueError, match="extension"):
        _open_writer(str(tmp_path / "c.webm"), fps=10, width=48, height=32)


def test_view_trajectory_requires_display(monkeypatch):
    from tpu_dialmpc_torch.tools.render import view_trajectory

    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.raises(RuntimeError, match="no display"):
        view_trajectory("go2_force", np.zeros((3, 19)), dt=0.02)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """A port `run --out` trajectory per leg control mode, tiny, on the CPU."""
    out = {}
    for task in ("go2_stand", "go2_trot_position"):
        path = tmp_path_factory.mktemp("runs") / f"{task}.npz"
        assert tcli.main(["run", "--task", task, "--device", "cpu", "--nsample", "4",
                          "--hsample", "2", "--substeps", "1", "--n-steps", "4",
                          "--out", str(path)]) == 0
        out[task] = path
    return out


@pytest.mark.parametrize("task", ["go2_stand", "go2_trot_position"])
@pytest.mark.parametrize("saved_start", [True, False])
def test_executed_torques_equal_jax(monkeypatch, port_runs, task, saved_start):
    """The JAX CLI's `_executed_torques` on the same file to 1e-5: the PD
    torques (go2_stand) and the servo forces (go2_trot_position); files
    without qpos0/qvel0 start from the reset state in both."""
    from tpu_dialmpc.cli import main as jcli
    from tpu_dialmpc.envs import registry as jregistry

    with np.load(port_runs[task]) as f:
        data = {k: f[k] for k in f.files if saved_start or k not in ("qpos0", "qvel0")}
    got = tcli._executed_torques(get_env(task, device="cpu"), data)
    want = jcli._executed_torques(jregistry.get_env(task), data)
    assert got.shape == (4, 12) and np.isfinite(got).all()
    assert np.abs(got).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_cli_render_refuses_without_a_trajectory_or_a_display(monkeypatch, port_runs):
    with pytest.raises(SystemExit, match="render needs --trajectory"):
        tcli.main(["render", "--task", "go2_stand", "--device", "cpu"])
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    with pytest.raises(SystemExit, match="no display"):
        tcli.main(["render", "--task", "go2_stand", "--device", "cpu", "--interactive",
                   "--trajectory", str(port_runs["go2_stand"])])


def test_cli_render_writes_a_video(port_runs, tmp_path, capsys):
    out = tmp_path / "traj.gif"
    try:
        rc = tcli.main(["render", "--task", "go2_stand", "--device", "cpu", "--torques",
                        "--trajectory", str(port_runs["go2_stand"]), "--out", str(out)])
    except Exception as e:
        pytest.skip(f"offscreen GL unavailable: {e}")
    assert rc == 0 and out.exists()
    assert "rendered 4 frames to" in capsys.readouterr().out
