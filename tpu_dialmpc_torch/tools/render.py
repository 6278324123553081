"""Offscreen trajectory rendering (headless MP4/GIF) and an interactive
replay viewer, on the host.

Counterpart of `tpu_dialmpc/tools/render.py`, with the same functions,
writers and errors.  A saved trajectory (`cli run --out traj.npz` →
`cli render --trajectory traj.npz`) is drawn offscreen through EGL: every
control step's qpos is pushed through mj_forward and rendered with a
torso-tracking camera, then encoded to MP4 (OpenCV) or GIF (imageio, when
no MP4 codec is available).  It needs mujoco and an EGL (or, for the
viewer, a windowing GL) display, which the card's machine does not have:
it runs on a workstation.  Scenes come from `dynamics/assets.py`;
`assets.host_mj_model(env)` gives a task's scene with its crate placement.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def render_trajectory(
    scene,  # scene name (str) or a loaded mujoco.MjModel
    qpos: np.ndarray,
    out: str,
    fps: float = 50.0,
    width: int = 640,
    height: int = 480,
    camera_distance: float = 2.0,
    track_body: Optional[str] = None,
    max_frames: int = 2000,
    tau: Optional[np.ndarray] = None,
) -> str:
    """Render a (T, nq) qpos trajectory of the named scene to MP4/GIF.

    With `tau` (T, nu — per-actuator joint torques) each frame also draws an
    arrow per actuated joint along the joint axis, green for positive /
    red for negative torque, length scaled by |τ| relative to the
    trajectory's max.

    Returns the path actually written (the extension may change to .gif if
    no MP4 codec is available).  Frames beyond `max_frames` are dropped by
    striding, and frames stream into the encoder one at a time, so
    pathological trajectory lengths or resolutions can't OOM the host.
    """
    os.environ.setdefault("MUJOCO_GL", "egl")
    import mujoco

    from tpu_dialmpc_torch.dynamics import assets

    # `scene` may be a registered scene name or an already-loaded (possibly
    # task-patched) MjModel — tasks that reposition scene bodies
    # (go2_crate_climb's 0.30 m crate) pass assets.host_mj_model(env) so the
    # video shows the geometry the task actually ran against
    if isinstance(scene, mujoco.MjModel):
        m = scene
    else:
        m = assets.load_mj_model(scene)
    d = mujoco.MjData(m)
    qpos = np.asarray(qpos)
    if qpos.ndim != 2 or qpos.shape[1] != m.nq:
        raise ValueError(f"qpos must be (T, {m.nq}), got {qpos.shape}")
    if qpos.shape[0] == 0:
        raise ValueError("empty trajectory: qpos has 0 steps")
    if tau is not None:
        tau = np.asarray(tau)
        if tau.shape != (qpos.shape[0], m.nu):
            raise ValueError(
                f"tau must be (T, nu) = ({qpos.shape[0]}, {m.nu}), got {tau.shape}"
            )
    stride = max(1, int(np.ceil(qpos.shape[0] / max_frames)))
    qpos = qpos[::stride]
    if tau is not None:
        tau = tau[::stride]
        # actuated hinge joints: arrow anchor/axis come from xanchor/xaxis
        act_jnt = [int(m.actuator_trnid[i, 0]) for i in range(m.nu)]
        tau_max = max(float(np.abs(tau).max()), 1e-9)

    cam = mujoco.MjvCamera()
    mujoco.mjv_defaultCamera(cam)
    if track_body is None:
        # track the root body with a free joint (torso), if any
        free = [
            j
            for j in range(m.njnt)
            if m.jnt_type[j] == mujoco.mjtJoint.mjJNT_FREE
        ]
        body_id = int(m.jnt_bodyid[free[0]]) if free else 0
    else:
        body_id = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_BODY, track_body)
    cam.type = mujoco.mjtCamera.mjCAMERA_TRACKING
    cam.trackbodyid = body_id
    cam.distance = camera_distance
    cam.elevation = -20.0
    cam.azimuth = 135.0

    renderer = mujoco.Renderer(m, height, width)
    writer = _open_writer(out, fps / stride, width, height)
    try:
        for t in range(qpos.shape[0]):
            d.qpos[:] = qpos[t]
            mujoco.mj_forward(m, d)
            renderer.update_scene(d, camera=cam)
            if tau is not None:
                _add_torque_arrows(
                    mujoco, renderer.scene, d, act_jnt, tau[t], tau_max
                )
            writer.add(renderer.render())
    except BaseException:
        # don't leave a truncated video behind on a failed render
        try:
            writer.close()
        finally:
            if os.path.exists(writer.path):
                os.unlink(writer.path)
        raise
    finally:
        renderer.close()
    return writer.close()


def _add_torque_arrows(mujoco, scene, d, act_jnt, tau_t, tau_max):
    """Append one arrow geom per actuated joint to an updated mjvScene.

    Arrow base sits at the joint anchor, points along ±joint axis by torque
    sign (green positive / red negative), length
    0.05–0.30 m proportional to |τ|/τ_max.
    """
    for k, j in enumerate(act_jnt):
        if scene.ngeom >= scene.maxgeom:
            break
        t = float(tau_t[k])
        frac = abs(t) / tau_max
        if frac < 1e-3:
            continue
        anchor = d.xanchor[j]
        axis = d.xaxis[j] * (1.0 if t >= 0 else -1.0)
        tip = anchor + axis * (0.05 + 0.25 * frac)
        g = scene.geoms[scene.ngeom]
        rgba = (
            np.array([0.1, 0.9, 0.1, 0.8], np.float32)
            if t >= 0
            else np.array([0.9, 0.1, 0.1, 0.8], np.float32)
        )
        mujoco.mjv_initGeom(
            g,
            mujoco.mjtGeom.mjGEOM_ARROW,
            np.zeros(3),
            np.zeros(3),
            np.zeros(9),
            rgba,
        )
        mujoco.mjv_connector(
            g, mujoco.mjtGeom.mjGEOM_ARROW, 0.01, anchor, tip
        )
        scene.ngeom += 1


class _Mp4Writer:
    """Streaming MP4 encoder (OpenCV): one frame in flight, constant memory."""

    def __init__(self, path: str, fps: float, width: int, height: int):
        import cv2

        self._cv2 = cv2
        self.path = path
        self._vw = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (width, height)
        )
        if not self._vw.isOpened():
            self._vw.release()
            raise RuntimeError("OpenCV has no usable MP4 codec here")

    def add(self, frame):
        self._vw.write(self._cv2.cvtColor(frame, self._cv2.COLOR_RGB2BGR))

    def close(self) -> str:
        self._vw.release()
        return self.path


class _GifWriter:
    """Streaming GIF encoder (imageio appending writer)."""

    def __init__(self, path: str, fps: float):
        import imageio

        self.path = path
        self._w = imageio.get_writer(
            path, mode="I", duration=1.0 / max(fps, 1e-6), loop=0
        )

    def add(self, frame):
        self._w.append_data(frame)

    def close(self) -> str:
        self._w.close()
        return self.path


def _open_writer(out: str, fps: float, width: int, height: int):
    """Open a streaming encoder for `out` before the first frame renders.

    .mp4 → OpenCV, silently downgrading to .gif only when no MP4 codec is
    available (the reference environment's known-good fallback); .gif →
    imageio.  Anything else is an explicit error — imageio would otherwise
    guess a format from the extension and write something unintended.
    """
    if out.endswith(".mp4"):
        try:
            return _Mp4Writer(out, fps, width, height)
        except Exception:
            return _GifWriter(out[:-4] + ".gif", fps)
    if out.endswith(".gif"):
        return _GifWriter(out, fps)
    raise ValueError(
        f"unsupported output extension on {out!r}: use .mp4 or .gif"
    )


def view_trajectory(
    scene,  # scene name (str) or a loaded mujoco.MjModel
    qpos: np.ndarray,
    dt: float,
    loop: bool = True,
):
    """Interactive replay viewer, for workstation users with a display.

    Uses mujoco.viewer.launch_passive (which owns the GLFW window, camera
    and mouse/keyboard handlers) and drives qpos kinematically at the
    recording's control period.  Headless hosts should use
    render_trajectory instead; this raises a clean error when no display
    is available.
    """
    import time

    if not (os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY")):
        raise RuntimeError(
            "no display (DISPLAY/WAYLAND_DISPLAY unset) — interactive "
            "viewing needs a workstation; use `cli render` for headless MP4"
        )
    # the viewer needs a windowing GL backend, not the headless EGL default
    os.environ["MUJOCO_GL"] = "glfw"
    import mujoco
    import mujoco.viewer

    from tpu_dialmpc_torch.dynamics import assets

    m = scene if isinstance(scene, mujoco.MjModel) else assets.load_mj_model(scene)
    d = mujoco.MjData(m)
    with mujoco.viewer.launch_passive(m, d) as viewer:
        while viewer.is_running():
            t0 = time.time()
            for t in range(qpos.shape[0]):
                if not viewer.is_running():
                    return
                d.qpos[: qpos.shape[1]] = qpos[t]
                mujoco.mj_forward(m, d)
                viewer.sync()
                # real-time pacing against the recording clock
                lag = t0 + (t + 1) * dt - time.time()
                if lag > 0:
                    time.sleep(lag)
            if not loop:
                return
