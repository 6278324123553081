"""The Go2 env step's CUDA kernels (`csrc/go2_env_step.cu`) and their wrapper.

`Go2EnvKernels(env)` packs a `UnitreeGo2Env`'s config once, as the kernels'
parameter struct, and launches them on CUDA tensors in the env's dtype:

- `ctrl(action (B,nu), qpos (B,nq), qvel (B,nv)) -> ctrl (B,nu)`: the env's
  `_ctrl_batch` (the PD torque map, or the joint targets in position mode);
- `post_physics(qpos, qvel, site_xpos, torso_xpos, torso_xquat, torso_cvel,
  root_com, qfrc_actuator, info) -> (reward (B,), done (B,), the new
  StateInfo's computed fields by name)`: the env's `_post_physics`.

Each call is one launch on the current stream, with no synchronisation; a
non-zero `cudaGetLastError` raises.  Inputs are read through their batch
stride (0 for a field broadcast to the batch), so none is copied; each
row must be contiguous, and anything else the kernels do not take (device,
dtype, shape, layout) raises.  `ctrl_launches` and `post_physics_launches`
count the launches; a CUDA graph that holds them adds them at each replay
(`planner/capture.py`).

The library is built at first use (`dynamics/_build.py`, content-keyed in
`build/kernels/`), one build per motor count: every Go2 config shares it.
With `host=True` the same source is built with g++ and takes CPU tensors:
the CPU tests check the kernels' arithmetic through it.
"""

from __future__ import annotations

import ctypes

import torch

from tpu_dialmpc_torch.dynamics import _build
from tpu_dialmpc_torch.envs import gait
from tpu_dialmpc_torch.telemetry import spans

SOURCE = "go2_env_step.cu"
N_FEET = 4

# go2_post_physics's inputs and outputs, in the source's IN_* / OUT_* order;
# an output's width per sample (None: one value)
POST_INPUTS = ("qpos", "qvel", "site_xpos", "torso_xpos", "torso_xquat", "torso_cvel",
               "root_com", "qfrc_actuator", "pos_tar", "vel_tar", "ang_vel_tar", "yaw_tar",
               "step", "last_contact", "feet_air_time", "seed")
POST_OUTPUTS = (("reward", None), ("done", None), ("vel_tar", 3), ("ang_vel_tar", 3),
                ("yaw_tar", None), ("step", None), ("z_feet", N_FEET),
                ("z_feet_tar", N_FEET), ("last_contact", N_FEET), ("feet_air_time", N_FEET))
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}


def params_struct(real, nu: int):
    """The source's Go2Params<T> as a ctypes structure (`real` c_float or
    c_double)."""
    pair = (real * 2) * nu
    fields = [(k, real) for k in ("kp", "kd", "action_scale")]
    fields += [(k, pair) for k in ("joint_range", "physical_range", "torque_range",
                                   "termination_range")]
    fields += [(k, real) for k in ("dt", "ramp_up_time", "default_vx", "default_vy",
                                   "default_vyaw", "abs_vyaw", "goal_x")]
    fields += [("command_range", real * 3)]
    fields += [(k, real) for k in ("cadence", "amplitude", "swing_width")]
    fields += [("phases", real * N_FEET)]
    fields += [(k, real) for k in ("crate_cx", "crate_cy", "crate_hx", "crate_hy", "crate_top",
                                   "crate_ramp", "crate_front", "vel_weight", "energy_weight",
                                   "y_anchor_weight", "done_penalty", "foot_radius")]
    fields += [(k, ctypes.c_int32) for k in ("position", "randomize", "turn_period",
                                             "yaw_eigen", "lifts", "crate", "goal", "energy",
                                             "y_anchor", "done_pen", "n_energy")]
    fields += [("feet_site", ctypes.c_int32 * N_FEET)]
    return type("Go2Params", (ctypes.Structure,), {"_fields_": fields})


def pack_params(env):
    """The env's config as the kernels' Go2Params: each value as go2.py and
    legged.py hand it to a PyTorch op (a Python number, rounded to the
    dtype by ctypes as PyTorch rounds it; a constant tensor's values)."""
    cfg = env.config
    model = env.model
    real = ctypes.c_float if env._dtype == torch.float32 else ctypes.c_double
    p = params_struct(real, model.nu)()
    p.kp, p.kd, p.action_scale = cfg.kp, cfg.kd, cfg.action_scale
    for name, t in (("joint_range", env.joint_range), ("physical_range", env.physical_joint_range),
                    ("torque_range", env.joint_torque_range),
                    ("termination_range", env.termination_joint_range)):
        dst = getattr(p, name)
        for j, (lo, hi) in enumerate(t.cpu().tolist()):
            dst[j][0], dst[j][1] = lo, hi
    p.dt, p.ramp_up_time = env.dt, cfg.ramp_up_time
    p.default_vx, p.default_vy, p.default_vyaw = cfg.default_vx, cfg.default_vy, cfg.default_vyaw
    p.abs_vyaw, p.goal_x = abs(cfg.default_vyaw), cfg.goal_x
    p.command_range[:] = list(env.COMMAND_RANGE)
    duty, cadence, amplitude = env._gait_params
    p.cadence, p.amplitude = cadence, amplitude
    p.swing_width = float(gait._swing_width(duty, env._dtype, torch.device("cpu")))
    p.phases[:] = env._gait_phases.cpu().tolist()
    if env._crate is not None:
        cx, cy, hx, hy, top = env._crate
        p.crate_cx, p.crate_cy, p.crate_hx, p.crate_hy, p.crate_top = cx, cy, hx, hy, top
        p.crate_front = cx - hx - 0.15
    p.crate_ramp = cfg.crate_ramp
    p.vel_weight, p.energy_weight = cfg.vel_weight, cfg.energy_weight
    p.y_anchor_weight, p.done_penalty = cfg.y_anchor_weight, cfg.done_penalty
    p.foot_radius = env._foot_radius
    p.position = cfg.leg_control == "position"
    p.randomize = bool(cfg.randomize_tasks)
    p.turn_period = int(cfg.turn_period)
    p.yaw_eigen = cfg.yaw_mode == "eigen"
    p.lifts = duty < 1.0
    p.crate = env._crate is not None
    p.goal = cfg.goal_x > 0.0
    p.energy = cfg.energy_weight != 0.0
    p.y_anchor = cfg.y_anchor_weight != 0.0
    p.done_pen = cfg.done_penalty != 0.0
    p.n_energy = model.nv - 6
    p.feet_site[:] = env._feet_site_id.cpu().tolist()
    return p


class _Library:
    """One built library of the two kernels."""

    def __init__(self, path):
        lib = ctypes.CDLL(str(path))
        lib.go2_params_nbytes.restype = ctypes.c_size_t
        lib.go2_params_nbytes.argtypes = [ctypes.c_int]
        lib.go2_io_words.restype = ctypes.c_size_t
        lib.go2_io_words.argtypes = [ctypes.c_int]
        for fn in (lib.go2_ctrl_launch, lib.go2_post_physics_launch):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p]
        self.lib = lib


def build_library(nu: int, host: bool = False, out_dir=None):
    """Build (or find) and load the library for `nu` motors; returns
    (library, build log)."""
    path, log, _ = _build.build(SOURCE, {"G2_NU": nu}, host=host, out_dir=out_dir)
    return _Library(path), log


class Go2EnvKernels:
    """The two kernels for one Go2 env (module docstring)."""

    def __init__(self, env, host: bool = False, out_dir=None):
        m = env.model
        self.nu, self.nq, self.nv, self.nsite = m.nu, m.nq, m.nv, m.nsite
        self.dtype = env._dtype
        self.params = pack_params(env)
        self.turn_period = bool(env.config.turn_period)
        self.host = host
        self.out_dir = out_dir
        self.ctrl_launches = 0
        self.post_physics_launches = 0
        self.build_log = None
        self._lib = None

    @property
    def counters(self):
        """The (object, attribute) pairs of the launch counters."""
        return [(self, "ctrl_launches"), (self, "post_physics_launches")]

    def library(self) -> _Library:
        if self._lib is None:
            with spans.span("setup/env_kernels"):
                lib, self.build_log = build_library(self.nu, self.host, self.out_dir)
            code = _DTYPE_CODE[self.dtype]
            if lib.lib.go2_params_nbytes(code) != ctypes.sizeof(self.params):
                raise RuntimeError(
                    f"Go2Params layout mismatch: kernel struct {lib.lib.go2_params_nbytes(code)} "
                    f"bytes, packed {ctypes.sizeof(self.params)}")
            for kernel, n in ((0, 7), (1, 2 * len(POST_INPUTS) + len(POST_OUTPUTS))):
                if lib.lib.go2_io_words(kernel) != n:
                    raise RuntimeError(f"go2_io_words({kernel}) is "
                                       f"{lib.lib.go2_io_words(kernel)}, the wrapper packs {n}")
            self._lib = lib
        return self._lib

    # ------------------------------------------------------------------
    def _word(self, name, t, B, width, dtype, device):
        """(address, batch stride) of a (B,) or (B, width) input whose rows
        are contiguous."""
        want = "cpu" if self.host else "cuda"
        if t.device.type != want or t.device != device:
            raise ValueError(f"{name}: expected a {want} tensor on {device}, got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
        shape = (B,) if width is None else (B, width)
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if width is not None and width > 1 and t.stride(1) != 1:
            raise ValueError(f"{name}: expected contiguous rows, got strides {t.stride()}")
        return [t.data_ptr(), t.stride(0) if B > 1 else 0]

    def _launch(self, fn, B, words, device, what):
        args = (_DTYPE_CODE[self.dtype], B, ctypes.byref(self.params),
                (ctypes.c_int64 * len(words))(*words))
        if self.host:
            err = fn(*args, None)
        else:
            with torch.cuda.device(device):
                err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{what} kernel launch failed: cudaGetLastError() = {err}")

    def ctrl(self, action, qpos, qvel):
        """`_ctrl_batch` for (B, nu) actions at (B, nq) / (B, nv) states."""
        device = action.device
        B = action.shape[0] if action.dim() == 2 else -1
        words = []
        for name, t, width in (("action", action, self.nu), ("qpos", qpos, self.nq),
                               ("qvel", qvel, self.nv)):
            words += self._word(name, t, B, width, self.dtype, device)
        out = torch.empty((B, self.nu), dtype=self.dtype, device=device)
        if B == 0:
            return out
        lib = self.library()
        self._launch(lib.lib.go2_ctrl_launch, B, words + [out.data_ptr()], device, "go2_ctrl")
        self.ctrl_launches += 1
        return out

    def post_physics(self, qpos, qvel, site_xpos, torso_xpos, torso_xquat, torso_cvel,
                     root_com, qfrc_actuator, info):
        """`_post_physics` for a batch: (reward, done, the StateInfo fields it
        computes, by name; `yaw_tar` only under turn_period)."""
        device = qpos.device
        B = qpos.shape[0] if qpos.dim() == 2 else -1
        if site_xpos.dim() != 3 or site_xpos.stride(2) != 1 or (
                self.nsite > 1 and site_xpos.stride(1) != 3):
            raise ValueError(f"site_xpos: expected (B, {self.nsite}, 3) with contiguous rows, "
                             f"got shape {tuple(site_xpos.shape)}, strides {site_xpos.stride()}")
        real, n = self.dtype, N_FEET
        inputs = dict(
            qpos=(qpos, self.nq, real), qvel=(qvel, self.nv, real),
            site_xpos=(site_xpos.flatten(1), 3 * self.nsite, real),  # a view, checked above
            torso_xpos=(torso_xpos, 3, real), torso_xquat=(torso_xquat, 4, real),
            torso_cvel=(torso_cvel, 6, real), root_com=(root_com, 3, real),
            qfrc_actuator=(qfrc_actuator, self.nv, real),
            pos_tar=(info.pos_tar, 3, real), vel_tar=(info.vel_tar, 3, real),
            ang_vel_tar=(info.ang_vel_tar, 3, real), yaw_tar=(info.yaw_tar, None, real),
            step=(info.step, None, torch.int32), last_contact=(info.last_contact, n, torch.bool),
            feet_air_time=(info.feet_air_time, n, real), seed=(info.seed, None, torch.int64),
        )
        words = []
        for name in POST_INPUTS:
            t, width, dtype = inputs[name]
            words += self._word(name, t, B, width, dtype, device)
        out = {}
        for name, width in POST_OUTPUTS:
            if name == "yaw_tar" and not self.turn_period:
                continue
            dtype = {"done": torch.bool, "last_contact": torch.bool,
                     "step": torch.int32}.get(name, real)
            out[name] = torch.empty((B,) if width is None else (B, width), dtype=dtype,
                                    device=device)
        if B == 0:
            return out.pop("reward"), out.pop("done"), out
        lib = self.library()
        words += [out[name].data_ptr() if name in out else 0 for name, _ in POST_OUTPUTS]
        self._launch(lib.lib.go2_post_physics_launch, B, words, device, "go2_post_physics")
        self.post_physics_launches += 1
        return out.pop("reward"), out.pop("done"), out

