"""torch port: the Go2 env step's CUDA kernels (`csrc/go2_env_step.cu`,
wrapper `envs/go2_cuda.py`) through their g++ host build, against the
plain version, the PyTorch ops of `envs/go2.py` and `envs/legged.py`.

One case per Go2 config that takes a branch of the kernels: the stand and
trot gaits, torque and position legs, the crate (its support under the feet,
the torso's ramp, `goal_x`, `y_anchor_weight`), `turn_period`,
`randomize_tasks`, `yaw_mode="eigen"`, `energy_weight` and `done_penalty`;
each in float32 and float64, at B=1 and at B=64 with the state's info one
row per sample or broadcast from one state with stride 0 (as
`rollout_batch` hands it).  The reward inputs are views of one (B, ND) row
block, as the fused substep returns them.

`done`, `step` and `last_contact` must match exactly, and so must every
float output: the source keeps the plain version's order of operations,
one rounding per PyTorch op.  Two differences are taken out, neither of them
the kernels' arithmetic: torch's CPU sin, cos and atan2 are SLEEF's vector
routines, which round some inputs otherwise than glibc's, so the plain
version here calls glibc's (`host_math`), as the host build does; and
torch's CPU sum of the energy's 12 terms adds the last four first (an
8-wide vector and its tail), where the kernel adds them in index order, so
with `energy_weight` set the reward may differ by the rounding of that sum:
at most 8 ulps of the energy term, |energy_weight * reward_energy|, and
the one ulp of the reward by which the last sum then rounds otherwise.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch
from torch_port_helpers import go2_env_inputs

from tpu_dialmpc_torch.envs import go2_cuda
from tpu_dialmpc_torch.envs.base import StateInfo
from tpu_dialmpc_torch.envs.go2 import UnitreeGo2Env, UnitreeGo2EnvConfig

BASE = dict(kp=30.0, kd=0.65, leg_control="torque", n_substeps=8)
CONFIGS = {
    "stand": dict(gait="stand", default_vx=0.8),
    "trot_eigen": dict(gait="trot", default_vx=0.8, yaw_mode="eigen", done_penalty=2.0,
                       joint_range_source="climb"),
    "trot_position": dict(gait="trot", default_vx=0.8, leg_control="position",
                          scene="go2_position", action_scale=0.9),
    "crate_climb": dict(gait="climb", default_vx=0.5, scene="go2_force_crate", crate_top_z=0.30,
                        goal_x=1.35, termination_range_source="physical", done_penalty=2.0,
                        y_anchor_weight=1.0, vel_weight=2.5),
    "turn_energy": dict(gait="gallop", default_vx=0.3, default_vyaw=-1.5, turn_period=75,
                        energy_weight=0.5, ramp_up_time=0.7, joint_range_source="model"),
    "randomize": dict(gait="walk", default_vx=0.5, randomize_tasks=True, default_vy=0.2,
                      default_vyaw=0.4),
}
# energy_weight's reward bound, in ulps of the energy term (module docstring)
ENERGY_ULPS = 8


@pytest.fixture(scope="module")
def host_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("go2_env_kernels")


@pytest.fixture
def host_math(monkeypatch):
    """torch.sin, cos and atan2 as glibc's, element by element (module
    docstring)."""
    libm = ctypes.CDLL("libm.so.6")
    fns = {}
    for name, nargs in (("sin", 1), ("cos", 1), ("atan2", 2)):
        for suffix, real in (("f", ctypes.c_float), ("", ctypes.c_double)):
            fn = getattr(libm, name + suffix)
            fn.restype, fn.argtypes = real, [real] * nargs
            fns[name, suffix] = fn

    def host(name):
        def f(*args):
            args = torch.broadcast_tensors(*(torch.as_tensor(a) for a in args))
            fn = fns[name, "f" if args[0].dtype == torch.float32 else ""]
            flat = [a.reshape(-1).tolist() for a in args]
            out = [fn(*xs) for xs in zip(*flat)]
            return torch.tensor(out, dtype=args[0].dtype).reshape(args[0].shape)
        return f

    for name in ("sin", "cos", "atan2"):
        monkeypatch.setattr(torch, name, host(name))


def make_env(name, dtype):
    return UnitreeGo2Env(UnitreeGo2EnvConfig(**dict(BASE, **CONFIGS[name]), dtype=dtype),
                         device="cpu")


LAYOUTS = [(1, False), (64, False), (64, True)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("B,broadcast", LAYOUTS, ids=["B1", "B64", "B64-broadcast"])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_host_build_matches_plain(config, B, broadcast, dtype, host_dir, host_math):
    """go2_ctrl and go2_post_physics (the g++ build) against `_ctrl_batch`
    and `_post_physics` (PyTorch on the CPU): every output equal, but the
    reward under `energy_weight` (module docstring)."""
    env = make_env(config, dtype)
    env._env_kernels = go2_cuda.Go2EnvKernels(env, host=True, out_dir=host_dir)
    args, info, action = go2_env_inputs(env, B, seed=hash((config, B, broadcast)) % 2**32,
                                    broadcast_info=broadcast)
    assert action.stride(0) == 3 * env.model.nu  # a column of the (B, T, nu) controls
    assert (info.step.stride(0) == 0) == broadcast

    want = env._ctrl_batch_plain(action, args["qpos"], args["qvel"])
    got = env._env_kernels.ctrl(action, args["qpos"], args["qvel"])
    assert got.dtype == want.dtype and torch.equal(got, want)

    r0, d0, i0 = env._post_physics_plain(**args, info=info)
    r1, d1, i1 = env._post_physics_kernel(**args, info=info)
    assert env._env_kernels.ctrl_launches == env._env_kernels.post_physics_launches == 1
    assert torch.equal(d1, d0) and d1.dtype == torch.bool
    for f in dataclasses.fields(StateInfo):
        a, b = getattr(i1, f.name), getattr(i0, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert torch.equal(a, b), f.name
    if env.config.energy_weight:
        cfg = env.config
        qd, tau = args["qvel"][:, 6:], args["qfrc_actuator"][:, 6:]
        energy = torch.sum(torch.clamp(tau * qd / 160.0, min=0.0) ** 2, dim=-1)
        term = (cfg.energy_weight * energy).to(torch.float64).numpy()
        real = r0.numpy().dtype
        bound = (ENERGY_ULPS * np.spacing(term.astype(real)).astype(np.float64)
                 + np.spacing(np.abs(r0.numpy())).astype(np.float64))
        gap = (r1 - r0).abs().to(torch.float64).numpy()
        assert np.all(gap <= bound), float(np.max(gap / bound))
    else:
        assert torch.equal(r1, r0)


def test_every_branch_is_taken(host_dir):
    """The inputs of the B=64 cases reach the kernels' branches: contact and
    air time both ways, some done, redraw steps under randomize_tasks, the
    crate's support under a foot and the torso past the crate's front."""
    env = make_env("crate_climb", "float32")
    args, info, _ = go2_env_inputs(env, 64, seed=1, broadcast_info=False)
    _, done, out = env._post_physics_plain(**args, info=info)
    assert 0 < int(done.sum()) < 64
    assert 0 < int(out.last_contact.sum()) < 256
    top = env._crate[4]
    assert bool((out.z_feet_tar == top).any()) and bool((out.z_feet_tar < top).any())
    assert bool((args["torso_xpos"][:, 0] > 1.35).any())
    env = make_env("randomize", "float32")
    _, info, _ = go2_env_inputs(env, 64, seed=2, broadcast_info=False)
    assert bool((info.step % 500 == 0).any()) and bool((info.step % 500 != 0).any())


def _bad(case, x):
    """`x` (B, n) made into what the kernels do not take."""
    if case == "dtype":
        return x.to(torch.float64)
    if case == "shape":
        return x[:, :-1]
    if case == "rows":  # the right shape, rows not contiguous
        return torch.empty((x.shape[0], 2 * x.shape[1]), dtype=x.dtype)[:, ::2]
    if case == "batch":
        return x[:-1]
    if case == "device":
        return x.to("meta")
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["dtype", "shape", "rows", "batch", "device"])
def test_wrapper_rejects_what_the_kernels_do_not_take(case, host_dir):
    """Another dtype, width, row layout, batch or device raises, and nothing
    is launched."""
    env = make_env("stand", "float32")
    kernels = go2_cuda.Go2EnvKernels(env, host=True, out_dir=host_dir)
    args, info, action = go2_env_inputs(env, 8, seed=3, broadcast_info=False)
    with pytest.raises((TypeError, ValueError)):
        kernels.ctrl(_bad(case, action), args["qpos"], args["qvel"])
    with pytest.raises((TypeError, ValueError)):
        kernels.post_physics(**dict(args, qpos=_bad(case, args["qpos"])), info=info)
    with pytest.raises((TypeError, ValueError)):
        kernels.post_physics(**args, info=dataclasses.replace(
            info, feet_air_time=_bad(case, info.feet_air_time)))
    assert kernels.ctrl_launches == kernels.post_physics_launches == 0


def test_params_layout_and_empty_batch(host_dir):
    """The packed Go2Params is the source's struct, byte for byte, in both
    dtypes; a batch of 0 launches nothing."""
    for dtype in ("float32", "float64"):
        env = make_env("turn_energy", dtype)
        kernels = go2_cuda.Go2EnvKernels(env, host=True, out_dir=host_dir)
        lib = kernels.library()
        code = 0 if dtype == "float32" else 1
        assert lib.lib.go2_params_nbytes(code) == ctypes.sizeof(kernels.params)
        args, info, action = go2_env_inputs(env, 4, seed=4, broadcast_info=False)
        empty = {k: v[:0] for k, v in args.items()}
        out = kernels.ctrl(action[:0], empty["qpos"], empty["qvel"])
        assert out.shape == (0, env.model.nu)
        reward, done, fields = kernels.post_physics(
            **empty, info=StateInfo(**{f.name: getattr(info, f.name)[:0]
                                       for f in dataclasses.fields(info)}))
        assert reward.shape == done.shape == (0,) and fields["z_feet"].shape == (0, 4)
        assert kernels.ctrl_launches == kernels.post_physics_launches == 0


def test_cpu_env_launches_nothing():
    """A CPU env runs the plain version and makes no kernels; its capture
    counters are the fused kernel's alone, its launches and waves."""
    env = make_env("stand", "float32")
    assert env._env_kernels is None
    assert env.launch_counters() == [(env.fused_step, "launches"), (env.fused_step, "waves")]
    args, info, action = go2_env_inputs(env, 4, seed=5, broadcast_info=False)
    env._post_physics(**args, info=info, ctrl=None)
    env._ctrl_batch(action, args["qpos"], args["qvel"])
    assert env._env_kernels is None
