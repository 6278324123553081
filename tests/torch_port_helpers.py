"""Shared helpers for the torch port's parity tests (tests/test_torch_*.py).

The Go2 and H1 stand-in scenes live in tests/assets; the JAX package reaches them
through TPU_DIALMPC_ASSETS, which `models_root()` reads at call time, so the
tests set it with monkeypatch and other test files are not affected.  Nothing
here imports jax at module level: tests/test_torch_cuda.py runs without it.
"""

import dataclasses
from pathlib import Path

import numpy as np

ASSETS = Path(__file__).resolve().parent / "assets"
PORT_NPZ = ASSETS.parents[1] / "tpu_dialmpc_torch" / "assets" / "go2_force.npz"
CRATE_NPZ = PORT_NPZ.with_name("go2_force_crate.npz")
H1_NPZ = PORT_NPZ.with_name("h1_push_crate.npz")
TIMESTEP = 0.0025
# scenes of this repository's own, which the JAX package's registry does not
# name: reached by path
OWN_SCENES = {
    "go2_pair_kinds": ASSETS / "pairs" / "mjx_scene_pair_kinds.xml",
    # the pair-kinds scene with its objects colliding with the floor alone
    # (nv=36), and the H1-2 joint layout (nv=33): dof masks past 32 bits
    "go2_pair_kinds_fused": ASSETS / "pairs" / "mjx_scene_pair_kinds_fused.xml",
    "h1_2_walk": ASSETS / "unitree_h1" / "mjx_scene_h1_2_walk.xml",
}


def use_standin_assets(monkeypatch):
    monkeypatch.setenv("TPU_DIALMPC_ASSETS", str(ASSETS))


def jax_standin_model(monkeypatch, scene="go2_force"):
    """A stand-in scene compiled by the JAX package, as UnitreeGo2Env does
    (with no crate option set)."""
    from tpu_dialmpc.dynamics import assets
    from tpu_dialmpc.dynamics.model import compile_model

    use_standin_assets(monkeypatch)
    mj = assets.load_mj_model(str(OWN_SCENES.get(scene, scene)))
    mj.opt.timestep = TIMESTEP
    return compile_model(mj).with_options(timestep=TIMESTEP)


def port_model_from(jax_model):
    """The same model carried into the port through its numpy fields."""
    from tpu_dialmpc_torch.dynamics.model import from_numpy_fields

    return from_numpy_fields(
        {f.name: getattr(jax_model, f.name) for f in dataclasses.fields(jax_model)}
    )


def standin_joint_names(monkeypatch, scene):
    """The stand-in scene's joint names in joint order ("" where unnamed),
    read by mujoco: what the exported model file must carry."""
    import mujoco

    from tpu_dialmpc.dynamics import assets

    use_standin_assets(monkeypatch)
    mj = assets.load_mj_model(str(OWN_SCENES.get(scene, scene)))
    return tuple(mujoco.mj_id2name(mj, mujoco.mjtObj.mjOBJ_JOINT, j) or ""
                 for j in range(mj.njnt))


def assert_same(a, b, where):
    """Exact equality of numpy fields, dicts, dataclasses and plain values."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b), where
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k}]")
    elif dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            assert_same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    else:
        assert a == b, where


def assert_same_model(port, jax_model):
    """The port's model equals the JAX package's in every field the JAX model
    has (the port's own `jnt_names` is checked on its own)."""
    for f in dataclasses.fields(jax_model):
        assert_same(getattr(port, f.name), getattr(jax_model, f.name), f.name)


def near_home_states(model, rng, n, scale_q=0.1, scale_v=0.5):
    """test_fused.py's _rand_state, batched: home keyframe with perturbed
    joints, random velocities and warmstarts."""
    qpos = np.tile(np.asarray(model.key_qpos["home"], np.float64), (n, 1))
    qpos[:, 7:] += rng.normal(scale=scale_q, size=(n, model.nq - 7))
    qvel = rng.normal(scale=scale_v, size=(n, model.nv))
    ws = rng.normal(scale=scale_v, size=(n, model.nv))
    return qpos, qvel, ws


def servo_states(model, rng, n):
    """Inputs for the position-servo model (go2_position): near-home states
    (test_fused.py's perturbation) and joint targets about each sample's
    joints, spread so that some targets lie outside the servo's ctrlrange
    and some forces kp (ctrl - q) - kv qdot outside its forcerange, and the
    rest inside both.  Returns (qpos, qvel, ws, ctrl)."""
    qpos, qvel, ws = near_home_states(model, rng, n, scale_q=0.05, scale_v=0.2)
    ws[:] = 0.0
    ctrl = qpos[:, 7:7 + model.nu] + rng.normal(scale=0.8, size=(n, model.nu))
    return qpos, qvel, ws, ctrl


def servo_clamps(model, qpos, qvel, ctrl):
    """(ctrl clamped, force clamped, the largest |b1 q + b2 qdot|) over the
    samples and servos: how much of the affine-bias actuator branch the
    inputs exercise."""
    qpos, qvel, ctrl = (np.asarray(a, np.float64) for a in (qpos, qvel, ctrl))
    qadr, dadr = np.asarray(model.actuator_qposadr), np.asarray(model.actuator_dofadr)
    lo, hi = np.asarray(model.actuator_ctrlrange).T
    c = np.clip(ctrl, lo, hi)
    b = np.asarray(model.actuator_biasprm)
    bias = b[:, 0] + b[:, 1] * qpos[:, qadr] + b[:, 2] * qvel[:, dadr]
    force = np.asarray(model.actuator_gainprm) * c + bias
    flo, fhi = np.asarray(model.actuator_forcerange).T
    return (int(((ctrl < lo) | (ctrl > hi)).sum()), int(((force < flo) | (force > fhi)).sum()),
            float(np.abs(bias).max()))


def _quat_rp(roll, pitch):
    cr, sr = np.cos(roll / 2), np.sin(roll / 2)
    cp, sp = np.cos(pitch / 2), np.sin(pitch / 2)
    return np.stack([cr * cp, sr * cp, cr * sp, -sr * sp], -1)


def crate_states(model, rng, n):
    """States on the crate scene where every contact kind is active.

    - the first third stands with its base about 0.2 m before the crate's
      face (x = 0.99): every other sample with its front feet and calves
      on the face (sphere-box, capsule-box), the others a little closer
      with the front thighs drawn back, so the torso's corners and the
      thighs meet it (box-box, capsule-box);
    - the second third lies on the floor: every other sample on its side,
      legs level, so the lower legs' capsules touch (plane-capsule), the
      others low with the legs splayed and folded so the torso box touches
      (plane-box);
    - the rest stands near home on the floor (plane-sphere).
    Returns (qpos, qvel), zero-mean velocities of scale 0.2."""
    qpos = np.tile(np.asarray(model.key_qpos["home"], np.float64), (n, 1))
    qpos[:, 7:] += rng.normal(scale=0.03, size=(n, model.nq - 7))
    t = n // 3
    face = np.arange(t)
    feet, torso = face[::2], face[1::2]
    qpos[feet, 0] = rng.uniform(0.77, 0.79, feet.size)
    qpos[torso, 0] = rng.uniform(0.80, 0.815, torso.size)
    qpos[torso, 8] += 0.35  # front thighs back: the torso, not the feet,
    qpos[torso, 11] += 0.35  # leads into the crate
    low = np.arange(t, 2 * t)
    side, splay = low[::2], low[1::2]
    qpos[side, 2] = rng.uniform(0.15, 0.16, side.size)
    qpos[side, 3:7] = _quat_rp(rng.choice([-1.0, 1.0], side.size)
                               * rng.uniform(1.45, 1.65, side.size),
                               rng.uniform(-0.1, 0.1, side.size))
    qpos[splay, 2] = rng.uniform(0.06, 0.07, splay.size)
    qpos[splay, 3:7] = _quat_rp(rng.uniform(-0.15, 0.15, splay.size),
                                rng.uniform(-0.1, 0.1, splay.size))
    qpos[splay, 7::3] += 0.75 * np.array([1.0, -1.0, 1.0, -1.0])  # hips out
    qpos[splay, 8::3] += 0.6  # thighs up
    qpos[splay, 9::3] -= 0.9  # calves folded
    qvel = rng.normal(scale=0.2, size=(n, model.nv))
    return qpos, qvel


H1_CRATE_AT_HANDS = -0.095  # the H1 crate's slide qpos that puts its face 3 mm into the hands


def h1_crate_states(model, rng, n):
    """States on the H1 push-crate scene where every contact kind is active,
    and most of them between the robot and the crate, whose slots carry the
    dofs of both kinematic trees.

    The robot stands at home (joints perturbed); the crate slides along x
    (its qpos, index 26) so that its near face sits a few mm into what
    leads, found by the plain forward kinematics of each sample:
    - the first fifth: the hands (sphere-box, both trees);
    - the second: the knees' capsules, the arms swung back out of the way
      (capsule-box, both trees);
    - the third: the torso box's lower front corners, the pelvis leaning
      forward, thighs vertical, arms back (box-box, both trees);
    - the fourth lies face down with its hands on the floor, the crate out of
      reach (plane-sphere);
    - the rest stands, the crate just out of reach.
    The lower foot (face down: hand) is a few mm in the floor (plane-capsule;
    the leaning torso's feet hang just above it), and the crate rests 1 mm
    in it (plane-box).  Returns (qpos, qvel), zero-mean
    velocities of scale 0.2."""
    import torch

    from tpu_dialmpc_torch.dynamics import fused

    geom = {name: i for i, name in enumerate(
        ("floor", "l_knee", "l_shin", "l_foot", "r_knee", "r_shin", "r_foot",
         "torso", "l_hand", "r_hand", "crate"))}
    assert [int(t) for t in model.geom_type] == [0] + [3] * 6 + [6, 2, 2, 6], "not the H1 stand-in"
    crate_qadr, half_x = 26, float(model.geom_size[geom["crate"], 0])
    face0 = float(model.body_pos[model.body_names.index("crate"), 0]) - half_x
    top = float(model.body_pos[model.body_names.index("crate"), 2]
                + model.geom_size[geom["crate"], 2])
    qpos = np.tile(np.asarray(model.key_qpos["home"], np.float64), (n, 1))
    qpos[:, 7:crate_qadr] += rng.normal(scale=0.03, size=(n, crate_qadr - 7))
    g = np.arange(n) * 5 // n  # the group of each sample
    arms_back = (g == 1) | (g == 2)
    for adr in (18, 22):  # shoulder pitch: the arms swing back
        qpos[arms_back, adr] += rng.uniform(1.0, 1.4, int(arms_back.sum()))
    lean = np.where(g == 2, rng.uniform(0.5, 0.6, n), 0.0)
    down = np.where(g == 3, np.pi / 2 + rng.uniform(-0.1, 0.1, n), 0.0)
    qpos[:, 3:7] = _quat_rp(np.zeros(n), lean + down)
    for adr in (9, 14):  # hip pitch: the leaning torso's thighs stay vertical
        qpos[g == 2, adr] += 0.4 - lean[g == 2]

    # each group's leading point, from the plain forward kinematics
    fk = fused._fk(model, list(torch.as_tensor(qpos).unbind(-1)))

    def world(i, local):
        """(n, 3) world position of a point given in geom i's frame."""
        p, m = fk["geom_xpos"][i], fk["geom_xmat"][i]
        return np.stack([np.broadcast_to(np.asarray(
            p[r] + sum(m[r][c] * local[c] for c in range(3)), np.float64), (n,))
            for r in range(3)], -1)

    hands = [world(geom[k], (0.0, 0.0, 0.0)) for k in ("l_hand", "r_hand")]
    hand_front = np.max([h[:, 0] for h in hands], axis=0) + 0.04
    knee_front = np.max([world(geom[k], (0.0, 0.0, sz * 0.05))[:, 0]
                         for k in ("l_knee", "r_knee") for sz in (-1.0, 1.0)], axis=0) + 0.05
    hx, hy, hz = (float(x) for x in model.geom_size[geom["torso"]])
    corners = [world(geom["torso"], (hx, sy * hy, -hz)) for sy in (-1.0, 1.0)]
    assert np.all(np.max([c[:, 2] for c in corners], axis=0)[g == 2] < top - 0.01)
    torso_front = np.max([c[:, 0] for c in corners], axis=0)
    depth = rng.uniform(0.002, 0.008, n)
    face = np.select([g == 0, g == 1, g == 2], [hand_front, knee_front, torso_front],
                     face0 + rng.uniform(0.01, 0.05, n)) - np.where(g < 3, depth, 0.0)
    face[g == 3] = face0 + 1.0
    qpos[:, crate_qadr] = face - face0
    # the pelvis's height: the lower foot, or face down the lower hand, a few
    # mm in the floor
    foot_low = np.min([world(geom[k], (0.0, 0.0, sz * 0.1))[:, 2]
                       for k in ("l_foot", "r_foot") for sz in (-1.0, 1.0)], axis=0) - 0.02
    hand_low = np.min([h[:, 2] for h in hands], axis=0) - 0.04
    low = np.where(g == 3, hand_low, foot_low)
    qpos[g != 2, 2] -= (low + depth)[g != 2]
    qvel = rng.normal(scale=0.2, size=(n, model.nv))
    return qpos, qvel


def use_host_math(monkeypatch):
    """Make the plain version's sin, cos and sqrt the host's own (glibc's
    sinf/cosf, IEEE sqrt), as the kernel's g++ host build calls them: torch's
    CPU kernels round a few inputs in 1e3 differently.  With this the host
    build and the plain float32 version are equal to the bit."""
    import ctypes
    import math

    import torch

    from tpu_dialmpc_torch.dynamics import fused

    libm = ctypes.CDLL("libm.so.6")
    for fn in (libm.sinf, libm.cosf):
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]

    def host(fn, exact):
        def f(a):
            if fused._isf(a):
                return exact(float(a))
            return torch.tensor([fn(x) for x in a.tolist()], dtype=a.dtype).reshape(a.shape)
        return f

    monkeypatch.setattr(fused, "ssin", host(libm.sinf, math.sin))
    monkeypatch.setattr(fused, "scos", host(libm.cosf, math.cos))
    monkeypatch.setattr(fused, "ssqrt", lambda a: math.sqrt(float(a)) if fused._isf(a)
                        else torch.from_numpy(np.sqrt(a.numpy())))


def h1_floor_states(model, rng, n):
    """States on a crate-free H1 scene (h1_walk, h1_loco) where every
    contact kind the scene has is active, each against the floor.

    The joints are perturbed about home; by thirds, the robot
    - stands, its lowest foot a few mm in the floor (plane-capsule);
    - lies face down, its lower hand a few mm in the floor (plane-sphere);
    - lies on its back, the torso box's lowest corner a few mm in the floor
      (plane-box).
    The pelvis height that does it comes from the plain forward kinematics
    of each sample.  Returns (qpos, qvel), zero-mean velocities of scale
    0.2."""
    import torch

    from tpu_dialmpc_torch.dynamics import fused
    from tpu_dialmpc_torch.dynamics.model import GEOM_BOX, GEOM_CAPSULE, GEOM_SPHERE

    types = [int(t) for t in model.geom_type]
    qpos = np.tile(np.asarray(model.key_qpos["home"], np.float64), (n, 1))
    qpos[:, 7:] += rng.normal(scale=0.03, size=(n, model.nq - 7))
    g = np.arange(n) * 3 // n
    pitch = np.select([g == 1, g == 2], [np.pi / 2, -np.pi / 2], 0.0) + rng.uniform(-0.1, 0.1, n)
    qpos[:, 3:7] = _quat_rp(np.zeros(n), np.where(g == 0, 0.0, pitch))
    fk = fused._fk(model, list(torch.as_tensor(qpos).unbind(-1)))

    def lowest(kind):
        """(n,) the lowest z over the geoms of one type."""
        out = []
        for i, t in enumerate(types):
            if t != kind:
                continue
            p = [np.broadcast_to(np.asarray(x, np.float64), (n,)) for x in fk["geom_xpos"][i]]
            zrow = [np.broadcast_to(np.asarray(x, np.float64), (n,)) for x in fk["geom_xmat"][i][2]]
            size = model.geom_size[i]
            if t == GEOM_SPHERE:
                out.append(p[2] - size[0])
            elif t == GEOM_CAPSULE:
                out.append(p[2] - np.abs(zrow[2]) * size[1] - size[0])
            else:
                out.append(p[2] - sum(np.abs(zrow[c]) * size[c] for c in range(3)))
        return np.min(out, axis=0)

    low = np.select([g == 0, g == 1], [lowest(GEOM_CAPSULE), lowest(GEOM_SPHERE)],
                    lowest(GEOM_BOX))
    qpos[:, 2] -= low + rng.uniform(0.002, 0.008, n)
    qvel = rng.normal(scale=0.2, size=(n, model.nv))
    return qpos, qvel


def pair_kinds_states(model, rng, n):
    """States on the pair-kinds scene (tests/assets/pairs) where every contact
    kind is active.  The robot stands near home (joints perturbed), the ball
    and both sticks rest 1-2 mm in the floor (plane-sphere, plane-capsule);
    by thirds:
    - the ball leans on the front-left foot (sphere-sphere);
    - stick 1 lies across the front of the front-right foot, the ball
      against its far side (sphere-capsule, twice);
    - the sticks cross, stick 2 on top of stick 1 (capsule-capsule).
    The robot's foot positions come from the plain forward kinematics of
    each sample; each contact overlaps by 1-4 mm (a foot too high to reach
    the object leaves it just below, out of contact).  Returns (qpos, qvel),
    velocities of scale 0.1.  On the fused variant of the scene
    (mjx_scene_pair_kinds_fused.xml), where the objects collide with the
    floor alone, the same states hold the ball and, in two thirds of the
    samples, both sticks in the floor."""
    import torch

    from tpu_dialmpc_torch.dynamics import fused

    r_ball, r_stick, r_foot = 0.05, 0.02, 0.0175
    assert model.nq == 40 and [float(model.geom_size[g, 0]) for g in (5, 6, 7)] == [
        r_ball, r_stick, r_stick], "not the pair-kinds scene"
    ball, stick1, stick2 = 19, 26, 33  # the free joints' qpos addresses
    along_x = np.array([np.cos(np.pi / 4), 0.0, np.sin(np.pi / 4), 0.0])
    along_y = np.array([np.cos(np.pi / 4), -np.sin(np.pi / 4), 0.0, 0.0])
    qpos = np.tile(np.asarray(model.key_qpos["home"], np.float64), (n, 1))
    qpos[:, 7:19] += rng.normal(scale=0.03, size=(n, 12))
    fk = fused._fk(model, list(torch.as_tensor(qpos).unbind(-1)))
    foot = [np.stack([np.broadcast_to(np.asarray(x, np.float64), (n,)) for x in fk["geom_xpos"][g]],
                     -1) for g in range(1, 5)]  # FL, FR, RL, RR: the geoms after the floor
    depth = rng.uniform(0.001, 0.004, n)
    ball_z = r_ball - rng.uniform(0.001, 0.002, n)
    stick_z = r_stick - rng.uniform(0.001, 0.002, n)
    g = np.arange(n) * 3 // n
    # objects apart on the floor, then moved into contact by group
    qpos[:, ball : ball + 3] = np.stack([np.full(n, 0.8), np.zeros(n), ball_z], -1)
    qpos[:, stick1 : stick1 + 3] = np.stack([np.full(n, 0.8), np.full(n, 0.5), stick_z], -1)
    qpos[:, stick2 : stick2 + 3] = np.stack([np.full(n, -0.6), np.zeros(n), stick_z], -1)
    qpos[:, stick1 + 3 : stick1 + 7] = along_y
    qpos[:, stick2 + 3 : stick2 + 7] = along_x
    # the ball against the front-left foot, ahead of it
    k = g == 0
    dz = ball_z[k] - foot[0][k, 2]
    dx = np.sqrt(np.maximum((r_ball + r_foot - depth[k]) ** 2 - dz**2, 0.0))
    qpos[k, ball : ball + 3] = np.stack([foot[0][k, 0] + dx, foot[0][k, 1], ball_z[k]], -1)
    # stick 1 (along y) across the front of the front-right foot, the ball
    # behind it on the far side
    k = g == 1
    dz = stick_z[k] - foot[1][k, 2]
    dx = np.sqrt(np.maximum((r_stick + r_foot - depth[k]) ** 2 - dz**2, 0.0))
    x1 = foot[1][k, 0] + dx
    qpos[k, stick1 : stick1 + 3] = np.stack([x1, foot[1][k, 1], stick_z[k]], -1)
    dz = ball_z[k] - stick_z[k]
    qpos[k, ball : ball + 3] = np.stack(
        [x1 + np.sqrt(np.maximum((r_ball + r_stick - depth[k]) ** 2 - dz**2, 0.0)), foot[1][k, 1],
         ball_z[k]], -1)
    # stick 2 (along x) on top of stick 1 (along y), crossing at right angles
    k = g == 2
    qpos[k, stick2 : stick2 + 3] = np.stack(
        [np.full(k.sum(), 0.8), np.full(k.sum(), 0.5), stick_z[k] + 2 * r_stick - depth[k]], -1)
    qvel = rng.normal(scale=0.1, size=(n, model.nv))
    return qpos, qvel


class TorchStubEnv:
    """Torch copy of tests/stub_env.py's StubFusedEnv: linear dynamics
    qpos' = 0.9 qpos + 0.1 u, so the planner is tested without physics."""

    nu = 4
    A = 0.9
    B = 0.1
    device = "cpu"
    on_fused_path = True  # a planner captures its units whole

    @property
    def action_size(self):
        return self.nu

    def launch_counters(self):
        """No kernel of its own: no launch counter for a graph to add to."""
        return []

    def reset(self, generator=None):
        import torch

        from tpu_dialmpc_torch.envs.base import LeanEnvState, LeanPipelineState

        z = torch.zeros(self.nu, dtype=torch.float64)
        return LeanEnvState(
            pipeline=LeanPipelineState(qpos=z, qvel=z, qacc_warmstart=z),
            obs=z, reward=torch.zeros((), dtype=torch.float64),
            done=torch.zeros((), dtype=torch.bool), info=None,
        )

    def _step_math(self, qpos, qvel, u):
        qpos2 = self.A * qpos + self.B * u
        qvel2 = qpos2 - qpos
        reward = -((qpos2 - 1.0) ** 2).sum(-1) + 0.01 * qvel2.sum(-1)
        return qpos2, qvel2, reward

    def rollout_batch(self, state, all_us, want_states=False, step=None):
        """`step` is never given: a planner on the stub captures no env step."""
        import torch

        B = all_us.shape[0]
        qpos = state.pipeline.qpos.expand(B, self.nu)
        qvel = state.pipeline.qvel.expand(B, self.nu)
        outs = []
        for t in range(all_us.shape[1]):
            qpos, qvel, r = self._step_math(qpos, qvel, all_us[:, t])
            outs.append((r, qpos, qvel, qpos[:, :3]) if want_states else (r,))
        stacked = [torch.stack(x, dim=1) for x in zip(*outs)]
        return tuple(stacked) if want_states else stacked[0]

    def step_lean(self, state, u):
        import dataclasses

        qpos2, qvel2, r = self._step_math(state.pipeline.qpos, state.pipeline.qvel, u)
        return dataclasses.replace(
            state,
            pipeline=dataclasses.replace(state.pipeline, qpos=qpos2, qvel=qvel2),
            obs=qpos2, reward=r,
        )

    step = step_lean  # the stub's one step, as StubFusedEnv.step (compat_q1 chains it)


class EagerGraph:
    """A stand-in for `planner.capture.CudaGraph` on the CPU: its capture
    runs the unit's function once on the static buffers and keeps the
    outputs, a replay runs it again and copies the results into those
    outputs, as a CUDA graph writes its buffers.  The Python counters a
    replay moves are set back by `capture.Unit`, as on the card, where a
    replay runs no Python."""

    def __init__(self, device=None):
        self.fn = self.out = None
        self.captures = self.replays = 0

    def warm(self, fn):
        return fn()

    def capture(self, fn, setup=True):
        self.fn, self.captures = fn, self.captures + 1
        self.out = fn()
        return self.out

    def replay(self):
        from tpu_dialmpc_torch.planner import capture

        new = capture._flatten(self.fn())
        for dst, src in zip(capture._flatten(self.out), new):
            dst.copy_(src)
        self.replays += 1


def use_eager_graphs(setattr_=setattr):
    """Every planner built from here on captures wherever `capture` is not
    False, through `EagerGraph`s; returns the list of graphs made.
    `setattr_` patches `planner.capture`: a test's `monkeypatch.setattr`
    (undone after the test), the builtin in a rank process."""
    from tpu_dialmpc_torch.planner import capture

    graphs = []

    def make(device):
        graphs.append(EagerGraph(device))
        return graphs[-1]

    def pick(mode, env, backend=None):
        return mode is not False

    setattr_(capture, "pick_capture", pick)
    setattr_(capture, "CudaGraph", make)
    return graphs


EVENT_RECORD = 7  # CU_GRAPH_NODE_TYPE_EVENT_RECORD


def graph_node_types(cuda_graph) -> dict:
    """{node type: count} of a kept `torch.cuda.CUDAGraph`, from libcuda's
    cuGraphGetNodes and cuGraphNodeGetType."""
    import collections
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    cuda.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_size_t)]
    cuda.cuGraphNodeGetType.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    cuda.cuGraphGetNodes.restype = cuda.cuGraphNodeGetType.restype = ctypes.c_int
    graph, n = ctypes.c_void_p(cuda_graph.raw_cuda_graph()), ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(graph, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cuda.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) == 0
    kinds = collections.Counter()
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
        kinds[kind.value] += 1
    return dict(kinds)


def fused_kernel_records(fn):
    """`fn()` under torch.profiler after a pre-roll of spin kernels (a
    trace's first records can be lost) and a settle wait (its last ones can
    come late): (start ns, duration ns) of each fused-kernel record, in
    start order."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpu_dialmpc_torch.telemetry.profile import TRACE_SETTLE_S

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(256):
            torch.cuda._sleep(40_000)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_SETTLE_S)
    return sorted((e.start_ns(), e.duration_ns()) for e in prof.profiler.kineto_results.events()
                  if "fused_step_kernel" in e.name()
                  and not str(e.device_type()).endswith("CPU"))


def _unit_quats(rng, n):
    """Unit quaternions: a third near upright, a third tilted up to 90
    degrees, a third anywhere (upside down too)."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = np.select([np.arange(n) % 3 == 0, np.arange(n) % 3 == 1],
                      [rng.uniform(-0.2, 0.2, n), rng.uniform(-1.6, 1.6, n)],
                      rng.uniform(-np.pi, np.pi, n))
    yaw = rng.uniform(-np.pi, np.pi, n)
    q = np.concatenate([np.cos(angle / 2)[:, None], np.sin(angle / 2)[:, None] * axis], 1)
    z = np.stack([np.cos(yaw / 2), 0 * yaw, 0 * yaw, np.sin(yaw / 2)], 1)
    w1, v1, w2, v2 = z[:, :1], z[:, 1:], q[:, :1], q[:, 1:]
    return np.concatenate([w1 * w2 - np.sum(v1 * v2, 1, keepdims=True),
                           w1 * v2 + w2 * v1 + np.cross(v1, v2)], 1)


def go2_env_inputs(env, B, seed, broadcast_info=False, device="cpu"):
    """Reward inputs that take every branch somewhere in the batch: feet in
    and out of contact and of the crate's footprint, torsos above and below
    0.18 m, upside down, past the crate's front and `goal_x`, joints inside
    and outside their ranges; steps at and off the redraw and turn periods.
    Made on the CPU from `seed`, then moved to `device`.  Returns (kwargs of
    `_post_physics` but info and ctrl, info, action (B, nu), a strided view
    as `rollout_batch` hands it); the reward inputs are views of one (B, ND)
    tensor, as the fused substep returns them."""
    import torch

    from tpu_dialmpc_torch.dynamics import fused
    from tpu_dialmpc_torch.envs.base import StateInfo

    m, dtype = env.model, env._dtype
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype)  # noqa: E731
    qpos = np.tile(np.asarray(m.key_qpos["home"], np.float64), (B, 1))
    qpos[:, 7:] += rng.normal(scale=0.5, size=(B, m.nq - 7))
    qvel = rng.normal(scale=2.0, size=(B, m.nv))
    der = torch.as_tensor(rng.normal(size=(B, fused.derived_size(m, env._fused_spec()))),
                          dtype=dtype)
    d = fused.split_derived(m, env._fused_spec(), der)
    cx = env._crate[0] if env._crate is not None else 0.3
    d["torso_xpos"].copy_(t(np.stack([rng.uniform(-0.5, 2.0, B), rng.uniform(-0.3, 0.3, B),
                                      rng.uniform(0.1, 0.45, B)], 1)))
    d["torso_xquat"].copy_(t(_unit_quats(rng, B)))
    d["torso_cvel"].copy_(t(rng.normal(size=(B, 6))))
    d["root_com"].copy_(d["torso_xpos"] + t(rng.normal(scale=0.05, size=(B, 3))))
    sites = rng.normal(scale=0.5, size=(B, m.nsite, 3))
    sites[..., 0] += cx
    sites[..., 2] = rng.uniform(0.0, 0.4, (B, m.nsite))
    sites[:, :, 2][rng.uniform(size=(B, m.nsite)) < 0.3] = 0.0175 + rng.uniform(-2e-3, 2e-3)
    d["site_xpos"].copy_(t(sites))
    d["qfrc_actuator"].copy_(t(rng.normal(scale=20.0, size=(B, m.nv))))
    steps = rng.integers(0, 2000, B)
    pick = rng.uniform(size=B) < 0.3  # the redraw and turn periods, and steps beside them
    steps[pick] = rng.choice([0, 500, 1000, 75, 150, 499, 74], int(pick.sum()))
    info = StateInfo(
        pos_tar=t(np.array([0.282, 0.0, 0.3]) + rng.normal(scale=0.05, size=(B, 3))),
        vel_tar=t(rng.normal(size=(B, 3))),
        ang_vel_tar=t(rng.normal(size=(B, 3))),
        yaw_tar=t(rng.uniform(-4, 4, B)),
        step=torch.as_tensor(steps, dtype=torch.int32),
        z_feet=t(rng.normal(size=(B, 4))),
        z_feet_tar=t(rng.normal(size=(B, 4))),
        last_contact=torch.as_tensor(rng.uniform(size=(B, 4)) < 0.5),
        feet_air_time=t(rng.uniform(0, 0.5, (B, 4))),
        seed=torch.as_tensor(rng.integers(0, 2**62, B), dtype=torch.int64),
    )
    info = StateInfo(**{f.name: getattr(info, f.name).to(device)
                        for f in dataclasses.fields(info)})
    if broadcast_info:
        info = StateInfo(**{f.name: getattr(info, f.name)[0].expand_as(getattr(info, f.name))
                            for f in dataclasses.fields(info)})
    us = t(rng.uniform(-1.5, 1.5, (B, 3, m.nu))).to(device)
    args = dict(qpos=t(qpos).to(device), qvel=t(qvel).to(device),
                **fused.split_derived(m, env._fused_spec(), der.to(device)))
    return args, info, us[:, 1]
