"""Shared helpers for the torch port's parity tests (tests/test_torch_*.py).

The Go2 stand-in scene lives in tests/assets; the JAX package reaches it
through TPU_DIALMPC_ASSETS, which `models_root()` reads at call time, so the
tests set it with monkeypatch and other test files are not affected.
"""

import dataclasses
from pathlib import Path

import numpy as np

ASSETS = Path(__file__).resolve().parent / "assets"
PORT_NPZ = ASSETS.parents[1] / "tpu_dialmpc_torch" / "assets" / "go2_force.npz"
CRATE_NPZ = PORT_NPZ.with_name("go2_force_crate.npz")
TIMESTEP = 0.0025


def use_standin_assets(monkeypatch):
    monkeypatch.setenv("TPU_DIALMPC_ASSETS", str(ASSETS))


def jax_standin_model(monkeypatch, scene="go2_force"):
    """A stand-in scene compiled by the JAX package, as UnitreeGo2Env does
    (with no crate option set)."""
    from tpu_dialmpc.dynamics import assets
    from tpu_dialmpc.dynamics.model import compile_model

    use_standin_assets(monkeypatch)
    mj = assets.load_mj_model(scene)
    mj.opt.timestep = TIMESTEP
    return compile_model(mj).with_options(timestep=TIMESTEP)


def port_model_from(jax_model):
    """The same model carried into the port through its numpy fields."""
    from tpu_dialmpc_torch.dynamics.model import from_numpy_fields

    return from_numpy_fields(
        {f.name: getattr(jax_model, f.name) for f in dataclasses.fields(jax_model)}
    )


def near_home_states(model, rng, n, scale_q=0.1, scale_v=0.5):
    """test_fused.py's _rand_state, batched: home keyframe with perturbed
    joints, random velocities and warmstarts."""
    qpos = np.tile(np.asarray(model.key_qpos["home"], np.float64), (n, 1))
    qpos[:, 7:] += rng.normal(scale=scale_q, size=(n, model.nq - 7))
    qvel = rng.normal(scale=scale_v, size=(n, model.nv))
    ws = rng.normal(scale=scale_v, size=(n, model.nv))
    return qpos, qvel, ws


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


class TorchStubEnv:
    """Torch copy of tests/stub_env.py's StubFusedEnv: linear dynamics
    qpos' = 0.9 qpos + 0.1 u, so the planner is tested without physics."""

    nu = 4
    A = 0.9
    B = 0.1
    device = "cpu"

    @property
    def action_size(self):
        return self.nu

    def reset(self):
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

    def rollout_batch(self, state, all_us):
        import torch

        B = all_us.shape[0]
        qpos = state.pipeline.qpos.expand(B, self.nu)
        qvel = state.pipeline.qvel.expand(B, self.nu)
        rews = []
        for t in range(all_us.shape[1]):
            qpos, qvel, r = self._step_math(qpos, qvel, all_us[:, t])
            rews.append(r)
        return torch.stack(rews, dim=1)

    def step_lean(self, state, u):
        import dataclasses

        qpos2, qvel2, r = self._step_math(state.pipeline.qpos, state.pipeline.qvel, u)
        return dataclasses.replace(
            state,
            pipeline=dataclasses.replace(state.pipeline, qpos=qpos2, qvel=qvel2),
            obs=qpos2, reward=r,
        )
