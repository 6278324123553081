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
TIMESTEP = 0.0025


def use_standin_assets(monkeypatch):
    monkeypatch.setenv("TPU_DIALMPC_ASSETS", str(ASSETS))


def jax_standin_model(monkeypatch):
    """The stand-in compiled by the JAX package, as UnitreeGo2Env does."""
    from tpu_dialmpc.dynamics import assets
    from tpu_dialmpc.dynamics.model import compile_model

    use_standin_assets(monkeypatch)
    mj = assets.load_mj_model("go2_force")
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
