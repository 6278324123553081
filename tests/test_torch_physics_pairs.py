"""torch port, the physics pipeline on the pair-kinds scene
(tests/assets/pairs/mjx_scene_pair_kinds.xml: the Go2 robot with a free ball
and two free sticks), whose sphere-sphere, sphere-capsule and
capsule-capsule pairs the fused substep does not have: the committed model
file against a fresh compile, the stage-by-stage cases of
tests/torch_physics_cases.py against the JAX package in float64, and the
env's physics choice on a model `fused.supported` rejects."""

import numpy as np
import pytest
import torch

from torch_physics_cases import *  # noqa: F401,F403 -- the cases, run on this file's scene
from torch_port_helpers import (
    PORT_NPZ,
    assert_same_model,
    jax_standin_model,
    pair_kinds_states,
    standin_joint_names,
)
from tpu_dialmpc.dynamics import fused as jfused
from tpu_dialmpc_torch.dynamics import fused
from tpu_dialmpc_torch.dynamics.model import load_model, load_scene
from tpu_dialmpc_torch.envs import get_env

SCENE = "go2_pair_kinds"
NEW_KINDS = [(2, 2), (2, 3), (3, 3)]  # sphere-sphere, sphere-capsule, capsule-capsule


@pytest.fixture(scope="module", params=[SCENE])
def scene(request):
    return request.param


def test_committed_pair_kinds_npz_equals_fresh_compile(monkeypatch):
    jm = jax_standin_model(monkeypatch, SCENE)
    port = load_model(str(PORT_NPZ.with_name(f"{SCENE}.npz")))
    assert_same_model(port, jm)
    assert port.jnt_names == standin_joint_names(monkeypatch, SCENE)
    assert (port.nq, port.nv, port.nu) == (40, 36, 12)
    assert sorted(port.pairs) == [(0, 2), (0, 3)] + NEW_KINDS
    assert not fused.supported(port) and not jfused.supported(jm)


def test_pair_kinds_states_touch_every_kind():
    m = load_scene(SCENE)
    qpos, _ = pair_kinds_states(m, np.random.default_rng(0), 12)
    from tpu_dialmpc_torch.dynamics import collision, kinematics

    got = collision.collide(m, kinematics.kinematics(m, torch.as_tensor(qpos)))
    active = (got.dist < torch.as_tensor(collision.contact_params(m).includemargin)).numpy()
    k = 0
    for kind in sorted(m.pairs):
        n = m.pairs[kind].geom1.shape[0] * m.pairs[kind].ncon
        assert active[:, k : k + n].sum() > 0, kind
        k += n


def test_fused_on_raises_and_auto_runs_the_physics_pipeline():
    """fused='on' refuses a model the fused substep does not support; 'auto'
    runs it on the pipeline, and so does 'off'; a supported model runs the
    fused substep under 'auto'."""
    with pytest.raises(ValueError, match="does not support"):
        get_env("go2_stand", device="cpu", scene=SCENE, fused="on")
    with pytest.raises(ValueError, match="fused="):
        get_env("go2_stand", device="cpu", fused="sometimes")
    assert get_env("go2_stand", device="cpu").on_fused_path
    for mode in ("auto", "off"):
        env = get_env("go2_stand", device="cpu", scene=SCENE, fused=mode, n_substeps=1)
        assert not env.on_fused_path
        state = env.reset()
        lean = env.step_lean(state, torch.zeros(12))
        full = env.step(state, torch.zeros(12))
        assert env._fused_step is None  # the fused substep was never built
        for f in ("qpos", "qvel", "qacc_warmstart"):
            assert torch.equal(getattr(lean.pipeline, f), getattr(full.pipeline, f)), f
        assert torch.equal(lean.reward, full.reward) and torch.equal(lean.obs, full.obs)
