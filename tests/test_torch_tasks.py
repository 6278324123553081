"""torch port, envs/registry.py: all 13 of the JAX registry's tasks, their
planner defaults, the env config fields (the same set in both packages, with
the same values), `fused="off"` for each task, and what each
env derives from its model (action ranges, torque and termination ranges,
sizes), against the JAX package on the stand-in scenes; and `register_env`
with `dial_defaults`' warning for a task registered without planner
defaults.

Exact comparisons: the same config values, the same numpy-derived ranges.
"""

import dataclasses
import warnings

import numpy as np
import pytest

from torch_port_helpers import use_standin_assets
from tpu_dialmpc.envs import registry as jregistry
from tpu_dialmpc_torch.envs import dial_defaults, get_env, list_envs, register_env
from tpu_dialmpc_torch.envs import registry

TASKS = sorted(jregistry.list_envs())


def test_the_port_registers_every_jax_task():
    assert len(TASKS) == 13
    assert list_envs() == TASKS


@pytest.mark.parametrize("task", TASKS)
def test_task_matches_jax(monkeypatch, task):
    use_standin_assets(monkeypatch)
    assert dial_defaults(task) == jregistry.dial_defaults(task)
    jenv, tenv = jregistry.get_env(task), get_env(task, device="cpu")
    jc, tc = dataclasses.asdict(jenv.config), dataclasses.asdict(tenv.config)
    # the derived ranges in the JAX env's float64 (the port keeps them in
    # the env's dtype)
    tenv = get_env(task, device="cpu", dtype="float64")
    # the same config fields, each with the JAX task's value
    assert set(tc) == set(jc)
    assert tc == jc
    assert tc["dtype"] == "float32" and tc["fused"] == "auto"
    assert (tenv.action_size, tenv.observation_size, tenv.dt) == (
        jenv.action_size, jenv.observation_size, jenv.dt)
    assert (tenv.model.nq, tenv.model.nv, tenv.model.nu) == (
        jenv.model.nq, jenv.model.nv, jenv.model.nu)
    for name in ("joint_range", "physical_joint_range", "joint_torque_range"):
        np.testing.assert_array_equal(getattr(tenv, name).numpy(), getattr(jenv, name),
                                      err_msg=name)
    if task.startswith("go2"):  # the termination box: the action table unless "physical"
        want = jenv.termination_joint_range
        np.testing.assert_array_equal(tenv.termination_joint_range.numpy(),
                                      jenv.joint_range if want is None else want)
    # every task builds on the physics pipeline too (the JAX package's XLA path)
    off = get_env(task, device="cpu", fused="off")
    assert not off.on_fused_path and get_env(task, device="cpu").on_fused_path


def test_register_env_and_the_default_planner_warning():
    """A task registered with planner defaults carries them; one
    registered without gets the quadruped baseline with a warning."""
    try:
        register_env("_test_biped", dial=dict(Hsample=40, Hnode=10))(
            lambda device="cuda", **kw: ("biped", device, kw))
        assert dial_defaults("_test_biped") == dict(Hsample=40, Hnode=10)
        assert get_env("_test_biped", device="cpu", gait="walk") == (
            "biped", "cpu", dict(gait="walk"))
        register_env("_test_nodefaults")(lambda device="cuda", **kw: None)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            d = dial_defaults("_test_nodefaults")
        assert (d["Hsample"], d["Hnode"]) == (20, 5) and len(w) == 1
        with pytest.raises(KeyError):
            dial_defaults("_no_such_task")
    finally:
        for name in ("_test_biped", "_test_nodefaults"):
            registry._REGISTRY.pop(name, None)
            registry._DIAL_DEFAULTS.pop(name, None)
