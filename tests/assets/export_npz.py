"""Compile the stand-in scenes into the .npz model files the torch port ships.

The port compiles MJCF itself, with no mujoco (`tpu_dialmpc_torch/dynamics/
mjcf.py` and `model.py:compile_model`; `load_scene` does so for a scene name
when `TPU_DIALMPC_ASSETS` is set, and for any `.xml` path).  The shipped
files are a cache of the reference's result: a scene name loads its file
when the variable is unset.  They are compiled here, by the JAX package's own
`compile_model` through mujoco, and written with its `save_model`:

    PYTHONPATH=. python tests/assets/export_npz.py

writes `tpu_dialmpc_torch/assets/<scene>.npz` for every scene in SCENES: the
Go2 flat-ground scene with torque motors and with position servos, the Go2
crate scene (crate at its XML pose), the H1 push-crate, walking and
arms-fixed (loco) scenes, and the pair-kinds scene (the Go2 robot with a
free ball and two free sticks: the sphere-sphere, sphere-capsule and
capsule-capsule kinds).  Each file also carries the joint names (entry
`jnt_names`, "" for an unnamed joint), which `save_model` does not write and
the H1 env reads to size its arm actions.  `tests/test_torch_model.py` and
`tests/test_torch_h1_model.py` check that each committed file equals a fresh
compile of its scene, and `tests/test_torch_mjcf.py` that the port's own
compile equals the JAX one.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

ASSETS = Path(__file__).resolve().parent
OUT_DIR = ASSETS.parent.parent / "tpu_dialmpc_torch" / "assets"
SCENES = ("go2_force", "go2_force_crate", "go2_position", "h1_push_crate", "h1_walk", "h1_loco",
          "go2_pair_kinds")
# scenes of this repository's own, which the JAX package's registry does not name
OWN_SCENES = {"go2_pair_kinds": "pairs/mjx_scene_pair_kinds.xml"}
TIMESTEP = 0.0025  # the envs' default timestep (envs/go2.py, envs/h1.py config)


def out_path(scene: str) -> Path:
    return OUT_DIR / f"{scene}.npz"


def load_standin(scene: str):
    """The stand-in scene's MjModel, at TIMESTEP."""
    from tpu_dialmpc.dynamics import assets

    mj = assets.load_mj_model(str(ASSETS / (OWN_SCENES.get(scene) or assets.SCENES[scene])))
    mj.opt.timestep = TIMESTEP
    return mj


def compile_standin(scene: str = "go2_force"):
    """A stand-in scene compiled exactly as the JAX envs' `__init__` does
    (with no crate option set)."""
    from tpu_dialmpc.dynamics.model import compile_model

    return compile_model(load_standin(scene)).with_options(timestep=TIMESTEP)


def joint_names(mj) -> tuple:
    """Every joint's name in joint order ("" where the MJCF gives none)."""
    import mujoco

    return tuple(mujoco.mj_id2name(mj, mujoco.mjtObj.mjOBJ_JOINT, j) or ""
                 for j in range(mj.njnt))


def export(scene: str) -> Path:
    """save_model's file for the scene, plus its `jnt_names` entry."""
    from tpu_dialmpc.dynamics.model import save_model

    path = out_path(scene)
    save_model(compile_standin(scene), str(path))
    with np.load(path, allow_pickle=False) as data:
        entries = {k: data[k] for k in data.files}
    entries["jnt_names"] = np.array(joint_names(load_standin(scene)), dtype=str)
    np.savez(path, **entries)
    return path


def main():
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for scene in SCENES:
        print(f"wrote {export(scene)}")


if __name__ == "__main__":
    main()
