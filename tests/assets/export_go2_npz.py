"""Compile the Go2 stand-in scenes into the .npz model files the torch port loads.

The port reads models with numpy alone (no mujoco at run time), so the scenes
are compiled here, once, by the JAX package's own `compile_model` and written
with its `save_model`:

    PYTHONPATH=. python tests/assets/export_go2_npz.py

writes `tpu_dialmpc_torch/assets/go2_force.npz` (the flat-ground scene) and
`tpu_dialmpc_torch/assets/go2_force_crate.npz` (the crate scene, crate at its
XML pose).  `tests/test_torch_model.py` checks that each committed file
equals a fresh compile of its scene.
"""

from __future__ import annotations

from pathlib import Path

ASSETS = Path(__file__).resolve().parent
OUT_DIR = ASSETS.parent.parent / "tpu_dialmpc_torch" / "assets"
SCENES = ("go2_force", "go2_force_crate")
TIMESTEP = 0.0025  # the go2 env's default timestep (envs/go2.py config)


def out_path(scene: str) -> Path:
    return OUT_DIR / f"{scene}.npz"


def compile_standin(scene: str = "go2_force"):
    """A stand-in scene compiled exactly as `UnitreeGo2Env.__init__` does
    (with no crate option set)."""
    from tpu_dialmpc.dynamics import assets
    from tpu_dialmpc.dynamics.model import compile_model

    mj = assets.load_mj_model(str(ASSETS / assets.SCENES[scene]))
    mj.opt.timestep = TIMESTEP
    return compile_model(mj).with_options(timestep=TIMESTEP)


def main():
    from tpu_dialmpc.dynamics.model import save_model

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for scene in SCENES:
        save_model(compile_standin(scene), str(out_path(scene)))
        print(f"wrote {out_path(scene)}")


if __name__ == "__main__":
    main()
