"""Compile the Go2 stand-in scene into the .npz model file the torch port loads.

The port reads models with numpy alone (no mujoco at run time), so the scene
is compiled here, once, by the JAX package's own `compile_model` and written
with its `save_model`:

    PYTHONPATH=. python tests/assets/export_go2_npz.py

writes `tpu_dialmpc_torch/assets/go2_force.npz`.  `tests/test_torch_model.py`
checks that the committed file equals a fresh compile of the scene.
"""

from __future__ import annotations

from pathlib import Path

ASSETS = Path(__file__).resolve().parent
OUT = ASSETS.parent.parent / "tpu_dialmpc_torch" / "assets" / "go2_force.npz"
TIMESTEP = 0.0025  # the go2 env's default timestep (envs/go2.py config)


def compile_standin():
    """The stand-in scene compiled exactly as `UnitreeGo2Env.__init__` does."""
    from tpu_dialmpc.dynamics import assets
    from tpu_dialmpc.dynamics.model import compile_model

    mj = assets.load_mj_model(str(ASSETS / assets.SCENES["go2_force"]))
    mj.opt.timestep = TIMESTEP
    return compile_model(mj).with_options(timestep=TIMESTEP)


def main():
    from tpu_dialmpc.dynamics.model import save_model

    OUT.parent.mkdir(parents=True, exist_ok=True)
    save_model(compile_standin(), str(OUT))
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
