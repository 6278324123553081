"""MJCF scenes on the host, for the tools that need mujoco itself (`render`).

The port simulates compiled model files (`dynamics/model.py`, no mujoco);
drawing a trajectory needs the scene as a mujoco model.  This is the port's
copy of the JAX package's scene table and loader (`tpu_dialmpc/dynamics/
assets.py`), with `host_mj_model(env)`, which stands in for the JAX env's
`mj_model`: the env's scene with the task's crate placement applied.

Scene paths resolve against `TPU_DIALMPC_ASSETS`, else the repository's
stand-in scenes (`tests/assets`), which the port's model files were exported
from.  The Go2 force scene references a visual mesh, `base_4.obj`, that
the published model snapshot lacks; it is visual only (no contacts), so a
degenerate tetrahedron stands in for it at load time.

mujoco is imported inside the functions: the package imports without it.
"""

from __future__ import annotations

import os
from pathlib import Path

_DUMMY_OBJ = (
    b"v 0 0 0\nv 0.001 0 0\nv 0 0.001 0\nv 0 0 0.001\n"
    b"f 1 2 3\nf 1 2 4\nf 1 3 4\nf 2 3 4\n"
)

# Visual meshes known to be absent from the asset snapshot.
_MISSING_ASSETS = {"base_4.obj": _DUMMY_OBJ}

SCENES = {
    "go2_force": "unitree_go2/mjx_scene_force.xml",
    "go2_force_crate": "unitree_go2/mjx_scene_force_crate.xml",
    "go2_position": "unitree_go2/mjx_scene_position.xml",
    "go2_position_collision": "unitree_go2/mjx_scene_position_collision.xml",
    "h1_walk": "unitree_h1/mjx_scene_h1_walk.xml",
    "h1_loco": "unitree_h1/mjx_scene_h1_loco.xml",
    "h1_push_crate": "unitree_h1/mjx_scene_h1_push_crate.xml",
}

STANDINS = Path(__file__).resolve().parents[2] / "tests" / "assets"


def models_root() -> Path:
    return Path(os.environ.get("TPU_DIALMPC_ASSETS", str(STANDINS)))


def scene_path(name: str) -> Path:
    if name in SCENES:
        return models_root() / SCENES[name]
    return Path(name)


def _mujoco():
    # headless GL backend: must precede mujoco's first import
    os.environ.setdefault("MUJOCO_GL", "egl")
    import mujoco

    return mujoco


def load_mj_model(name_or_path: str):
    """Load an MJCF scene by registry name or path, patching missing assets."""
    mujoco = _mujoco()
    path = scene_path(name_or_path)
    if not path.exists():
        raise FileNotFoundError(
            f"scene {name_or_path!r} not found at {path}; set TPU_DIALMPC_ASSETS"
        )
    return mujoco.MjModel.from_xml_path(str(path), dict(_MISSING_ASSETS))


def host_mj_model(env):
    """The env's scene as a mujoco model, with the task's crate placement:
    `crate_x` moves the mocap crate `box_body` in x and `crate_top_z` sinks
    it so its top face sits there, as the env's `_place_crate` patched its
    compiled model (and the crate is made opaque for drawing, as in the JAX
    env's host model)."""
    mujoco = _mujoco()
    cfg = env.config
    m = load_mj_model(cfg.scene)
    if getattr(cfg, "crate_top_z", 0.0) > 0.0 or getattr(cfg, "crate_x", 0.0) != 0.0:
        bid = mujoco.mj_name2id(m, mujoco.mjtObj.mjOBJ_BODY, "box_body")
        if bid < 0:
            raise ValueError(f"crate_top_z/crate_x set but scene {cfg.scene!r} has no 'box_body'")
        gid = int(m.body_geomadr[bid])
        if cfg.crate_x != 0.0:
            m.body_pos[bid, 0] = cfg.crate_x
        if cfg.crate_top_z > 0.0:
            m.body_pos[bid, 2] = cfg.crate_top_z - float(m.geom_size[gid, 2])
            m.geom_rgba[gid, 3] = 1.0
    return m
