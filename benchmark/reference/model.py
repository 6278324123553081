# Frozen copy of tpu_dialmpc_torch/dynamics/model.py at commit ce76357, imports made relative,
# cut to the model container and the .npz reader.
"""The physics model container: compiled from MJCF, saved to and read from
`.npz`, all without mujoco.

Counterpart of `tpu_dialmpc/dynamics/model.py`: the same `PhysicsModel` and
`CollisionPairs` dataclasses of numpy arrays, the same constants,
`compile_model` (the JAX function line for line, reading the record that
`dynamics/mjcf.py` makes from the MJCF in place of a `mujoco.MjModel`),
`save_model` and `load_model`, which write and read the exact file format of
the JAX package's (plus the port's `jnt_names` entry), and
`from_numpy_fields`, which takes another model's fields in memory.
`load_scene` resolves a scene by name or path as the JAX envs do
(`dynamics/assets.py`).
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Mapping, Tuple

import numpy as np

# geom types we support (mujoco mjtGeom values)
GEOM_PLANE = 0
GEOM_SPHERE = 2
GEOM_CAPSULE = 3
GEOM_BOX = 6

JNT_FREE = 0
JNT_BALL = 1
JNT_SLIDE = 2
JNT_HINGE = 3

# contacts emitted per pair kind (kind key -> slots); mirrors MuJoCo's
# primitive narrowphase contact counts.
PAIR_NCON = {
    (GEOM_PLANE, GEOM_SPHERE): 1,
    (GEOM_PLANE, GEOM_CAPSULE): 2,
    (GEOM_PLANE, GEOM_BOX): 4,
    (GEOM_SPHERE, GEOM_SPHERE): 1,
    (GEOM_SPHERE, GEOM_CAPSULE): 1,
    (GEOM_SPHERE, GEOM_BOX): 1,
    (GEOM_CAPSULE, GEOM_CAPSULE): 1,
    (GEOM_CAPSULE, GEOM_BOX): 2,
    (GEOM_BOX, GEOM_BOX): 8,
}


@dataclasses.dataclass(frozen=True)
class CollisionPairs:
    """Static per-kind collision pair table (all arrays have leading dim npair)."""

    geom1: np.ndarray  # index into PhysicsModel.geom_* arrays
    geom2: np.ndarray
    condim: np.ndarray  # (npair,) int
    friction: np.ndarray  # (npair, 5) slide,slide,spin,roll,roll
    solref: np.ndarray  # (npair, 2)
    solimp: np.ndarray  # (npair, 5)
    margin: np.ndarray  # (npair,)
    gap: np.ndarray  # (npair,)
    invweight: np.ndarray  # (npair,) body_invweight0 sum (translational)
    ncon: int  # contact slots per pair


@dataclasses.dataclass(frozen=True)
class PhysicsModel:
    # ---- sizes ----
    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int
    # ---- options ----
    timestep: float
    gravity: np.ndarray  # (3,)
    iterations: int
    ls_iterations: int
    tolerance: float
    ls_tolerance: float
    impratio: float
    meaninertia: float  # stat.meaninertia — solver termination scale
    eulerdamp: bool  # mj_Euler implicit joint damping (mjDSBL_EULERDAMP off)
    # ---- bodies (topologically ordered: parent index < child index) ----
    body_parentid: np.ndarray
    body_rootid: np.ndarray
    body_jntadr: np.ndarray  # -1 if jointless; at most one joint per body
    body_pos: np.ndarray
    body_quat: np.ndarray
    body_ipos: np.ndarray
    body_iquat: np.ndarray
    body_mass: np.ndarray
    body_inertia: np.ndarray
    body_invweight0: np.ndarray  # (nbody, 2)
    # ---- joints ----
    jnt_type: np.ndarray
    jnt_qposadr: np.ndarray
    jnt_dofadr: np.ndarray
    jnt_bodyid: np.ndarray
    jnt_pos: np.ndarray
    jnt_axis: np.ndarray
    jnt_range: np.ndarray
    jnt_limited: np.ndarray
    jnt_solref: np.ndarray
    jnt_solimp: np.ndarray
    jnt_margin: np.ndarray
    qpos0: np.ndarray
    # ---- dofs ----
    dof_bodyid: np.ndarray
    dof_jntid: np.ndarray
    dof_armature: np.ndarray
    dof_damping: np.ndarray
    dof_invweight0: np.ndarray
    dof_frictionloss: np.ndarray
    dof_solref: np.ndarray  # (nv, 2) — friction-loss constraint solref
    dof_solimp: np.ndarray  # (nv, 5)
    # ---- geoms (collidable subset) ----
    geom_bodyid: np.ndarray
    geom_type: np.ndarray
    geom_pos: np.ndarray
    geom_quat: np.ndarray
    geom_size: np.ndarray
    geom_orig_id: np.ndarray  # index into the source MjModel (for oracle tests)
    # ---- sites ----
    site_bodyid: np.ndarray
    site_pos: np.ndarray
    site_quat: np.ndarray
    site_names: Tuple[str, ...]
    body_names: Tuple[str, ...]
    # ---- actuators (joint-transmission, fixed gain, none/affine bias) ----
    actuator_dofadr: np.ndarray  # (nu,) target dof of each actuator
    actuator_qposadr: np.ndarray  # (nu,) target qpos slot (for affine bias)
    actuator_gear: np.ndarray  # (nu,)
    actuator_gainprm: np.ndarray  # (nu,) fixed gain (1.0 for <motor>)
    actuator_biasprm: np.ndarray  # (nu, 3) affine bias b0 + b1*q + b2*qdot
    actuator_ctrlrange: np.ndarray  # (nu, 2) raw (may be 0,0 = unlimited)
    actuator_ctrllimited: np.ndarray  # (nu,) bool
    actuator_forcerange: np.ndarray
    actuator_forcelimited: np.ndarray
    # ---- keyframes ----
    key_qpos: Dict[str, np.ndarray]
    # ---- static structure masks ----
    ancestor_mask: np.ndarray  # (nv, nv) 1.0 if dof j is ancestor-or-self of dof i
    body_dof_mask: np.ndarray  # (nbody, nv) 1.0 if dof d is in body b's ancestor chain
    # ---- collision pair tables, keyed by (type1, type2) with type1 <= type2 ----
    pairs: Dict[Tuple[int, int], CollisionPairs]
    # ---- the port's own: joint names ("" if unnamed), where the file has them ----
    jnt_names: Tuple[str, ...] = ()

    def with_options(self, **kw) -> "PhysicsModel":
        return dataclasses.replace(self, **kw)

    @property
    def ncon_max(self) -> int:
        return sum(p.geom1.shape[0] * p.ncon for p in self.pairs.values())


def cached(model: PhysicsModel, key, build):
    """`build()`, made once per model and `key` and kept on the model object
    (as the JAX package keeps `_cparams_cache`): the physics stages keep
    their model constants here as tensors on one device, in one dtype, so a
    step makes no host-to-device copy.  A model from `with_options` starts
    with an empty cache."""
    cache = model.__dict__.get("_torch_cache")
    if cache is None:
        cache = {}
        object.__setattr__(model, "_torch_cache", cache)
    if key not in cache:
        cache[key] = build()
    return cache[key]


def load_model(path: str) -> PhysicsModel:
    """Load a PhysicsModel serialized by the JAX package's `save_model`, with
    the joint names of an optional `jnt_names` entry."""
    with np.load(path, allow_pickle=False) as data:
        return _from_npz(data)


def _from_npz(data) -> PhysicsModel:
    meta = json.loads(str(data["meta"]))
    kwargs = dict(meta["scalars"])
    array_fields = {
        f.name
        for f in dataclasses.fields(PhysicsModel)
        if f.name not in kwargs
        and f.name not in ("site_names", "body_names", "key_qpos", "pairs", "jnt_names")
    }
    for name in array_fields:
        kwargs[name] = data[name]
    if "jnt_names" in data.files:
        kwargs["jnt_names"] = tuple(str(x) for x in data["jnt_names"])
    kwargs["site_names"] = tuple(meta["site_names"])
    kwargs["body_names"] = tuple(meta["body_names"])
    kwargs["key_qpos"] = {
        name: data[f"key_{i}"] for i, name in enumerate(meta["key_names"])
    }
    pairs = {}
    for kind_l, ncon in zip(meta["pair_kinds"], meta["pair_ncon"]):
        kind = (int(kind_l[0]), int(kind_l[1]))
        tag = f"pair_{kind[0]}_{kind[1]}"
        pairs[kind] = CollisionPairs(
            geom1=data[f"{tag}_geom1"],
            geom2=data[f"{tag}_geom2"],
            condim=data[f"{tag}_condim"],
            friction=data[f"{tag}_friction"],
            solref=data[f"{tag}_solref"],
            solimp=data[f"{tag}_solimp"],
            margin=data[f"{tag}_margin"],
            gap=data[f"{tag}_gap"],
            invweight=data[f"{tag}_invweight"],
            ncon=int(ncon),
        )
    kwargs["pairs"] = pairs
    return PhysicsModel(**kwargs)
