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


ASSETS = Path(__file__).resolve().parents[1] / "assets"

# the compiled scenes the port ships (tests/assets/export_npz.py)
SCENES = {
    "go2_force": "go2_force.npz",
    "go2_force_crate": "go2_force_crate.npz",
    "go2_position": "go2_position.npz",
    "h1_push_crate": "h1_push_crate.npz",
    "h1_walk": "h1_walk.npz",
    "h1_loco": "h1_loco.npz",
    # the Go2 robot with a free ball and two free sticks: the sphere-sphere,
    # sphere-capsule and capsule-capsule pair kinds (physics pipeline only)
    "go2_pair_kinds": "go2_pair_kinds.npz",
}


def load_scene(name_or_path: str) -> PhysicsModel:
    """A scene's compiled model, resolved as the JAX envs resolve it
    (`tpu_dialmpc/dynamics/assets.py:55-68`): a path ending in `.npz` is
    loaded; a name in the scene table resolves under `TPU_DIALMPC_ASSETS`
    and is compiled from its MJCF when that variable is set, while with it
    unset a scene the port ships loads its `.npz`; any other name is taken as
    a path to MJCF and compiled."""
    import os

    from tpu_dialmpc_torch.dynamics import assets, mjcf

    name = str(name_or_path)
    if name.endswith(".npz"):
        if not Path(name).is_file():
            raise FileNotFoundError(f"scene {name!r} not found at {name}")
        return load_model(name)
    if name in SCENES and "TPU_DIALMPC_ASSETS" not in os.environ:
        return load_model(str(ASSETS / SCENES[name]))
    path = assets.scene_path(name)
    if not path.exists():
        raise FileNotFoundError(
            f"scene {name!r} not found at {path}; set TPU_DIALMPC_ASSETS"
        )
    return compile_model(mjcf.load(path))


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


def from_numpy_fields(fields: Mapping[str, object]) -> PhysicsModel:
    """Build the port's model from another model's fields as numpy values.

    `fields` maps every `PhysicsModel` field name to its value, as
    `{f.name: getattr(m, f.name) for f in dataclasses.fields(m)}` gives for
    the JAX package's model; `fields["pairs"]` maps each pair kind to an
    object (or mapping) with the `CollisionPairs` fields.  `jnt_names`, which
    the JAX model lacks, may be left out.  Arrays are copied.
    """

    def get(obj, name):
        return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)

    kwargs = {}
    for f in dataclasses.fields(PhysicsModel):
        if f.name == "jnt_names" and f.name not in fields:
            continue
        v = fields[f.name]
        if f.name == "pairs":
            v = {
                (int(kind[0]), int(kind[1])): CollisionPairs(
                    **{
                        pf.name: (
                            int(get(p, pf.name))
                            if pf.name == "ncon"
                            else np.array(get(p, pf.name))
                        )
                        for pf in dataclasses.fields(CollisionPairs)
                    }
                )
                for kind, p in v.items()
            }
        elif f.name == "key_qpos":
            v = {str(k): np.array(x) for k, x in v.items()}
        elif isinstance(v, np.ndarray):
            v = v.copy()
        elif isinstance(v, (tuple, list)):
            v = tuple(v)
        kwargs[f.name] = v
    return PhysicsModel(**kwargs)


def save_model(model: PhysicsModel, path: str) -> None:
    """Serialize a compiled PhysicsModel to .npz in the JAX package's format,
    with the joint names in a `jnt_names` entry where the model has them."""
    flat = {}
    meta = {"scalars": {}, "site_names": list(model.site_names),
            "body_names": list(model.body_names), "key_names": list(model.key_qpos),
            "pair_kinds": [], "pair_ncon": []}
    for f in dataclasses.fields(model):
        v = getattr(model, f.name)
        if isinstance(v, (int, float)):
            meta["scalars"][f.name] = v
        elif isinstance(v, np.ndarray):
            flat[f.name] = v
    for i, name in enumerate(model.key_qpos):
        flat[f"key_{i}"] = model.key_qpos[name]
    for kind in sorted(model.pairs):
        p = model.pairs[kind]
        meta["pair_kinds"].append(list(kind))
        meta["pair_ncon"].append(p.ncon)
        tag = f"pair_{kind[0]}_{kind[1]}"
        for pf in CollisionPairs.__dataclass_fields__:
            if pf == "ncon":
                continue
            flat[f"{tag}_{pf}"] = getattr(p, pf)
    flat["gravity"] = model.gravity
    if model.jnt_names:
        flat["jnt_names"] = np.array(model.jnt_names, dtype=str)
    np.savez(path, meta=json.dumps(meta), **flat)


# ---- compile_model: the JAX package's, reading dynamics/mjcf.py's record ----


def _name(names, i: int):
    """mj_id2name: the object's name, None where it has none."""
    return names[i] or None


def _mix_solref_solimp(m, g1: int, g2: int):
    """Contact parameter combination per MuJoCo's priority/solmix rules."""
    p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
    if p1 > p2:
        return m.geom_solref[g1].copy(), m.geom_solimp[g1].copy()
    if p2 > p1:
        return m.geom_solref[g2].copy(), m.geom_solimp[g2].copy()
    s1, s2 = m.geom_solmix[g1], m.geom_solmix[g2]
    if s1 >= 0.001 and s2 >= 0.001:
        mix = s1 / (s1 + s2)
    elif s1 < 0.001 and s2 < 0.001:
        mix = 0.5
    elif s1 < 0.001:
        mix = 0.0
    else:
        mix = 1.0
    # direct (negative) solref is not mixed: take elementwise min
    if m.geom_solref[g1][0] > 0 and m.geom_solref[g2][0] > 0:
        solref = mix * m.geom_solref[g1] + (1 - mix) * m.geom_solref[g2]
    else:
        solref = np.minimum(m.geom_solref[g1], m.geom_solref[g2])
    solimp = mix * m.geom_solimp[g1] + (1 - mix) * m.geom_solimp[g2]
    return solref, solimp


def _pair_friction(m, g1: int, g2: int) -> np.ndarray:
    p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
    if p1 > p2:
        f = m.geom_friction[g1]
    elif p2 > p1:
        f = m.geom_friction[g2]
    else:
        f = np.maximum(m.geom_friction[g1], m.geom_friction[g2])
    # (slide, slide, spin, roll, roll)
    return np.array([f[0], f[0], f[1], f[2], f[2]])


def _collision_candidates(m):
    """Enumerate geom pairs passing MuJoCo's broadphase-independent filters
    (as the JAX compiler, `<contact>`'s `<exclude>` and `<pair>` are not
    read)."""
    from tpu_dialmpc_torch.dynamics import mjcf

    filterparent = not (m.opt.disableflags & mjcf.DSBL_FILTERPARENT)
    weld = m.body_weldid
    weld_parent = weld[m.body_parentid[weld]]
    out = []
    for g1 in range(m.ngeom):
        for g2 in range(g1 + 1, m.ngeom):
            b1, b2 = m.geom_bodyid[g1], m.geom_bodyid[g2]
            if not (
                (m.geom_contype[g1] & m.geom_conaffinity[g2])
                or (m.geom_contype[g2] & m.geom_conaffinity[g1])
            ):
                continue
            if weld[b1] == weld[b2]:
                continue
            if filterparent and (
                (weld[b1] != 0 and weld_parent[b2] == weld[b1])
                or (weld[b2] != 0 and weld_parent[b1] == weld[b2])
            ):
                continue
            out.append((g1, g2))
    return out


def compile_model(m) -> PhysicsModel:
    """Compile an MJCF record (`dynamics/mjcf.py:load`) into a PhysicsModel
    (host-side, numpy float64), with the JAX compiler's checks and errors."""
    from tpu_dialmpc_torch.dynamics import mjcf

    if m.neq or m.ntendon:
        raise NotImplementedError("equality constraints / tendons not supported")
    # one joint per body at most — true for all Go2/H1 scenes; keeps tree
    # recursions trivially unrollable
    if np.any(m.body_jntnum > 1):
        raise NotImplementedError("bodies with >1 joint not supported")
    if not np.all(np.isin(m.jnt_type, [JNT_FREE, JNT_SLIDE, JNT_HINGE])):
        raise NotImplementedError("only free/slide/hinge joints supported")
    for i in range(m.nu):
        if m.actuator_trntype[i] != mjcf.TRN_JOINT:
            raise NotImplementedError("only joint-transmission actuators supported")
        jid = m.actuator_trnid[i, 0]
        if m.jnt_type[jid] not in (JNT_SLIDE, JNT_HINGE):
            raise NotImplementedError("actuators on free joints not supported")
        if m.actuator_dyntype[i] != mjcf.DYN_NONE:
            raise NotImplementedError("actuator activation dynamics not supported")
        if m.actuator_gaintype[i] != mjcf.GAIN_FIXED:
            raise NotImplementedError("only fixed-gain actuators supported")
        if m.actuator_biastype[i] not in (mjcf.BIAS_NONE, mjcf.BIAS_AFFINE):
            raise NotImplementedError("only none/affine actuator bias supported")

    # collidable geom subset
    candidates = _collision_candidates(m)
    collidable = sorted({g for pair in candidates for g in pair})
    gmap = {g: i for i, g in enumerate(collidable)}
    geom_orig = np.array(collidable, dtype=np.int32)
    for g in collidable:
        if m.geom_type[g] not in (GEOM_PLANE, GEOM_SPHERE, GEOM_CAPSULE, GEOM_BOX):
            raise NotImplementedError(
                f"collidable geom type {m.geom_type[g]} not supported"
            )

    # pair tables grouped by kind
    by_kind: Dict[Tuple[int, int], list] = {}
    for g1, g2 in candidates:
        t1, t2 = m.geom_type[g1], m.geom_type[g2]
        if t2 < t1:
            g1, g2, t1, t2 = g2, g1, t2, t1
        kind = (int(t1), int(t2))
        if kind not in PAIR_NCON:
            raise NotImplementedError(f"collision pair kind {kind} not supported")
        condim = max(m.geom_condim[g1], m.geom_condim[g2])
        p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
        if p1 != p2:
            condim = m.geom_condim[g1] if p1 > p2 else m.geom_condim[g2]
        solref, solimp = _mix_solref_solimp(m, g1, g2)
        friction = _pair_friction(m, g1, g2)
        margin = max(m.geom_margin[g1], m.geom_margin[g2])
        gap = max(m.geom_gap[g1], m.geom_gap[g2])
        b1, b2 = m.geom_bodyid[g1], m.geom_bodyid[g2]
        invweight = m.body_invweight0[b1, 0] + m.body_invweight0[b2, 0]
        by_kind.setdefault(kind, []).append(
            (gmap[g1], gmap[g2], condim, friction, solref, solimp, margin, gap, invweight)
        )

    pairs = {}
    for kind, rows in sorted(by_kind.items()):
        pairs[kind] = CollisionPairs(
            geom1=np.array([r[0] for r in rows], dtype=np.int32),
            geom2=np.array([r[1] for r in rows], dtype=np.int32),
            condim=np.array([r[2] for r in rows], dtype=np.int32),
            friction=np.stack([r[3] for r in rows]),
            solref=np.stack([r[4] for r in rows]),
            solimp=np.stack([r[5] for r in rows]),
            margin=np.array([r[6] for r in rows]),
            gap=np.array([r[7] for r in rows]),
            invweight=np.array([r[8] for r in rows]),
            ncon=PAIR_NCON[kind],
        )

    # ancestor masks
    nv, nbody = m.nv, m.nbody
    body_dof_mask = np.zeros((nbody, nv))
    for b in range(1, nbody):
        node = b
        while node != 0:
            j = m.body_jntadr[node]
            if j >= 0:
                adr = m.jnt_dofadr[j]
                ndof = {JNT_FREE: 6, JNT_BALL: 3, JNT_SLIDE: 1, JNT_HINGE: 1}[
                    int(m.jnt_type[j])
                ]
                body_dof_mask[b, adr : adr + ndof] = 1.0
            node = m.body_parentid[node]
    ancestor_mask = np.zeros((nv, nv))
    for i in range(nv):
        bi = m.dof_bodyid[i]
        ancestor_mask[i] = body_dof_mask[bi]
        # restrict "self joint" dofs to those at-or-before i within the joint
        for j in range(nv):
            if ancestor_mask[i, j] and m.dof_bodyid[j] == bi and j > i:
                ancestor_mask[i, j] = 0.0

    key_qpos = {}
    for k in range(m.nkey):
        name = _name(m.key_names, k) or f"key{k}"
        key_qpos[name] = m.key_qpos[k].copy()

    site_names = tuple(_name(m.site_names, s) or f"site{s}" for s in range(m.nsite))
    body_names = tuple(_name(m.body_names, b) or f"body{b}" for b in range(m.nbody))

    actuator_dofadr = np.array(
        [m.jnt_dofadr[m.actuator_trnid[i, 0]] for i in range(m.nu)], dtype=np.int32
    )
    actuator_qposadr = np.array(
        [m.jnt_qposadr[m.actuator_trnid[i, 0]] for i in range(m.nu)], dtype=np.int32
    )

    return PhysicsModel(
        nq=int(m.nq),
        nv=int(m.nv),
        nu=int(m.nu),
        nbody=int(m.nbody),
        njnt=int(m.njnt),
        ngeom=len(collidable),
        nsite=int(m.nsite),
        timestep=float(m.opt.timestep),
        gravity=m.opt.gravity.copy(),
        iterations=int(m.opt.iterations),
        ls_iterations=int(m.opt.ls_iterations),
        tolerance=float(m.opt.tolerance),
        ls_tolerance=float(m.opt.ls_tolerance),
        impratio=float(m.opt.impratio),
        meaninertia=float(m.stat.meaninertia),
        eulerdamp=not (m.opt.disableflags & mjcf.DSBL_EULERDAMP),
        body_parentid=m.body_parentid.copy(),
        body_rootid=m.body_rootid.copy(),
        body_jntadr=m.body_jntadr.copy(),
        body_pos=m.body_pos.copy(),
        body_quat=m.body_quat.copy(),
        body_ipos=m.body_ipos.copy(),
        body_iquat=m.body_iquat.copy(),
        body_mass=m.body_mass.copy(),
        body_inertia=m.body_inertia.copy(),
        body_invweight0=m.body_invweight0.copy(),
        jnt_type=m.jnt_type.copy(),
        jnt_qposadr=m.jnt_qposadr.copy(),
        jnt_dofadr=m.jnt_dofadr.copy(),
        jnt_bodyid=m.jnt_bodyid.copy(),
        jnt_pos=m.jnt_pos.copy(),
        jnt_axis=m.jnt_axis.copy(),
        jnt_range=m.jnt_range.copy(),
        jnt_limited=m.jnt_limited.copy().astype(bool),
        jnt_solref=m.jnt_solref.copy(),
        jnt_solimp=m.jnt_solimp.copy(),
        jnt_margin=m.jnt_margin.copy(),
        qpos0=m.qpos0.copy(),
        dof_bodyid=m.dof_bodyid.copy(),
        dof_jntid=m.dof_jntid.copy(),
        dof_armature=m.dof_armature.copy(),
        dof_damping=m.dof_damping.copy(),
        dof_invweight0=m.dof_invweight0.copy(),
        dof_frictionloss=m.dof_frictionloss.copy(),
        dof_solref=m.dof_solref.copy(),
        dof_solimp=m.dof_solimp.copy(),
        geom_bodyid=m.geom_bodyid[geom_orig].copy(),
        geom_type=m.geom_type[geom_orig].copy(),
        geom_pos=m.geom_pos[geom_orig].copy(),
        geom_quat=m.geom_quat[geom_orig].copy(),
        geom_size=m.geom_size[geom_orig].copy(),
        geom_orig_id=geom_orig,
        site_bodyid=m.site_bodyid.copy(),
        site_pos=m.site_pos.copy(),
        site_quat=m.site_quat.copy(),
        site_names=site_names,
        body_names=body_names,
        actuator_dofadr=actuator_dofadr,
        actuator_qposadr=actuator_qposadr,
        actuator_gear=m.actuator_gear[:, 0].copy(),
        actuator_gainprm=m.actuator_gainprm[:, 0].copy(),
        actuator_biasprm=m.actuator_biasprm[:, :3].copy(),
        actuator_ctrlrange=m.actuator_ctrlrange.copy(),
        actuator_ctrllimited=m.actuator_ctrllimited.copy().astype(bool),
        actuator_forcerange=m.actuator_forcerange.copy(),
        actuator_forcelimited=m.actuator_forcelimited.copy().astype(bool),
        key_qpos=key_qpos,
        ancestor_mask=ancestor_mask,
        body_dof_mask=body_dof_mask,
        pairs=pairs,
        jnt_names=tuple(m.jnt_names),
    )
