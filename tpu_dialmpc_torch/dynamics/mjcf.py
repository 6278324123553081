"""MJCF read with numpy and `xml.etree`: the port's stand-in for mujoco's
`MjModel.from_xml_path` and `mj_setConst`, so the port compiles a scene with
no mujoco (the card's machine has none).

`load(path)` returns an `MjcfModel`: a host record of numpy arrays under
MjModel's own field names (`body_parentid`, `body_weldid`, `geom_contype`,
`geom_solmix`, `actuator_trnid`, `opt.timestep`, `stat.meaninertia`, ...),
the fields `dynamics/model.py:compile_model` reads, computed as mujoco 3.10's
compiler computes them.  What it reads:

- structure: `<include file>` (relative to the including file), `<default>`
  classes, nested, with `class` and `childclass`; `<compiler angle
  autolimits eulerseq inertiafromgeom inertiagrouprange>`;
- frames: `pos`, `quat` (normalised), `euler`, `axisangle`, `xyaxes`,
  `zaxis`, and `fromto` on capsule, cylinder, box and ellipsoid geoms and
  sites;
- bodies in mujoco's order (depth first, pre-order), `mocap`, `<freejoint>`
  (no defaults, as in mujoco) and `<joint type=free|ball|slide|hinge>` with
  `range limited armature damping frictionloss ref margin solreflimit
  solimplimit solreffriction solimpfriction`;
- inertia from `<inertial pos quat mass diaginertia|fullinertia>`, else from
  the body's primitive geoms (`mass` or `density`);
- every geom, visual mesh geoms included, so geom ids agree with mujoco's
  (a mesh file is never read); geom `contype conaffinity condim priority
  solmix solref solimp friction margin gap`; `<site>`;
- `<motor>`, `<position kp kv timeconst>`, `<velocity kv>` and `<general>`,
  through the default classes as mujoco layers them;
- `<keyframe><key name qpos>` and `<size nkey>`; `<option timestep gravity iterations
  ls_iterations tolerance ls_tolerance impratio>` with `<flag>`;
  `<statistic meaninertia>`; `<tendon>` and `<equality>` are counted
  (`ntendon`, `neq`), which `compile_model` rejects.

Skipped, as reaching no PhysicsModel field: `light`, `camera`, `asset`,
`visual`, `sensor`, `custom`, the rest of `size`, `contact` (the JAX compiler ignores
`<exclude>` and `<pair>`, and so does the port), the rest of `statistic`,
and attributes the compiled model keeps but `compile_model` never reads
(`rgba`, `group` outside inertia, `stiffness`, ...).  Raised on, where mujoco
compiles something this reader cannot reproduce: `<frame>` and other body
children it does not know, a mesh, height field or SDF geom whose inertia
the body needs, actuator kinds other than the four above, `dampratio` and
`inheritrange`, and the compiler's `boundmass`, `boundinertia`,
`balanceinertia`, `settotalmass`, `fusestatic`, `discardvisual` and
`alignfree`.

`mj_setConst`'s part is `set_const`: `qpos0` comes from the joints, and
`dof_invweight0`, `body_invweight0` and `stat.meaninertia` at `qpos0` from
the port's own `kinematics` and `crb_mass_matrix` in float64 on the CPU.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from pathlib import Path
from types import SimpleNamespace

import numpy as np

MINVAL = 1e-15  # mjMINVAL
EIG_EPS = 1e-12  # mjuu_eig3's tolerance

GEOM_TYPES = {"plane": 0, "hfield": 1, "sphere": 2, "capsule": 3, "ellipsoid": 4,
              "cylinder": 5, "box": 6, "mesh": 7, "sdf": 8}
JOINT_TYPES = {"free": 0, "ball": 1, "slide": 2, "hinge": 3}
JNT_FREE, JNT_BALL, JNT_SLIDE, JNT_HINGE = 0, 1, 2, 3
JOINT_NQ = {JNT_FREE: 7, JNT_BALL: 4, JNT_SLIDE: 1, JNT_HINGE: 1}
JOINT_NV = {JNT_FREE: 6, JNT_BALL: 3, JNT_SLIDE: 1, JNT_HINGE: 1}

# mjtTrn, mjtDyn, mjtGain, mjtBias
TRN_JOINT, TRN_JOINTINPARENT, TRN_SLIDERCRANK, TRN_TENDON, TRN_SITE, TRN_BODY = range(6)
DYN_TYPES = {"none": 0, "integrator": 1, "filter": 2, "filterexact": 3, "muscle": 4, "user": 6}
GAIN_TYPES = {"fixed": 0, "affine": 1, "muscle": 2, "user": 4}
BIAS_TYPES = {"none": 0, "affine": 1, "muscle": 2, "user": 4}
DYN_NONE, DYN_FILTEREXACT = 0, 3
GAIN_FIXED = 0
BIAS_NONE, BIAS_AFFINE = 0, 1

# mjtDisableBit, by the <flag> attribute that sets it
DISABLE_BITS = {"constraint": 1, "equality": 2, "frictionloss": 4, "limit": 8, "contact": 16,
                "spring": 32, "damper": 64, "gravity": 128, "clampctrl": 256,
                "warmstart": 512, "filterparent": 1024, "actuation": 2048, "refsafe": 4096,
                "sensor": 8192, "midphase": 16384, "eulerdamp": 32768, "autoreset": 65536,
                "nativeccd": 131072, "island": 262144, "multiccd": 524288}
DSBL_FILTERPARENT = DISABLE_BITS["filterparent"]
DSBL_EULERDAMP = DISABLE_BITS["eulerdamp"]

SOLREF = (0.02, 1.0)
SOLIMP = (0.9, 0.95, 0.001, 0.5, 2.0)
# built-in defaults (mujoco's mjs_default*)
JOINT_DEFAULTS = dict(pos=(0, 0, 0), axis=(0, 0, 1), range=(0, 0), ref=(0,), armature=(0,),
                      damping=(0,), frictionloss=(0,), margin=(0,), solreflimit=SOLREF,
                      solimplimit=SOLIMP, solreffriction=SOLREF, solimpfriction=SOLIMP)
GEOM_DEFAULTS = dict(size=(0, 0, 0), pos=(0, 0, 0), contype=(1,), conaffinity=(1,), condim=(3,),
                     group=(0,), priority=(0,), friction=(1, 0.005, 0.0001), solmix=(1,),
                     solref=SOLREF, solimp=SOLIMP, margin=(0,), gap=(0,), density=(1000,))
SITE_DEFAULTS = dict(pos=(0, 0, 0), size=(0.005, 0.005, 0.005))

ORIENTATIONS = ("quat", "axisangle", "euler", "xyaxes", "zaxis")
ACTUATOR_TAGS = ("general", "motor", "position", "velocity")
# body children and sections that reach no PhysicsModel field
SKIPPED_BODY_CHILDREN = {"light", "camera"}
SKIPPED_SECTIONS = {"asset", "visual", "sensor", "custom", "contact"}
UNSUPPORTED_COMPILER = ("boundmass", "boundinertia", "balanceinertia", "settotalmass")


class MjcfModel(SimpleNamespace):
    """The compiled MJCF as MjModel's fields (numpy arrays, float64 and
    int32), plus the names of bodies, joints, sites and keys in
    `<kind>_names` ("" where unnamed)."""


# ---------------------------------------------------------------------------
# mujoco's frame arithmetic (user_util.cc), in its operation order


def _normvec(v):
    """(v / |v|, |v|); a vector shorter than mjMINVAL is left as it is."""
    v = np.asarray(v, np.float64)
    n = math.sqrt(float(np.sum(v * v)))
    return (v, 0.0) if n < MINVAL else (v / n, n)


def _mulquat(a, b):
    return np.array([
        a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3],
        a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2],
        a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1],
        a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0],
    ])


def _quat2mat(q):
    """Row-major 3x3 rotation matrix of a unit quaternion."""
    if q[0] == 1 and q[1] == 0 and q[2] == 0 and q[3] == 0:
        return np.eye(3)
    q00, q01, q02, q03 = q[0] * q[0], q[0] * q[1], q[0] * q[2], q[0] * q[3]
    q11, q12, q13 = q[1] * q[1], q[1] * q[2], q[1] * q[3]
    q22, q23, q33 = q[2] * q[2], q[2] * q[3], q[3] * q[3]
    return np.array([
        [q00 + q11 - q22 - q33, 2 * (q12 - q03), 2 * (q13 + q02)],
        [2 * (q12 + q03), q00 - q11 + q22 - q33, 2 * (q23 - q01)],
        [2 * (q13 - q02), 2 * (q23 + q01), q00 - q11 - q22 + q33],
    ])


def _z2quat(vec):
    """The quaternion that turns (0, 0, 1) into the direction of `vec`."""
    axis = np.array([-vec[1], vec[0], 0.0])  # (0, 0, 1) x vec
    axis, s = _normvec(axis)
    if s < 1e-10:
        axis = np.array([1.0, 0.0, 0.0])
    ang = math.atan2(s, vec[2])
    return np.concatenate([[math.cos(ang / 2)], axis * math.sin(ang / 2)])


def _frame2quat(x, y, z):
    """The quaternion of the frame whose axes are the columns x, y, z."""
    m = (x, y, z)  # m[c][r]
    if m[0][0] + m[1][1] + m[2][2] > 0:
        q0 = 0.5 * math.sqrt(1 + m[0][0] + m[1][1] + m[2][2])
        q = [q0, 0.25 * (m[1][2] - m[2][1]) / q0, 0.25 * (m[2][0] - m[0][2]) / q0,
             0.25 * (m[0][1] - m[1][0]) / q0]
    elif m[0][0] > m[1][1] and m[0][0] > m[2][2]:
        q1 = 0.5 * math.sqrt(1 + m[0][0] - m[1][1] - m[2][2])
        q = [0.25 * (m[1][2] - m[2][1]) / q1, q1, 0.25 * (m[1][0] + m[0][1]) / q1,
             0.25 * (m[2][0] + m[0][2]) / q1]
    elif m[1][1] > m[2][2]:
        q2 = 0.5 * math.sqrt(1 - m[0][0] + m[1][1] - m[2][2])
        q = [0.25 * (m[2][0] - m[0][2]) / q2, 0.25 * (m[1][0] + m[0][1]) / q2, q2,
             0.25 * (m[2][1] + m[1][2]) / q2]
    else:
        q3 = 0.5 * math.sqrt(1 - m[0][0] - m[1][1] + m[2][2])
        q = [0.25 * (m[0][1] - m[1][0]) / q3, 0.25 * (m[2][0] + m[0][2]) / q3,
             0.25 * (m[2][1] + m[1][2]) / q3, q3]
    return _normvec(q)[0]


def _eig3(mat):
    """mujoco's mjuu_eig3: Jacobi rotations kept as a quaternion, then the
    eigenvalues sorted in decreasing order; (eigenvalues, quaternion)."""
    quat = np.array([1.0, 0.0, 0.0, 0.0])
    eigval = np.zeros(3)
    for _ in range(500):
        v = _quat2mat(quat)
        d = v.T @ mat @ v
        eigval = np.array([d[0, 0], d[1, 1], d[2, 2]])
        if abs(d[0, 1]) > abs(d[0, 2]) and abs(d[0, 1]) > abs(d[1, 2]):
            rk, ck, rotk = 0, 1, 2
        elif abs(d[0, 2]) > abs(d[1, 2]):
            rk, ck, rotk = 0, 2, 1
        else:
            rk, ck, rotk = 1, 2, 0
        if abs(d[rk, ck]) < EIG_EPS:
            break
        tau = (d[ck, ck] - d[rk, rk]) / (2 * d[rk, ck])
        if tau >= 0:
            t = 1.0 / (tau + math.sqrt(1 + tau * tau))
        else:
            t = -1.0 / (-tau + math.sqrt(1 + tau * tau))
        c = 1.0 / math.sqrt(1 + t * t)
        if c > 1.0 - EIG_EPS:
            break
        rot = np.zeros(4)
        rot[rotk + 1] = -math.sqrt(0.5 - 0.5 * c) if tau >= 0 else math.sqrt(0.5 - 0.5 * c)
        if rotk == 1:
            rot[rotk + 1] = -rot[rotk + 1]
        rot[0] = math.sqrt(1.0 - rot[rotk + 1] * rot[rotk + 1])
        rot = _normvec(rot)[0]
        quat = _normvec(_mulquat(quat, rot))[0]
    for j in range(3):  # bubble sort, decreasing: places 0, 1, 0
        j1 = j % 2
        if eigval[j1] < eigval[j1 + 1]:
            eigval[j1], eigval[j1 + 1] = eigval[j1 + 1], eigval[j1]
            rot = np.zeros(4)
            rot[0] = 0.707106781186548
            rot[(j1 + 2) % 3 + 1] = rot[0]
            quat = _normvec(_mulquat(quat, rot))[0]
    return eigval, quat


def _full_inertia(full):
    """(iquat, diagonal inertia) of the inertia (xx, yy, zz, xy, xz, yz)."""
    xx, yy, zz, xy, xz, yz = full
    eigval, quat = _eig3(np.array([[xx, xy, xz], [xy, yy, yz], [xz, yz, zz]]))
    if eigval[2] < 1e-14:  # mjEPS
        raise ValueError("inertia must have positive eigenvalues")
    return quat, eigval


def _global_inertia(local, quat):
    """The diagonal inertia `local` in the frame `quat`, as (xx, yy, zz, xy,
    xz, yz) in the parent frame."""
    mat = _quat2mat(quat)
    tmp = mat * np.asarray(local)[None, :]
    return np.array([tmp[0] @ mat[0], tmp[1] @ mat[1], tmp[2] @ mat[2],
                     tmp[0] @ mat[1], tmp[0] @ mat[2], tmp[1] @ mat[2]])


def _offcenter(mass, v):
    """Parallel-axis term of a point mass at offset v, (xx, yy, zz, xy, xz, yz)."""
    return np.array([mass * (v[1] * v[1] + v[2] * v[2]), mass * (v[0] * v[0] + v[2] * v[2]),
                     mass * (v[0] * v[0] + v[1] * v[1]), -mass * v[0] * v[1],
                     -mass * v[0] * v[2], -mass * v[1] * v[2]])


# ---------------------------------------------------------------------------
# attributes, layered: the built-in default, each default class from the
# root down, then the element; a shorter vector overwrites only its leading
# values, as mujoco reads them


def _floats(text):
    return [float(x) for x in text.split()]


def _vec(layers, key, default):
    out = np.array(default, np.float64)
    for a in layers:
        if key in a:
            v = _floats(a[key])
            if len(v) > out.size:
                raise ValueError(f"attribute {key}={a[key]!r}: more than {out.size} values")
            out[: len(v)] = v
    return out


def _last(layers, key, default=None):
    for a in reversed(layers):
        if key in a:
            return a[key]
    return default


def _bool(text, key):
    if text not in ("true", "false"):
        raise ValueError(f"attribute {key}={text!r}: expected true or false")
    return text == "true"


def _limited(layers, key, autolimits, has_range, what):
    """mujoco's limited="auto" resolution (and its error without autolimits)."""
    text = _last(layers, key, "auto")
    if text != "auto":
        return _bool(text, key)
    if has_range and not autolimits:
        raise ValueError(f"{what} has a range but not `{key}`: set the compiler's "
                         f"autolimits=\"true\" or give `{key}`")
    return has_range


class _Compiler:
    def __init__(self):
        self.degree = True
        self.autolimits = True
        self.eulerseq = "xyz"
        self.inertiafromgeom = "auto"
        self.inertiagrouprange = (0, 5)

    def read(self, a):
        for key in UNSUPPORTED_COMPILER:
            if key in a and float(a[key]) != 0.0:
                raise NotImplementedError(f"<compiler {key}> is not read by the port")
        for key in ("fusestatic", "discardvisual", "alignfree"):
            if a.get(key) == "true":
                raise NotImplementedError(f"<compiler {key}=\"true\"> is not read by the port")
        if "angle" in a:
            if a["angle"] not in ("degree", "radian"):
                raise ValueError(f"<compiler angle={a['angle']!r}>")
            self.degree = a["angle"] == "degree"
        if "autolimits" in a:
            self.autolimits = _bool(a["autolimits"], "autolimits")
        if "eulerseq" in a:
            seq = a["eulerseq"]
            if len(seq) != 3 or any(c not in "xyzXYZ" for c in seq):
                raise ValueError(f"<compiler eulerseq={seq!r}>")
            self.eulerseq = seq
        if "inertiafromgeom" in a:
            if a["inertiafromgeom"] not in ("auto", "true", "false"):
                raise ValueError(f"<compiler inertiafromgeom={a['inertiafromgeom']!r}>")
            self.inertiafromgeom = a["inertiafromgeom"]
        if "inertiagrouprange" in a:
            lo, hi = (int(x) for x in a["inertiagrouprange"].split())
            self.inertiagrouprange = (lo, hi)

    def angle(self, x):
        return x / 180.0 * math.pi if self.degree else x

    def quat(self, layers):
        """The frame's quaternion from the last layer with an orientation."""
        for a in reversed(layers):
            given = [k for k in ORIENTATIONS if k in a]
            if len(given) > 1:
                raise ValueError(f"more than one orientation given: {given}")
            if given:
                return self._orientation(given[0], _floats(a[given[0]]))
        return np.array([1.0, 0.0, 0.0, 0.0])

    def _orientation(self, kind, v):
        if kind == "quat":
            q, n = _normvec(v)
            if len(v) != 4 or n < 1e-14:
                raise ValueError(f"quat {v}: expected 4 values, not all 0")
            return q
        if kind == "axisangle":
            axis, n = _normvec(v[:3])
            if n < 1e-14:
                raise ValueError("axisangle: axis too small")
            half = self.angle(v[3]) / 2
            return np.concatenate([[math.cos(half)], math.sin(half) * axis])
        if kind == "xyaxes":
            x, n = _normvec(v[:3])
            if n < 1e-14:
                raise ValueError("xyaxes: x axis too small")
            y = np.asarray(v[3:6], np.float64)
            y = y - x * float(x @ y)
            y, n = _normvec(y)
            if n < 1e-14:
                raise ValueError("xyaxes: y axis too small")
            z, n = _normvec(np.cross(x, y))
            if n < 1e-14:
                raise ValueError("xyaxes: cross(x, y) too small")
            return _frame2quat(x, y, z)
        if kind == "zaxis":
            z, n = _normvec(v)
            if n < 1e-14:
                raise ValueError("zaxis too small")
            return _z2quat(z)
        quat = np.array([1.0, 0.0, 0.0, 0.0])  # euler
        for axis, angle in zip(self.eulerseq, v):
            angle = self.angle(angle)
            rot = np.array([math.cos(angle / 2), 0.0, 0.0, 0.0])
            rot["xyz".index(axis.lower()) + 1] = math.sin(angle / 2)
            # lower case: axes that move with the frame (post-multiply)
            quat = _mulquat(quat, rot) if axis.islower() else _mulquat(rot, quat)
        return quat


def _fromto(layers, kind_type, size, what):
    """(pos, quat, size) of a geom or site given by `fromto`, else None."""
    text = _last(layers, "fromto")
    if text is None:
        return None
    v = _floats(text)
    if len(v) != 6:
        raise ValueError(f"{what}: fromto needs 6 values")
    if kind_type not in (GEOM_TYPES["capsule"], GEOM_TYPES["cylinder"], GEOM_TYPES["box"],
                         GEOM_TYPES["ellipsoid"]):
        raise ValueError(f"{what}: fromto requires a capsule, cylinder, box or ellipsoid")
    a, b = np.array(v[:3]), np.array(v[3:])
    vec = a - b
    if float(vec @ vec) < MINVAL:
        raise ValueError(f"{what}: fromto points too close")
    size = size.copy()
    half = math.sqrt(float(vec @ vec)) / 2
    if kind_type in (GEOM_TYPES["box"], GEOM_TYPES["ellipsoid"]):
        size[1] = size[0]
        size[2] = half
    else:
        size[1] = half
    return (a + b) / 2, _z2quat(vec), size


# ---------------------------------------------------------------------------
# default classes


class _Defaults:
    """Default classes: each class's parent and its elements (tag, attributes)
    in document order."""

    def __init__(self):
        self.parent = {"main": None}
        self.elems = {"main": []}

    def read(self, elem, cls):
        for child in elem:
            if child.tag == "default":
                name = child.get("class")
                if name is None:
                    raise ValueError("a nested <default> needs a class")
                if name not in self.parent:
                    self.parent[name] = cls
                    self.elems[name] = []
                self.read(child, name)
            else:
                self.elems[cls].append((child.tag, dict(child.attrib)))

    def chain(self, cls):
        if cls not in self.parent:
            raise ValueError(f"unknown default class {cls!r}")
        out = []
        while cls is not None:
            out.append(cls)
            cls = self.parent[cls]
        return out[::-1]

    def layers(self, cls, tags):
        """The attributes the classes from the root down to `cls` give to
        elements of the tags `tags`, as (tag, attributes) in order."""
        return [(tag, a) for c in self.chain(cls) for tag, a in self.elems[c] if tag in tags]


# ---------------------------------------------------------------------------
# geoms: volume, mass and inertia (mjCGeom), for inertia from geoms


def _geom_inertia(g, what):
    """(mass, diagonal inertia in the geom frame) of a primitive geom."""
    t, s = g["type"], g["size"]
    if t == GEOM_TYPES["sphere"]:
        vol = 4 * math.pi * s[0] * s[0] * s[0] / 3
    elif t == GEOM_TYPES["capsule"]:
        vol = math.pi * (s[0] * s[0] * 2 * s[1] + 4 * s[0] * s[0] * s[0] / 3)
    elif t == GEOM_TYPES["cylinder"]:
        vol = math.pi * s[0] * s[0] * 2 * s[1]
    elif t == GEOM_TYPES["ellipsoid"]:
        vol = 4 * math.pi * s[0] * s[1] * s[2] / 3
    elif t == GEOM_TYPES["box"]:
        vol = s[0] * s[1] * s[2] * 8
    elif t == GEOM_TYPES["plane"]:
        vol = 0.0
    else:
        raise NotImplementedError(
            f"{what}: the body's inertia would come from a geom of type {t} (mesh, height "
            "field or SDF), whose file the port does not read; give the body an <inertial>")
    mass = g["mass"] if g["mass"] is not None else g["density"] * vol
    if t == GEOM_TYPES["sphere"]:
        i = [2 * mass * s[0] * s[0] / 5] * 3
    elif t == GEOM_TYPES["capsule"]:
        r, h = s[0], 2 * s[1]
        sphere_mass = mass * 4 * r / (4 * r + 3 * h)  # the two hemispheres' share
        cyl_mass = mass - sphere_mass
        i0 = cyl_mass * (3 * r * r + h * h) / 12
        i2 = cyl_mass * r * r / 2
        sphere_i = 2 * sphere_mass * r * r / 5
        i0 += sphere_i + sphere_mass * h * (3 * r + 2 * h) / 8
        i = [i0, i0, i2 + sphere_i]
    elif t == GEOM_TYPES["cylinder"]:
        h = 2 * s[1]
        i0 = mass * (3 * s[0] * s[0] + h * h) / 12
        i = [i0, i0, mass * s[0] * s[0] / 2]
    elif t == GEOM_TYPES["ellipsoid"]:
        i = [mass * (s[1] * s[1] + s[2] * s[2]) / 5, mass * (s[0] * s[0] + s[2] * s[2]) / 5,
             mass * (s[0] * s[0] + s[1] * s[1]) / 5]
    elif t == GEOM_TYPES["box"]:
        i = [mass * (s[1] * s[1] + s[2] * s[2]) / 3, mass * (s[0] * s[0] + s[2] * s[2]) / 3,
             mass * (s[0] * s[0] + s[1] * s[1]) / 3]
    else:
        i = [0.0, 0.0, 0.0]
    return mass, np.array(i)


def _inertia_from_geoms(geoms, what):
    """mjCBody::InertiaFromGeom: (mass, ipos, iquat, inertia)."""
    if len(geoms) == 1:
        mass, inertia = _geom_inertia(geoms[0], what)
        return mass, geoms[0]["pos"].copy(), geoms[0]["quat"].copy(), inertia
    parts = [(g, *_geom_inertia(g, what)) for g in geoms]
    mass = sum(m for _, m, _ in parts)
    if mass < MINVAL:
        raise ValueError(f"{what}: body mass is too small, cannot compute center of mass")
    com = sum(m * g["pos"] for g, m, _ in parts) / mass
    total = np.zeros(6)
    for g, m, inertia in parts:
        total = total + _global_inertia(inertia, g["quat"]) + _offcenter(m, g["pos"] - com)
    iquat, inertia = _full_inertia(total)
    return mass, com, iquat, inertia


# ---------------------------------------------------------------------------
# the reader


def _expand_includes(elem, base: Path, depth=0):
    """Replace every <include file> under `elem` by the children of the
    included file's root, the file resolved relative to the including one."""
    if depth > 32:
        raise ValueError("<include> nested too deep")
    children = []
    for child in list(elem):
        if child.tag == "include":
            path = base / child.get("file", "")
            if not path.is_file():
                raise FileNotFoundError(f"<include file={child.get('file')!r}>: no file {path}")
            root = ET.parse(path).getroot()
            _expand_includes(root, path.parent, depth + 1)
            children.extend(root)
        else:
            _expand_includes(child, base, depth)
            children.append(child)
    elem[:] = children


class _Reader:
    def __init__(self):
        self.compiler = _Compiler()
        self.defaults = _Defaults()
        self.bodies = []  # dicts, in mujoco's body order
        self.joints, self.geoms, self.sites, self.actuators, self.keys = [], [], [], [], []
        self.opt = SimpleNamespace(timestep=0.002, gravity=np.array([0.0, 0.0, -9.81]),
                                   iterations=100, ls_iterations=50, tolerance=1e-8,
                                   ls_tolerance=0.01, impratio=1.0, disableflags=0)
        self.meaninertia = None
        self.ntendon = self.neq = 0

    # -- sections ----------------------------------------------------------
    def read(self, root):
        if root.tag != "mujoco":
            raise ValueError(f"the root element is <{root.tag}>, not <mujoco>")
        sections = {}
        for child in root:
            sections.setdefault(child.tag, []).append(child)
        known = {"compiler", "option", "size", "default", "statistic", "worldbody", "actuator",
                 "keyframe", "tendon", "equality"} | SKIPPED_SECTIONS
        for tag in sections:
            if tag not in known:
                raise NotImplementedError(f"<{tag}> is not read by the port")
        for e in sections.get("compiler", []):
            self.compiler.read(e.attrib)
        for e in sections.get("option", []):
            self._option(e)
        for e in sections.get("default", []):
            if e.get("class", "main") != "main":
                raise ValueError("the top-level <default> is the class 'main'")
            self.defaults.read(e, "main")
        for e in sections.get("statistic", []):
            if "meaninertia" in e.attrib:
                self.meaninertia = float(e.get("meaninertia"))
        self.bodies.append(dict(name="world", parent=-1, pos=np.zeros(3),
                                quat=np.array([1.0, 0.0, 0.0, 0.0]), joints=[], geoms=[],
                                sites=[], inertial=None))
        for e in sections.get("worldbody", []):
            self._children(e, 0, "main")
        for e in sections.get("tendon", []):
            self.ntendon += len(list(e))
        for e in sections.get("equality", []):
            self.neq += len(list(e))
        for e in sections.get("actuator", []):
            for child in e:
                self._actuator(child)
        for e in sections.get("keyframe", []):
            for child in e:
                if child.tag != "key":
                    raise ValueError(f"<keyframe> holds <{child.tag}>")
                qpos = _floats(child.get("qpos")) if "qpos" in child.attrib else None
                self.keys.append((child.get("name", ""), qpos))
        for e in sections.get("size", []):  # <size nkey> adds unnamed keys at qpos0
            self.keys += [("", None)] * max(0, int(e.get("nkey", 0)) - len(self.keys))

    def _option(self, e):
        a = e.attrib
        o = self.opt
        if "timestep" in a:
            o.timestep = float(a["timestep"])
        if "gravity" in a:
            o.gravity = _vec([a], "gravity", o.gravity)
        for key in ("iterations", "ls_iterations"):
            if key in a:
                setattr(o, key, int(a[key]))
        for key in ("tolerance", "ls_tolerance", "impratio"):
            if key in a:
                setattr(o, key, float(a[key]))
        for child in e:
            if child.tag != "flag":
                continue
            for key, value in child.attrib.items():
                if key not in DISABLE_BITS:
                    continue  # enable flags: none reaches the model
                if value == "disable":
                    o.disableflags |= DISABLE_BITS[key]
                elif value == "enable":
                    o.disableflags &= ~DISABLE_BITS[key]
                else:
                    raise ValueError(f"<flag {key}={value!r}>")

    # -- bodies --------------------------------------------------------------
    def _children(self, elem, bid, cls):
        """Read the children of body `bid` (the world's from <worldbody>);
        `cls` is the class its elements take by default."""
        for child in elem:
            tag = child.tag
            if tag == "body":
                self._body(child, bid, cls)
            elif tag == "geom":
                self._geom(child, bid, cls)
            elif tag == "site":
                self._site(child, bid, cls)
            elif tag in ("joint", "freejoint"):
                if bid == 0:
                    raise ValueError("the world body cannot have joints")
                self._joint(child, bid, cls)
            elif tag == "inertial":
                if bid == 0:
                    raise ValueError("the world body cannot have an <inertial>")
                self.bodies[bid]["inertial"] = child.attrib
            elif tag in SKIPPED_BODY_CHILDREN:
                continue
            else:
                raise NotImplementedError(f"<{tag}> in a body is not read by the port")

    def _body(self, e, parent, cls):
        a = e.attrib
        bid = len(self.bodies)
        if "mocap" in a and _bool(a["mocap"], "mocap") and parent != 0:
            raise ValueError(f"mocap body {a.get('name', '')!r} must be a child of the world")
        self.bodies.append(dict(
            name=a.get("name", ""), parent=parent, pos=_vec([a], "pos", (0, 0, 0)),
            quat=self.compiler.quat([a]), joints=[], geoms=[], sites=[], inertial=None))
        self._children(e, bid, a.get("childclass", cls))

    def _layers(self, e, cls, tags):
        return [a for _, a in self.defaults.layers(e.get("class", cls), tags)] + [e.attrib]

    def _joint(self, e, bid, cls):
        if e.tag == "freejoint":
            layers, jtype = [e.attrib], JNT_FREE
        else:
            layers = self._layers(e, cls, ("joint",))
            text = _last(layers, "type", "hinge")
            if text not in JOINT_TYPES:
                raise ValueError(f"joint type {text!r}")
            jtype = JOINT_TYPES[text]
        name = e.get("name", "")
        if jtype == JNT_FREE and self.bodies[bid]["parent"] != 0:
            raise ValueError(f"free joint {name!r} can only be used on top level")
        j = {k: _vec(layers, k, v) for k, v in JOINT_DEFAULTS.items()}
        j.update(name=name, type=jtype, body=bid)
        has_range = not (j["range"][0] == 0 and j["range"][1] == 0)
        j["limited"] = _limited(layers, "limited", self.compiler.autolimits, has_range,
                                f"joint {name!r}")
        if jtype in (JNT_HINGE, JNT_BALL):
            j["range"] = np.array([self.compiler.angle(x) for x in j["range"]])
        if jtype == JNT_HINGE:
            j["ref"] = np.array([self.compiler.angle(j["ref"][0])])
        if j["limited"] and jtype != JNT_FREE and not j["range"][0] < j["range"][1]:
            raise ValueError(f"joint {name!r}: invalid range {j['range']}")
        if jtype == JNT_FREE:
            j["pos"], j["axis"], j["limited"] = np.zeros(3), np.array([0.0, 0.0, 1.0]), False
        else:
            j["axis"], n = _normvec(j["axis"])
            if n < 1e-14:
                raise ValueError(f"joint {name!r}: axis too small")
        self.bodies[bid]["joints"].append(len(self.joints))
        self.joints.append(j)

    def _geom(self, e, bid, cls):
        layers = self._layers(e, cls, ("geom",))
        name = e.get("name", "")
        what = f"geom {name or len(self.geoms)!r}"
        text = _last(layers, "type", "sphere")
        if text not in GEOM_TYPES:
            raise ValueError(f"{what}: type {text!r}")
        gtype = GEOM_TYPES[text]
        g = {k: _vec(layers, k, v) for k, v in GEOM_DEFAULTS.items()}
        mass = _last(layers, "mass")
        ft = _fromto(layers, gtype, g["size"], what)
        if ft is None:
            pos, quat, size = g["pos"], self.compiler.quat(layers), g["size"]
        else:
            pos, quat, size = ft
        g.update(name=name, body=bid, type=gtype, pos=pos, quat=quat, size=size,
                 mass=None if mass is None else float(mass), density=float(g["density"][0]))
        for k in ("contype", "conaffinity", "condim", "group", "priority"):
            g[k] = int(g[k][0])
        for k in ("solmix", "margin", "gap"):
            g[k] = float(g[k][0])
        self.bodies[bid]["geoms"].append(len(self.geoms))
        self.geoms.append(g)

    def _site(self, e, bid, cls):
        layers = self._layers(e, cls, ("site",))
        name = e.get("name", "")
        text = _last(layers, "type", "sphere")
        if text not in GEOM_TYPES:
            raise ValueError(f"site {name!r}: type {text!r}")
        ft = _fromto(layers, GEOM_TYPES[text], _vec(layers, "size", SITE_DEFAULTS["size"]),
                     f"site {name!r}")
        if ft is None:
            pos, quat = _vec(layers, "pos", SITE_DEFAULTS["pos"]), self.compiler.quat(layers)
        else:
            pos, quat, _ = ft
        self.bodies[bid]["sites"].append(len(self.sites))
        self.sites.append(dict(name=name, body=bid, pos=pos, quat=quat))

    # -- actuators -------------------------------------------------------------
    def _actuator(self, e):
        if e.tag not in ACTUATOR_TAGS:
            raise NotImplementedError(f"actuator <{e.tag}> is not read by the port")
        act = dict(gear=np.array([1.0, 0, 0, 0, 0, 0]), ctrlrange=np.zeros(2),
                   forcerange=np.zeros(2), ctrllimited="auto", forcelimited="auto",
                   gainprm=np.eye(1, 10).ravel(), biasprm=np.zeros(10), dyntype=DYN_NONE,
                   gaintype=GAIN_FIXED, biastype=BIAS_NONE)
        for tag, a in self.defaults.layers(e.get("class", "main"), ACTUATOR_TAGS):
            _apply_actuator(act, tag, a)
        _apply_actuator(act, e.tag, e.attrib)
        name = e.get("name", "")
        targets = [k for k in ("joint", "jointinparent", "cranksite", "tendon", "site", "body")
                   if k in e.attrib]
        if len(targets) != 1:
            raise ValueError(f"actuator {name!r} needs exactly one transmission target")
        kind = targets[0]
        act["trntype"] = {"joint": TRN_JOINT, "jointinparent": TRN_JOINTINPARENT,
                          "cranksite": TRN_SLIDERCRANK, "tendon": TRN_TENDON,
                          "site": TRN_SITE, "body": TRN_BODY}[kind]
        act["target"] = (kind, e.get(kind))
        act["name"] = name
        for key, rng in (("ctrllimited", "ctrlrange"), ("forcelimited", "forcerange")):
            has_range = not (act[rng][0] == 0 and act[rng][1] == 0)
            act[key] = _limited([{key: act[key]}], key, self.compiler.autolimits, has_range,
                                f"actuator {name!r}")
            if act[key] and not act[rng][0] < act[rng][1]:
                raise ValueError(f"actuator {name!r}: invalid {rng} {act[rng]}")
        self.actuators.append(act)


def _apply_actuator(act, tag, a):
    """One actuator element's attributes (in a default class or the
    actuator itself) applied to `act`, with its kind's implied parameters
    (mujoco's mjs_setToMotor / Position / Velocity)."""
    for key in ("gear", "ctrlrange", "forcerange"):
        if key in a:
            act[key] = _vec([a], key, act[key])
    for key in ("ctrllimited", "forcelimited"):
        if key in a:
            if a[key] not in ("auto", "true", "false"):
                raise ValueError(f"attribute {key}={a[key]!r}")
            act[key] = a[key]
    if tag == "general":
        for key, table in (("dyntype", DYN_TYPES), ("gaintype", GAIN_TYPES),
                           ("biastype", BIAS_TYPES)):
            if key in a:
                if a[key] not in table:
                    raise NotImplementedError(f"<general {key}={a[key]!r}>")
                act[key] = table[a[key]]
        for key in ("gainprm", "biasprm"):
            if key in a:
                act[key] = _vec([a], key, act[key])
    elif tag == "motor":
        act["gainprm"][0] = 1.0
        act.update(dyntype=DYN_NONE, gaintype=GAIN_FIXED, biastype=BIAS_NONE)
    elif tag == "position":
        for key in ("dampratio", "inheritrange"):
            if key in a:
                raise NotImplementedError(f"<position {key}> is not read by the port")
        kp = float(a.get("kp", act["gainprm"][0]))
        act["gainprm"][0] = kp
        act["biasprm"][1] = -kp
        if "kv" in a:
            kv = float(a["kv"])
            if kv < 0:
                raise ValueError("<position kv> must be non-negative")
            act["biasprm"][2] = -kv
        timeconst = float(a.get("timeconst", 0.0))
        act.update(dyntype=DYN_FILTEREXACT if timeconst > 0 else DYN_NONE,
                   gaintype=GAIN_FIXED, biastype=BIAS_AFFINE)
    else:  # velocity
        kv = float(a.get("kv", act["gainprm"][0]))
        act["gainprm"][0] = kv
        act["biasprm"][:] = 0.0
        act["biasprm"][2] = -kv
        act.update(dyntype=DYN_NONE, gaintype=GAIN_FIXED, biastype=BIAS_AFFINE)


# ---------------------------------------------------------------------------
# the compiled record


def _body_inertia(reader, bid):
    """(mass, ipos, iquat, inertia) of a body, from its <inertial> or its geoms."""
    comp, body = reader.compiler, reader.bodies[bid]
    what = f"body {body['name'] or bid!r}"
    a = body["inertial"]
    if comp.inertiafromgeom == "true" or (comp.inertiafromgeom == "auto" and a is None):
        lo, hi = comp.inertiagrouprange
        sel = [reader.geoms[g] for g in body["geoms"] if lo <= reader.geoms[g]["group"] <= hi]
        if sel:
            return _inertia_from_geoms(sel, what)
    if a is None:
        return 0.0, np.zeros(3), np.array([1.0, 0.0, 0.0, 0.0]), np.zeros(3)
    if "pos" not in a or "mass" not in a:
        raise ValueError(f"{what}: <inertial> needs pos and mass")
    mass, ipos = float(a["mass"]), _vec([a], "pos", (0, 0, 0))
    if "fullinertia" in a:
        if any(k in a for k in ORIENTATIONS):
            raise ValueError(f"{what}: fullinertia and an inertial orientation cannot both "
                             "be given")
        iquat, inertia = _full_inertia(_vec([a], "fullinertia", np.zeros(6)))
    elif "diaginertia" in a:
        iquat, inertia = comp.quat([a]), _vec([a], "diaginertia", (0, 0, 0))
    else:
        raise ValueError(f"{what}: <inertial> needs diaginertia or fullinertia")
    i0, i1, i2 = inertia
    if mass < 0 or min(inertia) < 0 or i0 + i1 < i2 or i0 + i2 < i1 or i1 + i2 < i0:
        raise ValueError(f"{what}: mass and inertia must be positive and satisfy A + B >= C")
    return mass, ipos, iquat, inertia


def _build(reader) -> MjcfModel:
    bodies = reader.bodies
    nbody = len(bodies)
    # per-body lists in mujoco's order: by body, then as written
    jorder = [j for b in bodies for j in b["joints"]]
    gorder = [g for b in bodies for g in b["geoms"]]
    sorder = [s for b in bodies for s in b["sites"]]
    joints = [reader.joints[j] for j in jorder]
    geoms = [reader.geoms[g] for g in gorder]
    sites = [reader.sites[s] for s in sorder]
    jid_of = {old: new for new, old in enumerate(jorder)}

    m = MjcfModel()
    m.nbody, m.njnt, m.ngeom, m.nsite = nbody, len(joints), len(geoms), len(sites)
    m.nu, m.nkey, m.ntendon, m.neq = len(reader.actuators), len(reader.keys), reader.ntendon, \
        reader.neq
    m.opt = SimpleNamespace(**vars(reader.opt))
    m.opt.gravity = np.array(m.opt.gravity, np.float64)

    # bodies
    m.body_parentid = np.array([max(b["parent"], 0) for b in bodies], np.int32)
    m.body_jntnum = np.array([len(b["joints"]) for b in bodies], np.int32)
    m.body_jntadr = np.full(nbody, -1, np.int32)
    for b in range(nbody):
        if bodies[b]["joints"]:
            m.body_jntadr[b] = jid_of[bodies[b]["joints"][0]]
    m.body_weldid = np.zeros(nbody, np.int32)
    m.body_rootid = np.zeros(nbody, np.int32)
    for b in range(1, nbody):
        p = m.body_parentid[b]
        m.body_weldid[b] = b if m.body_jntnum[b] else m.body_weldid[p]
        m.body_rootid[b] = b if p == 0 else m.body_rootid[p]
    m.body_pos = np.array([b["pos"] for b in bodies])
    m.body_quat = np.array([b["quat"] for b in bodies])
    inertial = [(0.0, np.zeros(3), np.array([1.0, 0.0, 0.0, 0.0]), np.zeros(3))]
    inertial += [_body_inertia(reader, b) for b in range(1, nbody)]
    m.body_mass = np.array([x[0] for x in inertial], np.float64)
    m.body_ipos = np.array([x[1] for x in inertial])
    m.body_iquat = np.array([x[2] for x in inertial])
    m.body_inertia = np.array([x[3] for x in inertial])

    # joints and dofs
    types = [j["type"] for j in joints]
    m.jnt_type = np.array(types, np.int32)
    m.jnt_bodyid = np.array([j["body"] for j in joints], np.int32)
    m.jnt_qposadr = np.cumsum([0] + [JOINT_NQ[t] for t in types])[:-1].astype(np.int32)
    m.jnt_dofadr = np.cumsum([0] + [JOINT_NV[t] for t in types])[:-1].astype(np.int32)
    m.nq = int(sum(JOINT_NQ[t] for t in types))
    m.nv = int(sum(JOINT_NV[t] for t in types))
    m.jnt_pos = np.array([j["pos"] for j in joints]).reshape(-1, 3)
    m.jnt_axis = np.array([j["axis"] for j in joints]).reshape(-1, 3)
    m.jnt_range = np.array([j["range"] for j in joints]).reshape(-1, 2)
    m.jnt_limited = np.array([j["limited"] for j in joints], np.uint8)
    m.jnt_solref = np.array([j["solreflimit"] for j in joints]).reshape(-1, 2)
    m.jnt_solimp = np.array([j["solimplimit"] for j in joints]).reshape(-1, 5)
    m.jnt_margin = np.array([j["margin"][0] for j in joints], np.float64)
    qpos0 = []
    for j in joints:
        if j["type"] == JNT_FREE:
            qpos0 += list(bodies[j["body"]]["pos"]) + list(bodies[j["body"]]["quat"])
        elif j["type"] == JNT_BALL:
            qpos0 += [1.0, 0.0, 0.0, 0.0]
        else:
            qpos0.append(j["ref"][0])
    m.qpos0 = np.array(qpos0, np.float64)
    dofs = [(jid, j) for jid, j in enumerate(joints) for _ in range(JOINT_NV[j["type"]])]
    m.dof_bodyid = np.array([j["body"] for _, j in dofs], np.int32)
    m.dof_jntid = np.array([jid for jid, _ in dofs], np.int32)
    for field, key in (("armature", "armature"), ("damping", "damping"),
                       ("frictionloss", "frictionloss")):
        setattr(m, f"dof_{field}", np.array([j[key][0] for _, j in dofs], np.float64))
    m.dof_solref = np.array([j["solreffriction"] for _, j in dofs]).reshape(-1, 2)
    m.dof_solimp = np.array([j["solimpfriction"] for _, j in dofs]).reshape(-1, 5)

    # geoms and sites
    m.geom_bodyid = np.array([g["body"] for g in geoms], np.int32)
    for key in ("type", "contype", "conaffinity", "condim", "priority"):
        setattr(m, f"geom_{key}", np.array([g[key] for g in geoms], np.int32))
    for key in ("solmix", "margin", "gap"):
        setattr(m, f"geom_{key}", np.array([g[key] for g in geoms], np.float64))
    for key, width in (("size", 3), ("pos", 3), ("quat", 4), ("friction", 3), ("solref", 2),
                       ("solimp", 5)):
        setattr(m, f"geom_{key}", np.array([g[key] for g in geoms]).reshape(-1, width))
    m.site_bodyid = np.array([s["body"] for s in sites], np.int32)
    m.site_pos = np.array([s["pos"] for s in sites]).reshape(-1, 3)
    m.site_quat = np.array([s["quat"] for s in sites]).reshape(-1, 4)

    # actuators
    names = {j["name"]: k for k, j in enumerate(joints) if j["name"]}
    acts = reader.actuators
    m.actuator_trntype = np.array([a["trntype"] for a in acts], np.int32)
    m.actuator_trnid = np.full((len(acts), 2), -1, np.int32)
    for i, a in enumerate(acts):
        kind, target = a["target"]
        if kind in ("joint", "jointinparent"):
            if target not in names:
                raise ValueError(f"actuator {a['name']!r}: unknown joint {target!r}")
            m.actuator_trnid[i, 0] = names[target]
    for key in ("dyntype", "gaintype", "biastype"):
        setattr(m, f"actuator_{key}", np.array([a[key] for a in acts], np.int32))
    for key, width in (("gear", 6), ("gainprm", 10), ("biasprm", 10), ("ctrlrange", 2),
                       ("forcerange", 2)):
        setattr(m, f"actuator_{key}", np.array([a[key] for a in acts]).reshape(-1, width))
    m.actuator_ctrllimited = np.array([a["ctrllimited"] for a in acts], np.uint8)
    m.actuator_forcelimited = np.array([a["forcelimited"] for a in acts], np.uint8)

    # keyframes
    m.key_qpos = np.zeros((len(reader.keys), m.nq))
    for k, (name, qpos) in enumerate(reader.keys):
        if qpos is not None and len(qpos) != m.nq:
            raise ValueError(f"key {name!r}: qpos has {len(qpos)} values, nq is {m.nq}")
        m.key_qpos[k] = m.qpos0 if qpos is None else qpos
        for j in range(m.njnt):  # free and ball joints' quaternions, normalised
            if m.jnt_type[j] in (JNT_FREE, JNT_BALL):
                adr = int(m.jnt_qposadr[j]) + (3 if m.jnt_type[j] == JNT_FREE else 0)
                m.key_qpos[k, adr:adr + 4] = _normvec(m.key_qpos[k, adr:adr + 4])[0]

    m.body_names = tuple(b["name"] for b in bodies)
    m.jnt_names = tuple(j["name"] for j in joints)
    m.site_names = tuple(s["name"] for s in sites)
    m.key_names = tuple(name for name, _ in reader.keys)
    m.stat = SimpleNamespace(meaninertia=reader.meaninertia)
    return m


def _sliders_only(m: MjcfModel, b: int, nchild) -> bool:
    """mujoco's body_simple == 2: a childless body on a static parent whose
    inertial frame is its own and whose joints are slides through its origin
    along a coordinate axis."""
    if nchild[b] or m.body_weldid[m.body_parentid[b]] != 0:
        return False
    if np.sum(m.body_ipos[b] ** 2) >= MINVAL or np.sum(m.body_iquat[b, 1:] ** 2) >= MINVAL:
        return False
    joints = np.flatnonzero(m.jnt_bodyid == b)
    return all(m.jnt_type[j] == JNT_SLIDE and np.sum(m.jnt_pos[j] ** 2) < MINVAL
               and np.count_nonzero(m.jnt_axis[j]) == 1 for j in joints)


def set_const(m: MjcfModel) -> None:
    """mj_setConst's fields at qpos0, in place: `dof_invweight0`,
    `body_invweight0` and, unless the MJCF gives it, `stat.meaninertia`.

    M (armature included) comes from the port's `kinematics` and
    `crb_mass_matrix` in float64 on the CPU.  A dof's invweight0 is its
    diagonal entry of M⁻¹, averaged over a free joint's translational and its
    rotational triple; a body's is the mean of the translational and of the
    rotational diagonal of J M⁻¹ Jᵀ, J its Jacobian at its centre of mass,
    0 for bodies welded to the world, and (1 / mass, 0) for mujoco's simple
    bodies on sliders alone (`_sliders_only`); meaninertia is trace(M) / nv."""
    import torch

    from tpu_dialmpc_torch.dynamics import kinematics, smooth
    from tpu_dialmpc_torch.dynamics.model import compile_model

    m.dof_invweight0 = np.zeros(m.nv)
    m.body_invweight0 = np.zeros((m.nbody, 2))
    given = m.stat.meaninertia
    m.stat.meaninertia = 1.0 if given is None else given
    if m.nv == 0:
        return
    model = compile_model(m)  # the structure, with the constants still unset
    qpos = torch.as_tensor(m.qpos0[None], dtype=torch.float64)
    kin = kinematics.kinematics(model, qpos)
    M = smooth.crb_mass_matrix(model, kin)[0].numpy()
    minv = np.linalg.inv(M)
    diag = np.diag(minv)
    for j in range(m.njnt):
        adr = int(m.jnt_dofadr[j])
        if m.jnt_type[j] == JNT_FREE:
            m.dof_invweight0[adr:adr + 3] = np.mean(diag[adr:adr + 3])
            m.dof_invweight0[adr + 3:adr + 6] = np.mean(diag[adr + 3:adr + 6])
        elif m.jnt_type[j] == JNT_BALL:
            m.dof_invweight0[adr:adr + 3] = np.mean(diag[adr:adr + 3])
        else:
            m.dof_invweight0[adr] = diag[adr]
    cdof = kin.cdof[0].numpy()
    xipos, com = kin.xipos[0].numpy(), kin.subtree_com[0].numpy()
    chain = np.asarray(model.body_dof_mask) > 0
    nchild = np.bincount(m.body_parentid[1:], minlength=m.nbody)
    for b in range(1, m.nbody):
        if m.body_weldid[b] == 0:
            continue
        if _sliders_only(m, b, nchild):
            # mujoco's body_simple == 2: 1/mass, no rotation
            m.body_invweight0[b] = [1.0 / max(MINVAL, m.body_mass[b]), 0.0]
            continue
        offset = xipos[b] - com[m.body_rootid[b]]
        jacr = np.where(chain[b][:, None], cdof[:, :3], 0.0)
        jacp = np.where(chain[b][:, None], cdof[:, 3:] + np.cross(cdof[:, :3], offset), 0.0)
        jac = np.concatenate([jacp, jacr], axis=1).T  # (6, nv)
        A = jac @ minv @ jac.T
        m.body_invweight0[b] = [np.trace(A[:3, :3]) / 3, np.trace(A[3:, 3:]) / 3]
    if given is None:
        m.stat.meaninertia = float(np.trace(M) / m.nv)


def load(path) -> MjcfModel:
    """Read the MJCF file at `path` (its includes resolved relative to the
    including file) into the compiled record `compile_model` takes."""
    path = Path(path)
    root = ET.parse(path).getroot()
    _expand_includes(root, path.parent)
    reader = _Reader()
    reader.read(root)
    m = _build(reader)
    set_const(m)
    return m
