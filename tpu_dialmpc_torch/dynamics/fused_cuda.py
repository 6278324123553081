"""The fused substep's CUDA kernel (`csrc/fused_step.cu`) and its wrapper.

`FusedStep(model, n_substeps, spec)` is called like the JAX package's
`build_fused_step` function: (qpos (B,nq), qvel (B,nv), ws (B,nv),
ctrl (B,nu)) -> (qpos', qvel', ws', derived (B, ND)).

- On CPU tensors it runs the plain PyTorch version (`fused.py`).
- On CUDA tensors it launches the kernel, or raises: float32, contiguous,
  the model's widths, all on one device.  It never falls back.

The kernel is built from the checkout's sources at the first CUDA call
(`_build.py`), with the model's sizes as compile-time constants; the model's
values are packed here into the kernel's `FusedModel` struct (uploaded to
its `__constant__` memory and to a global copy once), and the index lists
its lanes walk into `FusedTables`.  `launches` counts kernel launches and
nothing else, `waves` the waves they took (`waves`: ceil(B / the samples
the card holds at once)); a CUDA graph that holds launches adds both at
each replay (`planner/capture.py`), and takes back those its capture
counted.

Launch shape: one warp per sample, `samples_per_block` samples per block,
each sample's working set (`Work` in the source) in the block's dynamic
shared memory; `launch_config` sizes both from the model.  A wave holds
what the runtime's occupancy reports (shared memory and registers;
`samples_per_sm` models both).

A build has limits: a sample's `Work` must fit a block's shared memory,
the `FusedModel` copy the 64 KB `__constant__` bank, the byte tables and
term lists their 8- and 16-bit fields, and a lane's rows (32 a round, at
most 32 rounds) its registers.  `kernel_limits(model, spec)`
names each limit a model would break, before anything is built, so the
envs choose their physics when they are built (`envs/fused_rollout.py:
pick_physics`); `launch_config` and `_tables` still raise as the last guard.
Dof masks take (nv + 31) // 32 words (`mask_words`).
"""

from __future__ import annotations

import ctypes
import hashlib
import re
from typing import List, Tuple

import numpy as np
import torch

from tpu_dialmpc_torch.dynamics import _build, fused
from tpu_dialmpc_torch.telemetry import spans
from tpu_dialmpc_torch.dynamics.model import (
    GEOM_BOX,
    GEOM_CAPSULE,
    GEOM_PLANE,
    GEOM_SPHERE,
    PhysicsModel,
)

SOURCE = "fused_step.cu"

# contact slot kinds, as csrc/fused_step.cu numbers them (KIND_*)
KIND_CODES = {
    (GEOM_PLANE, GEOM_SPHERE): 0,
    (GEOM_PLANE, GEOM_CAPSULE): 1,
    (GEOM_PLANE, GEOM_BOX): 2,
    (GEOM_SPHERE, GEOM_BOX): 3,
    (GEOM_CAPSULE, GEOM_BOX): 4,
    (GEOM_BOX, GEOM_BOX): 5,
}


def _imp_params(solref, solimp) -> List[float]:
    """A row's ImpParams (fused.py _impedance and _kb_const, in double)."""
    dmin, dmax, width, mid, power = (float(x) for x in solimp)
    mid = min(max(mid, fused.MJ_MINIMP), fused.MJ_MAXIMP)
    power = max(power, 1.0)
    k, b = fused._kb_const(tuple(float(x) for x in solref), dmax)
    return [
        dmin, dmax - dmin, 1.0 / max(width, fused.MJ_MINVAL), mid, power,
        1.0 / mid ** (power - 1.0), 1.0 / (1.0 - mid) ** (power - 1.0), k, -b,
    ]


def _static_geoms(model: PhysicsModel):
    """Per geom: (static, world pos (3), rotation (9), box corners (8, 3),
    plane frame (9)).  A geom is static where the plain version's forward
    kinematics folds its whole pose into Python constants (a body with no
    dofs in its chain); its corners and plane frame are then constants too,
    computed here by the plain version's own functions, in double."""
    fk = fused._fk(model, [torch.zeros(1, dtype=torch.float64)] * model.nq)
    out = []
    for g in range(model.geom_bodyid.shape[0]):
        p, m = fk["geom_xpos"][g], fk["geom_xmat"][g]
        flat = list(p) + [x for row in m for x in row]
        if not all(fused._isf(x) for x in flat):
            out.append((0, [0.0] * 3, [0.0] * 9, [[0.0] * 3] * 8, [0.0] * 9))
            continue
        corners, frame = [[0.0] * 3] * 8, [0.0] * 9
        if int(model.geom_type[g]) == GEOM_BOX:
            corners = [list(c) for c in fused._box_corners(p, m, model.geom_size[g])]
        if int(model.geom_type[g]) == GEOM_PLANE:
            frame = [x for v in fused._make_frame((m[0][2], m[1][2], m[2][2]), None)
                     for x in v]
        out.append((1, list(p), flat[3:], corners, frame))
    return out


# shared memory: a block may use 227 KB; an SM holds 228 KB, less 1 KB per
# resident block; an SM runs at most 32 blocks and 64 warps; its 64K
# registers lie in 4 sub-partitions of 16K, each giving a warp its registers
# in units of 256 (the H100's limits)
SMEM_PER_BLOCK = 232448
SMEM_PER_SM = 233472
SMEM_RESERVED_PER_BLOCK = 1024
MAX_BLOCKS_PER_SM = 32
MAX_WARPS_PER_SM = 64
REGS_PER_SM = 65536
SUB_PARTITIONS = 4
REG_UNIT = 256
MAX_SAMPLES_PER_BLOCK = 4
# the most registers a thread at which an SM holds 16 warps, 4 in each
# sub-partition: the kernel's launch bound asks ptxas to stay within it
# where the build's shared memory holds that many (FS_MIN_BLOCKS)
BOUND_REGISTERS = 128
# the kernel's other limits: the __constant__ bank holding c_model; the
# term lists' 16-bit row field and 16-bit places in Work.jl; Work's byte
# tables (slots, dofs) and the terms' 8-bit places in a row's dof list; a
# lane's rows, 32 to a round, whose values it keeps in registers
CONSTANT_BYTES = 65536
MAX_ROWS = 1 << 16
MAX_JL = 1 << 16
BYTE_LIMIT = 256
MAX_ROW_ROUNDS = 32


def mask_words(nv: int) -> int:
    """Words per dof mask: the source's FS_NW."""
    return (nv + 31) // 32


def jl_words(defines: dict) -> int:
    """Words of the kernel's Work.jl: per row its Hessian weight, then its
    Jacobian values (one for a friction-loss or limit row)."""
    d = defines
    return 2 * (d["FS_NFL"] + d["FS_NLIM"]) + d["FS_NCROW"] + d["FS_NJ"]


def work_bytes(defines: dict) -> int:
    """Bytes of one sample's working set, the kernel's `struct Work`, in its
    order (4-byte fields, and byte arrays in whole words): its fixed part,
    then three unions, each starting on 16 bytes and taking a multiple of
    16."""
    d = defines
    nq, nv, nu = d["FS_NQ"], d["FS_NV"], d["FS_NU"]
    nb, nj, ng = d["FS_NBODY"], d["FS_NJNT"], d["FS_NGEOM"]
    nrow = max(d["FS_NFL"] + d["FS_NLIM"] + d["FS_NCROW"], 1)
    nw = mask_words(nv)
    tri = nv * (nv + 1) // 2
    words = (
        2 * nv * nw + max(d["FS_NCROW"], 1)  # anc; rinfo
        + (max(d["FS_NSLOT"] * d["FS_MAXD"], 1) + 3) // 4  # sdof, bytes in whole words
        + nq + 2 * nv + nu  # q, v, w, ctrl
        + tri + 2 * nv,  # M; dinv, qsm
        # kin: com, cdof, gpos, gmat | sol: the solver's vectors
        max(3 * nb + 6 * nv + 12 * ng, 12 * nv),
        # H | rw: dc | t1; t2 | sdist
        max(tri, nrow + max(nrow, d["FS_NSLOT"])),
        max(
            # sm: xpos, xquat; xanchor, xaxis; cin, crb; cvel, qfrc_act; the
            # inertial frames, cdof_dot, crbf, cacc, cfrc
            7 * nb + 6 * nj + 20 * nb + 6 * nb + nv + 27 * nb + 12 * nv,
            max(jl_words(d), 1),  # jl
        ),
    )
    return sum(-(-4 * n // 16) * 16 for n in words)


def model_bytes(defines: dict) -> int:
    """Bytes of the kernel's `struct FusedModel`, in its order (4-byte
    fields; arrays sized 0 take one element): what its `__constant__` copy
    takes."""
    d = defines
    nq, nv, nu = d["FS_NQ"], d["FS_NV"], d["FS_NU"]
    nb, nj, ng = d["FS_NBODY"], d["FS_NJNT"], d["FS_NGEOM"]
    nw = mask_words(nv)
    site, s, md = (max(d[k], 1) for k in ("FS_NSITE", "FS_NSLOT", "FS_MAXD"))
    c, lim, fl = (max(d[k], 1) for k in ("FS_NCROW", "FS_NLIM", "FS_NFL"))
    words = (
        9  # dt, tol_scale, iterations, ls_iterations, gravity, torso, torso_root
        + 23 * nb + 10 * nj + nq  # bodies; joints; qpos0
        + 4 * nv + 2 * nv * nw  # dof_body, armature, damping, damp_dt; anc masks
        + 57 * ng + 4 * site + 14 * nu  # geoms and their static poses; sites; actuators
        + 17 * s + s * md + 2 * s * nw  # slots: scalars, ImpParams, dof lists, dof masks
        + 4 * c + 15 * lim + 6 * fl  # contact, limit and friction-loss rows
        + max(nb - 1, 1) + d["FS_NLEVEL"] + 1 + 3 * s + 2 * (nv + 1)  # launch order
    )
    return 4 * words


def limits_of(defines: dict) -> List[str]:
    """Each limit of the kernel that a build with these sizes breaks (an
    empty list: it builds and launches)."""
    d = defines
    out = []
    work = work_bytes(d)
    if work > SMEM_PER_BLOCK:
        out.append(f"one sample's working set (Work) is {work} bytes; a block's shared memory "
                   f"holds {SMEM_PER_BLOCK}")
    const = model_bytes(d)
    if const > CONSTANT_BYTES:
        out.append(f"the model (FusedModel) is {const} bytes; the __constant__ bank holds "
                   f"{CONSTANT_BYTES}")
    for key, what in (("FS_NSLOT", "contact slots"), ("FS_NV", "dofs"),
                      ("FS_MAXD", "dofs in one contact slot")):
        if d[key] >= BYTE_LIMIT:
            out.append(f"{d[key]} {what}; the kernel's byte tables hold fewer than {BYTE_LIMIT}")
    nrow = d["FS_NFL"] + d["FS_NLIM"] + d["FS_NCROW"]
    if nrow > MAX_ROWS:
        out.append(f"{nrow} constraint rows; the kernel's term lists hold at most {MAX_ROWS}")
    if nrow > 32 * MAX_ROW_ROUNDS:
        out.append(f"{nrow} constraint rows; a lane keeps its rows' values in registers, "
                   f"at most {32 * MAX_ROW_ROUNDS} rows")
    if jl_words(d) > MAX_JL:
        out.append(f"the rows' weights and Jacobian values take {jl_words(d)} words; the "
                   f"kernel's term lists place at most {MAX_JL}")
    return out


def kernel_limits(model: PhysicsModel, spec: fused.DerivedSpec, meta=None) -> List[str]:
    """Each limit of the kernel that this model's build would break, read
    from `pack_model`'s sizes before anything is packed or built."""
    return limits_of(kernel_sizes(model, meta if meta is not None else fused._meta(model),
                                  spec)[0])


def samples_per_sm(nbytes: int, spb: int, registers: int = 0) -> int:
    """Samples an SM holds at once, `spb` to a block of `nbytes` each: as
    many blocks as its shared memory takes, at most 32 blocks and 64 warps,
    and, given the build's registers a thread (ptxas' count), as many as
    its register file takes."""
    blocks = min(SMEM_PER_SM // (spb * nbytes + SMEM_RESERVED_PER_BLOCK), MAX_BLOCKS_PER_SM,
                 MAX_WARPS_PER_SM // spb)
    if registers:
        per_warp = -(-registers * 32 // REG_UNIT) * REG_UNIT
        warps = SUB_PARTITIONS * (REGS_PER_SM // SUB_PARTITIONS // per_warp)
        blocks = min(blocks, warps // spb)
    return spb * blocks


def ptxas_usage(log: str) -> dict:
    """The fused kernel's registers a thread, stack frame and spill bytes,
    from ptxas' -v lines in a card build's log (all 0 where the log has
    none: a host build)."""
    found = re.findall(r"Function properties for \S*fused_step_kernel\S*\s+(\d+) bytes stack "
                       r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads.*?Used "
                       r"(\d+) registers", log or "", re.S)
    stack, stores, loads, regs = (int(x) for x in found[-1]) if found else (0, 0, 0, 0)
    return dict(registers=regs, stack_frame=stack, spill_stores=stores, spill_loads=loads)


def launch_config(defines: dict) -> Tuple[int, int]:
    """(bytes per sample, samples per block): the samples per block (up to
    4) that let the most samples share an SM's shared memory, the larger on
    a tie.  Raises if one sample does not fit a block's 227 KB."""
    nbytes = work_bytes(defines)
    if nbytes > SMEM_PER_BLOCK:
        raise ValueError(f"one sample's working set is {nbytes} bytes; a block holds at most "
                         f"{SMEM_PER_BLOCK}")
    fits = [k for k in range(1, MAX_SAMPLES_PER_BLOCK + 1) if k * nbytes <= SMEM_PER_BLOCK]
    return nbytes, max(fits, key=lambda k: (samples_per_sm(nbytes, k), k))


def waves(batch: int, resident: int) -> int:
    """Waves a launch of `batch` samples takes: ceil(batch / resident)."""
    return -(-batch // resident)


def _bits(idx, nw: int) -> List[int]:
    """A dof mask: bit j of the set `idx` is bit j % 32 of word j // 32."""
    out = [0] * nw
    for j in idx:
        out[int(j) >> 5] |= 1 << (int(j) & 31)
    return out


def _tree_levels(model: PhysicsModel):
    """(bodies 1.. ordered by tree depth, offsets of each depth 1.. in it)."""
    depth = [0] * model.nbody
    for b in range(1, model.nbody):
        depth[b] = depth[int(model.body_parentid[b])] + 1
    order = sorted(range(1, model.nbody), key=lambda b: (depth[b], b))
    nlevel = max(depth, default=0)
    off = [sum(1 for b in order if depth[b] <= lv) for lv in range(nlevel + 1)]
    return order, off


def _ldl_pairs(anc, nv):
    """Per k: the pairs (i, j), j <= i, both in row k's pattern."""
    return [[(i, j) for i in sorted(anc[k]) for j in sorted(anc[k]) if j <= i]
            for k in range(nv)]


def _row_dofs(meta, crows):
    """Each constraint row's dof list, in row order: friction loss, limits,
    contacts (a contact row's dofs are its slot's)."""
    slots = meta.contact_slots
    return ([[int(r["dof"])] for r in meta.floss_rows]
            + [[int(r["dadr"])] for r in meta.limit_rows]
            + [list(slots[c[0]]["dofs"]) for c in crows])


def _tables(nv, rows):
    """FusedTables' lists: the Hessian's entries (longest term list first)
    with their rows' terms, and each dof's rows, in row order.  A term
    names its row r (16 bits) and the places k (8 bits each) of its dofs in
    the row's dof list; the kernel finds the row's Jacobian values from r
    (`jl_row`)."""
    if len(rows) > 1 << 16:
        raise ValueError(f"{len(rows)} rows: the kernel's term lists hold at most 65536")
    h = {(i, j): [] for i in range(nv) for j in range(i + 1)}
    g = [[] for _ in range(nv)]
    for r, dofs in enumerate(rows):
        if list(dofs) != sorted(dofs):
            raise ValueError(f"row {r}: the kernel takes a row's dofs in ascending order")
        for ki, i in enumerate(dofs):
            g[i].append(r | ki << 16)
            for kj in range(ki + 1):
                h[(i, dofs[kj])].append(r | ki << 16 | kj << 24)
    ents = sorted(h, key=lambda e: -len(h[e]))  # stable: ties in entry order
    return ents, [h[e] for e in ents], g


def _encode(hterms, gterms, rows):
    """The term lists as the kernel reads them, from `_tables`' row terms
    and each row's dof list (in row order: friction loss, limits,
    contacts): a Hessian term names the place in Work.jl of its row's
    first Jacobian value (the row's weight one before it) instead of the
    row; a gradient term the place of its row's value for the dof (16
    bits) and the row (16 bits).  Also each row's first place."""
    start, pos = [], 0
    for dofs in rows:
        start.append(pos + 1)
        pos += 1 + len(dofs)
    if pos > MAX_JL:
        raise ValueError(f"the rows' weights and Jacobian values take {pos} words; the kernel's "
                         f"term lists place at most {MAX_JL}")
    h = [[start[u & 0xFFFF] | (u & ~0xFFFF) for u in x] for x in hterms]
    g = [[(start[u & 0xFFFF] + (u >> 16)) | (u & 0xFFFF) << 16 for u in x] for x in gterms]
    return h, g, start


def _interleave(lists):
    """Term lists of outputs p = 0, 1, ... (lane p % 32 of round p // 32),
    stored round by round with term t of output p at base[p // 32] + t * 32
    + p % 32, so the lanes of a round read one line per step; (base per
    round, the stored words, 0 where a list is shorter than its round's
    longest)."""
    base, words = [], []
    for r0 in range(0, len(lists), 32):
        group = lists[r0:r0 + 32]
        n = max((len(x) for x in group), default=0)
        base.append(len(words))
        block = [0] * (32 * n)
        for lane, x in enumerate(group):
            for t, u in enumerate(x):
                block[t * 32 + lane] = u
        words.extend(block)
    return base, words


def kernel_sizes(model: PhysicsModel, meta, spec: fused.DerivedSpec) -> Tuple[dict, list]:
    """(the build's -D sizes but the tables' lengths, FS_SPB and
    FS_MIN_BLOCKS, the contact rows (slot, t, s * mu, diagApprox) in the
    plain version's row order)."""
    slots, limits, floss = meta.contact_slots, meta.limit_rows, meta.floss_rows
    crows = []
    for si, s in enumerate(slots):
        iw = s["invweight"]
        if s["condim"] == 1:
            crows.append((si, -1, 0.0, iw))
        else:
            for t in range(2):
                mu = s["friction"][t]
                for sgn in (1.0, -1.0):
                    crows.append((si, t, sgn * mu, 2.0 * (iw + mu * mu * iw)))
    defines = dict(
        FS_NQ=model.nq, FS_NV=model.nv, FS_NU=model.nu, FS_NBODY=model.nbody,
        FS_NJNT=model.njnt, FS_NGEOM=int(model.geom_bodyid.shape[0]), FS_NSITE=model.nsite,
        FS_NSLOT=len(slots), FS_NCROW=len(crows), FS_NLIM=len(limits),
        FS_NFL=len(floss), FS_MAXD=max([len(s["dofs"]) for s in slots], default=0),
        FS_ND=fused.derived_size(model, spec),
        FS_IMPLICIT=int(bool(model.eulerdamp) and bool((model.dof_damping != 0).any())),
        FS_WANT_SITES=int(spec.want_sites), FS_WANT_QFRC=int(spec.want_qfrc_actuator),
        FS_NLEVEL=len(_tree_levels(model)[1]) - 1,
        FS_NJ=sum(len(slots[c[0]]["dofs"]) for c in crows),
    )
    return defines, crows


def pack_model(
    model: PhysicsModel, meta, spec: fused.DerivedSpec
) -> Tuple[dict, bytes, bytes]:
    """(the kernel's -D sizes, the FusedModel struct as bytes, the
    FusedTables struct as bytes).

    Fields are written in the structs' order; every field is 4 bytes wide, so
    the layout has no padding.  Arrays sized 0 in the model are padded to one
    element, as the structs' FS_DIM does."""
    nv = model.nv
    nw = mask_words(nv)
    slots, limits, floss = meta.contact_slots, meta.limit_rows, meta.floss_rows
    defines, crows = kernel_sizes(model, meta, spec)
    maxd = defines["FS_MAXD"]
    if any(len([c for c in crows if c[0] == si]) > 4 for si in range(len(slots))):
        raise ValueError("the kernel takes at most 4 rows per contact slot")
    rows = _row_dofs(meta, crows)
    ents, hterms, gterms = _tables(nv, rows)
    hterms, gterms, jl_start = _encode(hterms, gterms, rows)
    pairs = [_ldl_pairs(anc, nv) for anc in (meta.anc_strict, meta.anc_solver)]
    h_base, h_words = _interleave(hterms)
    g_base, g_words = _interleave(gterms)
    body_order, level_off = _tree_levels(model)
    nb = model.nbody
    sub_mass = [float(x) for x in model.body_mass]
    for b in range(nb - 1, 0, -1):
        sub_mass[int(model.body_parentid[b])] += sub_mass[b]
    torso = spec.torso_body
    defines.update(
        FS_NLDLPAIR=sum(len(p) for pk in pairs for p in pk),
        FS_NHTERM=len(h_words), FS_NGTERM=len(g_words),
    )
    nbytes, defines["FS_SPB"] = launch_config(defines)
    # the launch bound's blocks an SM: as many as it holds at BOUND_REGISTERS
    defines["FS_MIN_BLOCKS"] = (samples_per_sm(nbytes, defines["FS_SPB"], BOUND_REGISTERS)
                                // defines["FS_SPB"])

    parts: List[np.ndarray] = []

    def put(values, dtype, n=None, width=1):
        a = np.asarray(values, dtype=np.float64 if dtype == "f" else np.int64)
        a = a.reshape(-1, width) if width > 1 else a.reshape(-1)
        if n is not None and a.shape[0] < max(n, 1):
            pad = np.zeros((max(n, 1) - a.shape[0],) + a.shape[1:], a.dtype)
            a = np.concatenate([a, pad])
        np_dtype = {"f": np.float32, "i": np.int32, "u": np.uint32}[dtype]
        parts.append(a.astype(np_dtype).reshape(-1))

    put([model.timestep, model.tolerance * model.meaninertia * max(1, nv)], "f")
    put([max(1, model.iterations), max(1, model.ls_iterations)], "i")
    put(model.gravity, "f")
    put([torso, int(model.body_rootid[torso])], "i")
    put(model.body_parentid, "i")
    put(model.body_rootid, "i")
    put(model.body_jntadr, "i")
    for f in ("body_pos", "body_quat", "body_ipos", "body_iquat", "body_mass",
              "body_inertia"):
        put(getattr(model, f), "f")
    put(sub_mass, "f")
    put([1.0 / max(m, 1e-12) for m in sub_mass], "f")
    for f in ("jnt_type", "jnt_qposadr", "jnt_dofadr", "jnt_bodyid"):
        put(getattr(model, f), "i")
    put(model.jnt_pos, "f")
    put(model.jnt_axis, "f")
    put(model.qpos0, "f")
    put(model.dof_bodyid, "i")
    put([_bits(a, nw) for a in meta.anc_strict], "u", nv, nw)
    put([_bits(a, nw) for a in meta.anc_solver], "u", nv, nw)
    put(model.dof_armature, "f")
    put(model.dof_damping, "f")
    put([model.timestep * float(d) for d in model.dof_damping], "f")
    put(model.geom_bodyid, "i")
    put(model.geom_pos, "f")
    put(model.geom_quat, "f")
    put(model.geom_size[:, :3], "f")
    static = _static_geoms(model)
    put([g[0] for g in static], "i")
    for k in range(1, 5):
        put([g[k] for g in static], "f")
    put(model.site_bodyid, "i", model.nsite)
    put(model.site_pos, "f", model.nsite, 3)
    put(model.actuator_dofadr, "i")
    put(model.actuator_qposadr, "i")
    put(model.actuator_ctrllimited, "i")
    put(model.actuator_forcelimited, "i")
    put([int(np.any(np.asarray(b) != 0.0)) for b in model.actuator_biasprm], "i")
    put(model.actuator_gainprm, "f")
    put(model.actuator_biasprm, "f")
    put(model.actuator_gear, "f")
    put(model.actuator_ctrlrange, "f")
    put(model.actuator_forcerange, "f")
    ns = len(slots)
    put([KIND_CODES[s["kind"]] for s in slots], "i", ns)
    put([s["sub"] for s in slots], "i", ns)
    for key in ("g1", "g2", "body1", "body2"):
        put([s[key] for s in slots], "i", ns)
    put([len(s["dofs"]) for s in slots], "i", ns)
    put([list(s["dofs"]) + [0] * (maxd - len(s["dofs"])) for s in slots], "i", ns,
        max(maxd, 1))
    for key in ("body1", "body2"):
        put([_bits(np.nonzero(model.body_dof_mask[s[key]] > 0.5)[0], nw) for s in slots],
            "u", ns, nw)
    put([s["includemargin"] for s in slots], "f", ns)
    put([_imp_params(s["solref"], s["solimp"]) for s in slots], "f", ns, 9)
    nc = len(crows)
    put([c[0] for c in crows], "i", nc)
    put([c[1] for c in crows], "i", nc)
    put([c[2] for c in crows], "f", nc)
    put([c[3] for c in crows], "f", nc)
    nl = len(limits)
    put([r["qadr"] for r in limits], "i", nl)
    put([r["dadr"] for r in limits], "i", nl)
    for key in ("sign", "bound", "margin", "invweight"):
        put([r[key] for r in limits], "f", nl)
    put([_imp_params(r["solref"], r["solimp"]) for r in limits], "f", nl, 9)
    # friction-loss rows are fully constant: the plain version folds them
    nf = len(floss)
    fl_D, fl_negb, fl_knee, fl_lin0 = [], [], [], []
    for r in floss:
        _, D = fused._aref_d(r["solref"], r["solimp"], r["invweight"], 0.0, 0.0, 0.0, None)
        knee = r["floss"] * (1.0 / max(D, 1e-30))
        fl_D.append(D)
        fl_negb.append(-fused._kb_const(r["solref"], r["solimp"][1])[1])
        fl_knee.append(knee)
        fl_lin0.append(0.5 * (knee * r["floss"]))
    put([r["dof"] for r in floss], "i", nf)
    put([r["floss"] for r in floss], "f", nf)
    for vals in (fl_D, fl_negb, fl_knee, fl_lin0):
        put(vals, "f", nf)
    # launch order: bodies by depth, slots grouped by kind, slot -> rows
    put(body_order, "i", nb - 1)
    put(level_off, "i")
    put(sorted(range(ns), key=lambda s: (KIND_CODES[slots[s]["kind"]], s)), "i", ns)
    put([next((c for c, row in enumerate(crows) if row[0] == si), 0) for si in range(ns)], "i", ns)
    put([sum(1 for row in crows if row[0] == si) for si in range(ns)], "i", ns)
    off = np.cumsum([0] + [len(p) for pk in pairs for p in pk])  # into both patterns' lists
    put([off[:nv + 1], off[nv:]], "i")
    blob = b"".join(p.tobytes() for p in parts)

    parts = []
    put([i | j << 8 for pk in pairs for p in pk for i, j in p], "i", defines["FS_NLDLPAIR"])
    put([(i * (i + 1) // 2 + j) | i << 16 | j << 24 for i, j in ents], "i")
    put([len(x) for x in hterms], "i")
    put(h_base, "i")
    put(h_words, "u", defines["FS_NHTERM"])
    put([len(x) for x in gterms], "i")
    put(g_base, "i")
    put(g_words, "u", defines["FS_NGTERM"])
    k0 = len(floss) + len(limits)
    put([c[0] | len(rows[k0 + i]) << 8 | jl_start[k0 + i] << 16 for i, c in enumerate(crows)],
        "u", nc)
    return defines, blob, b"".join(p.tobytes() for p in parts)


class _Library:
    """One built kernel library with the model uploaded to its constants."""

    def __init__(self, path):
        lib = ctypes.CDLL(str(path))
        lib.fused_model_nbytes.restype = ctypes.c_size_t
        lib.fused_model_nbytes.argtypes = []
        lib.fused_step_upload.restype = ctypes.c_int
        lib.fused_step_upload.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.fused_tables_nbytes.restype = ctypes.c_size_t
        lib.fused_tables_nbytes.argtypes = []
        lib.fused_tables_upload.restype = ctypes.c_int
        lib.fused_tables_upload.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
        lib.fused_launch_info.restype = ctypes.c_int
        lib.fused_launch_info.argtypes = [ctypes.c_void_p]
        lib.fused_step_launch.restype = ctypes.c_int
        lib.fused_step_launch.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 11
        lib.fused_symbols.restype = ctypes.c_int
        lib.fused_symbols.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "fused_contacts"):  # host builds only
            lib.fused_contacts.restype = ctypes.c_int
            lib.fused_contacts.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2
        self.lib = lib

    def upload(self, blob: bytes, tables: bytes):
        for name, data, nbytes, fn in (
            ("FusedModel", blob, self.lib.fused_model_nbytes, self.lib.fused_step_upload),
            ("FusedTables", tables, self.lib.fused_tables_nbytes, self.lib.fused_tables_upload),
        ):
            n = nbytes()
            if n != len(data):
                raise RuntimeError(
                    f"{name} layout mismatch: kernel struct {n} bytes, packed {len(data)}"
                )
            err = fn(ctypes.create_string_buffer(data, len(data)), len(data))
            if err != 0:
                raise RuntimeError(f"uploading {name} to the kernel failed (error {err})")
        # the global copies' addresses, looked up once: a launch then calls no
        # runtime function but the launch, which a CUDA graph can capture
        out = (ctypes.c_void_p * 2)()
        err = self.lib.fused_symbols(out)
        if err != 0:
            raise RuntimeError(f"fused_symbols failed (error {err})")
        self.symbols = (out[0], out[1])

    def launch_info(self) -> dict:
        """The build's bytes per sample and samples per block, and how many
        blocks an SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor;
        1 in a host build)."""
        out = (ctypes.c_int * 3)()
        err = self.lib.fused_launch_info(out)
        if err != 0:
            raise RuntimeError(f"fused_launch_info failed (error {err})")
        return dict(bytes_per_sample=out[0], samples_per_block=out[1], blocks_per_sm=out[2])

    def launch(self, n_substeps, qpos, qvel, ws, ctrl, outs, stream: int) -> int:
        ptrs = [t.data_ptr() for t in (qpos, qvel, ws, ctrl, *outs)]
        return self.lib.fused_step_launch(qpos.shape[0], n_substeps, *self.symbols, *ptrs,
                                          stream)

    def contacts(self, qpos: torch.Tensor, nslot: int) -> torch.Tensor:
        """Host builds only: every slot's contact geometry at each sample's
        qpos (B, nq) float32 CPU -> (B, nslot, 13) = dist, pos, n, t1, t2."""
        if qpos.device.type != "cpu" or qpos.dtype != torch.float32:
            raise TypeError(f"qpos: expected a float32 CPU tensor, got {qpos.dtype} on {qpos.device}")
        if qpos.dim() != 2 or not qpos.is_contiguous():
            raise ValueError(f"qpos: expected a contiguous (B, nq) tensor, got {tuple(qpos.shape)}")
        out = torch.empty((qpos.shape[0], nslot, 13), dtype=torch.float32)
        err = self.lib.fused_contacts(qpos.shape[0], qpos.shape[1], nslot, qpos.data_ptr(),
                                      out.data_ptr())
        if err != 0:
            raise ValueError(f"the library's model has other widths than nq={qpos.shape[1]}, "
                             f"nslot={nslot}")
        return out


def _compile(model, meta, spec, host=False, out_dir=None):
    """(defines, FusedModel bytes, FusedTables bytes, library path, build
    log, built now): the library for this model, built or found."""
    defines, blob, tables = pack_model(model, meta, spec)
    path, log, built = _build.build(
        SOURCE, defines, key=hashlib.sha256(blob + tables).digest(), host=host, out_dir=out_dir
    )
    return defines, blob, tables, path, log, built


def build_library(model, meta, spec, host=False, out_dir=None):
    """Build (or find) and load the kernel library for this model, with the
    model uploaded; returns (library, build log, built now)."""
    defines, blob, tables, path, log, built = _compile(model, meta, spec, host, out_dir)
    lib = _Library(path)
    lib.upload(blob, tables)
    info = lib.launch_info()
    want = launch_config(defines)
    if (info["bytes_per_sample"], info["samples_per_block"]) != want:
        raise RuntimeError(f"the kernel's Work is {info['bytes_per_sample']} bytes and "
                           f"{info['samples_per_block']} per block; work_bytes/launch_config "
                           f"say {want}")
    return lib, log, built


class FusedStep:
    """The fused substep chain for one model: the kernel on CUDA tensors, the
    plain version on CPU tensors."""

    def __init__(self, model: PhysicsModel, n_substeps: int, spec: fused.DerivedSpec):
        self.model = model
        self.n_substeps = int(n_substeps)
        self.spec = spec
        self.plain = fused.build_fused_step(model, n_substeps, spec)
        self.meta = fused._meta(model)
        self.nd = fused.derived_size(model, spec)
        self.launches = 0
        self.waves = 0
        self.build_log = None  # nvcc's output, after the first CUDA call
        self._libs = {}  # device index -> _Library

    def compile(self) -> str:
        """Build this model's kernel library without loading it (a build
        already in `build/kernels/` is reused) and return nvcc's log; the
        first CUDA call then only loads it.  Each build is its own nvcc
        process, so several models' builds can run in parallel threads."""
        return _compile(self.model, self.meta, self.spec)[4]

    def library(self, device: torch.device) -> _Library:
        """The kernel for `device`, built and uploaded at first use (the
        span `setup/kernel`, `telemetry/spans.py`), with the samples one of
        its waves holds on that card (`resident`: the blocks an SM holds at
        once, as the runtime's occupancy reports them, times the samples a
        block takes, on every SM)."""
        idx = device.index if device.index is not None else torch.cuda.current_device()
        if idx not in self._libs:
            with spans.span("setup/kernel"), torch.cuda.device(idx):
                lib, self.build_log, _ = build_library(self.model, self.meta, self.spec)
            with torch.cuda.device(idx):
                info = lib.launch_info()
            lib.resident = (info["blocks_per_sm"] * info["samples_per_block"]
                            * torch.cuda.get_device_properties(idx).multi_processor_count)
            self._libs[idx] = lib
        return self._libs[idx]

    def __call__(self, qpos, qvel, ws, ctrl):
        args = (qpos, qvel, ws, ctrl)
        if all(t.device.type == "cpu" for t in args):
            return self.plain(qpos, qvel, ws, ctrl)
        return self.launch(qpos, qvel, ws, ctrl)

    def launch(self, qpos, qvel, ws, ctrl):
        m = self.model
        device = qpos.device
        B = qpos.shape[0] if qpos.dim() == 2 else -1
        for name, t, width in (("qpos", qpos, m.nq), ("qvel", qvel, m.nv),
                               ("ws", ws, m.nv), ("ctrl", ctrl, m.nu)):
            if t.device != device or device.type != "cuda":
                raise ValueError(f"{name}: expected a CUDA tensor on {device}, got {t.device}")
            if t.dtype != torch.float32:
                raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
            if t.dim() != 2 or t.shape != (B, width):
                raise ValueError(f"{name}: expected shape ({B}, {width}), got {tuple(t.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: expected a contiguous tensor")
        lib = self.library(device)
        outs = (
            torch.empty((B, m.nq), dtype=torch.float32, device=device),
            torch.empty((B, m.nv), dtype=torch.float32, device=device),
            torch.empty((B, m.nv), dtype=torch.float32, device=device),
            torch.empty((B, self.nd), dtype=torch.float32, device=device),
        )
        if B == 0:  # nothing to launch
            return outs
        stream = torch.cuda.current_stream(device).cuda_stream
        with torch.cuda.device(device):
            err = lib.launch(self.n_substeps, qpos, qvel, ws, ctrl, outs, stream)
        if err != 0:
            raise RuntimeError(f"fused_step kernel launch failed: cudaGetLastError() = {err}")
        self.launches += 1
        self.waves += waves(B, lib.resident)
        return outs
