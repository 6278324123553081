// fused_step.cu — the physics substep chain of DIAL-MPC's rollouts, as one
// CUDA kernel for Hopper (sm_90a): one warp per sample, the sample's working
// set in shared memory.
//
// Replaces: tpu_dialmpc/dynamics/fused.py:build_fused_step (def at :1440,
// its inner Pallas `kernel` at :1465, the `pallas_call` at :1576), the JAX
// package's only TPU kernel.  The plain PyTorch version of the same
// function is tpu_dialmpc_torch/dynamics/fused.py; the wrapper that builds,
// uploads and launches this file is dynamics/fused_cuda.py.
//
// What it computes, per sample: n_substeps x (forward kinematics, CoM
// frames, CRB mass matrix, RNE bias, actuation, LDL^T smooth acceleration,
// contact rows of the six pair kinds (plane-sphere, plane-capsule,
// plane-box, sphere-box, capsule-box, box-box; condim 1 or 3 pyramidal) +
// joint-limit + friction-loss rows, truncated Newton solve with an exact
// 1-D Newton line search, optional implicit joint damping, semi-implicit
// Euler with quaternion integration), then writes (qpos', qvel',
// warmstart' = the solver's qacc, derived reward inputs).  Geoms on bodies
// without dofs (the floor, a mocap crate) have a constant pose: the host
// packs their pose, a box's corners and a plane's frame, computed by the
// plain version in double and rounded once.  A slot's two bodies may carry
// dofs of two kinematic trees (a robot and a crate on its own slide joint):
// each side's point Jacobian is taken about its own root's subtree CoM
// under its own dof mask, and the Newton Hessian's pattern (anc_solver)
// holds the LDL fill-in; those entries start at 0.
//
// What bounds it: arithmetic.  One substep is 38,881 fp32 ops per sample on
// the flat Go2 scene (4 slots, 52 rows), 183,782 on the Go2 crate scene (52
// slots, 244 rows) and 206,491 on the H1 push-crate scene (44 slots, 234
// rows, nv=26) (fused.py count_ops, which chip_smoke.py's bound uses),
// against 67 TFLOP/s of fp32 outside the tensor cores: 2049 samples x 8
// substeps take at least 9.5, 45.0 and 50.5 us.
// Bytes do not bound it: under 1 KB in and out per sample.  What kept the
// one-thread-per-sample version three orders of magnitude from that bound
// was latency: a 12-37 KB per-thread stack at 255 registers (local memory
// traffic), one warp on half the SMs at B=2049, and a warp running the
// slowest of its 32 samples' Newton iterations.  Nearly all its time went
// to the Newton solve's sums over rows (the cost evaluations, the gradient,
// the Hessian assembly, the line search).
//
// What the design does about it:
// - one warp per sample, FS_SPB samples per block; the sample's working set
//   (struct Work: M, H and its factor, the rows' J and per-row terms, the
//   body quantities) lives in dynamic shared memory, so nothing spills and
//   several samples share an SM;
// - at B=8193 a launch takes ceil(B / the samples the card holds) waves of
//   about one sample's latency each, so Work is kept small: the values of a
//   row that only its own lane reads (aref, D, active, and the solver's x
//   and J.delta) stay in that lane's registers (RowRegs); each contact row's
//   J takes its slot's dof count, its Hessian weight beside it; arrays
//   that a substep's phases never hold live at once share bytes: the smooth
//   dynamics' intermediates (body frames and velocities, inertias, the
//   actuator force) with the rows' J, the kinematics' CoM, motion axes and
//   geom poses with the solver's vectors, and H with the terms of the sums
//   over rows (the slots' distances, J.v, dcost, the line search's terms),
//   which are read only while H is dead; and the reward inputs go straight
//   to global memory;
// - lanes take independent outputs, each with the exact operation sequence
//   of the sequential version (and so of the plain version and the JAX
//   graph): bodies of one tree level, components of a sum up the tree,
//   joints, geoms, contact slots (grouped by kind, so a warp diverges
//   little), rows, dofs, entries of M and H, and within one column step of
//   the LDL^T factor the pairs it updates.  An entry of H sums the rows that
//   hold both its dofs, in row order, from a host-built term list (longest
//   list first, so the warp's rounds are balanced; stored so that a round's
//   32 lanes read one line per step); a dof's gradient likewise;
// - sums over all rows or dofs to a scalar (the costs, the line search's
//   derivatives, d'Md, d'M(a - qsm), |grad|) are not reduced as a tree:
//   every lane adds the terms in row order from shared memory, so the
//   result is the sequential one, bit for bit, and warp-uniform;
// - done, any_active and the iteration count are one sample's, so the warp
//   never waits on another sample's iterations;
// - model values that lanes read alike live in __constant__ memory; tables
//   that lanes index (slots, bodies, the term and LDL pair lists) are read
//   from global memory (a copy of the model, and FusedTables); the few the
//   row and matvec loops read over and over (dof patterns, each contact
//   row's slot and dofs) are copied into the sample's Work once, since the
//   shared memory leaves the SM little L1 and a global read is then an L2
//   round trip;
// - sizes are compile-time (-D FS_*), one build per model; dof masks take
//   (nv + 31) / 32 words (FS_NW), so a build runs any nv < 256, and the
//   limits a model can break (shared memory, the constant bank, the byte
//   tables and term fields, the rows a lane keeps in registers) are
//   checked on the host before it is built (fused_cuda.py kernel_limits);
// - -fmad=false: each product and sum rounds on its own, like the plain
//   version's separate elementwise ops, so the check on the card holds the
//   two equal to the last bit.  FMA contraction is a later, measured change.
//
// What it left: a sample's substep is a few hundred short lane sections
// (the LDL^T column steps, the row passes, the serial sums), each a chain of
// shared-memory round trips, so one warp's latency, not the SM's
// instruction throughput, sets the time of a wave.  How many samples a
// wave holds is set by Work's size (H1 push-crate: 14,224 B, 4 to a block,
// 16 an SM) and by the registers (up to 128 a thread, an SM holds 16 warps;
// above, 12).
// No split of the latency by stage has been measured on this design (the
// card has no ncu).
//
// The same source builds as plain C++ for the host (g++ -x c++): there one
// lane takes every index of a lane section in order, and fused_step_launch
// runs the samples one after another; the CPU tests use that build to check
// this file's arithmetic against the plain version without a card.

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

// Lanes.  On the card a warp computes one sample: FS_FOR(i, n) gives lane
// l the indices l, l+32, ... of a lane-parallel section, and FS_SYNC()
// (__syncwarp) ends the section.  In the host build one "lane" takes every
// index in order and FS_SYNC() is empty, so the g++ build runs the same
// sections one after another.  Within a section no lane reads what another
// lane writes in it; a value every lane needs (a sum over rows, a pivot) is
// computed by every lane alike from shared memory, in the plain order.
#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FS_DEVICE __device__ __forceinline__
#define FS_CONSTANT __constant__
#define FS_GLOBAL __device__
#define FS_LANE ((int)(threadIdx.x & 31u))
#define FS_FOR(i, n) for (int i = FS_LANE; i < (n); i += 32)
#define FS_SYNC() __syncwarp()
#define FS_ANY(p) __any_sync(0xffffffffu, (p))
#else
#define FS_DEVICE static inline
#define FS_CONSTANT static
#define FS_GLOBAL static
#define FS_LANE 0
#define FS_FOR(i, n) for (int i = 0; i < (n); ++i)
#define FS_SYNC() ((void)0)
#define FS_ANY(p) (p)
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
#endif

// ---- sizes, from the model (see fused_cuda.py: pack_model) ----
#if !defined(FS_NQ) || !defined(FS_NV) || !defined(FS_NU) || !defined(FS_NBODY) || \
    !defined(FS_NJNT) || !defined(FS_NGEOM) || !defined(FS_NSITE) ||               \
    !defined(FS_NSLOT) || !defined(FS_NCROW) || !defined(FS_NLIM) ||               \
    !defined(FS_NFL) || !defined(FS_MAXD) || !defined(FS_ND) ||                    \
    !defined(FS_IMPLICIT) || !defined(FS_WANT_SITES) || !defined(FS_WANT_QFRC) ||  \
    !defined(FS_NLEVEL) || !defined(FS_NLDLPAIR) || !defined(FS_NHTERM) ||         \
    !defined(FS_NGTERM) || !defined(FS_SPB) || !defined(FS_NJ)
#error "fused_step.cu needs the FS_* size definitions"
#endif

#define FS_DIM(n) ((n) > 0 ? (n) : 1)
#define FS_NROW (FS_NFL + FS_NLIM + FS_NCROW)
#define FS_TRI(n) ((n) * ((n) + 1) / 2)
#define FS_IDX(i, j) ((i) * ((i) + 1) / 2 + (j))  // lower triangle, j <= i
// Work.jl: per row its Hessian weight hc, then its Jacobian values (one for
// a friction-loss or limit row, its slot's dof count for a contact row;
// FS_NJ in all for the contact rows)
#define FS_NJL (2 * (FS_NFL + FS_NLIM) + FS_NCROW + FS_NJ)
#define FS_R4(n) ((FS_DIM(n) + 3) / 4 * 4)  // a byte array's length, in whole words

// A lane's rows: FS_ROWS(k, r) gives lane l the rows r = l + 32 k, k the
// round, unrolled, so a value of row r that only its lane reads is element
// k of a register array (RowRegs).  In the host build the one lane takes
// every row, k = r.
#ifdef __CUDACC__
#define FS_RR ((FS_NROW + 31) / 32)
#define FS_ROWS(k, r) \
  _Pragma("unroll") for (int k = 0, r = FS_LANE; k < FS_RR; ++k, r += 32) if (r < FS_NROW)
#else
#define FS_RR FS_NROW
#define FS_ROWS(k, r) for (int k = 0, r = 0; r < FS_NROW; ++k, ++r)
#endif

// Dof masks (a pattern row, a body's dofs): bit j is bit j % 32 of word
// j / 32, FS_NW words per mask.  A loop that tests one mask takes it once
// as a DofMask: with one word the word itself, in a register, as before
// masks grew past 32 dofs (so those builds' arithmetic and code are
// unchanged); with more, a pointer to the words where they lie.  dof_bit is
// the one bit test.
#define FS_NW ((FS_NV + 31) / 32)
#if FS_NW == 1
typedef uint32_t DofMask;
FS_DEVICE DofMask dof_mask(const uint32_t* w) { return w[0]; }
FS_DEVICE uint32_t dof_bit(DofMask m, int j) { return (m >> j) & 1u; }
#else
typedef const uint32_t* DofMask;
FS_DEVICE DofMask dof_mask(const uint32_t* w) { return w; }
FS_DEVICE uint32_t dof_bit(DofMask m, int j) { return (m[j >> 5] >> (j & 31)) & 1u; }
#endif


#define JNT_FREE 0
#define JNT_SLIDE 2
#define JNT_HINGE 3

// contact slot kinds (fused_cuda.py KIND_CODES); geom1 is the first geom
// of the kind's name
#define KIND_PLANE_SPHERE 0
#define KIND_PLANE_CAPSULE 1
#define KIND_PLANE_BOX 2
#define KIND_SPHERE_BOX 3
#define KIND_CAPSULE_BOX 4
#define KIND_BOX_BOX 5

// Soft-constraint constants of one row (fused.py _impedance, _kb_const),
// evaluated in double on the host and rounded once, as the plain version's
// Python constants are.
struct ImpParams {
  float dmin, dspan;  // dmin, dmax - dmin
  float inv_width;    // 1 / max(width, MJ_MINVAL)
  float mid, power;   // clamped midpoint, max(power, 1)
  float a, b;         // 1 / mid^(power-1), 1 / (1-mid)^(power-1)
  float k, negb;      // solref stiffness and -damping
};

// The model, as fused_cuda.py packs it: 4-byte fields only, in this order.
struct FusedModel {
  float dt, tol_scale;
  int iterations, ls_iterations;  // max(1, .)
  float gravity[3];
  int torso, torso_root;
  // bodies
  int body_parent[FS_NBODY], body_root[FS_NBODY], body_jnt[FS_NBODY];
  float body_pos[FS_NBODY][3], body_quat[FS_NBODY][4];
  float body_ipos[FS_NBODY][3], body_iquat[FS_NBODY][4];
  float body_mass[FS_NBODY], body_inertia[FS_NBODY][3];
  float subtree_mass[FS_NBODY], subtree_inv_mass[FS_NBODY];
  // joints
  int jnt_type[FS_NJNT], jnt_qadr[FS_NJNT], jnt_dadr[FS_NJNT], jnt_body[FS_NJNT];
  float jnt_pos[FS_NJNT][3], jnt_axis[FS_NJNT][3];
  float qpos0[FS_NQ];
  // dofs; anc bit j of dof i: j is in the pattern row of i (j < i)
  int dof_body[FS_NV];
  uint32_t anc_strict[FS_NV][FS_NW], anc_solver[FS_NV][FS_NW];
  float dof_armature[FS_NV], dof_damping[FS_NV], dof_damp_dt[FS_NV];
  // collidable geoms (size: sphere r; capsule r, half-length; box
  // half-sizes), sites
  int geom_body[FS_NGEOM];
  float geom_pos[FS_NGEOM][3], geom_quat[FS_NGEOM][4], geom_size[FS_NGEOM][3];
  // geoms of constant pose, folded on the host in double: world pose, a
  // box's 8 corners (fused.py _box_corners order), a plane's (n, t1, t2)
  int geom_static[FS_NGEOM];
  float geom_sxpos[FS_NGEOM][3], geom_sxmat[FS_NGEOM][9];
  float geom_scorner[FS_NGEOM][8][3], geom_sframe[FS_NGEOM][9];
  int site_body[FS_DIM(FS_NSITE)];
  float site_pos[FS_DIM(FS_NSITE)][3];
  // actuators
  int act_dof[FS_NU], act_qadr[FS_NU];
  int act_ctrllimited[FS_NU], act_forcelimited[FS_NU], act_hasbias[FS_NU];
  float act_gain[FS_NU], act_bias[FS_NU][3], act_gear[FS_NU];
  float act_ctrlrange[FS_NU][2], act_forcerange[FS_NU][2];
  // contact slots: kind, sub-contact index, geoms, bodies, dof list
  int slot_kind[FS_DIM(FS_NSLOT)], slot_sub[FS_DIM(FS_NSLOT)];
  int slot_g1[FS_DIM(FS_NSLOT)], slot_g2[FS_DIM(FS_NSLOT)];
  int slot_body1[FS_DIM(FS_NSLOT)], slot_body2[FS_DIM(FS_NSLOT)];
  int slot_ndof[FS_DIM(FS_NSLOT)], slot_dof[FS_DIM(FS_NSLOT)][FS_DIM(FS_MAXD)];
  uint32_t slot_body1_dofs[FS_DIM(FS_NSLOT)][FS_NW], slot_body2_dofs[FS_DIM(FS_NSLOT)][FS_NW];
  float slot_margin[FS_DIM(FS_NSLOT)];
  ImpParams slot_imp[FS_DIM(FS_NSLOT)];
  // contact rows, in the plain version's order: per slot, condim 1 -> one
  // normal row; condim 3 -> (t=0, s=+1), (t=0, s=-1), (t=1, +1), (t=1, -1)
  int crow_slot[FS_DIM(FS_NCROW)], crow_t[FS_DIM(FS_NCROW)];  // t = -1: normal
  float crow_coef[FS_DIM(FS_NCROW)];                          // s * mu
  float crow_diag[FS_DIM(FS_NCROW)];                          // diagApprox
  // joint-limit rows
  int lim_qadr[FS_DIM(FS_NLIM)], lim_dadr[FS_DIM(FS_NLIM)];
  float lim_sign[FS_DIM(FS_NLIM)], lim_bound[FS_DIM(FS_NLIM)];
  float lim_margin[FS_DIM(FS_NLIM)], lim_invweight[FS_DIM(FS_NLIM)];
  ImpParams lim_imp[FS_DIM(FS_NLIM)];
  // friction-loss rows (pos = margin = 0: D and the Huber knee are constants)
  int fl_dof[FS_DIM(FS_NFL)];
  float fl_floss[FS_DIM(FS_NFL)], fl_D[FS_DIM(FS_NFL)], fl_negb[FS_DIM(FS_NFL)];
  float fl_knee[FS_DIM(FS_NFL)], fl_lin0[FS_DIM(FS_NFL)];  // 0.5 * knee * floss
  // launch order: bodies 1.. by tree depth (level_off[l] .. level_off[l+1]
  // have depth l+1), slots grouped by kind, each slot's first contact row
  // and row count, the LDL pair lists' offsets per k (0: anc_strict, 1:
  // anc_solver; pairs in FusedTables)
  int body_order[FS_DIM(FS_NBODY - 1)], level_off[FS_NLEVEL + 1];
  int slot_order[FS_DIM(FS_NSLOT)], slot_crow0[FS_DIM(FS_NSLOT)], slot_ncrow[FS_DIM(FS_NSLOT)];
  int ldl_off[2][FS_NV + 1];
};

// Index lists that lanes walk, too large for constant memory; global only.
struct FusedTables {
  // per k of each pattern: the pairs (i, j), j <= i < k, both in row k's
  // pattern: i | j << 8
  int ldl_pair[FS_DIM(FS_NLDLPAIR)];
  // every lower-triangle entry p of the Newton Hessian, longest term list
  // first (idx | i << 16 | j << 24), its list's length, and its rows'
  // terms in row order: j0 | ki << 16 | kj << 24, j0 the place in Work.jl
  // of the row's first Jacobian value (its weight hc sits at j0 - 1), ki
  // and kj the places of dofs i and j in the row's dof list.  Term t of
  // entry p sits at h_base[p / 32] + t * 32 + p % 32: the lanes of a round
  // of 32 entries read one line per step (fused_cuda.py _tables, _encode,
  // _interleave).
  int h_ent[FS_TRI(FS_NV)], h_len[FS_TRI(FS_NV)], h_base[(FS_TRI(FS_NV) + 31) / 32];
  uint32_t h_term[FS_DIM(FS_NHTERM)];
  // per dof d: the rows that hold it, in row order (the place in Work.jl of
  // the row's value for d | row << 16), term t at g_base[d / 32] + t * 32 +
  // d % 32, stored as the Hessian's are
  int g_len[FS_NV], g_base[FS_NW];
  uint32_t g_term[FS_DIM(FS_NGTERM)];
  // per contact row: slot | dof count << 8 | j0 << 16 (Work.rinfo)
  uint32_t crow_info[FS_DIM(FS_NCROW)];
};

// The model twice: in constant memory for values every lane reads alike,
// in global memory for tables lanes index by slot, row, body or dof
// (constant memory serialises a warp's distinct addresses).
FS_CONSTANT FusedModel c_model;
FS_GLOBAL FusedModel g_model;
FS_GLOBAL FusedTables g_tables;

#define MJ_MINVAL 1e-15f
#define MJ_MINIMP 0.0001f
#define MJ_MAXIMP 0.9999f

// max/min that propagate NaN like torch.clamp / torch.maximum
FS_DEVICE float fs_max(float a, float b) { return (a < b) ? b : a; }
FS_DEVICE float fs_min(float a, float b) { return (a > b) ? b : a; }
FS_DEVICE float fs_sign(float x) { return (x > 0.0f) ? 1.0f : ((x < 0.0f) ? -1.0f : x); }

// ---- 3-vectors and quaternions (fused.py v3*/q*) ----
FS_DEVICE float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
FS_DEVICE void cross3(const float* a, const float* b, float* o) {
  float o0 = a[1] * b[2] - a[2] * b[1];
  float o1 = a[2] * b[0] - a[0] * b[2];
  float o2 = a[0] * b[1] - a[1] * b[0];
  o[0] = o0; o[1] = o1; o[2] = o2;
}
FS_DEVICE void qmul(const float* p, const float* q, float* o) {
  float o0 = p[0] * q[0] - p[1] * q[1] - p[2] * q[2] - p[3] * q[3];
  float o1 = p[0] * q[1] + p[1] * q[0] + p[2] * q[3] - p[3] * q[2];
  float o2 = p[0] * q[2] - p[1] * q[3] + p[2] * q[0] + p[3] * q[1];
  float o3 = p[0] * q[3] + p[1] * q[2] - p[2] * q[1] + p[3] * q[0];
  o[0] = o0; o[1] = o1; o[2] = o2; o[3] = o3;
}
// Rodrigues: 2 u (u.v) + (s^2 - u.u) v + 2 s (u x v)
FS_DEVICE void qrotate(const float* v, const float* q, float* o) {
  const float* u = q + 1;
  float s = q[0];
  float uv = dot3(u, v), uu = dot3(u, u), c[3];
  cross3(u, v, c);
  float k = s * s - uu;
  float o0 = 2.0f * (u[0] * uv) + k * v[0] + 2.0f * (s * c[0]);
  float o1 = 2.0f * (u[1] * uv) + k * v[1] + 2.0f * (s * c[1]);
  float o2 = 2.0f * (u[2] * uv) + k * v[2] + 2.0f * (s * c[2]);
  o[0] = o0; o[1] = o1; o[2] = o2;
}
FS_DEVICE void qmat(const float* q, float* R) {  // row-major 3x3
  float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1.0f - 2.0f * (y * y + z * z);
  R[1] = 2.0f * (x * y - w * z);
  R[2] = 2.0f * (x * z + w * y);
  R[3] = 2.0f * (x * y + w * z);
  R[4] = 1.0f - 2.0f * (x * x + z * z);
  R[5] = 2.0f * (y * z - w * x);
  R[6] = 2.0f * (x * z - w * y);
  R[7] = 2.0f * (y * z + w * x);
  R[8] = 1.0f - 2.0f * (x * x + y * y);
}
FS_DEVICE void qnormalize(float* q) {
  float inv = rsqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  q[0] *= inv; q[1] *= inv; q[2] *= inv; q[3] *= inv;
}

// Spatial inertia (fused.py CInert): ul = (a00 a01 a02 a11 a12 a22), h, m.
struct CInert {
  float ul[6], h[3], m;
};

// cinert @ [ang; lin] = [UL ang + h x lin ; -(h x ang) + m lin]
FS_DEVICE void cinert_vec(const CInert& ci, const float* v, float* o) {
  const float* a = ci.ul;
  float hl[3], ha[3];
  cross3(ci.h, v + 3, hl);
  cross3(ci.h, v, ha);
  float o0 = (a[0] * v[0] + a[1] * v[1] + a[2] * v[2]) + hl[0];
  float o1 = (a[1] * v[0] + a[3] * v[1] + a[4] * v[2]) + hl[1];
  float o2 = (a[2] * v[0] + a[4] * v[1] + a[5] * v[2]) + hl[2];
  float o3 = -ha[0] + v[3] * ci.m;
  float o4 = -ha[1] + v[4] * ci.m;
  float o5 = -ha[2] + v[5] * ci.m;
  o[0] = o0; o[1] = o1; o[2] = o2; o[3] = o3; o[4] = o4; o[5] = o5;
}
FS_DEVICE void motion_cross(const float* v, const float* m, float* o) {
  float a[3], l1[3], l2[3];
  cross3(v, m, a);
  cross3(v, m + 3, l1);
  cross3(v + 3, m, l2);
  o[0] = a[0]; o[1] = a[1]; o[2] = a[2];
  o[3] = l1[0] + l2[0]; o[4] = l1[1] + l2[1]; o[5] = l1[2] + l2[2];
}
FS_DEVICE void force_cross(const float* v, const float* f, float* o) {
  float a1[3], a2[3], l[3];
  cross3(v, f, a1);
  cross3(v + 3, f + 3, a2);
  cross3(v, f + 3, l);
  o[0] = a1[0] + a2[0]; o[1] = a1[1] + a2[1]; o[2] = a1[2] + a2[2];
  o[3] = l[0]; o[4] = l[1]; o[5] = l[2];
}
FS_DEVICE float dot6(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2] + a[3] * b[3] + a[4] * b[4] + a[5] * b[5];
}


// A sample's working set, in shared memory (one per warp); 4-byte fields
// only, so fused_cuda.py:work_bytes can size it.  Constraint rows: r in
// [0, NFL) friction loss, [NFL, NFL+NLIM) limits, [NFL+NLIM, NROW)
// contacts; a contact row keeps its Jacobian on its slot's dof list.
struct alignas(16) Work {
  // the model's tables that the row and matvec loops read, copied once per
  // sample (global memory is an L2 round trip: the shared memory leaves
  // little L1): dof patterns, each contact row's slot, dof count and place
  // in jl (FusedTables.crow_info), each slot's dofs
  uint32_t anc[2][FS_NV][FS_NW];
  uint32_t rinfo[FS_DIM(FS_NCROW)];
  unsigned char sdof[FS_R4(FS_NSLOT * FS_MAXD)];
  // state, carried across substeps
  float q[FS_NQ], v[FS_NV], w[FS_NV], ctrl[FS_NU];
  float M[FS_TRI(FS_NV)], dinv[FS_NV], qsm[FS_NV];
  // A substep's phases: (1) the kinematics and smooth dynamics, to the
  // smooth acceleration and the reward inputs; (2) the rows' build, from
  // the contact slots to each row's aref, D and active; (3) the Newton
  // solve and the integration.  Each union below holds members that are
  // never live at once, and each member is written in its phase before it
  // is read there.  Each union starts on 16 bytes, Work's size is a
  // multiple of 16 and a block's Works lie end to end from a 16-byte
  // aligned base, so the compiler can prove the alignment that 8- and
  // 16-byte shared loads and stores of neighbouring values need.
  union {
    // kin: the bodies' subtree CoM, the dofs' motion axes and the geoms'
    // world poses, from (1) to their last reads in contact_slot in (2).
    // sol: the Newton solve's and the integration's vectors, first written
    // at the top of (3)
    struct alignas(16) {
      float com[FS_NBODY][3], cdof[FS_NV][6], gpos[FS_NGEOM][3], gmat[FS_NGEOM][9];
    } kin;
    struct {
      float a[FS_NV], a_new[FS_NV], da[FS_NV], mda[FS_NV], grad[FS_NV], delta[FS_NV];
      float md[FS_NV], tv[FS_NV], tm[FS_NV], qacc[FS_NV], qfrc_con[FS_NV], qacc_int[FS_NV];
    } sol;
  };
  union {
    // H: the smooth LDL^T factor of M in (1), each Newton iteration's
    // Hessian and its factor from the assembly to ldl_solve(delta), and the
    // implicit re-solve's factor at the end of (3)
    alignas(16) float H[FS_TRI(FS_NV)];
    // rw: terms of sums over rows, each written and read only while H is
    // dead.  In (2) t1 holds the contact rows' J.v and sdist the slots'
    // distances; in (3) dc (the solver's dcost) is read by the gradient,
    // before the assembly, and t1, t2 by the costs and the line search,
    // after ldl_solve(delta)
    struct {
      union { float dc[FS_DIM(FS_NROW)], t1[FS_DIM(FS_NROW)]; };
      union { float t2[FS_DIM(FS_NROW)], sdist[FS_DIM(FS_NSLOT)]; };
    } rw;
  };
  union {
    // sm: the intermediates of (1), dead once the smooth acceleration's
    // bias and the reward inputs are taken (so the world body's frame and
    // velocity are set again each substep)
    struct alignas(16) {
      float xpos[FS_NBODY][3], xquat[FS_NBODY][4];
      float xanchor[FS_NJNT][3], xaxis[FS_NJNT][3];
      CInert cin[FS_NBODY], crb[FS_NBODY];
      float cvel[FS_NBODY][6], qfrc_act[FS_NV];
      float xipos[FS_NBODY][3], ximat[FS_NBODY][9], sub_mpos[FS_NBODY][3];
      float cdof_dot[FS_NV][6], crbf[FS_NV][6], cacc[FS_NBODY][6], cfrc[FS_NBODY][6];
    } sm;
    // per row, from (2) on: its Hessian weight hc, then its Jacobian values
    // (a friction-loss or limit row's one at 2 r + 1, a contact row's on
    // its slot's dofs from rinfo's j0)
    float jl[FS_DIM(FS_NJL)];
  };
};

static_assert(FS_NSLOT < 256 && FS_NV < 256 && FS_MAXD < 256, "the byte tables of Work");
static_assert(FS_NJL <= 65536, "the term lists' 16-bit places in Work.jl");
static_assert(sizeof(Work) % 4 == 0 && sizeof(Work) <= 232448,
              "a sample's working set must fit one block's 227 KB of shared memory");

// A lane's per-row values (FS_ROWS' round k): the rows' aref, D and active
// (a bit per round) for the whole solve, x = J a - aref and J delta for one
// Newton iteration.
struct RowRegs {
  float aref[FS_DIM(FS_RR)], D[FS_DIM(FS_RR)], x[FS_DIM(FS_RR)], jd[FS_DIM(FS_RR)];
  uint32_t active[(FS_DIM(FS_RR) + 31) / 32];
};
#ifdef __CUDACC__
static_assert(FS_RR <= 32, "a lane keeps at most 32 rounds of rows in registers");
#endif
FS_DEVICE bool row_active(const RowRegs& R, int k) { return (R.active[k >> 5] >> (k & 31)) & 1u; }

FS_DEVICE float& cin_comp(CInert& c, int k) {
  return k < 6 ? c.ul[k] : (k < 9 ? c.h[k - 6] : c.m);
}

// (i, j) of lower-triangle entry e = FS_IDX(i, j)
FS_DEVICE void tri_ij(int e, int& i, int& j) {
  int r = (int)((sqrtf(8.0f * (float)e + 1.0f) - 1.0f) * 0.5f);
  while (FS_IDX(r + 1, 0) <= e) ++r;
  while (FS_IDX(r, 0) > e) --r;
  i = r;
  j = e - FS_IDX(r, 0);
}

// ---- dense-storage LDL^T in the tree-sparse order (fused.py ldl_factor /
// ldl_solve).  Pattern pat (0: anc_strict, 1: anc_solver); anc = Work.anc[pat],
// bit j of mask anc[k]: entry (k, j), j < k.  A is overwritten by L (strict
// lower part); dinv gets 1 / D.  Column k's step updates the pairs (i, j)
// of row k's pattern in parallel, each once, as the sequential loop does;
// row k+1's scaling by its pivot joins that step (no lane of it touches
// row k+1).
FS_DEVICE void ldl_factor(const FusedTables& T, int pat, const uint32_t (*anc)[FS_NW],
                          float* A, float* dinv) {
  float dprev = 0.0f;
  for (int k = FS_NV - 1; k >= 0; --k) {
    float dk = 1.0f / A[FS_IDX(k, k)];
    int p0 = c_model.ldl_off[pat][k], np = c_model.ldl_off[pat][k + 1] - p0;
    FS_FOR(p, np) {
      int e = T.ldl_pair[p0 + p], i = e & 0xff, j = e >> 8;
      float lki = A[FS_IDX(k, i)] * dk;
      A[FS_IDX(i, j)] = A[FS_IDX(i, j)] - lki * A[FS_IDX(k, j)];
    }
    if (k + 1 < FS_NV) {
      DofMask a1 = dof_mask(anc[k + 1]);
      FS_FOR(j, k + 1) if (dof_bit(a1, j)) A[FS_IDX(k + 1, j)] = A[FS_IDX(k + 1, j)] * dprev;
    }
    if (FS_LANE == 0) dinv[k] = dk;
    FS_SYNC();
    dprev = dk;
  }
}
// Back substitution row by row (lanes over the row's pattern), the
// diagonal, then forward substitution column by column: x[k] takes its
// terms in the sequential loop's order, j ascending.
FS_DEVICE void ldl_solve(const uint32_t (*anc)[FS_NW], const float* L, const float* dinv,
                         float* x) {
  for (int k = FS_NV - 1; k > 0; --k) {
    DofMask ak = dof_mask(anc[k]);
    float xk = x[k];
    FS_FOR(j, k) if (dof_bit(ak, j)) x[j] = x[j] - L[FS_IDX(k, j)] * xk;
    FS_SYNC();
  }
  FS_FOR(k, FS_NV) x[k] = x[k] * dinv[k];
  FS_SYNC();
  for (int j = 0; j < FS_NV - 1; ++j) {
    float xj = x[j];
    FS_FOR(t, FS_NV - 1 - j) {
      int k = j + 1 + t;
      if (dof_bit(dof_mask(anc[k]), j)) x[k] = x[k] - L[FS_IDX(k, j)] * xj;
    }
    FS_SYNC();
  }
}
// symmetric matvec over the mass-matrix pattern (fused.py m_vec), one lane
// per output k, its terms in the order of the sequential loop: M[k][j] x[j]
// for j < k, M[k][k] x[k], then M[i][k] x[i] for i > k.  No sync.
FS_DEVICE void m_vec(const Work& W, const float* M, const float* x, float* out) {
  FS_FOR(k, FS_NV) {
    DofMask ak = dof_mask(W.anc[0][k]);
    float acc = 0.0f;
    // each term computed, and added only on the pattern: no branch on a
    // loaded mask, so the loads run ahead of the sum
    for (int j = 0; j < k; ++j) {
      float t = acc + M[FS_IDX(k, j)] * x[j];
      acc = dof_bit(ak, j) ? t : acc;
    }
    acc = acc + M[FS_IDX(k, k)] * x[k];
    for (int i = k + 1; i < FS_NV; ++i) {
      float t = acc + M[FS_IDX(i, k)] * x[i];
      acc = dof_bit(dof_mask(W.anc[0][i]), k) ? t : acc;
    }
    out[k] = acc;
  }
}
// sums every lane computes alike, in index order
FS_DEVICE float sum_prod(float acc, const float* a, const float* b, int n) {
#pragma unroll 8
  for (int i = 0; i < n; ++i) acc = acc + a[i] * b[i];
  return acc;
}

// ---- forward kinematics of one body (fused.py _fk, its first loop); its
// parent is final (an earlier tree level) ----
FS_DEVICE void body_frame(const FusedModel& m, Work& W, int b) {
  int p = m.body_parent[b];
  float t[3], pos[3], quat[4];
  qrotate(m.body_pos[b], W.sm.xquat[p], t);
  for (int i = 0; i < 3; ++i) pos[i] = W.sm.xpos[p][i] + t[i];
  qmul(W.sm.xquat[p], m.body_quat[b], quat);
  int j = m.body_jnt[b];
  if (j >= 0) {
    int qa = m.jnt_qadr[j];
    const float* ax = m.jnt_axis[j];
    const float* jp = m.jnt_pos[j];
    int jt = m.jnt_type[j];
    if (jt == JNT_FREE) {
      for (int i = 0; i < 3; ++i) pos[i] = W.q[qa + i];
      for (int i = 0; i < 4; ++i) quat[i] = W.q[qa + 3 + i];
      qnormalize(quat);
      for (int i = 0; i < 3; ++i) { W.sm.xanchor[j][i] = pos[i]; W.sm.xaxis[j][i] = ax[i]; }
    } else if (jt == JNT_SLIDE) {
      float aw[3], t2[3];
      qrotate(ax, quat, aw);
      qrotate(jp, quat, t2);
      float trans = W.q[qa] - m.qpos0[qa];
      for (int i = 0; i < 3; ++i) {
        W.sm.xanchor[j][i] = pos[i] + t2[i];
        pos[i] = pos[i] + aw[i] * trans;
        W.sm.xaxis[j][i] = aw[i];
      }
    } else {  // hinge
      float anchor[3], t2[3];
      qrotate(jp, quat, t2);
      for (int i = 0; i < 3; ++i) anchor[i] = pos[i] + t2[i];
      float half = 0.5f * (W.q[qa] - m.qpos0[qa]);
      float sh = sinf(half);
      float qloc[4] = {cosf(half), ax[0] * sh, ax[1] * sh, ax[2] * sh};
      float nq[4];
      qmul(quat, qloc, nq);
      for (int i = 0; i < 4; ++i) quat[i] = nq[i];
      qrotate(jp, quat, t2);
      for (int i = 0; i < 3; ++i) {
        pos[i] = anchor[i] - t2[i];
        W.sm.xanchor[j][i] = anchor[i];
      }
      qrotate(ax, quat, W.sm.xaxis[j]);
    }
  }
  for (int i = 0; i < 3; ++i) W.sm.xpos[b][i] = pos[i];
  for (int i = 0; i < 4; ++i) W.sm.xquat[b][i] = quat[i];
}

// every body's frame, level by level down the tree (ends synced)
FS_DEVICE void kinematics(const FusedModel& m, Work& W) {
  for (int l = 0; l < FS_NLEVEL; ++l) {
    int o = c_model.level_off[l];
    FS_FOR(t, c_model.level_off[l + 1] - o) body_frame(m, W, m.body_order[o + t]);
    FS_SYNC();
  }
}

// world pose of geom g; a static geom's is the host's
FS_DEVICE void geom_frame(const FusedModel& m, Work& W, int g) {
  if (m.geom_static[g]) {
    for (int i = 0; i < 3; ++i) W.kin.gpos[g][i] = m.geom_sxpos[g][i];
    for (int i = 0; i < 9; ++i) W.kin.gmat[g][i] = m.geom_sxmat[g][i];
    return;
  }
  int b = m.geom_body[g];
  float t[3], gq[4];
  qrotate(m.geom_pos[g], W.sm.xquat[b], t);
  for (int i = 0; i < 3; ++i) W.kin.gpos[g][i] = W.sm.xpos[b][i] + t[i];
  qmul(W.sm.xquat[b], m.geom_quat[g], gq);
  qmat(gq, W.kin.gmat[g]);
}

// ---- contact geometry (fused.py _contact_geometry and its helpers) ----
// 3x3 matrices are row-major; m33_vec(m, v)_i = m_i . v, m33_t_vec(m, v)_i =
// column i . v, each a left-to-right sum as the plain version's sdot.
FS_DEVICE void m33_vec(const float* m, const float* v, float* o) {
  float o0 = m[0] * v[0] + m[1] * v[1] + m[2] * v[2];
  float o1 = m[3] * v[0] + m[4] * v[1] + m[5] * v[2];
  float o2 = m[6] * v[0] + m[7] * v[1] + m[8] * v[2];
  o[0] = o0; o[1] = o1; o[2] = o2;
}
FS_DEVICE void m33_t_vec(const float* m, const float* v, float* o) {
  float o0 = m[0] * v[0] + m[3] * v[1] + m[6] * v[2];
  float o1 = m[1] * v[0] + m[4] * v[1] + m[7] * v[2];
  float o2 = m[2] * v[0] + m[5] * v[1] + m[8] * v[2];
  o[0] = o0; o[1] = o1; o[2] = o2;
}

// mju_makeFrame of a per-sample normal (fused.py _make_frame): t1 from the
// y or z axis, whichever is farther from n, then t2 = n x t1
FS_DEVICE void make_frame(const float* n, float* t1, float* t2) {
  bool use_y = fabsf(n[1]) < 0.5f;
  float b1 = use_y ? 1.0f : 0.0f, b2 = use_y ? 0.0f : 1.0f;
  float nb = n[1] * b1 + n[2] * b2;
  t1[0] = -(n[0] * nb);
  t1[1] = b1 - n[1] * nb;
  t1[2] = b2 - n[2] * nb;
  float inv = rsqrtf(dot3(t1, t1));
  for (int i = 0; i < 3; ++i) t1[i] = t1[i] * inv;
  cross3(n, t1, t2);
}

// collision.sphere_box (fused.py _sphere_box_scalar): dist of a sphere
// (center spos, radius r) against a box (bpos, rotation bm, half-sizes sz),
// the contact point and the normal from the box into the sphere, in world
// coordinates.  Outside: from the closest box point; inside: through the
// face of least depth (the first of a tie wins).
FS_DEVICE float sphere_box(const float* spos, float r, const float* bpos, const float* bm,
                           const float* sz, float* pos_w, float* n_w) {
  float rel[3] = {spos[0] - bpos[0], spos[1] - bpos[1], spos[2] - bpos[2]};
  float local[3], clamped[3], delta[3];
  m33_t_vec(bm, rel, local);
  for (int i = 0; i < 3; ++i) clamped[i] = fs_min(fs_max(local[i], -sz[i]), sz[i]);
  bool outside = (fabsf(local[0]) > sz[0]) || (fabsf(local[1]) > sz[1]) || (fabsf(local[2]) > sz[2]);
  for (int i = 0; i < 3; ++i) delta[i] = local[i] - clamped[i];
  float len_out = sqrtf(fs_max(dot3(delta, delta), 0.0f));
  float inv_len = 1.0f / fs_max(len_out, 1e-12f);
  float dist_out = len_out - r;
  float depth[3], sg[3];
  for (int i = 0; i < 3; ++i) depth[i] = sz[i] - fabsf(local[i]);
  bool m0 = (depth[0] <= depth[1]) && (depth[0] <= depth[2]);
  bool m1 = !m0 && (depth[1] <= depth[2]);
  bool mk[3] = {m0, m1, !(m0 || m1)};
  for (int i = 0; i < 3; ++i) sg[i] = fs_sign(local[i]);
  float depth_min = m0 ? depth[0] : (m1 ? depth[1] : depth[2]);
  float dist_in = -(depth_min + r);
  float n_loc[3], p_loc[3];
  for (int i = 0; i < 3; ++i) {
    float n_out = delta[i] * inv_len;
    float p_out = clamped[i] + n_out * (0.5f * dist_out);
    float n_in = mk[i] ? sg[i] : 0.0f;
    float surface = mk[i] ? sg[i] * sz[i] : local[i];
    float p_in = surface + n_in * (0.5f * dist_in);
    n_loc[i] = outside ? n_out : n_in;
    p_loc[i] = outside ? p_out : p_in;
  }
  float t[3];
  m33_vec(bm, n_loc, n_w);
  m33_vec(bm, p_loc, t);
  for (int i = 0; i < 3; ++i) pos_w[i] = bpos[i] + t[i];
  return outside ? dist_out : dist_in;
}

// corner k of a box, x slowest then y then z, each sign - before +
FS_DEVICE void box_corner(const float* bpos, const float* bm, const float* sz, int k,
                          float* c) {
  float local[3] = {(k & 4) ? sz[0] : -sz[0], (k & 2) ? sz[1] : -sz[1],
                    (k & 1) ? sz[2] : -sz[2]};
  float t[3];
  m33_vec(bm, local, t);
  for (int i = 0; i < 3; ++i) c[i] = bpos[i] + t[i];
}

// the deepest point of segment a-b against a box: 4 sweeps of projecting
// the box point onto the segment and clamping the segment point into the
// box (collision._capsule_box)
FS_DEVICE void capsule_box_sweeps(const float* a, const float* b, const float* bpos,
                                  const float* bm, const float* sz, float* seg) {
  float ab[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
  float denom = fs_max(dot3(ab, ab), 1e-12f);
  float p[3] = {bpos[0], bpos[1], bpos[2]};
  for (int it = 0; it < 4; ++it) {
    float pa[3] = {p[0] - a[0], p[1] - a[1], p[2] - a[2]};
    float t = dot3(pa, ab) / denom;
    t = fs_min(fs_max(t, 0.0f), 1.0f);
    for (int i = 0; i < 3; ++i) seg[i] = a[i] + ab[i] * t;
    float rel[3] = {seg[0] - bpos[0], seg[1] - bpos[1], seg[2] - bpos[2]}, local[3], w[3];
    m33_t_vec(bm, rel, local);
    for (int i = 0; i < 3; ++i) local[i] = fs_min(fs_max(local[i], -sz[i]), sz[i]);
    m33_vec(bm, local, w);
    for (int i = 0; i < 3; ++i) p[i] = bpos[i] + w[i];
  }
}

// dist, pos and frame (n, t1, t2) of contact slot s, given every geom's
// world pose (gpos, gmat)
FS_DEVICE float contact_geometry(const FusedModel& m, int s, const float (*gpos)[3],
                                 const float (*gmat)[9], float* pos, float* n, float* t1,
                                 float* t2) {
  int kind = m.slot_kind[s], sub = m.slot_sub[s];
  int g1 = m.slot_g1[s], g2 = m.slot_g2[s];
  const float* p1 = gpos[g1];
  const float* R1 = gmat[g1];
  const float* p2 = gpos[g2];
  const float* R2 = gmat[g2];
  const float* sz1 = m.geom_size[g1];
  const float* sz2 = m.geom_size[g2];

  if (kind <= KIND_PLANE_BOX) {
    // the plane's normal and its generic frame
    float gt1[3], gt2[3];
    if (m.geom_static[g1]) {
      for (int i = 0; i < 3; ++i) {
        n[i] = m.geom_sframe[g1][i];
        gt1[i] = m.geom_sframe[g1][3 + i];
        gt2[i] = m.geom_sframe[g1][6 + i];
      }
    } else {
      n[0] = R1[2]; n[1] = R1[5]; n[2] = R1[8];
      make_frame(n, gt1, gt2);
    }
    if (kind == KIND_PLANE_BOX) {
      // the corner of rank `sub` by depth (ties broken by corner index),
      // picked by sums of 8 masked terms in corner order
      float c[8][3], d[8];
      for (int k = 0; k < 8; ++k) {
        if (m.geom_static[g2]) {
          for (int i = 0; i < 3; ++i) c[k][i] = m.geom_scorner[g2][k][i];
        } else {
          box_corner(p2, R2, sz2, k, c[k]);
        }
        float rel[3] = {c[k][0] - p1[0], c[k][1] - p1[1], c[k][2] - p1[2]};
        d[k] = dot3(n, rel);
      }
      float dist = 0.0f, pc[3] = {0.0f, 0.0f, 0.0f};
      for (int k = 0; k < 8; ++k) {
        float rank = 0.0f;
        for (int j = 0; j < 8; ++j) {
          if (j == k) continue;
          bool before = (d[j] < d[k]) || ((d[j] == d[k]) && (j < k));
          rank = rank + (before ? 1.0f : 0.0f);
        }
        bool sel = rank == (float)sub;
        dist = (k == 0) ? (sel ? d[k] : 0.0f) : dist + (sel ? d[k] : 0.0f);
        for (int i = 0; i < 3; ++i)
          pc[i] = (k == 0) ? (sel ? c[k][i] : 0.0f) : pc[i] + (sel ? c[k][i] : 0.0f);
      }
      for (int i = 0; i < 3; ++i) pos[i] = pc[i] - n[i] * (0.5f * dist);
      for (int i = 0; i < 3; ++i) { t1[i] = gt1[i]; t2[i] = gt2[i]; }
      return dist;
    }
    // plane-sphere; plane-capsule is a sphere at the capsule's end `sub`
    float spos[3], r = sz2[0];
    float axis[3] = {R2[2], R2[5], R2[8]};
    if (kind == KIND_PLANE_CAPSULE) {
      float h = (sub == 0) ? sz2[1] : -sz2[1];
      for (int i = 0; i < 3; ++i) spos[i] = p2[i] + axis[i] * h;
    } else {
      for (int i = 0; i < 3; ++i) spos[i] = p2[i];
    }
    float rel[3] = {spos[0] - p1[0], spos[1] - p1[1], spos[2] - p1[2]};
    float dist = dot3(n, rel) - r;
    float hs = r + 0.5f * dist;
    for (int i = 0; i < 3; ++i) pos[i] = spos[i] - n[i] * hs;
    if (kind == KIND_PLANE_SPHERE) {
      for (int i = 0; i < 3; ++i) { t1[i] = gt1[i]; t2[i] = gt2[i]; }
      return dist;
    }
    // MuJoCo's plane-capsule frame: t1 is the capsule axis projected onto
    // the plane, the generic frame's where that projection vanishes
    float na = dot3(n, axis), proj[3];
    for (int i = 0; i < 3; ++i) proj[i] = axis[i] - n[i] * na;
    float pl2 = dot3(proj, proj);
    bool nearz = pl2 < 1e-20f;
    float inv = 1.0f / sqrtf(nearz ? 1.0f : pl2);
    for (int i = 0; i < 3; ++i) t1[i] = nearz ? gt1[i] : proj[i] * inv;
    cross3(n, t1, t2);
    return dist;
  }

  // the box kinds: geom2 is a box; the normal is flipped to point from
  // geom1 into the box
  float dist, nw[3];
  if (kind == KIND_SPHERE_BOX) {
    dist = sphere_box(p1, sz1[0], p2, R2, sz2, pos, nw);
  } else if (kind == KIND_CAPSULE_BOX) {
    // slot 0: the deepest segment point; slot 1: the deeper end point,
    // switched off (dist 1) where it is slot 0's point
    float r = sz1[0], half = sz1[1];
    float axis[3] = {R1[2], R1[5], R1[8]}, a[3], b[3], seg[3];
    for (int i = 0; i < 3; ++i) {
      a[i] = p1[i] - axis[i] * half;
      b[i] = p1[i] + axis[i] * half;
    }
    capsule_box_sweeps(a, b, p2, R2, sz2, seg);
    if (sub == 0) {
      dist = sphere_box(seg, r, p2, R2, sz2, pos, nw);
    } else {
      float pa[3], na[3], pb[3], nbv[3];
      float da = sphere_box(a, r, p2, R2, sz2, pa, na);
      float db = sphere_box(b, r, p2, R2, sz2, pb, nbv);
      bool deeper = da < db;
      dist = deeper ? da : db;
      float gap[3];
      for (int i = 0; i < 3; ++i) {
        pos[i] = deeper ? pa[i] : pb[i];
        nw[i] = deeper ? na[i] : nbv[i];
        gap[i] = seg[i] - (deeper ? a[i] : b[i]);
      }
      if (dot3(gap, gap) < 1e-12f) dist = 1.0f;
    }
  } else {  // box-box: box1's corner `sub` against box2
    float c[3];
    if (m.geom_static[g1]) {
      for (int i = 0; i < 3; ++i) c[i] = m.geom_scorner[g1][sub][i];
    } else {
      box_corner(p1, R1, sz1, sub, c);
    }
    dist = sphere_box(c, 0.0f, p2, R2, sz2, pos, nw);
  }
  for (int i = 0; i < 3; ++i) n[i] = -nw[i];
  make_frame(n, t1, t2);
  return dist;
}

// ---- soft constraints (fused.py _impedance, _aref_d) ----
FS_DEVICE float impedance(const ImpParams& p, float pos, float margin) {
  float x = fabsf(pos - margin) * p.inv_width;
  x = fs_min(fs_max(x, 0.0f), 1.0f);
  float y;
  if (p.power == 2.0f) {
    float xm = 1.0f - x;
    y = (x <= p.mid) ? p.a * (x * x) : 1.0f - p.b * (xm * xm);
  } else if (p.power == 1.0f) {
    y = (x <= p.mid) ? p.a * x : 1.0f - p.b * (1.0f - x);
  } else {
    y = (x <= p.mid) ? p.a * powf(x, p.power) : 1.0f - p.b * powf(1.0f - x, p.power);
  }
  return fs_min(fs_max(p.dmin + y * p.dspan, MJ_MINIMP), MJ_MAXIMP);
}
FS_DEVICE void aref_d(const ImpParams& p, float diag, float pos, float margin, float vel,
                      float* aref, float* D) {
  float imp = impedance(p, pos, margin);
  *aref = p.negb * vel - p.k * (imp * (pos - margin));
  float r = fs_max(((1.0f - imp) / imp) * diag, MJ_MINVAL);
  *D = 1.0f / r;
}


// ---- constraint rows (fused.py _constraint_rows, _s_terms) ----
FS_DEVICE float row_dot(const FusedModel& m, const Work& W, int r, const float* a) {
  if (r < FS_NFL) return a[m.fl_dof[r]];
  if (r < FS_NFL + FS_NLIM) {
    int l = r - FS_NFL;
    return m.lim_sign[l] * a[m.lim_dadr[l]];
  }
  uint32_t info = W.rinfo[r - FS_NFL - FS_NLIM];
  int nd = (info >> 8) & 0xffu;
  const float* J = W.jl + (info >> 16);
  const unsigned char* dofs = W.sdof + (info & 0xffu) * FS_MAXD;
  float acc = 0.0f;
#pragma unroll 4
  for (int k = 0; k < nd; ++k) acc = acc + J[k] * a[dofs[k]];
  return acc;
}
// where row r's Jacobian values start in Work.jl (its weight hc one before)
FS_DEVICE int jl_start(const Work& W, int r) {
  return r < FS_NFL + FS_NLIM ? 2 * r + 1 : (int)(W.rinfo[r - FS_NFL - FS_NLIM] >> 16);
}
// per-row cost, dcost, hcost (fused.py _s_terms), given the row's active
// flag and D
FS_DEVICE void s_terms(const FusedModel& m, int r, float x, bool active, float D, float* cost,
                       float* dc, float* hc) {
  if (r < FS_NFL) {  // Huber friction-loss row, always active
    float D = m.fl_D[r], fl = m.fl_floss[r];
    float ax = fabsf(x);
    bool quad = ax <= m.fl_knee[r];
    *cost = quad ? 0.5f * (D * (x * x)) : fl * ax - m.fl_lin0[r];
    *dc = quad ? D * x : fl * fs_sign(x);
    *hc = quad ? D : 0.0f;
    return;
  }
  bool act = active && (x < 0.0f);
  *cost = act ? 0.5f * (D * (x * x)) : 0.0f;
  *dc = act ? D * x : 0.0f;
  *hc = act ? D : 0.0f;
}

// contact slot s: geometry, point Jacobians of the contact point on body2
// minus body1 (fused.py _point_jac), its rows' J (at their places in jl)
// and J.v (into t1)
FS_DEVICE void contact_slot(const FusedModel& m, Work& W, int s) {
  float pos[3], n[3], t1[3], t2[3];
  float dist = contact_geometry(m, s, W.kin.gpos, W.kin.gmat, pos, n, t1, t2);
  W.rw.sdist[s] = dist;
  const float* c2 = W.kin.com[m.body_root[m.slot_body2[s]]];
  const float* c1 = W.kin.com[m.body_root[m.slot_body1[s]]];
  float off2[3] = {pos[0] - c2[0], pos[1] - c2[1], pos[2] - c2[2]};
  float off1[3] = {pos[0] - c1[0], pos[1] - c1[1], pos[2] - c1[2]};
  int c0 = m.slot_crow0[s], nr = m.slot_ncrow[s], nd = m.slot_ndof[s];
  DofMask b2 = dof_mask(m.slot_body2_dofs[s]), b1 = dof_mask(m.slot_body1_dofs[s]);
  float vel[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int j0[4] = {0, 0, 0, 0};
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < nr) j0[q] = (int)(W.rinfo[c0 + q] >> 16);
  for (int k = 0; k < nd; ++k) {
    int d = m.slot_dof[s][k];
    float j2[3] = {0.0f, 0.0f, 0.0f}, j1[3] = {0.0f, 0.0f, 0.0f}, cr[3];
    if (dof_bit(b2, d)) {
      cross3(W.kin.cdof[d], off2, cr);
      for (int i = 0; i < 3; ++i) j2[i] = W.kin.cdof[d][3 + i] + cr[i];
    }
    if (dof_bit(b1, d)) {
      cross3(W.kin.cdof[d], off1, cr);
      for (int i = 0; i < 3; ++i) j1[i] = W.kin.cdof[d][3 + i] + cr[i];
    }
    float jac[3] = {j2[0] - j1[0], j2[1] - j1[1], j2[2] - j1[2]};
    float jn = dot3(jac, n), jt1 = dot3(jac, t1), jt2 = dot3(jac, t2);
    float vd = W.v[d];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= nr) break;
      int c = c0 + q;
      int t = m.crow_t[c];
      float jr = jn;
      if (t == 0) jr = jr + m.crow_coef[c] * jt1;
      else if (t == 1) jr = jr + m.crow_coef[c] * jt2;
      W.jl[j0[q] + k] = jr;
      vel[q] = vel[q] + jr * vd;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < nr) W.rw.t1[FS_NFL + FS_NLIM + c0 + q] = vel[q];
}

// where dof d's term list starts: its round's base, then its lane
FS_DEVICE const uint32_t* g_terms(const FusedTables& T, int d) {
#if FS_NW == 1
  return T.g_term + d;  // one round, based at 0: the code of builds before masks grew
#else
  return T.g_term + T.g_base[d >> 5] + (d & 31);
#endif
}

// out[d] = start[d] + J' dc (or 0 - J' dc), each dof's rows in row order.
// No sync.
FS_DEVICE void jt_dc(const FusedTables& T, Work& W, const float* start, float* out,
                     bool subtract) {
  FS_FOR(d, FS_NV) {
    float g = subtract ? 0.0f : start[d];
    const uint32_t* term = g_terms(T, d);
    int n = T.g_len[d], t = 0;
    for (; t + 8 <= n; t += 8) {  // 8 loads in flight, then the sum in order
      uint32_t u[8];
#pragma unroll
      for (int q = 0; q < 8; ++q) u[q] = term[(t + q) * 32];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        float tj = W.jl[u[q] & 0xffffu] * W.rw.dc[u[q] >> 16];
        g = subtract ? g - tj : g + tj;
      }
    }
    for (; t < n; ++t) {
      uint32_t u = term[t * 32];
      float tj = W.jl[u & 0xffffu] * W.rw.dc[u >> 16];
      g = subtract ? g - tj : g + tj;
    }
    out[d] = g;
  }
}

// 0.5 (a - qsm)' M (a - qsm) + the rows' costs at a (ends synced)
FS_DEVICE float total_cost(const FusedModel& m, Work& W, const RowRegs& R, const float* a) {
  FS_FOR(i, FS_NV) W.sol.tv[i] = a[i] - W.qsm[i];
  FS_ROWS(k, r) {
    float cost, dc, hc;
    s_terms(m, r, row_dot(m, W, r, a) - R.aref[k], row_active(R, k), R.D[k], &cost, &dc, &hc);
    W.rw.t1[r] = cost;
  }
  FS_SYNC();
  m_vec(W, W.M, W.sol.tv, W.sol.tm);
  FS_SYNC();
  float c = 0.5f * sum_prod(0.0f, W.sol.tv, W.sol.tm, FS_NV);
#pragma unroll 8
  for (int r = 0; r < FS_NROW; ++r) c = c + W.rw.t1[r];
  FS_SYNC();
  return c;
}

// ---- the truncated Newton solve (fused.py _newton_solve): qacc, and the
// constraint force into qfrc_con.  done, any_active and the iteration
// count are one sample's, so uniform over the warp.  R: the rows' aref, D
// and active, from substep; x and jd are set here. ----
FS_DEVICE void newton(const FusedModel& m, const FusedTables& T, Work& W, RowRegs& R) {
  FS_FOR(i, FS_NV) { W.sol.qacc[i] = W.qsm[i]; W.sol.qfrc_con[i] = 0.0f; }
  FS_SYNC();
#if FS_NROW > 0
  bool any_active = FS_NFL > 0;
  FS_ROWS(k, r) if (r >= FS_NFL && row_active(R, k)) any_active = true;
  any_active = FS_ANY(any_active);
  // start from the warmstart only where it is strictly cheaper
  float cost_ws = total_cost(m, W, R, W.w);
  float cost_sm = total_cost(m, W, R, W.qsm);
  bool better = cost_ws < cost_sm;
  FS_FOR(i, FS_NV) W.sol.a[i] = better ? W.w[i] : W.qsm[i];
  FS_SYNC();
  float cost_prev = fs_min(cost_ws, cost_sm);
  // done is sticky and a sample moves only while it was not done before,
  // so stopping at the top of an iteration is the same computation
  bool done = !any_active;
  for (int it = 0; it < c_model.iterations && !done; ++it) {
    FS_FOR(i, FS_NV) W.sol.da[i] = W.sol.a[i] - W.qsm[i];
    FS_ROWS(k, r) {
      float cost;
      float x = row_dot(m, W, r, W.sol.a) - R.aref[k];
      R.x[k] = x;
      s_terms(m, r, x, row_active(R, k), R.D[k], &cost, &W.rw.dc[r],
              &W.jl[jl_start(W, r) - 1]);
    }
    FS_SYNC();
    m_vec(W, W.M, W.sol.da, W.sol.mda);
    FS_SYNC();
    // the gradient mda + J' dc; H = M + J' diag(hc) J on the solver
    // pattern, one lane per entry, its rows in row order (H takes dc's
    // bytes: the gradient's reads end first)
    jt_dc(T, W, W.sol.mda, W.sol.grad, false);
    FS_SYNC();
    FS_FOR(p, FS_TRI(FS_NV)) {
      int e = T.h_ent[p], idx = e & 0xffff, i = (e >> 16) & 0xff, j = e >> 24;
      float h = (i == j || dof_bit(dof_mask(W.anc[0][i]), j)) ? W.M[idx] : 0.0f;
      const uint32_t* term = T.h_term + T.h_base[p / 32] + p % 32;
      int n = T.h_len[p], t = 0;
      for (; t + 8 <= n; t += 8) {  // 8 loads in flight, then the sum in order
        uint32_t u[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) u[q] = term[(t + q) * 32];
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float* jr = W.jl + (u[q] & 0xffffu);
          h = h + jr[-1] * (jr[(u[q] >> 16) & 0xffu] * jr[u[q] >> 24]);
        }
      }
      for (; t < n; ++t) {
        uint32_t u = term[t * 32];
        const float* jr = W.jl + (u & 0xffffu);
        h = h + jr[-1] * (jr[(u >> 16) & 0xffu] * jr[u >> 24]);
      }
      W.H[idx] = h;
    }
    FS_SYNC();
    ldl_factor(T, 1, W.anc[1], W.H, W.dinv);
    FS_FOR(i, FS_NV) W.sol.delta[i] = -W.sol.grad[i];
    FS_SYNC();
    ldl_solve(W.anc[1], W.H, W.dinv, W.sol.delta);
    FS_ROWS(k, r) R.jd[k] = row_dot(m, W, r, W.sol.delta);
    m_vec(W, W.M, W.sol.delta, W.sol.md);
    FS_SYNC();
    float dmd = sum_prod(0.0f, W.sol.delta, W.sol.md, FS_NV);
    float dma = sum_prod(0.0f, W.sol.delta, W.sol.mda, FS_NV);

    // exactly ls_iterations 1-D Newton steps on alpha, then alpha >= 0
    float alpha = 0.0f;
    for (int ls = 0; ls < c_model.ls_iterations; ++ls) {
      FS_ROWS(k, r) {
        float cost, dc, hc, jd = R.jd[k];
        s_terms(m, r, R.x[k] + alpha * jd, row_active(R, k), R.D[k], &cost, &dc, &hc);
        W.rw.t1[r] = jd * dc;
        W.rw.t2[r] = hc * (jd * jd);
      }
      FS_SYNC();
      float d1 = alpha * dmd + dma, d2 = dmd;
#pragma unroll 8
      for (int r = 0; r < FS_NROW; ++r) {
        d1 = d1 + W.rw.t1[r];
        d2 = d2 + W.rw.t2[r];
      }
      alpha = alpha - d1 / fs_max(d2, 1e-30f);
      FS_SYNC();
    }
    alpha = fs_max(alpha, 0.0f);

    FS_FOR(i, FS_NV) W.sol.a_new[i] = W.sol.a[i] + alpha * W.sol.delta[i];
    FS_SYNC();
    float cost_new = total_cost(m, W, R, W.sol.a_new);
    float improved = cost_prev - cost_new;
    float gn = sqrtf(sum_prod(0.0f, W.sol.grad, W.sol.grad, FS_NV));
    FS_FOR(i, FS_NV) W.sol.a[i] = W.sol.a_new[i];
    FS_SYNC();
    cost_prev = cost_new;
    done = (improved < c_model.tol_scale) || (gn < c_model.tol_scale);
  }
  if (any_active) {
    FS_FOR(i, FS_NV) W.sol.qacc[i] = W.sol.a[i];
    FS_ROWS(k, r) {
      float cost, hc;
      s_terms(m, r, row_dot(m, W, r, W.sol.a) - R.aref[k], row_active(R, k), R.D[k], &cost,
              &W.rw.dc[r], &hc);
    }
    FS_SYNC();
    jt_dc(T, W, nullptr, W.sol.qfrc_con, true);
    FS_SYNC();
  }
#endif
}

// the world body's frame, velocity and acceleration (gravity), which never
// change; they lie in the phase sm, so each substep sets them
FS_DEVICE void init_world(Work& W) {
  if (FS_LANE == 0) {
    for (int i = 0; i < 3; ++i) W.sm.xpos[0][i] = 0.0f;
    W.sm.xquat[0][0] = 1.0f;
    W.sm.xquat[0][1] = W.sm.xquat[0][2] = W.sm.xquat[0][3] = 0.0f;
    for (int k = 0; k < 6; ++k) W.sm.cvel[0][k] = 0.0f;
    W.sm.cacc[0][0] = W.sm.cacc[0][1] = W.sm.cacc[0][2] = 0.0f;
    for (int i = 0; i < 3; ++i) W.sm.cacc[0][3 + i] = -c_model.gravity[i];
  }
}

// ---- one substep for one sample (fused.py _substep); the reward inputs
// (derived) go to der ----
FS_DEVICE void substep(const FusedModel& m, const FusedTables& T, Work& W, float* der) {
  const float dt = c_model.dt;

  init_world(W);
  FS_SYNC();
  // _fk: body frames, inertial frames, subtree CoM; the geoms' world poses
  kinematics(m, W);
  FS_FOR(b, FS_NBODY) {
    float t[3], qi[4];
    qrotate(m.body_ipos[b], W.sm.xquat[b], t);
    for (int i = 0; i < 3; ++i) W.sm.xipos[b][i] = W.sm.xpos[b][i] + t[i];
    qmul(W.sm.xquat[b], m.body_iquat[b], qi);
    qmat(qi, W.sm.ximat[b]);
    for (int i = 0; i < 3; ++i) W.sm.sub_mpos[b][i] = W.sm.xipos[b][i] * m.body_mass[b];
  }
  FS_FOR(g, FS_NGEOM) geom_frame(m, W, g);
  FS_SYNC();
  FS_FOR(i, 3) {  // one lane per component, children before their parent
    for (int b = FS_NBODY - 1; b > 0; --b) {
      int p = c_model.body_parent[b];
      W.sm.sub_mpos[p][i] = W.sm.sub_mpos[p][i] + W.sm.sub_mpos[b][i];
    }
  }
  FS_SYNC();
  FS_FOR(e, FS_NBODY * 3) {
    int b = e / 3, i = e - 3 * b;
    W.kin.com[b][i] = W.sm.sub_mpos[b][i] * m.subtree_inv_mass[b];
  }
  FS_SYNC();

  // spatial inertia about the root's subtree CoM; cdof
  FS_FOR(b, FS_NBODY) {
    const float* croot = W.kin.com[m.body_root[b]];
    const float* R = W.sm.ximat[b];
    const float* I3 = m.body_inertia[b];
    float c[3] = {W.sm.xipos[b][0] - croot[0], W.sm.xipos[b][1] - croot[1], W.sm.xipos[b][2] - croot[2]};
    float mb = m.body_mass[b];
    float cc = dot3(c, c);
    CInert& ci = W.sm.cin[b];
#define FS_ENT(a_, b_) \
  ((I3[0] * R[3 * (a_)] * R[3 * (b_)] + I3[1] * R[3 * (a_) + 1] * R[3 * (b_) + 1]) + \
   I3[2] * R[3 * (a_) + 2] * R[3 * (b_) + 2])
    ci.ul[0] = FS_ENT(0, 0) + mb * (cc - c[0] * c[0]);
    ci.ul[1] = FS_ENT(0, 1) - mb * (c[0] * c[1]);
    ci.ul[2] = FS_ENT(0, 2) - mb * (c[0] * c[2]);
    ci.ul[3] = FS_ENT(1, 1) + mb * (cc - c[1] * c[1]);
    ci.ul[4] = FS_ENT(1, 2) - mb * (c[1] * c[2]);
    ci.ul[5] = FS_ENT(2, 2) + mb * (cc - c[2] * c[2]);
#undef FS_ENT
    for (int i = 0; i < 3; ++i) ci.h[i] = c[i] * mb;
    ci.m = mb;
  }
  FS_FOR(j, FS_NJNT) {
    int b = m.jnt_body[j], adr = m.jnt_dadr[j], jt = m.jnt_type[j];
    const float* croot = W.kin.com[m.body_root[b]];
    if (jt == JNT_FREE) {
      for (int i = 0; i < 3; ++i)
        for (int k = 0; k < 6; ++k) W.kin.cdof[adr + i][k] = (k == 3 + i) ? 1.0f : 0.0f;
      float R[9], off[3];
      qmat(W.sm.xquat[b], R);
      for (int i = 0; i < 3; ++i) off[i] = croot[i] - W.sm.xpos[b][i];
      for (int i = 0; i < 3; ++i) {
        float axc[3] = {R[i], R[3 + i], R[6 + i]};
        float cr[3];
        cross3(axc, off, cr);
        for (int k = 0; k < 3; ++k) {
          W.kin.cdof[adr + 3 + i][k] = axc[k];
          W.kin.cdof[adr + 3 + i][3 + k] = cr[k];
        }
      }
    } else if (jt == JNT_SLIDE) {
      for (int k = 0; k < 3; ++k) {
        W.kin.cdof[adr][k] = 0.0f;
        W.kin.cdof[adr][3 + k] = W.sm.xaxis[j][k];
      }
    } else {
      float off[3], cr[3];
      for (int i = 0; i < 3; ++i) off[i] = croot[i] - W.sm.xanchor[j][i];
      cross3(W.sm.xaxis[j], off, cr);
      for (int k = 0; k < 3; ++k) {
        W.kin.cdof[adr][k] = W.sm.xaxis[j][k];
        W.kin.cdof[adr][3 + k] = cr[k];
      }
    }
  }
  FS_SYNC();

  // _com_vel: cvel, cdof_dot, level by level
  for (int l = 0; l < FS_NLEVEL; ++l) {
    int o = c_model.level_off[l];
    FS_FOR(t, c_model.level_off[l + 1] - o) {
      int b = m.body_order[o + t];
      float vel[6];
      for (int k = 0; k < 6; ++k) vel[k] = W.sm.cvel[m.body_parent[b]][k];
      int j = m.body_jnt[b];
      if (j >= 0) {
        int adr = m.jnt_dadr[j];
        if (m.jnt_type[j] == JNT_FREE) {
          for (int i = 0; i < 3; ++i)
            for (int k = 0; k < 6; ++k) W.sm.cdof_dot[adr + i][k] = 0.0f;
          for (int i = 0; i < 3; ++i)
            for (int k = 0; k < 6; ++k) vel[k] = vel[k] + W.kin.cdof[adr + i][k] * W.v[adr + i];
          for (int i = 3; i < 6; ++i)
            motion_cross(vel, W.kin.cdof[adr + i], W.sm.cdof_dot[adr + i]);
          for (int i = 3; i < 6; ++i)
            for (int k = 0; k < 6; ++k) vel[k] = vel[k] + W.kin.cdof[adr + i][k] * W.v[adr + i];
        } else {
          motion_cross(vel, W.kin.cdof[adr], W.sm.cdof_dot[adr]);
          for (int k = 0; k < 6; ++k) vel[k] = vel[k] + W.kin.cdof[adr][k] * W.v[adr];
        }
      }
      for (int k = 0; k < 6; ++k) W.sm.cvel[b][k] = vel[k];
    }
    FS_SYNC();
  }

  // _crb: composite inertias (one lane per component, children before
  // their parent); _actuator_force (one lane per dof, its motors in order)
  FS_FOR(k, 10) {
    for (int b = 0; b < FS_NBODY; ++b)
      cin_comp(W.sm.crb[b], k) = (k < 9) ? cin_comp(W.sm.cin[b], k) : c_model.subtree_mass[b];
    if (k < 9) {
      for (int b = FS_NBODY - 1; b > 0; --b) {
        int p = c_model.body_parent[b];
        cin_comp(W.sm.crb[p], k) = cin_comp(W.sm.crb[p], k) + cin_comp(W.sm.crb[b], k);
      }
    }
  }
  FS_FOR(d, FS_NV) {
    float acc = 0.0f;
    for (int a = 0; a < FS_NU; ++a) {
      if (c_model.act_dof[a] != d) continue;
      float c = W.ctrl[a];
      if (m.act_ctrllimited[a]) c = fs_min(fs_max(c, m.act_ctrlrange[a][0]), m.act_ctrlrange[a][1]);
      float force = m.act_gain[a] * c;
      if (m.act_hasbias[a])
        force = force + (m.act_bias[a][0] + (m.act_bias[a][1] * W.q[m.act_qadr[a]] +
                                             m.act_bias[a][2] * W.v[d]));
      if (m.act_forcelimited[a])
        force = fs_min(fs_max(force, m.act_forcerange[a][0]), m.act_forcerange[a][1]);
      force = m.act_gear[a] * force;
      acc = acc + force;
    }
    W.sm.qfrc_act[d] = acc;
  }
  FS_SYNC();
  // M on the tree pattern (+ armature), one lane per entry
  FS_FOR(i, FS_NV) cinert_vec(W.sm.crb[m.dof_body[i]], W.kin.cdof[i], W.sm.crbf[i]);
  FS_SYNC();
  FS_FOR(e, FS_TRI(FS_NV)) {
    int i, j;
    tri_ij(e, i, j);
    if (i == j) W.M[e] = dot6(W.kin.cdof[i], W.sm.crbf[i]) + m.dof_armature[i];
    else W.M[e] = dof_bit(dof_mask(W.anc[0][i]), j) ? dot6(W.kin.cdof[j], W.sm.crbf[i]) : 0.0f;
  }

  // _rne_bias: cacc level by level, cfrc per body, summed up the tree
  for (int l = 0; l < FS_NLEVEL; ++l) {
    int o = c_model.level_off[l];
    FS_FOR(t, c_model.level_off[l + 1] - o) {
      int b = m.body_order[o + t];
      float a6[6];
      for (int k = 0; k < 6; ++k) a6[k] = W.sm.cacc[m.body_parent[b]][k];
      int j = m.body_jnt[b];
      if (j >= 0) {
        int adr = m.jnt_dadr[j];
        int nd = (m.jnt_type[j] == JNT_FREE) ? 6 : 1;
        for (int i = 0; i < nd; ++i)
          for (int k = 0; k < 6; ++k) a6[k] = a6[k] + W.sm.cdof_dot[adr + i][k] * W.v[adr + i];
      }
      for (int k = 0; k < 6; ++k) W.sm.cacc[b][k] = a6[k];
    }
    FS_SYNC();
  }
  FS_FOR(b, FS_NBODY) {
    float iv[6], ia[6], fx[6];
    cinert_vec(W.sm.cin[b], W.sm.cvel[b], iv);
    cinert_vec(W.sm.cin[b], W.sm.cacc[b], ia);
    force_cross(W.sm.cvel[b], iv, fx);
    for (int k = 0; k < 6; ++k) W.sm.cfrc[b][k] = ia[k] + fx[k];
  }
  FS_SYNC();
  FS_FOR(k, 6) {
    for (int b = FS_NBODY - 1; b > 0; --b) {
      int p = c_model.body_parent[b];
      W.sm.cfrc[p][k] = W.sm.cfrc[p][k] + W.sm.cfrc[b][k];
    }
  }
  FS_SYNC();

  // smooth acceleration; the derived reward inputs, from this
  // (pre-integration) forward pass: the last reads of the phase sm
  FS_FOR(d, FS_NV) {
    float bias = dot6(W.kin.cdof[d], W.sm.cfrc[m.dof_body[d]]);
    W.qsm[d] = ((-m.dof_damping[d]) * W.v[d] + W.sm.qfrc_act[d]) - bias;
  }
  FS_FOR(e, FS_TRI(FS_NV)) W.H[e] = W.M[e];
  FS_FOR(i, 16) {
    int tb = c_model.torso;
    der[i] = (i < 3) ? W.sm.xpos[tb][i]
           : (i < 7) ? W.sm.xquat[tb][i - 3]
           : (i < 13) ? W.sm.cvel[tb][i - 7]
                      : W.kin.com[c_model.torso_root][i - 13];
  }
#if FS_WANT_SITES
  FS_FOR(s, FS_NSITE) {
    float t[3];
    int b = m.site_body[s];
    qrotate(m.site_pos[s], W.sm.xquat[b], t);
    for (int i = 0; i < 3; ++i) der[16 + 3 * s + i] = W.sm.xpos[b][i] + t[i];
  }
#endif
#if FS_WANT_QFRC
  FS_FOR(d, FS_NV) der[16 + 3 * FS_NSITE * FS_WANT_SITES + d] = W.sm.qfrc_act[d];
#endif
  FS_SYNC();
  ldl_factor(T, 0, W.anc[0], W.H, W.dinv);
  ldl_solve(W.anc[0], W.H, W.dinv, W.qsm);

  // _constraint_rows: the contact slots (lanes take them grouped by kind),
  // then each row's aref, D and active on its own lane (FS_ROWS), and the
  // friction-loss and limit rows' J
  FS_FOR(t, FS_NSLOT) contact_slot(m, W, m.slot_order[t]);
  FS_SYNC();
  RowRegs rows;
  for (int i = 0; i < (FS_DIM(FS_RR) + 31) / 32; ++i) rows.active[i] = 0u;
  FS_ROWS(k, r) {
    float aref, D;
    bool act;
    if (r < FS_NFL) {
      aref = m.fl_negb[r] * W.v[m.fl_dof[r]];
      D = m.fl_D[r];
      act = true;
      W.jl[2 * r + 1] = 1.0f;
    } else if (r < FS_NFL + FS_NLIM) {
      int l = r - FS_NFL;
      float sign = m.lim_sign[l];
      float dist = sign * (W.q[m.lim_qadr[l]] - m.lim_bound[l]);
      float vel = sign * W.v[m.lim_dadr[l]];
      aref_d(m.lim_imp[l], m.lim_invweight[l], dist, m.lim_margin[l], vel, &aref, &D);
      act = dist < m.lim_margin[l];
      W.jl[2 * r + 1] = sign;
    } else {
      int c = r - FS_NFL - FS_NLIM, s = m.crow_slot[c];
      aref_d(m.slot_imp[s], m.crow_diag[c], W.rw.sdist[s], m.slot_margin[s], W.rw.t1[r], &aref,
             &D);
      act = W.rw.sdist[s] < m.slot_margin[s];
    }
    rows.aref[k] = aref;
    rows.D[k] = D;
    if (act) rows.active[k >> 5] |= 1u << (k & 31);
  }
  FS_SYNC();

  newton(m, T, W, rows);

  // integration; the optional implicit-damping re-solve (mj_Euler) solves
  // (M + dt diag(damping)) qacc_int = M qacc_smooth + qfrc_constraint
#if FS_IMPLICIT
  FS_FOR(e, FS_TRI(FS_NV)) {
    int i, j;
    tri_ij(e, i, j);
    float h = W.M[e];
    if (i == j && m.dof_damp_dt[i] != 0.0f) h = h + m.dof_damp_dt[i];
    W.H[e] = h;
  }
  m_vec(W, W.M, W.qsm, W.sol.tm);
  FS_SYNC();
  FS_FOR(d, FS_NV) W.sol.qacc_int[d] = W.sol.tm[d] + W.sol.qfrc_con[d];
  FS_SYNC();
  ldl_factor(T, 0, W.anc[0], W.H, W.dinv);
  ldl_solve(W.anc[0], W.H, W.dinv, W.sol.qacc_int);
#else
  FS_FOR(d, FS_NV) W.sol.qacc_int[d] = W.sol.qacc[d];
  FS_SYNC();
#endif

  FS_FOR(d, FS_NV) W.v[d] = W.v[d] + dt * W.sol.qacc_int[d];
  FS_SYNC();
  FS_FOR(j, FS_NJNT) {
    int qa = m.jnt_qadr[j], da = m.jnt_dadr[j];
    if (m.jnt_type[j] == JNT_FREE) {
      for (int i = 0; i < 3; ++i) W.q[qa + i] = W.q[qa + i] + dt * W.v[da + i];
      // mju_quatIntegrate, with the small-angle branch of the plain version
      const float* w3 = W.v + da + 3;
      float wn2 = w3[0] * w3[0] + w3[1] * w3[1] + w3[2] * w3[2];
      float theta = sqrtf(fs_max(wn2, 1e-30f)) * dt;
      float half = 0.5f * theta;
      float sin_over = (theta < 1e-9f) ? 0.5f : sinf(half) / fs_max(theta, 1e-30f);
      float s = dt * sin_over;
      float dq[4] = {cosf(half), w3[0] * s, w3[1] * s, w3[2] * s};
      float qn[4];
      qmul(W.q + qa + 3, dq, qn);
      qnormalize(qn);
      for (int i = 0; i < 4; ++i) W.q[qa + 3 + i] = qn[i];
    } else {
      W.q[qa] = W.q[qa] + dt * W.v[da];
    }
  }
  // the warmstart output is the solver's qacc (not the damped qacc_int)
  FS_FOR(d, FS_NV) W.w[d] = W.sol.qacc[d];
  FS_SYNC();
}

FS_DEVICE void step_sample(const FusedModel& m, const FusedTables& T, Work& W, int b,
                           int n_substeps, const float* qpos, const float* qvel,
                           const float* ws, const float* ctrl, float* oq, float* ov,
                           float* ow, float* od) {
  FS_FOR(i, FS_NQ) W.q[i] = qpos[(size_t)b * FS_NQ + i];
  FS_FOR(i, FS_NV) W.v[i] = qvel[(size_t)b * FS_NV + i];
  FS_FOR(i, FS_NV) W.w[i] = ws[(size_t)b * FS_NV + i];
  FS_FOR(i, FS_NU) W.ctrl[i] = ctrl[(size_t)b * FS_NU + i];
  FS_FOR(e, FS_NV * FS_NW) {
    W.anc[0][e / FS_NW][e % FS_NW] = m.anc_strict[e / FS_NW][e % FS_NW];
    W.anc[1][e / FS_NW][e % FS_NW] = m.anc_solver[e / FS_NW][e % FS_NW];
  }
  FS_FOR(c, FS_NCROW) W.rinfo[c] = T.crow_info[c];
  FS_FOR(e, FS_NSLOT * FS_MAXD) W.sdof[e] = (unsigned char)m.slot_dof[e / FS_MAXD][e % FS_MAXD];
  FS_SYNC();
  for (int s = 0; s < n_substeps; ++s) substep(m, T, W, od + (size_t)b * FS_ND);
  FS_FOR(i, FS_NQ) oq[(size_t)b * FS_NQ + i] = W.q[i];
  FS_FOR(i, FS_NV) ov[(size_t)b * FS_NV + i] = W.v[i];
  FS_FOR(i, FS_NV) ow[(size_t)b * FS_NV + i] = W.w[i];
}

#define FS_THREADS (32 * FS_SPB)
#define FS_SMEM ((size_t)FS_SPB * sizeof(Work))

#ifdef __CUDACC__
// one warp per sample, FS_SPB samples per block, each warp's Work in the
// block's dynamic shared memory.  128 registers a thread is the most at
// which each of an SM's 4 register sub-partitions (16K) holds 4 warps, 16
// an SM.  The launch bound asks for FS_MIN_BLOCKS blocks an SM: as many as
// the SM holds at 128 registers (fused_cuda.py pack_model: 16 warps, 15 at
// 3 a block, or fewer where shared memory holds fewer).  So ptxas keeps a
// build whose shared memory holds 16 samples an SM within 128 registers
// (asked for one block an SM, it gave H1's build 149 at 4 samples a block:
// 12 an SM, not 16), and leaves a build that its shared memory holds to
// fewer the registers those blocks allow.  With the thread count alone it
// held some builds at 80-96 registers and spilled.
__global__ void __launch_bounds__(FS_THREADS, FS_MIN_BLOCKS)
fused_step_kernel(const FusedModel* __restrict__ gm, const FusedTables* __restrict__ gt,
                  int batch, int n_substeps, const float* __restrict__ qpos,
                  const float* __restrict__ qvel, const float* __restrict__ ws,
                  const float* __restrict__ ctrl, float* __restrict__ oq,
                  float* __restrict__ ov, float* __restrict__ ow, float* __restrict__ od) {
  extern __shared__ __align__(16) unsigned char fs_smem[];
  int warp = (int)(threadIdx.x >> 5);
  int b = blockIdx.x * FS_SPB + warp;
  if (b >= batch) return;  // the last block's spare warps
  Work& W = reinterpret_cast<Work*>(fs_smem)[warp];
  step_sample(*gm, *gt, W, b, n_substeps, qpos, qvel, ws, ctrl, oq, ov, ow, od);
}

// Both uploads return once the device holds the data.  A copy from pageable
// memory on the legacy default stream may return before its DMA lands, and
// PyTorch's streams are created non-blocking, so they do not wait for it: a
// first launch on such a stream (a captured unit's eager first call) could
// read the model before it is there.
extern "C" int fused_step_upload(const void* model, size_t nbytes) {
  if (nbytes != sizeof(FusedModel)) return -1;
  cudaError_t e = cudaMemcpyToSymbol(c_model, model, nbytes);
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_model, model, nbytes);
  if (e == cudaSuccess && FS_SMEM > 48 * 1024)
    e = cudaFuncSetAttribute(fused_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)FS_SMEM);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

extern "C" int fused_tables_upload(const void* tables, size_t nbytes) {
  if (nbytes != sizeof(FusedTables)) return -1;
  cudaError_t e = cudaMemcpyToSymbol(g_tables, tables, nbytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

// out: bytes per sample, samples per block, resident blocks per SM
extern "C" int fused_launch_info(int* out) {
  out[0] = (int)sizeof(Work);
  out[1] = FS_SPB;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], fused_step_kernel,
                                                            FS_THREADS, FS_SMEM);
}

// out: the device addresses of the global FusedModel and FusedTables, looked
// up once after the upload (a launch then calls no runtime function but the
// launch itself, so it can be captured in a CUDA graph).
extern "C" int fused_symbols(void** out) {
  cudaError_t e = cudaGetSymbolAddress(&out[0], g_model);
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&out[1], g_tables);
  return (int)e;
}

// Launches on `stream` and returns cudaGetLastError(): 0 when the launch
// was accepted.  Faults during the run surface at the next synchronize.
// gm, gt: fused_symbols' addresses.
extern "C" int fused_step_launch(int batch, int n_substeps, const void* gm, const void* gt,
                                 const float* qpos, const float* qvel, const float* ws,
                                 const float* ctrl, float* oq, float* ov, float* ow, float* od,
                                 void* stream) {
  if (batch <= 0) return 0;
  int blocks = (batch + FS_SPB - 1) / FS_SPB;
  fused_step_kernel<<<blocks, FS_THREADS, FS_SMEM, (cudaStream_t)stream>>>(
      (const FusedModel*)gm, (const FusedTables*)gt, batch, n_substeps, qpos, qvel, ws, ctrl,
      oq, ov, ow, od);
  return (int)cudaGetLastError();
}
#else
extern "C" int fused_step_upload(const void* model, size_t nbytes) {
  if (nbytes != sizeof(FusedModel)) return -1;
  memcpy(&c_model, model, nbytes);
  memcpy(&g_model, model, nbytes);
  return 0;
}

extern "C" int fused_tables_upload(const void* tables, size_t nbytes) {
  if (nbytes != sizeof(FusedTables)) return -1;
  memcpy(&g_tables, tables, nbytes);
  return 0;
}

extern "C" int fused_launch_info(int* out) {
  out[0] = (int)sizeof(Work);
  out[1] = FS_SPB;
  out[2] = 1;
  return 0;
}

// Host build only: the contact geometry of every slot at each sample's
// qpos, out (batch, FS_NSLOT, 13) = dist, pos, n, t1, t2.  The CPU tests
// hold it against the plain version's _contact_geometry kind by kind.
// Returns -1, and writes nothing, when the caller's widths are not the
// build's.
extern "C" int fused_contacts(int batch, int nq, int nslot, const float* qpos, float* out) {
  if (nq != FS_NQ || nslot != FS_NSLOT) return -1;
  Work* W = (Work*)calloc(1, sizeof(Work));
  if (!W) return -2;
  for (int b = 0; b < batch; ++b) {
    for (int i = 0; i < FS_NQ; ++i) W->q[i] = qpos[(size_t)b * FS_NQ + i];
    init_world(*W);
    kinematics(g_model, *W);
    for (int g = 0; g < FS_NGEOM; ++g) geom_frame(g_model, *W, g);
    for (int s = 0; s < FS_NSLOT; ++s) {
      float* o = out + ((size_t)b * FS_NSLOT + s) * 13;
      o[0] = contact_geometry(g_model, s, W->kin.gpos, W->kin.gmat, o + 1, o + 4, o + 7, o + 10);
    }
  }
  free(W);
  return 0;
}

extern "C" int fused_symbols(void** out) {
  out[0] = (void*)&g_model;
  out[1] = (void*)&g_tables;
  return 0;
}

// The host build runs the samples one after another, each through the same
// lane sections with one lane taking every index.  Each sample's Work starts
// as all-ones bytes (a NaN in every float), as a card's shared memory holds
// what the last kernel left: a read of a byte not written in the launch
// shows as a non-finite output.
extern "C" int fused_step_launch(int batch, int n_substeps, const void* gm, const void* gt,
                                 const float* qpos, const float* qvel, const float* ws,
                                 const float* ctrl, float* oq, float* ov, float* ow, float* od,
                                 void* stream) {
  (void)stream;
  Work* W = (Work*)malloc(sizeof(Work));
  if (!W) return -2;
  for (int b = 0; b < batch; ++b) {
    memset(W, 0xff, sizeof(Work));
    step_sample(*(const FusedModel*)gm, *(const FusedTables*)gt, *W, b, n_substeps, qpos, qvel,
                ws, ctrl, oq, ov, ow, od);
  }
  free(W);
  return 0;
}
#endif

extern "C" size_t fused_model_nbytes(void) { return sizeof(FusedModel); }
extern "C" size_t fused_tables_nbytes(void) { return sizeof(FusedTables); }
