// fused_step.cu — the physics substep chain of DIAL-MPC's rollouts, as one
// CUDA kernel for Hopper (sm_90a).
//
// Replaces: tpu_dialmpc/dynamics/fused.py:build_fused_step (its inner Pallas
// `kernel`), the JAX package's only TPU kernel.  The plain PyTorch version of
// the same function is tpu_dialmpc_torch/dynamics/fused.py; the wrapper that
// builds, uploads and launches this file is dynamics/fused_cuda.py.
//
// What it computes, per sample: n_substeps x (forward kinematics, CoM
// frames, CRB mass matrix, RNE bias, actuation, LDL^T smooth acceleration,
// contact rows of the six pair kinds (plane-sphere, plane-capsule,
// plane-box, sphere-box, capsule-box, box-box; condim 1 or 3 pyramidal) +
// joint-limit + friction-loss rows, truncated Newton solve with an exact
// 1-D Newton line search, optional implicit joint damping, semi-implicit
// Euler with quaternion integration), then writes (qpos', qvel',
// warmstart' = the solver's qacc, derived reward inputs).  Geoms on bodies
// without dofs (the floor, a mocap crate) have a constant pose: the plain
// version folds their math into constants in double precision, so the
// host packs those values (pose, a box's corners, a plane's contact frame)
// precomputed in double and rounded once, and the kernel reads them.
//
// What bounds it on this card: arithmetic per sample and the per-thread
// registers and local memory that hold its state — about 31k scalar ops per
// substep on Go2 (README: 31,173 arithmetic eqns per substep in the JAX
// graph) against 80 + 19 + 18 + 18 + 12 floats of input and output per
// sample.  Bytes to and from device memory are negligible; the working set
// (mass matrix, Hessian, constraint rows, tree quantities: a few KB per
// sample) is not.  It grows with the contact rows and the dofs: 52 rows and
// an 11.6 KB stack frame on the flat Go2 scene (4 slots), 244 rows and a
// 29.2 KB frame on the Go2 crate scene (52 slots of six kinds), 234 rows
// and a 37.4 KB frame on the H1 push-crate scene (44 slots, nv=26), at 255
// registers each.
//
// A slot's two bodies may both carry dofs, of different kinematic trees (a
// robot and a crate on its own slide joint): each side's point Jacobian is
// taken about its own root's subtree CoM under its own dof mask, and the
// rows' cliques join the two trees' dofs in the Newton Hessian, whose
// pattern (anc_solver) then holds LDL fill-in outside the mass matrix's;
// those entries start at 0.
//
// Contact slots run one after another in a loop with a branch per kind;
// capsule-box's slot 1 repeats slot 0's four projection sweeps (the JAX
// graph's CSE merges them; here each slot computes its own, the same
// values).
//
// What the design does about it (a first, simple version):
// - one thread per sample, the n_substeps loop inside the thread, so a
//   sample's state never leaves the thread between substeps;
// - model constants (tree, joint axes, inertias, contact-slot and row
//   parameters, ancestor patterns as bitmasks) live in one __constant__
//   struct uploaded once: every thread of a warp reads the same address, so
//   constant-cache reads broadcast;
// - sizes are compile-time (-D FS_*), so loops over dofs have fixed bounds;
// - M and the Newton Hessian H are dense lower triangles (171 floats at
//   nv=18), factored in the tree-sparse elimination order with the pattern
//   masks, so their values equal the sparse factor's;
// - 32 threads per block, so the 2049 samples of a rollout spread over 65
//   SMs: at this batch the card is latency-bound, not occupancy-bound;
// - the build passes -fmad=false: each product and sum rounds on its own,
//   like the plain version's separate elementwise ops, so the check on the
//   card can hold the two close.  Letting nvcc contract to FMA is a later,
//   measured change.
// The operation order follows the plain version (and the JAX graph) step by
// step; the comments name the Python function each block mirrors.
//
// The same source builds as plain C++ for the host (g++ -x c++), where
// fused_step_launch loops over the samples: the CPU tests use that build to
// check this file's arithmetic against the plain version without a card.

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define FS_DEVICE __device__ __forceinline__
#define FS_CONSTANT __constant__
#else
#define FS_DEVICE static inline
#define FS_CONSTANT static
static inline float rsqrtf(float x) { return 1.0f / sqrtf(x); }
#endif

// ---- sizes, from the model (see fused_cuda.py: kernel_defines) ----
#if !defined(FS_NQ) || !defined(FS_NV) || !defined(FS_NU) || !defined(FS_NBODY) || \
    !defined(FS_NJNT) || !defined(FS_NGEOM) || !defined(FS_NSITE) ||               \
    !defined(FS_NSLOT) || !defined(FS_NCROW) || !defined(FS_NLIM) ||               \
    !defined(FS_NFL) || !defined(FS_MAXD) || !defined(FS_ND) ||                    \
    !defined(FS_IMPLICIT) || !defined(FS_WANT_SITES) || !defined(FS_WANT_QFRC)
#error "fused_step.cu needs the FS_* size definitions"
#endif

#define FS_DIM(n) ((n) > 0 ? (n) : 1)
#define FS_NROW (FS_NFL + FS_NLIM + FS_NCROW)
#define FS_TRI(n) ((n) * ((n) + 1) / 2)
#define FS_IDX(i, j) ((i) * ((i) + 1) / 2 + (j))  // lower triangle, j <= i

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
  uint32_t anc_strict[FS_NV], anc_solver[FS_NV];
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
  uint32_t slot_body1_dofs[FS_DIM(FS_NSLOT)], slot_body2_dofs[FS_DIM(FS_NSLOT)];
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
};

FS_CONSTANT FusedModel c_model;

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

// ---- dense-storage LDL^T in the tree-sparse order (fused.py ldl_factor /
// ldl_solve).  anc[k] bit j marks pattern entry (k, j), j < k.  A is
// overwritten by L (strict lower part); dinv gets 1 / D.
FS_DEVICE void ldl_factor(float* A, const uint32_t* anc, float* dinv) {
  for (int k = FS_NV - 1; k >= 0; --k) {
    float dk = 1.0f / A[FS_IDX(k, k)];
    dinv[k] = dk;
    uint32_t ak = anc[k];
    for (int i = 0; i < k; ++i) {
      if (!((ak >> i) & 1u)) continue;
      float lki = A[FS_IDX(k, i)] * dk;
      for (int j = 0; j <= i; ++j) {
        if (!((ak >> j) & 1u)) continue;
        A[FS_IDX(i, j)] = A[FS_IDX(i, j)] - lki * A[FS_IDX(k, j)];
      }
    }
    for (int j = 0; j < k; ++j)
      if ((ak >> j) & 1u) A[FS_IDX(k, j)] = A[FS_IDX(k, j)] * dk;
  }
}
FS_DEVICE void ldl_solve(const float* L, const uint32_t* anc, const float* dinv, float* x) {
  for (int k = FS_NV - 1; k >= 0; --k)
    for (int j = 0; j < k; ++j)
      if ((anc[k] >> j) & 1u) x[j] = x[j] - L[FS_IDX(k, j)] * x[k];
  for (int k = 0; k < FS_NV; ++k) x[k] = x[k] * dinv[k];
  for (int k = 0; k < FS_NV; ++k)
    for (int j = 0; j < k; ++j)
      if ((anc[k] >> j) & 1u) x[k] = x[k] - L[FS_IDX(k, j)] * x[j];
}
// symmetric matvec over the mass-matrix pattern, in m_keys order (fused.py m_vec)
FS_DEVICE void m_vec(const float* M, const float* x, float* out) {
  for (int i = 0; i < FS_NV; ++i) out[i] = 0.0f;
  for (int i = 0; i < FS_NV; ++i) {
    uint32_t ai = c_model.anc_strict[i];
    for (int j = 0; j < i; ++j) {
      if (!((ai >> j) & 1u)) continue;
      float mij = M[FS_IDX(i, j)];
      out[i] = out[i] + mij * x[j];
      out[j] = out[j] + mij * x[i];
    }
    out[i] = out[i] + M[FS_IDX(i, i)] * x[i];
  }
}

// ---- forward kinematics of the bodies (fused.py _fk, its first loop) ----
FS_DEVICE void body_frames(const float* q, float (*xpos)[3], float (*xquat)[4],
                           float (*xanchor)[3], float (*xaxis)[3]) {
  const FusedModel& m = c_model;
  xpos[0][0] = xpos[0][1] = xpos[0][2] = 0.0f;
  xquat[0][0] = 1.0f; xquat[0][1] = xquat[0][2] = xquat[0][3] = 0.0f;
  for (int b = 1; b < FS_NBODY; ++b) {
    int p = m.body_parent[b];
    float t[3], pos[3], quat[4];
    qrotate(m.body_pos[b], xquat[p], t);
    for (int i = 0; i < 3; ++i) pos[i] = xpos[p][i] + t[i];
    qmul(xquat[p], m.body_quat[b], quat);
    int j = m.body_jnt[b];
    if (j >= 0) {
      int qa = m.jnt_qadr[j];
      const float* ax = m.jnt_axis[j];
      const float* jp = m.jnt_pos[j];
      int jt = m.jnt_type[j];
      if (jt == JNT_FREE) {
        for (int i = 0; i < 3; ++i) pos[i] = q[qa + i];
        for (int i = 0; i < 4; ++i) quat[i] = q[qa + 3 + i];
        qnormalize(quat);
        for (int i = 0; i < 3; ++i) { xanchor[j][i] = pos[i]; xaxis[j][i] = ax[i]; }
      } else if (jt == JNT_SLIDE) {
        float aw[3], t2[3];
        qrotate(ax, quat, aw);
        qrotate(jp, quat, t2);
        float trans = q[qa] - m.qpos0[qa];
        for (int i = 0; i < 3; ++i) {
          xanchor[j][i] = pos[i] + t2[i];
          pos[i] = pos[i] + aw[i] * trans;
          xaxis[j][i] = aw[i];
        }
      } else {  // hinge
        float anchor[3], t2[3];
        qrotate(jp, quat, t2);
        for (int i = 0; i < 3; ++i) anchor[i] = pos[i] + t2[i];
        float half = 0.5f * (q[qa] - m.qpos0[qa]);
        float sh = sinf(half);
        float qloc[4] = {cosf(half), ax[0] * sh, ax[1] * sh, ax[2] * sh};
        float nq[4];
        qmul(quat, qloc, nq);
        for (int i = 0; i < 4; ++i) quat[i] = nq[i];
        qrotate(jp, quat, t2);
        for (int i = 0; i < 3; ++i) {
          pos[i] = anchor[i] - t2[i];
          xanchor[j][i] = anchor[i];
        }
        qrotate(ax, quat, xaxis[j]);
      }
    }
    for (int i = 0; i < 3; ++i) xpos[b][i] = pos[i];
    for (int i = 0; i < 4; ++i) xquat[b][i] = quat[i];
  }
}

// world pose of every collidable geom; a static geom's is the host's
FS_DEVICE void geom_frames(const float (*xpos)[3], const float (*xquat)[4], float (*gpos)[3],
                           float (*gmat)[9]) {
  const FusedModel& m = c_model;
  for (int g = 0; g < FS_NGEOM; ++g) {
    if (m.geom_static[g]) {
      for (int i = 0; i < 3; ++i) gpos[g][i] = m.geom_sxpos[g][i];
      for (int i = 0; i < 9; ++i) gmat[g][i] = m.geom_sxmat[g][i];
      continue;
    }
    int b = m.geom_body[g];
    float t[3], gq[4];
    qrotate(m.geom_pos[g], xquat[b], t);
    for (int i = 0; i < 3; ++i) gpos[g][i] = xpos[b][i] + t[i];
    qmul(xquat[b], m.geom_quat[g], gq);
    qmat(gq, gmat[g]);
  }
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
FS_DEVICE float contact_geometry(int s, const float (*gpos)[3], const float (*gmat)[9],
                                 float* pos, float* n, float* t1, float* t2) {
  const FusedModel& m = c_model;
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

// Constraint rows: r in [0, NFL) friction loss, [NFL, NFL+NLIM) limits,
// [NFL+NLIM, NROW) contacts.  Contact rows keep their Jacobian on the
// slot's dof list; friction-loss and limit rows are one dof with J = 1 or
// the limit's sign.
struct Rows {
  float J[FS_DIM(FS_NCROW)][FS_DIM(FS_MAXD)];
  float aref[FS_DIM(FS_NROW)], D[FS_DIM(FS_NROW)];
  bool active[FS_DIM(FS_NROW)];
};

FS_DEVICE float row_dot(const Rows& R, int r, const float* a) {
  if (r < FS_NFL) return a[c_model.fl_dof[r]];
  if (r < FS_NFL + FS_NLIM) {
    int l = r - FS_NFL;
    return c_model.lim_sign[l] * a[c_model.lim_dadr[l]];
  }
  int c = r - FS_NFL - FS_NLIM;
  int s = c_model.crow_slot[c];
  float acc = 0.0f;
  for (int k = 0; k < c_model.slot_ndof[s]; ++k) acc = acc + R.J[c][k] * a[c_model.slot_dof[s][k]];
  return acc;
}

// per-row cost, dcost, hcost (fused.py _s_terms)
FS_DEVICE void s_terms(const Rows& R, int r, float x, float* cost, float* dc, float* hc) {
  if (r < FS_NFL) {  // Huber friction-loss row, always active
    float D = c_model.fl_D[r], fl = c_model.fl_floss[r];
    float ax = fabsf(x);
    bool quad = ax <= c_model.fl_knee[r];
    *cost = quad ? 0.5f * (D * (x * x)) : fl * ax - c_model.fl_lin0[r];
    *dc = quad ? D * x : fl * fs_sign(x);
    *hc = quad ? D : 0.0f;
    return;
  }
  bool act = R.active[r] && (x < 0.0f);
  float D = R.D[r];
  *cost = act ? 0.5f * (D * (x * x)) : 0.0f;
  *dc = act ? D * x : 0.0f;
  *hc = act ? D : 0.0f;
}

FS_DEVICE float total_cost(const Rows& R, const float* M, const float* qsm, const float* a) {
  float da[FS_NV], mda[FS_NV];
  for (int i = 0; i < FS_NV; ++i) da[i] = a[i] - qsm[i];
  m_vec(M, da, mda);
  float g = 0.0f;
  for (int i = 0; i < FS_NV; ++i) g = g + da[i] * mda[i];
  float c = 0.5f * g;
  for (int r = 0; r < FS_NROW; ++r) {
    float cost, dc, hc;
    s_terms(R, r, row_dot(R, r, a) - R.aref[r], &cost, &dc, &hc);
    c = c + cost;
  }
  return c;
}

// H += hc * J_r^T J_r on the row's dofs (fused.py _newton_solve H assembly)
FS_DEVICE void add_row_hessian(const Rows& R, int r, float hc, float* H) {
  if (r < FS_NFL) {
    int d = c_model.fl_dof[r];
    H[FS_IDX(d, d)] = H[FS_IDX(d, d)] + hc * (1.0f * 1.0f);
    return;
  }
  if (r < FS_NFL + FS_NLIM) {
    int l = r - FS_NFL;
    int d = c_model.lim_dadr[l];
    float s = c_model.lim_sign[l];
    H[FS_IDX(d, d)] = H[FS_IDX(d, d)] + hc * (s * s);
    return;
  }
  int c = r - FS_NFL - FS_NLIM;
  int s = c_model.crow_slot[c];
  int nd = c_model.slot_ndof[s];
  for (int ii = 0; ii < nd; ++ii) {
    int i = c_model.slot_dof[s][ii];
    for (int jj = 0; jj <= ii; ++jj) {
      int j = c_model.slot_dof[s][jj];
      H[FS_IDX(i, j)] = H[FS_IDX(i, j)] + hc * (R.J[c][ii] * R.J[c][jj]);
    }
  }
}
// out[d] += coef * J_r[d]  (sign = -1 for the constraint force)
FS_DEVICE void add_row_jt(const Rows& R, int r, float coef, float* out, bool subtract) {
  if (r < FS_NFL) {
    int d = c_model.fl_dof[r];
    out[d] = subtract ? out[d] - 1.0f * coef : out[d] + 1.0f * coef;
    return;
  }
  if (r < FS_NFL + FS_NLIM) {
    int l = r - FS_NFL;
    int d = c_model.lim_dadr[l];
    float t = c_model.lim_sign[l] * coef;
    out[d] = subtract ? out[d] - t : out[d] + t;
    return;
  }
  int c = r - FS_NFL - FS_NLIM;
  int s = c_model.crow_slot[c];
  for (int k = 0; k < c_model.slot_ndof[s]; ++k) {
    int d = c_model.slot_dof[s][k];
    float t = R.J[c][k] * coef;
    out[d] = subtract ? out[d] - t : out[d] + t;
  }
}

// ---- one substep for one sample (fused.py _substep) ----
FS_DEVICE void substep(float* q, float* v, float* w, const float* ctrl, float* der) {
  const FusedModel& m = c_model;
  const float dt = m.dt;

  // _fk: body frames
  float xpos[FS_NBODY][3], xquat[FS_NBODY][4];
  float xanchor[FS_NJNT][3], xaxis[FS_NJNT][3];
  body_frames(q, xpos, xquat, xanchor, xaxis);

  // inertial frames, subtree CoM
  float xipos[FS_NBODY][3], ximat[FS_NBODY][9], sub_mpos[FS_NBODY][3], com[FS_NBODY][3];
  for (int b = 0; b < FS_NBODY; ++b) {
    float t[3], qi[4];
    qrotate(m.body_ipos[b], xquat[b], t);
    for (int i = 0; i < 3; ++i) xipos[b][i] = xpos[b][i] + t[i];
    qmul(xquat[b], m.body_iquat[b], qi);
    qmat(qi, ximat[b]);
    for (int i = 0; i < 3; ++i) sub_mpos[b][i] = xipos[b][i] * m.body_mass[b];
  }
  for (int b = FS_NBODY - 1; b > 0; --b) {
    int p = m.body_parent[b];
    for (int i = 0; i < 3; ++i) sub_mpos[p][i] = sub_mpos[p][i] + sub_mpos[b][i];
  }
  for (int b = 0; b < FS_NBODY; ++b)
    for (int i = 0; i < 3; ++i) com[b][i] = sub_mpos[b][i] * m.subtree_inv_mass[b];

  // spatial inertia about the root's subtree CoM
  CInert cin[FS_NBODY];
  for (int b = 0; b < FS_NBODY; ++b) {
    const float* croot = com[m.body_root[b]];
    const float* R = ximat[b];
    const float* I3 = m.body_inertia[b];
    float c[3] = {xipos[b][0] - croot[0], xipos[b][1] - croot[1], xipos[b][2] - croot[2]};
    float mb = m.body_mass[b];
    float cc = dot3(c, c);
#define FS_ENT(a_, b_) \
  ((I3[0] * R[3 * (a_)] * R[3 * (b_)] + I3[1] * R[3 * (a_) + 1] * R[3 * (b_) + 1]) + \
   I3[2] * R[3 * (a_) + 2] * R[3 * (b_) + 2])
    cin[b].ul[0] = FS_ENT(0, 0) + mb * (cc - c[0] * c[0]);
    cin[b].ul[1] = FS_ENT(0, 1) - mb * (c[0] * c[1]);
    cin[b].ul[2] = FS_ENT(0, 2) - mb * (c[0] * c[2]);
    cin[b].ul[3] = FS_ENT(1, 1) + mb * (cc - c[1] * c[1]);
    cin[b].ul[4] = FS_ENT(1, 2) - mb * (c[1] * c[2]);
    cin[b].ul[5] = FS_ENT(2, 2) + mb * (cc - c[2] * c[2]);
#undef FS_ENT
    for (int i = 0; i < 3; ++i) cin[b].h[i] = c[i] * mb;
    cin[b].m = mb;
  }

  // cdof
  float cdof[FS_NV][6];
  for (int j = 0; j < FS_NJNT; ++j) {
    int b = m.jnt_body[j], adr = m.jnt_dadr[j], jt = m.jnt_type[j];
    const float* croot = com[m.body_root[b]];
    if (jt == JNT_FREE) {
      for (int i = 0; i < 3; ++i)
        for (int k = 0; k < 6; ++k) cdof[adr + i][k] = (k == 3 + i) ? 1.0f : 0.0f;
      float R[9], off[3];
      qmat(xquat[b], R);
      for (int i = 0; i < 3; ++i) off[i] = croot[i] - xpos[b][i];
      for (int i = 0; i < 3; ++i) {
        float axc[3] = {R[i], R[3 + i], R[6 + i]};
        float cr[3];
        cross3(axc, off, cr);
        for (int k = 0; k < 3; ++k) { cdof[adr + 3 + i][k] = axc[k]; cdof[adr + 3 + i][3 + k] = cr[k]; }
      }
    } else if (jt == JNT_SLIDE) {
      for (int k = 0; k < 3; ++k) { cdof[adr][k] = 0.0f; cdof[adr][3 + k] = xaxis[j][k]; }
    } else {
      float off[3], cr[3];
      for (int i = 0; i < 3; ++i) off[i] = croot[i] - xanchor[j][i];
      cross3(xaxis[j], off, cr);
      for (int k = 0; k < 3; ++k) { cdof[adr][k] = xaxis[j][k]; cdof[adr][3 + k] = cr[k]; }
    }
  }

  // _com_vel: cvel, cdof_dot
  float cvel[FS_NBODY][6], cdof_dot[FS_NV][6];
  for (int k = 0; k < 6; ++k) cvel[0][k] = 0.0f;
  for (int b = 1; b < FS_NBODY; ++b) {
    float vel[6];
    for (int k = 0; k < 6; ++k) vel[k] = cvel[m.body_parent[b]][k];
    int j = m.body_jnt[b];
    if (j >= 0) {
      int adr = m.jnt_dadr[j];
      if (m.jnt_type[j] == JNT_FREE) {
        for (int i = 0; i < 3; ++i)
          for (int k = 0; k < 6; ++k) cdof_dot[adr + i][k] = 0.0f;
        for (int i = 0; i < 3; ++i)
          for (int k = 0; k < 6; ++k) vel[k] = vel[k] + cdof[adr + i][k] * v[adr + i];
        for (int i = 3; i < 6; ++i) motion_cross(vel, cdof[adr + i], cdof_dot[adr + i]);
        for (int i = 3; i < 6; ++i)
          for (int k = 0; k < 6; ++k) vel[k] = vel[k] + cdof[adr + i][k] * v[adr + i];
      } else {
        motion_cross(vel, cdof[adr], cdof_dot[adr]);
        for (int k = 0; k < 6; ++k) vel[k] = vel[k] + cdof[adr][k] * v[adr];
      }
    }
    for (int k = 0; k < 6; ++k) cvel[b][k] = vel[k];
  }

  // _crb: composite inertias, M on the tree pattern (+ armature)
  float M[FS_TRI(FS_NV)];
  {
    CInert crb[FS_NBODY];
    for (int b = 0; b < FS_NBODY; ++b) crb[b] = cin[b];
    for (int b = FS_NBODY - 1; b > 0; --b) {
      int p = m.body_parent[b];
      for (int i = 0; i < 6; ++i) crb[p].ul[i] = crb[p].ul[i] + crb[b].ul[i];
      for (int i = 0; i < 3; ++i) crb[p].h[i] = crb[p].h[i] + crb[b].h[i];
    }
    for (int b = 0; b < FS_NBODY; ++b) crb[b].m = m.subtree_mass[b];
    for (int i = 0; i < FS_TRI(FS_NV); ++i) M[i] = 0.0f;
    for (int i = 0; i < FS_NV; ++i) {
      float f[6];
      cinert_vec(crb[m.dof_body[i]], cdof[i], f);
      for (int j = 0; j < i; ++j)
        if ((m.anc_strict[i] >> j) & 1u) M[FS_IDX(i, j)] = dot6(cdof[j], f);
      M[FS_IDX(i, i)] = dot6(cdof[i], f) + m.dof_armature[i];
    }
  }

  // _actuator_force
  float qfrc_act[FS_NV];
  for (int d = 0; d < FS_NV; ++d) qfrc_act[d] = 0.0f;
  for (int a = 0; a < FS_NU; ++a) {
    float c = ctrl[a];
    if (m.act_ctrllimited[a]) c = fs_min(fs_max(c, m.act_ctrlrange[a][0]), m.act_ctrlrange[a][1]);
    float force = m.act_gain[a] * c;
    if (m.act_hasbias[a])
      force = force + (m.act_bias[a][0] + (m.act_bias[a][1] * q[m.act_qadr[a]] +
                                           m.act_bias[a][2] * v[m.act_dof[a]]));
    if (m.act_forcelimited[a])
      force = fs_min(fs_max(force, m.act_forcerange[a][0]), m.act_forcerange[a][1]);
    force = m.act_gear[a] * force;
    int d = m.act_dof[a];
    qfrc_act[d] = qfrc_act[d] + force;
  }

  // _rne_bias
  float bias[FS_NV];
  {
    float cacc[FS_NBODY][6], cfrc[FS_NBODY][6];
    cacc[0][0] = cacc[0][1] = cacc[0][2] = 0.0f;
    for (int i = 0; i < 3; ++i) cacc[0][3 + i] = -m.gravity[i];
    for (int b = 1; b < FS_NBODY; ++b) {
      float a6[6];
      for (int k = 0; k < 6; ++k) a6[k] = cacc[m.body_parent[b]][k];
      int j = m.body_jnt[b];
      if (j >= 0) {
        int adr = m.jnt_dadr[j];
        int nd = (m.jnt_type[j] == JNT_FREE) ? 6 : 1;
        for (int i = 0; i < nd; ++i)
          for (int k = 0; k < 6; ++k) a6[k] = a6[k] + cdof_dot[adr + i][k] * v[adr + i];
      }
      for (int k = 0; k < 6; ++k) cacc[b][k] = a6[k];
    }
    for (int b = 0; b < FS_NBODY; ++b) {
      float iv[6], ia[6], fx[6];
      cinert_vec(cin[b], cvel[b], iv);
      cinert_vec(cin[b], cacc[b], ia);
      force_cross(cvel[b], iv, fx);
      for (int k = 0; k < 6; ++k) cfrc[b][k] = ia[k] + fx[k];
    }
    for (int b = FS_NBODY - 1; b > 0; --b) {
      int p = m.body_parent[b];
      for (int k = 0; k < 6; ++k) cfrc[p][k] = cfrc[p][k] + cfrc[b][k];
    }
    for (int d = 0; d < FS_NV; ++d) bias[d] = dot6(cdof[d], cfrc[m.dof_body[d]]);
  }

  // smooth acceleration
  float qsm[FS_NV];
  {
    float L[FS_TRI(FS_NV)], dinv[FS_NV];
    for (int d = 0; d < FS_NV; ++d) qsm[d] = ((-m.dof_damping[d]) * v[d] + qfrc_act[d]) - bias[d];
    for (int i = 0; i < FS_TRI(FS_NV); ++i) L[i] = M[i];
    ldl_factor(L, m.anc_strict, dinv);
    ldl_solve(L, m.anc_strict, dinv, qsm);
  }

  // _constraint_rows
  Rows R;
  for (int r = 0; r < FS_NFL; ++r) {
    R.aref[r] = c_model.fl_negb[r] * v[c_model.fl_dof[r]];
    R.D[r] = c_model.fl_D[r];
    R.active[r] = true;
  }
  for (int l = 0; l < FS_NLIM; ++l) {
    int r = FS_NFL + l;
    float sign = m.lim_sign[l];
    float dist = sign * (q[m.lim_qadr[l]] - m.lim_bound[l]);
    float vel = sign * v[m.lim_dadr[l]];
    aref_d(m.lim_imp[l], m.lim_invweight[l], dist, m.lim_margin[l], vel, &R.aref[r], &R.D[r]);
    R.active[r] = dist < m.lim_margin[l];
  }
  {
    float gpos[FS_NGEOM][3], gmat[FS_NGEOM][9];
    geom_frames(xpos, xquat, gpos, gmat);
    float jn[FS_DIM(FS_NSLOT)][FS_DIM(FS_MAXD)], jt1[FS_DIM(FS_NSLOT)][FS_DIM(FS_MAXD)],
        jt2[FS_DIM(FS_NSLOT)][FS_DIM(FS_MAXD)], sdist[FS_DIM(FS_NSLOT)];
    for (int s = 0; s < FS_NSLOT; ++s) {
      float pos[3], n[3], t1[3], t2[3];
      float dist = contact_geometry(s, gpos, gmat, pos, n, t1, t2);
      sdist[s] = dist;
      // point Jacobians of pos on body2 minus body1 (fused.py _point_jac)
      const float* c2 = com[m.body_root[m.slot_body2[s]]];
      const float* c1 = com[m.body_root[m.slot_body1[s]]];
      float off2[3] = {pos[0] - c2[0], pos[1] - c2[1], pos[2] - c2[2]};
      float off1[3] = {pos[0] - c1[0], pos[1] - c1[1], pos[2] - c1[2]};
      for (int k = 0; k < m.slot_ndof[s]; ++k) {
        int d = m.slot_dof[s][k];
        float j2[3] = {0.0f, 0.0f, 0.0f}, j1[3] = {0.0f, 0.0f, 0.0f}, cr[3];
        if ((m.slot_body2_dofs[s] >> d) & 1u) {
          cross3(cdof[d], off2, cr);
          for (int i = 0; i < 3; ++i) j2[i] = cdof[d][3 + i] + cr[i];
        }
        if ((m.slot_body1_dofs[s] >> d) & 1u) {
          cross3(cdof[d], off1, cr);
          for (int i = 0; i < 3; ++i) j1[i] = cdof[d][3 + i] + cr[i];
        }
        float jac[3] = {j2[0] - j1[0], j2[1] - j1[1], j2[2] - j1[2]};
        jn[s][k] = dot3(jac, n);
        jt1[s][k] = dot3(jac, t1);
        jt2[s][k] = dot3(jac, t2);
      }
    }
    for (int c = 0; c < FS_NCROW; ++c) {
      int r = FS_NFL + FS_NLIM + c;
      int s = m.crow_slot[c];
      float coef = m.crow_coef[c];
      float vel = 0.0f;
      for (int k = 0; k < m.slot_ndof[s]; ++k) {
        float jr = jn[s][k];
        if (m.crow_t[c] == 0) jr = jr + coef * jt1[s][k];
        else if (m.crow_t[c] == 1) jr = jr + coef * jt2[s][k];
        R.J[c][k] = jr;
        vel = vel + jr * v[m.slot_dof[s][k]];
      }
      aref_d(m.slot_imp[s], m.crow_diag[c], sdist[s], m.slot_margin[s], vel, &R.aref[r], &R.D[r]);
      R.active[r] = sdist[s] < m.slot_margin[s];
    }
  }

  // _newton_solve
  float qacc[FS_NV], qfrc_con[FS_NV];
  for (int i = 0; i < FS_NV; ++i) { qacc[i] = qsm[i]; qfrc_con[i] = 0.0f; }
  if (FS_NROW > 0) {
    bool any_active = FS_NFL > 0;
    for (int r = FS_NFL; r < FS_NROW; ++r) any_active = any_active || R.active[r];
    // start from the warmstart only where it is strictly cheaper
    float cost_ws = total_cost(R, M, qsm, w);
    float cost_sm = total_cost(R, M, qsm, qsm);
    float a[FS_NV];
    bool better = cost_ws < cost_sm;
    for (int i = 0; i < FS_NV; ++i) a[i] = better ? w[i] : qsm[i];
    float cost_prev = fs_min(cost_ws, cost_sm);
    // done is sticky and a sample moves only while it was not done before,
    // so stopping at the top of an iteration is the same computation
    bool done = !any_active;
    for (int it = 0; it < m.iterations && !done; ++it) {
      float x[FS_DIM(FS_NROW)], hcs[FS_DIM(FS_NROW)], jd[FS_DIM(FS_NROW)];
      float da[FS_NV], mda[FS_NV], grad[FS_NV];
      for (int i = 0; i < FS_NV; ++i) da[i] = a[i] - qsm[i];
      m_vec(M, da, mda);
      for (int i = 0; i < FS_NV; ++i) grad[i] = mda[i];
      for (int r = 0; r < FS_NROW; ++r) {
        float cost, dc;
        x[r] = row_dot(R, r, a) - R.aref[r];
        s_terms(R, r, x[r], &cost, &dc, &hcs[r]);
        add_row_jt(R, r, dc, grad, false);
      }
      // H = M + J^T diag(h) J on the solver pattern
      float H[FS_TRI(FS_NV)], dinv[FS_NV], delta[FS_NV];
      for (int i = 0; i < FS_NV; ++i) {
        for (int j = 0; j < i; ++j)
          H[FS_IDX(i, j)] = ((m.anc_strict[i] >> j) & 1u) ? M[FS_IDX(i, j)] : 0.0f;
        H[FS_IDX(i, i)] = M[FS_IDX(i, i)];
      }
      for (int r = 0; r < FS_NROW; ++r) add_row_hessian(R, r, hcs[r], H);
      ldl_factor(H, m.anc_solver, dinv);
      for (int i = 0; i < FS_NV; ++i) delta[i] = -grad[i];
      ldl_solve(H, m.anc_solver, dinv, delta);

      float md[FS_NV];
      for (int r = 0; r < FS_NROW; ++r) jd[r] = row_dot(R, r, delta);
      m_vec(M, delta, md);
      float dmd = 0.0f, dma = 0.0f;
      for (int i = 0; i < FS_NV; ++i) dmd = dmd + delta[i] * md[i];
      for (int i = 0; i < FS_NV; ++i) dma = dma + delta[i] * mda[i];

      // exactly ls_iterations 1-D Newton steps on alpha, then alpha >= 0
      float alpha = 0.0f;
      for (int ls = 0; ls < m.ls_iterations; ++ls) {
        float d1 = alpha * dmd + dma, d2 = dmd;
        for (int r = 0; r < FS_NROW; ++r) {
          float cost, dc, hc;
          s_terms(R, r, x[r] + alpha * jd[r], &cost, &dc, &hc);
          d1 = d1 + jd[r] * dc;
          d2 = d2 + hc * (jd[r] * jd[r]);
        }
        alpha = alpha - d1 / fs_max(d2, 1e-30f);
      }
      alpha = fs_max(alpha, 0.0f);

      float a_new[FS_NV];
      for (int i = 0; i < FS_NV; ++i) a_new[i] = a[i] + alpha * delta[i];
      float cost_new = total_cost(R, M, qsm, a_new);
      float improved = cost_prev - cost_new;
      float gn = 0.0f;
      for (int i = 0; i < FS_NV; ++i) gn = gn + grad[i] * grad[i];
      gn = sqrtf(gn);
      for (int i = 0; i < FS_NV; ++i) a[i] = a_new[i];
      cost_prev = cost_new;
      done = (improved < m.tol_scale) || (gn < m.tol_scale);
    }
    if (any_active) {
      for (int i = 0; i < FS_NV; ++i) qacc[i] = a[i];
      for (int r = 0; r < FS_NROW; ++r) {
        float cost, dc, hc;
        s_terms(R, r, row_dot(R, r, a) - R.aref[r], &cost, &dc, &hc);
        add_row_jt(R, r, dc, qfrc_con, true);
      }
    }
  }

  // integration; the optional implicit-damping re-solve (mj_Euler) solves
  // (M + dt diag(damping)) qacc_int = M qacc_smooth + qfrc_constraint
  float qacc_int[FS_NV];
#if FS_IMPLICIT
  {
    float Mhb[FS_TRI(FS_NV)], dinv[FS_NV], mq[FS_NV];
    for (int i = 0; i < FS_TRI(FS_NV); ++i) Mhb[i] = M[i];
    for (int d = 0; d < FS_NV; ++d)
      if (m.dof_damp_dt[d] != 0.0f) Mhb[FS_IDX(d, d)] = Mhb[FS_IDX(d, d)] + m.dof_damp_dt[d];
    m_vec(M, qsm, mq);
    for (int d = 0; d < FS_NV; ++d) qacc_int[d] = mq[d] + qfrc_con[d];
    ldl_factor(Mhb, m.anc_strict, dinv);
    ldl_solve(Mhb, m.anc_strict, dinv, qacc_int);
  }
#else
  for (int d = 0; d < FS_NV; ++d) qacc_int[d] = qacc[d];
#endif

  // derived reward inputs, from this (pre-integration) forward pass
  {
    int o = 0;
    for (int i = 0; i < 3; ++i) der[o++] = xpos[m.torso][i];
    for (int i = 0; i < 4; ++i) der[o++] = xquat[m.torso][i];
    for (int i = 0; i < 6; ++i) der[o++] = cvel[m.torso][i];
    for (int i = 0; i < 3; ++i) der[o++] = com[m.torso_root][i];
#if FS_WANT_SITES
    for (int s = 0; s < FS_NSITE; ++s) {
      float t[3];
      int b = m.site_body[s];
      qrotate(m.site_pos[s], xquat[b], t);
      for (int i = 0; i < 3; ++i) der[o++] = xpos[b][i] + t[i];
    }
#endif
#if FS_WANT_QFRC
    for (int d = 0; d < FS_NV; ++d) der[o++] = qfrc_act[d];
#endif
  }

  for (int d = 0; d < FS_NV; ++d) v[d] = v[d] + dt * qacc_int[d];
  for (int j = 0; j < FS_NJNT; ++j) {
    int qa = m.jnt_qadr[j], da = m.jnt_dadr[j];
    if (m.jnt_type[j] == JNT_FREE) {
      for (int i = 0; i < 3; ++i) q[qa + i] = q[qa + i] + dt * v[da + i];
      // mju_quatIntegrate, with the small-angle branch of the plain version
      const float* w3 = v + da + 3;
      float wn2 = w3[0] * w3[0] + w3[1] * w3[1] + w3[2] * w3[2];
      float theta = sqrtf(fs_max(wn2, 1e-30f)) * dt;
      float half = 0.5f * theta;
      float sin_over = (theta < 1e-9f) ? 0.5f : sinf(half) / fs_max(theta, 1e-30f);
      float s = dt * sin_over;
      float dq[4] = {cosf(half), w3[0] * s, w3[1] * s, w3[2] * s};
      float qn[4];
      qmul(q + qa + 3, dq, qn);
      qnormalize(qn);
      for (int i = 0; i < 4; ++i) q[qa + 3 + i] = qn[i];
    } else {
      q[qa] = q[qa] + dt * v[da];
    }
  }
  // the warmstart output is the solver's qacc (not the damped qacc_int)
  for (int d = 0; d < FS_NV; ++d) w[d] = qacc[d];
}

FS_DEVICE void step_sample(int b, int n_substeps, const float* qpos, const float* qvel,
                           const float* ws, const float* ctrl, float* oq, float* ov,
                           float* ow, float* od) {
  float q[FS_NQ], v[FS_NV], w[FS_NV], c[FS_NU], der[FS_ND];
  for (int i = 0; i < FS_NQ; ++i) q[i] = qpos[(size_t)b * FS_NQ + i];
  for (int i = 0; i < FS_NV; ++i) v[i] = qvel[(size_t)b * FS_NV + i];
  for (int i = 0; i < FS_NV; ++i) w[i] = ws[(size_t)b * FS_NV + i];
  for (int i = 0; i < FS_NU; ++i) c[i] = ctrl[(size_t)b * FS_NU + i];
  for (int s = 0; s < n_substeps; ++s) substep(q, v, w, c, der);
  for (int i = 0; i < FS_NQ; ++i) oq[(size_t)b * FS_NQ + i] = q[i];
  for (int i = 0; i < FS_NV; ++i) ov[(size_t)b * FS_NV + i] = v[i];
  for (int i = 0; i < FS_NV; ++i) ow[(size_t)b * FS_NV + i] = w[i];
  for (int i = 0; i < FS_ND; ++i) od[(size_t)b * FS_ND + i] = der[i];
}

#define FS_THREADS 32

#ifdef __CUDACC__
__global__ void __launch_bounds__(FS_THREADS)
fused_step_kernel(int batch, int n_substeps, const float* __restrict__ qpos,
                  const float* __restrict__ qvel, const float* __restrict__ ws,
                  const float* __restrict__ ctrl, float* __restrict__ oq,
                  float* __restrict__ ov, float* __restrict__ ow, float* __restrict__ od) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;  // the last block's spare threads
  step_sample(b, n_substeps, qpos, qvel, ws, ctrl, oq, ov, ow, od);
}

extern "C" int fused_step_upload(const void* model, size_t nbytes) {
  if (nbytes != sizeof(FusedModel)) return -1;
  return (int)cudaMemcpyToSymbol(c_model, model, nbytes);
}

// Launches on `stream` and returns cudaGetLastError(): 0 when the launch
// was accepted.  Faults during the run surface at the next synchronize.
extern "C" int fused_step_launch(int batch, int n_substeps, const float* qpos,
                                 const float* qvel, const float* ws, const float* ctrl,
                                 float* oq, float* ov, float* ow, float* od, void* stream) {
  if (batch <= 0) return 0;
  int blocks = (batch + FS_THREADS - 1) / FS_THREADS;
  fused_step_kernel<<<blocks, FS_THREADS, 0, (cudaStream_t)stream>>>(
      batch, n_substeps, qpos, qvel, ws, ctrl, oq, ov, ow, od);
  return (int)cudaGetLastError();
}
#else
extern "C" int fused_step_upload(const void* model, size_t nbytes) {
  if (nbytes != sizeof(FusedModel)) return -1;
  memcpy(&c_model, model, nbytes);
  return 0;
}

// Host build only: the contact geometry of every slot at each sample's
// qpos, out (batch, FS_NSLOT, 13) = dist, pos, n, t1, t2.  The CPU tests
// hold it against the plain version's _contact_geometry kind by kind.
// Returns -1, and writes nothing, when the caller's widths are not the
// build's.
extern "C" int fused_contacts(int batch, int nq, int nslot, const float* qpos, float* out) {
  if (nq != FS_NQ || nslot != FS_NSLOT) return -1;
  for (int b = 0; b < batch; ++b) {
    float xpos[FS_NBODY][3], xquat[FS_NBODY][4], xanchor[FS_NJNT][3], xaxis[FS_NJNT][3];
    float gpos[FS_NGEOM][3], gmat[FS_NGEOM][9];
    body_frames(qpos + (size_t)b * FS_NQ, xpos, xquat, xanchor, xaxis);
    geom_frames(xpos, xquat, gpos, gmat);
    for (int s = 0; s < FS_NSLOT; ++s) {
      float* o = out + ((size_t)b * FS_NSLOT + s) * 13;
      o[0] = contact_geometry(s, gpos, gmat, o + 1, o + 4, o + 7, o + 10);
    }
  }
  return 0;
}

extern "C" int fused_step_launch(int batch, int n_substeps, const float* qpos,
                                 const float* qvel, const float* ws, const float* ctrl,
                                 float* oq, float* ov, float* ow, float* od, void* stream) {
  (void)stream;
  for (int b = 0; b < batch; ++b) step_sample(b, n_substeps, qpos, qvel, ws, ctrl, oq, ov, ow, od);
  return 0;
}
#endif

extern "C" size_t fused_model_nbytes(void) { return sizeof(FusedModel); }
