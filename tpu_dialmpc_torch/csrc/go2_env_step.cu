// go2_env_step.cu — the Go2 env step's small ops around the physics, as two
// CUDA kernels: the action-to-ctrl map (go2_ctrl) and the reward,
// termination and state-info update (go2_post_physics).
//
// Replaces no Pallas kernel.  The JAX package leaves these ops
// (tpu_dialmpc/envs/go2.py: _ctrl_batch, _post_physics) to XLA, which fuses
// them into a few loops; PyTorch runs them as written, about 160 small
// kernels per env step (tpu_dialmpc_torch/envs/go2.py, which stays their
// plain version and runs on CPU tensors).  The wrapper that builds, packs
// and launches this file is tpu_dialmpc_torch/envs/go2_cuda.py.
//
// What bounds it: latency.  A sample reads and writes about 0.5 KB and does
// a few hundred flops and six transcendental calls; at B=2049 that is ~1 MB
// (0.3 us at 3.35 TB/s) and ~1 MFLOP, both far under one kernel launch.  As
// separate PyTorch ops the same work was ~160 dependent launches of 1-2 us
// each, plus the gaps between them in the CUDA graph.
//
// What the design does about it:
// - go2_ctrl takes one thread per (sample, motor), go2_post_physics one
//   thread per sample: each is one launch, in one wave, for the whole
//   batch, and every intermediate stays in registers;
// - the config's fields are one parameter struct passed by value (a CUDA
//   graph keeps its copy); branches on them are uniform across the batch;
// - inputs are read through their batch stride: the state's info fields,
//   broadcast to the rollout's batch with stride 0, and the fused kernel's
//   derived rows, views of one (B, ND) tensor, are never copied.
//
// Arithmetic: each term keeps go2.py's order of operations, one rounding
// per PyTorch op, so on CPU tensors the g++ build of this file equals the
// plain version (tests/test_torch_go2_env_kernel.py).  Built with -fmad=false
// (and -ffp-contract=off on the host), products and sums round on their
// own; where PyTorch's own kernel rounds otherwise, this file does the
// same on purpose:
// - a cross product component is fma(a_j, b_k, -(a_k b_j)), as PyTorch's
//   CPU cross kernel computes it;
// - a tensor divided by a Python number is a division on the host, and a
//   multiply by the number's reciprocal on the card (div_scalar), as
//   PyTorch's CUDA division by a CPU scalar computes it;
// - sums over the feet, a vector's 2 or 3 components and the energy's
//   joints go in index order from zero.
//
// The same source builds as plain C++ for the host (g++ -x c++): the launch
// functions then run the samples one after another.

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define G2_DEV __device__ __forceinline__
#else
#define G2_DEV static inline
#endif

#ifndef G2_NU
#error "go2_env_step.cu needs -DG2_NU (the model's motor count)"
#endif
#define G2_NFEET 4
#define G2_PI 3.141592653589793

G2_DEV float g2_sin(float x) { return sinf(x); }
G2_DEV double g2_sin(double x) { return sin(x); }
G2_DEV float g2_cos(float x) { return cosf(x); }
G2_DEV double g2_cos(double x) { return cos(x); }
G2_DEV float g2_atan2(float y, float x) { return atan2f(y, x); }
G2_DEV double g2_atan2(double y, double x) { return atan2(y, x); }
G2_DEV float g2_fmod(float a, float b) { return fmodf(a, b); }
G2_DEV double g2_fmod(double a, double b) { return fmod(a, b); }
G2_DEV float g2_abs(float x) { return fabsf(x); }
G2_DEV double g2_abs(double x) { return fabs(x); }
G2_DEV float g2_fma(float a, float b, float c) { return fmaf(a, b, c); }
G2_DEV double g2_fma(double a, double b, double c) { return fma(a, b, c); }

// torch.maximum / torch.minimum / torch.clamp: a NaN operand gives NaN
template <typename T> G2_DEV T g2_max(T a, T b) {
  return (a != a) ? a : (b != b) ? b : (a > b ? a : b);
}
template <typename T> G2_DEV T g2_min(T a, T b) {
  return (a != a) ? a : (b != b) ? b : (a < b ? a : b);
}
template <typename T> G2_DEV T g2_clamp(T x, T lo, T hi) { return g2_min(g2_max(x, lo), hi); }

// a tensor divided by a Python number (see the note at the top)
template <typename T> G2_DEV T div_scalar(T a, T b) {
#ifdef __CUDACC__
  return a * (T(1) / b);
#else
  return a / b;
#endif
}

// torch.remainder for floats: fmod, moved into the divisor's sign
template <typename T> G2_DEV T py_remainder(T a, T b) {
  T mod = g2_fmod(a, b);
  if (mod != T(0) && ((b < T(0)) != (mod < T(0)))) mod += b;
  return mod;
}

template <typename T> G2_DEV T sum3(T a, T b, T c) { return ((T(0) + a) + b) + c; }

// torch.linalg.cross, each component fused as PyTorch's CPU kernel has it
template <typename T> G2_DEV void cross(const T* a, const T* b, T* out) {
  out[0] = g2_fma(a[1], b[2], -(a[2] * b[1]));
  out[1] = g2_fma(a[2], b[0], -(a[0] * b[2]));
  out[2] = g2_fma(a[0], b[1], -(a[1] * b[0]));
}

// core/rotations.py rotate: r = 2 u (u.v) + (s^2 - u.u) v + 2 s (u x v),
// with q = (s, u); sign = -1 rotates by the conjugate (inv_rotate)
template <typename T> G2_DEV void rotate(const T* v, const T* q, T sign, T* out) {
  T s = q[0];
  T u[3] = {sign * q[1], sign * q[2], sign * q[3]};
  T uv = sum3(u[0] * v[0], u[1] * v[1], u[2] * v[2]);
  T uu = sum3(u[0] * u[0], u[1] * u[1], u[2] * u[2]);
  T c = s * s - uu;
  T cr[3];
  cross(u, v, cr);
  T s2 = T(2.0) * s;
  for (int i = 0; i < 3; ++i) out[i] = ((T(2.0) * u[i]) * uv + c * v[i]) + s2 * cr[i];
}

// SplitMix64 (envs/legged.py command_uniforms), in unsigned 64-bit words
#define G2_GOLDEN 0x9E3779B97F4A7C15ull
G2_DEV uint64_t mix64(uint64_t z) {
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

// The env's config, as go2_cuda.py packs it (ctypes mirrors this layout;
// go2_params_nbytes checks it).  T fields are the Python values rounded
// once to the env's dtype, as PyTorch rounds a Python number in an op.
template <typename T> struct Go2Params {
  // the PD map (LeggedEnv.act2joint, _act2tau_qv)
  T kp, kd, action_scale;
  T joint_range[G2_NU][2], physical_range[G2_NU][2], torque_range[G2_NU][2];
  T termination_range[G2_NU][2];
  // the command schedule
  T dt, ramp_up_time, default_vx, default_vy, default_vyaw, abs_vyaw, goal_x;
  T command_range[3];  // randomize_tasks: |lin x|, |lin y|, |yaw rate|
  // the gait target (gait.get_foot_step): cadence, amplitude, the swing
  // width 1 - duty + 1e-12 in the dtype, each foot's phase
  T cadence, amplitude, swing_width, phases[G2_NFEET];
  // the crate (_support_z and the torso's ramp): centre, half sizes, top,
  // ramp length, and cx - hx - 0.15 in double rounded once
  T crate_cx, crate_cy, crate_hx, crate_hy, crate_top, crate_ramp, crate_front;
  // reward weights
  T vel_weight, energy_weight, y_anchor_weight, done_penalty, foot_radius;
  // switches, each read from the config in double as go2.py tests it
  int32_t position, randomize, turn_period, yaw_eigen, lifts, crate, goal, energy, y_anchor;
  int32_t done_pen, n_energy;
  int32_t feet_site[G2_NFEET];
};

// go2_ctrl: 0 action, 1 qpos, 2 qvel as (address, batch stride in
// elements), then the output's address (batch, G2_NU), contiguous
struct CtrlIo {
  int64_t in[3][2];
  int64_t out;
};

// go2_post_physics inputs, (address, batch stride in elements), in this
// order, and the outputs' addresses, each (batch, width) contiguous
enum {
  IN_QPOS, IN_QVEL, IN_SITE_XPOS, IN_TORSO_XPOS, IN_TORSO_XQUAT, IN_TORSO_CVEL, IN_ROOT_COM,
  IN_QFRC, IN_POS_TAR, IN_VEL_TAR, IN_ANG_VEL_TAR, IN_YAW_TAR, IN_STEP, IN_LAST_CONTACT,
  IN_AIR_TIME, IN_SEED, N_IN
};
enum {
  OUT_REWARD, OUT_DONE, OUT_VEL_TAR, OUT_ANG_VEL_TAR, OUT_YAW_TAR, OUT_STEP, OUT_Z_FEET,
  OUT_Z_FEET_TAR, OUT_LAST_CONTACT, OUT_AIR_TIME, N_OUT
};
struct PostIo {
  int64_t in[N_IN][2];
  int64_t out[N_OUT];
};

template <typename P> G2_DEV const P* row(const int64_t* in, int b) {
  return reinterpret_cast<const P*>(in[0]) + (int64_t)b * in[1];
}
template <typename P> G2_DEV P* out_row(int64_t addr, int b, int width) {
  return reinterpret_cast<P*>(addr) + (int64_t)b * width;
}

// ---- go2_ctrl: _ctrl_batch for one (sample, motor) ----
template <typename T>
G2_DEV void ctrl_one(const Go2Params<T>& p, const CtrlIo& io, int b, int j) {
  T act = row<T>(io.in[0], b)[j];
  // act2joint
  T lo = p.joint_range[j][0], hi = p.joint_range[j][1];
  T act_normalized = div_scalar(act * p.action_scale + T(1.0), T(2.0));
  T target = lo + act_normalized * (hi - lo);
  target = g2_min(g2_max(target, p.physical_range[j][0]), p.physical_range[j][1]);
  T out = target;
  if (!p.position) {  // _act2tau_qv: the PD torque toward the target
    T q = row<T>(io.in[1], b)[7 + j];
    T qd = row<T>(io.in[2], b)[6 + j];
    T tau = p.kp * (target - q) - p.kd * qd;
    out = g2_min(g2_max(tau, p.torque_range[j][0]), p.torque_range[j][1]);
  }
  out_row<T>(io.out, b, G2_NU)[j] = out;
}

// ---- go2_post_physics: _post_physics for one sample ----
template <typename T>
G2_DEV void post_sample(const Go2Params<T>& p, const PostIo& io, int b) {
  const T* qpos = row<T>(io.in[IN_QPOS], b);
  const T* qvel = row<T>(io.in[IN_QVEL], b);
  const T* site_xpos = row<T>(io.in[IN_SITE_XPOS], b);
  const T* xpos = row<T>(io.in[IN_TORSO_XPOS], b);
  const T* xquat = row<T>(io.in[IN_TORSO_XQUAT], b);
  const T* cvel = row<T>(io.in[IN_TORSO_CVEL], b);
  const T* root_com = row<T>(io.in[IN_ROOT_COM], b);
  const T* qfrc = row<T>(io.in[IN_QFRC], b);
  const T* pos_tar = row<T>(io.in[IN_POS_TAR], b);
  const T* info_vel = row<T>(io.in[IN_VEL_TAR], b);
  const T* info_ang = row<T>(io.in[IN_ANG_VEL_TAR], b);
  T info_yaw = *row<T>(io.in[IN_YAW_TAR], b);
  int32_t step = *row<int32_t>(io.in[IN_STEP], b);
  const uint8_t* last_contact = row<uint8_t>(io.in[IN_LAST_CONTACT], b);
  const T* air_time = row<T>(io.in[IN_AIR_TIME], b);
  int64_t seed = *row<int64_t>(io.in[IN_SEED], b);
  T t = T(step) * p.dt;

  // the command schedule
  T vel_tar[3], ang_vel_tar[3];
  if (p.randomize) {  // LeggedEnv._redrawn_command
    if (step % 500 == 0) {  // a new command every 500 steps
      uint64_t base = mix64((uint64_t)seed);
      uint64_t counter = (uint64_t)((int64_t)step * 3);
      T u[3];
      for (int k = 0; k < 3; ++k) {
        uint64_t z = mix64(base + (counter + (uint64_t)(k + 1)) * G2_GOLDEN) >> 40;
        u[k] = T((int64_t)z) * T(5.9604644775390625e-08);  // 2^-24
      }
      T draw[3];
      for (int k = 0; k < 3; ++k)
        draw[k] = p.command_range[k] * T(2.0) * u[k] + -p.command_range[k];
      vel_tar[0] = draw[0];
      vel_tar[1] = draw[1];
      vel_tar[2] = T(0);
      ang_vel_tar[0] = T(0);
      ang_vel_tar[1] = T(0);
      ang_vel_tar[2] = draw[2];
    } else {
      for (int k = 0; k < 3; ++k) {
        vel_tar[k] = info_vel[k];
        ang_vel_tar[k] = info_ang[k];
      }
    }
  } else {  // the reference ramp min(v t / T, v)
    T frac = div_scalar(t, p.ramp_up_time);
    T vyaw;
    if (p.turn_period) {
      int32_t n = step / p.turn_period;
      if ((step % p.turn_period != 0) && ((step < 0) != (p.turn_period < 0))) n -= 1;
      int32_t odd = n % 2;
      if (odd < 0) odd += 2;
      T sign = T(1.0) - T(2.0) * T(odd);
      T mag = g2_min(p.abs_vyaw * frac, p.abs_vyaw);
      vyaw = mag * sign;
    } else {
      vyaw = g2_min(p.default_vyaw * frac, p.default_vyaw);
    }
    vel_tar[0] = g2_min(p.default_vx * frac, p.default_vx);
    vel_tar[1] = g2_min(p.default_vy * frac, p.default_vy);
    vel_tar[2] = info_vel[2];
    ang_vel_tar[0] = info_ang[0];
    ang_vel_tar[1] = info_ang[1];
    ang_vel_tar[2] = vyaw;
  }
  if (p.goal) {
    T gate = (xpos[0] < p.goal_x) ? T(1) : T(0);
    vel_tar[0] = vel_tar[0] * gate;
  }

  // the gait target, and the crate's support under each foot
  T z_feet[G2_NFEET], z_feet_tar[G2_NFEET], reward_gaits = T(0);
  T tt = ((t * T(2.0)) * T(G2_PI)) * p.cadence + T(G2_PI);
  for (int f = 0; f < G2_NFEET; ++f) {
    const T* foot = site_xpos + 3 * p.feet_site[f];
    z_feet[f] = foot[2];
    T height = T(0);
    if (p.lifts) {
      T footphase = T(2.0 * G2_PI) * p.phases[f];
      T angle = py_remainder((tt + T(G2_PI)) - footphase, T(2.0 * G2_PI)) - T(G2_PI);
      angle = (angle * T(0.5)) / p.swing_width;
      T value = g2_cos(g2_clamp(angle, T(-G2_PI / 2.0), T(G2_PI / 2.0)));
      height = (g2_abs(value) >= T(1e-6)) ? g2_abs(value) : T(0);
    }
    T target = p.amplitude * height;
    if (p.crate) {
      T dx = foot[0] - p.crate_cx, dy = foot[1] - p.crate_cy;
      bool inside = (g2_abs(dx) < p.crate_hx) & (g2_abs(dy) < p.crate_hy);
      target = g2_max(target, (inside ? T(1) : T(0)) * p.crate_top);
    }
    z_feet_tar[f] = target;
    T e = div_scalar(target - z_feet[f], T(0.05));
    reward_gaits = reward_gaits + e * e;
  }
  reward_gaits = -reward_gaits;

  // upright
  const T up_global[3] = {T(0), T(0), T(1)};
  T up_body[3];
  rotate(up_global, xquat, T(1), up_body);
  T d0 = up_body[0] - up_global[0], d1 = up_body[1] - up_global[1];
  T d2 = up_body[2] - up_global[2];
  T reward_upright = -sum3(d0 * d0, d1 * d1, d2 * d2);

  // yaw
  T yaw_tar = p.turn_period ? info_yaw + ang_vel_tar[2] * p.dt
                            : info_yaw + (ang_vel_tar[2] * p.dt) * T(step);
  T qw = xquat[0], qx = xquat[1], qy = xquat[2], qz = xquat[3];
  T yaw = g2_atan2(T(2.0) * (qw * qz + qx * qy), T(1.0) - T(2.0) * (qy * qy + qz * qz));
  if (p.yaw_eigen && yaw < T(0)) yaw = yaw + T(G2_PI);
  T d_yaw = yaw - yaw_tar;
  T wrapped = g2_atan2(g2_sin(d_yaw), g2_cos(d_yaw));
  T reward_yaw = -(wrapped * wrapped);

  // the torso's body-frame velocities (LeggedEnv._body_velocities)
  T offset[3] = {xpos[0] - root_com[0], xpos[1] - root_com[1], xpos[2] - root_com[2]};
  T cvel_ang[3] = {cvel[0], cvel[1], cvel[2]};
  T oc[3];
  cross(offset, cvel_ang, oc);
  T vel_lin[3] = {cvel[3] - oc[0], cvel[4] - oc[1], cvel[5] - oc[2]};
  T vb[3], ab[3];
  rotate(vel_lin, xquat, T(-1), vb);
  rotate(cvel_ang, xquat, T(-1), ab);
  T e0 = vb[0] - vel_tar[0], e1 = vb[1] - vel_tar[1];
  T reward_vel = -((T(0) + e0 * e0) + e1 * e1);
  T ea = ab[2] - ang_vel_tar[2];
  T reward_ang_vel = -(ea * ea);

  // height, with the torso's target ramped onto the crate
  T z_torso = xpos[2];
  T z_tar = pos_tar[2];
  if (p.crate) {
    T frac = g2_clamp(div_scalar(xpos[0] - p.crate_front, p.crate_ramp), T(0), T(1));
    z_tar = z_tar + p.crate_top * frac;
  }
  T dz = z_torso - z_tar;
  T reward_height = -(dz * dz);

  T reward_energy = T(0);
  if (p.energy) {
    T acc = T(0);
    for (int j = 0; j < p.n_energy; ++j) {
      T power = g2_max(div_scalar(qfrc[6 + j] * qvel[6 + j], T(160.0)), T(0));
      acc = acc + power * power;
    }
    reward_energy = -acc;
  }

  T reward = ((((((T(0.1) * reward_gaits + T(0.5) * reward_upright) + T(0.3) * reward_yaw) +
                 p.vel_weight * reward_vel) +
                T(1.0) * reward_ang_vel) +
               T(1.0) * reward_height) +
              p.energy_weight * reward_energy);
  if (p.y_anchor) {
    T dy = xpos[1] - pos_tar[1];
    reward = reward - p.y_anchor_weight * (dy * dy);
  }

  // termination
  bool out_of_range = false;
  for (int j = 0; j < G2_NU; ++j) {
    T a = qpos[7 + j];
    out_of_range |= (a < p.termination_range[j][0]) | (a > p.termination_range[j][1]);
  }
  T up = sum3(up_body[0] * up_global[0], up_body[1] * up_global[1], up_body[2] * up_global[2]);
  bool done = (up < T(0)) | out_of_range | (z_torso < T(0.18));
  if (p.done_pen) reward = reward - p.done_penalty * (done ? T(1) : T(0));

  // outputs, with the contact and air-time update
  out_row<T>(io.out[OUT_REWARD], b, 1)[0] = reward;
  out_row<uint8_t>(io.out[OUT_DONE], b, 1)[0] = done ? 1 : 0;
  T* o_vel = out_row<T>(io.out[OUT_VEL_TAR], b, 3);
  T* o_ang = out_row<T>(io.out[OUT_ANG_VEL_TAR], b, 3);
  for (int k = 0; k < 3; ++k) {
    o_vel[k] = vel_tar[k];
    o_ang[k] = ang_vel_tar[k];
  }
  if (p.turn_period) out_row<T>(io.out[OUT_YAW_TAR], b, 1)[0] = yaw_tar;
  out_row<int32_t>(io.out[OUT_STEP], b, 1)[0] = step + 1;
  T* o_z = out_row<T>(io.out[OUT_Z_FEET], b, G2_NFEET);
  T* o_zt = out_row<T>(io.out[OUT_Z_FEET_TAR], b, G2_NFEET);
  uint8_t* o_contact = out_row<uint8_t>(io.out[OUT_LAST_CONTACT], b, G2_NFEET);
  T* o_air = out_row<T>(io.out[OUT_AIR_TIME], b, G2_NFEET);
  for (int f = 0; f < G2_NFEET; ++f) {
    bool contact = (z_feet[f] - p.foot_radius) < T(1e-3);
    bool filt = contact | (last_contact[f] != 0);
    o_z[f] = z_feet[f];
    o_zt[f] = z_feet_tar[f];
    o_contact[f] = contact ? 1 : 0;
    o_air[f] = filt ? T(0) : air_time[f] + p.dt;
  }
}

#define G2_THREADS 64

#ifdef __CUDACC__
template <typename T>
__global__ void __launch_bounds__(G2_THREADS)
go2_ctrl(const Go2Params<T> p, const CtrlIo io, int batch) {
  int i = blockIdx.x * G2_THREADS + threadIdx.x;
  if (i < batch * G2_NU) ctrl_one(p, io, i / G2_NU, i % G2_NU);
}

template <typename T>
__global__ void __launch_bounds__(G2_THREADS)
go2_post_physics(const Go2Params<T> p, const PostIo io, int batch) {
  int b = blockIdx.x * G2_THREADS + threadIdx.x;
  if (b < batch) post_sample(p, io, b);
}

template <typename T>
static int launch_ctrl(int batch, const void* params, const int64_t* io, void* stream) {
  CtrlIo a;
  memcpy(&a, io, sizeof(a));
  int blocks = (batch * G2_NU + G2_THREADS - 1) / G2_THREADS;
  go2_ctrl<T><<<blocks, G2_THREADS, 0, (cudaStream_t)stream>>>(
      *(const Go2Params<T>*)params, a, batch);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_post(int batch, const void* params, const int64_t* io, void* stream) {
  PostIo a;
  memcpy(&a, io, sizeof(a));
  int blocks = (batch + G2_THREADS - 1) / G2_THREADS;
  go2_post_physics<T><<<blocks, G2_THREADS, 0, (cudaStream_t)stream>>>(
      *(const Go2Params<T>*)params, a, batch);
  return (int)cudaGetLastError();
}
#else
// The host build runs the samples one after another.
template <typename T>
static int launch_ctrl(int batch, const void* params, const int64_t* io, void* stream) {
  (void)stream;
  CtrlIo a;
  memcpy(&a, io, sizeof(a));
  for (int b = 0; b < batch; ++b)
    for (int j = 0; j < G2_NU; ++j) ctrl_one(*(const Go2Params<T>*)params, a, b, j);
  return 0;
}

template <typename T>
static int launch_post(int batch, const void* params, const int64_t* io, void* stream) {
  (void)stream;
  PostIo a;
  memcpy(&a, io, sizeof(a));
  for (int b = 0; b < batch; ++b) post_sample(*(const Go2Params<T>*)params, a, b);
  return 0;
}
#endif

// dtype: 0 float32, 1 float64.  params: a Go2Params<T> in host memory, io:
// the CtrlIo / PostIo words.  Each launches on `stream` and returns
// cudaGetLastError() (0 in the host build); faults during the run surface
// at the next synchronize.
extern "C" size_t go2_params_nbytes(int dtype) {
  return dtype ? sizeof(Go2Params<double>) : sizeof(Go2Params<float>);
}

extern "C" size_t go2_io_words(int kernel) {
  return (kernel ? sizeof(PostIo) : sizeof(CtrlIo)) / sizeof(int64_t);
}

extern "C" int go2_ctrl_launch(int dtype, int batch, const void* params, const int64_t* io,
                               void* stream) {
  if (batch <= 0) return 0;
  return dtype ? launch_ctrl<double>(batch, params, io, stream)
               : launch_ctrl<float>(batch, params, io, stream);
}

extern "C" int go2_post_physics_launch(int dtype, int batch, const void* params,
                                       const int64_t* io, void* stream) {
  if (batch <= 0) return 0;
  return dtype ? launch_post<double>(batch, params, io, stream)
               : launch_post<float>(batch, params, io, stream);
}
