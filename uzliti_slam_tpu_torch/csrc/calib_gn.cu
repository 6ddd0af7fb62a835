// K20 calib_gn: the calibration's Gauss-Newton steps, in one launch.
//
// Replaces uzliti_slam_tpu/graph/calibration.py:calibrate (:63-133).  Each
// of the reference's steps evaluates the residual vector and its dense
// forward-mode Jacobian (jax.jacfwd), (6E + 6S + 3) x (6S + 3) floats, forms
// JᵀJ + damping·I and Jᵀr by matrix products, solves, and evaluates the
// cost again.
//
// What bounds it on the card: the operations, counted by
// chip_smoke.kernel_work: per residual group ~40 pose operations of ~60
// dual operations on P + 1 floats (P = 6S + 3) and 12 per entry of its
// sums, and a P x P solve, every step: 5.2·10⁸ at 1k nodes with one camera
// (999 groups, 21 passes), 0.0077 ms at 67 TFLOP/s; 1.0·10⁹ on the rig
// (0.0150 ms).  The bytes (the edge tables, once a pass) are fewer.  Each
// step needs the one before it, so a call is a chain of 21 short phases:
// latency bounds it.
//
// Design: one thread-block cluster of kCtas = 16 CTAs (a size above the
// portable 8, checked once per device with cudaOccupancyMaxActiveClusters;
// 701 if it does not fit) runs θ's initialisation, every step and the
// final cost.  A build with -DUZ_CALIB_CTAS=<1..16> takes another size
// (scripts/k19_k20_variants.py times one).
//   - At entry each CTA lists its residual groups (the edges e ≡ rank (mod
//     CTAs), in order, each is_sensor edge a sensor group and each is_odom
//     edge an odometry group; slots that are neither add exactly zero and
//     are never visited) and their units: a group and one block of 3
//     tangents that can be nonzero for it (the drift parameters' block for
//     an odometry group, the blocks of δL_sf and δL_st for a sensor group:
//     1, 2 or 4 units).  The other tangents of a group are zero for finite
//     values (a tangent component is computed from the values and that
//     component alone), and a zero adds nothing to a sum.  What of a group
//     does not depend on θ (T_e⁻¹; (X_i⁻¹ X_j)⁻¹, yaw and ‖t‖) is computed
//     once, by the same operations.
//   - The edge pass, a lane a unit, passes of up to 256 units that end on a
//     group's first unit: the lane evaluates the group's residual in
//     forward-mode dual numbers carrying its block's 3 tangents, and every
//     lane of a group recomputes the same value chain, so they hold the same
//     value bits and take the same small-angle branch.  It is the function
//     torch.func.jacfwd differentiates, the same float32 values, the tangent
//     of whichever branch the value selects (not an analytic Jacobian);
//     where torch.func.jacfwd and jax.jacfwd differ (clamp's tangent at its
//     bound: torch 1, JAX 1/2), this follows the plain version.  The dual
//     numbers follow uzliti_slam_tpu_torch/ops/lie.py function for function.
//     The extrinsics L_s = L0_s ∘ exp(δL_s) come first each step, a lane a
//     block, where the CTA has a sensor group.
//   - Each group's 6 Jacobian rows and residuals go to a tile in shared
//     memory as float64 rows [J (P), r], zero but for its units' blocks;
//     each thread owns one entry of the upper triangle of [J r]ᵀ[J r] (JᵀJ,
//     Jᵀr and ‖r‖²) and sums the tile's rows in order (P = 9: four slices
//     of the rows, added in slice order).
//   - The CTAs' sums meet in the leader through distributed shared memory
//     in rank order; its warp 0 adds the priors (√w·I on the extrinsics,
//     1e-2·I on the drift parameters, with their residuals), records ½‖r‖²
//     of the current θ, adds the damping and solves the P x P system by
//     Gauss-Jordan elimination with partial pivoting in float64, a lane a
//     row; the float32 update of θ is read by every CTA from the leader's
//     shared memory after a cluster barrier: two cluster barriers a step.
//   - No atomics, no host read, no global round trip between steps: two
//     launches give the same bits.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kT = 3;            // tangents a lane
#ifndef UZ_CALIB_CTAS
#define UZ_CALIB_CTAS 16
#endif
constexpr int kCtas = UZ_CALIB_CTAS;   // the one cluster's CTAs
static_assert(kCtas >= 1 && kCtas <= 16, "a cluster holds 1..16 CTAs");
constexpr int kMaxRows = 6 * kThreads;   // tile rows: a pass's groups, at most one a unit
// a CTA's scratch, in int32 a residual-group slot (2 an edge of its share):
// the groups (1), their units (4), their first units (1) and their
// constants (9 floats), plus one
constexpr int kScratchPerEdge = 2 * (1 + 4 + 1 + 9);
constexpr int kMaxDevices = 16;
constexpr float kEps = 1e-6f;
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------ dual numbers

template <int P>
struct D {
  float v;
  float d[P];
};

template <int P>
__device__ __forceinline__ D<P> cst(float x) {
  D<P> r;
  r.v = x;
#pragma unroll
  for (int k = 0; k < P; ++k) r.d[k] = 0.f;
  return r;
}

template <int P>
__device__ __forceinline__ D<P> operator+(const D<P>& a, const D<P>& b) {
  D<P> r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < P; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}

template <int P>
__device__ __forceinline__ D<P> operator-(const D<P>& a, const D<P>& b) {
  D<P> r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < P; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}

template <int P>
__device__ __forceinline__ D<P> operator-(const D<P>& a) {
  D<P> r;
  r.v = -a.v;
#pragma unroll
  for (int k = 0; k < P; ++k) r.d[k] = -a.d[k];
  return r;
}

template <int P>
__device__ __forceinline__ D<P> operator*(const D<P>& a, const D<P>& b) {
  D<P> r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < P; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}

template <int P>
__device__ __forceinline__ D<P> operator*(float s, const D<P>& a) {
  D<P> r;
  r.v = s * a.v;
#pragma unroll
  for (int k = 0; k < P; ++k) r.d[k] = s * a.d[k];
  return r;
}

template <int P>
__device__ __forceinline__ D<P> operator/(const D<P>& a, const D<P>& b) {
  D<P> r;
  r.v = a.v / b.v;
  const float ib = 1.f / b.v;
#pragma unroll
  for (int k = 0; k < P; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) * ib;
  return r;
}

template <int P>
__device__ __forceinline__ D<P> operator/(const D<P>& a, float b) {
  D<P> r;
  r.v = a.v / b;
#pragma unroll
  for (int k = 0; k < P; ++k) r.d[k] = a.d[k] / b;
  return r;
}

template <int P>
__device__ __forceinline__ D<P> scale_d(const D<P>& a, float v, float dv) {
  D<P> r;
  r.v = v;
#pragma unroll
  for (int k = 0; k < P; ++k) r.d[k] = dv * a.d[k];
  return r;
}

template <int P>
__device__ __forceinline__ D<P> dsqrt(const D<P>& a) {
  const float v = sqrtf(a.v);
  return scale_d(a, v, 0.5f / v);
}

template <int P>
__device__ __forceinline__ D<P> dsin(const D<P>& a) { return scale_d(a, sinf(a.v), cosf(a.v)); }

template <int P>
__device__ __forceinline__ D<P> dcos(const D<P>& a) { return scale_d(a, cosf(a.v), -sinf(a.v)); }

template <int P>
__device__ __forceinline__ D<P> datan2(const D<P>& y, const D<P>& x) {
  D<P> r;
  r.v = atan2f(y.v, x.v);
  const float inv = 1.f / (x.v * x.v + y.v * y.v);
#pragma unroll
  for (int k = 0; k < P; ++k) r.d[k] = (x.v * y.d[k] - y.v * x.d[k]) * inv;
  return r;
}

// torch.clamp(x, min=lo): the tangent passes where x >= lo
template <int P>
__device__ __forceinline__ D<P> floor_at(const D<P>& x, float lo) {
  return x.v < lo ? cst<P>(lo) : x;
}

template <int P>
__device__ __forceinline__ D<P> clamp_pm1(const D<P>& x) {
  if (x.v < -1.f) return cst<P>(-1.f);
  if (x.v > 1.f) return cst<P>(1.f);
  return x;
}

template <int P>
__device__ __forceinline__ D<P> safe_norm3(const D<P>* v) {
  return dsqrt(floor_at(v[0] * v[0] + v[1] * v[1] + v[2] * v[2], 1e-30f));
}

// ------------------------------------------------- lie ops on dual numbers

template <int P>
__device__ __forceinline__ void quat_normalize(D<P>* q) {
  const D<P> n = dsqrt(floor_at(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], 1e-30f));
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
  if (q[0].v < 0.f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
  }
}

template <int P>
__device__ __forceinline__ void quat_mul(const D<P>* a, const D<P>* b, D<P>* o) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

template <int P>
__device__ __forceinline__ void cross3(const D<P>* a, const D<P>* b, D<P>* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// v' = v + 2*(qw*(qv x v) + qv x (qv x v))
template <int P>
__device__ __forceinline__ void quat_rotate(const D<P>* q, const D<P>* v, D<P>* o) {
  D<P> uv[3], uuv[3];
  cross3(q + 1, v, uv);
  cross3(q + 1, uv, uuv);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = v[i] + 2.f * (q[0] * uv[i] + uuv[i]);
}

template <int P>
__device__ __forceinline__ void pose_compose(const D<P>* a, const D<P>* b, D<P>* o) {
  D<P> rt[3];
  quat_rotate(a + 3, b, rt);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = a[i] + rt[i];
  quat_mul(a + 3, b + 3, o + 3);
  quat_normalize(o + 3);
}

template <int P>
__device__ __forceinline__ void pose_inverse(const D<P>* p, D<P>* o) {
  o[3] = p[3];
  o[4] = -p[4];
  o[5] = -p[5];
  o[6] = -p[6];
  D<P> rt[3];
  quat_rotate(o + 3, p, rt);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = -rt[i];
}

// out = I + a*K + b*(K@K) applied to v, K = hat(phi)
template <int P>
__device__ __forceinline__ void eye_plus_apply(const D<P>* phi, const D<P>& a, const D<P>& b,
                                               const D<P>* v, D<P>* o) {
  const D<P> z = cst<P>(0.f);
  const D<P> K[3][3] = {{z, -phi[2], phi[1]}, {phi[2], z, -phi[0]}, {-phi[1], phi[0], z}};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    D<P> row[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const D<P> kk = K[i][0] * K[0][j] + K[i][1] * K[1][j] + K[i][2] * K[2][j];
      row[j] = a * K[i][j] + b * kk;
      if (i == j) row[j] = cst<P>(1.f) + row[j];
    }
    o[i] = row[0] * v[0] + row[1] * v[1] + row[2] * v[2];
  }
}

template <int P>
__device__ __forceinline__ void quat_from_axis_angle(const D<P>* phi, D<P>* q) {
  const D<P> theta = safe_norm3(phi);
  const D<P> half = 0.5f * theta;
  const bool small = theta.v < kEps;
  const D<P> k = small ? cst<P>(0.5f) - theta * theta / 48.f : dsin(half) / theta;
  q[0] = dcos(half);
  q[1] = k * phi[0];
  q[2] = k * phi[1];
  q[3] = k * phi[2];
  quat_normalize(q);
}

template <int P>
__device__ __forceinline__ void se3_exp(const D<P>* xi, D<P>* p) {
  quat_from_axis_angle(xi + 3, p + 3);
  const D<P>* phi = xi + 3;
  const D<P> theta = safe_norm3(phi);
  const bool small = theta.v < kEps;
  const D<P> t2 = theta * theta;
  const D<P> b = small ? cst<P>(0.5f) - t2 / 24.f : (cst<P>(1.f) - dcos(theta)) / t2;
  const D<P> c = small ? cst<P>(1.f / 6.f) - t2 / 120.f : (theta - dsin(theta)) / (t2 * theta);
  eye_plus_apply(phi, b, c, xi, p);
}

template <int P>
__device__ __forceinline__ void se3_log(const D<P>* p, D<P>* xi) {
  D<P> q[4] = {p[3], p[4], p[5], p[6]};
  quat_normalize(q);
  const D<P> w = clamp_pm1(q[0]);
  const D<P> vn = safe_norm3(q + 1);
  const bool small = vn.v < kEps;
  const D<P> scale = small ? (fabsf(w.v) < 1e-12f ? cst<P>(2.f) : cst<P>(2.f) / w)
                           : (2.f * datan2(vn, w)) / vn;
  D<P>* phi = xi + 3;
#pragma unroll
  for (int i = 0; i < 3; ++i) phi[i] = scale * q[i + 1];
  const D<P> theta = safe_norm3(phi);
  const bool tsmall = theta.v < kEps;
  const D<P> t2 = theta * theta;
  const D<P> half = 0.5f * theta;
  const D<P> cot = tsmall ? cst<P>(1.f / 12.f) + t2 / 720.f
                          : (cst<P>(1.f) - half * dcos(half) / dsin(half)) / t2;
  eye_plus_apply(phi, cst<P>(-0.5f), cot, p, xi);
}

template <int P>
__device__ __forceinline__ void load_pose(const float* src, D<P>* p) {
#pragma unroll
  for (int i = 0; i < 7; ++i) p[i] = cst<P>(src[i]);
}

// ---------------------------------------------------------------- residuals

// A group's values that do not depend on θ, computed once a call with the
// same operations the residuals below would repeat every step: a sensor
// group's T_e⁻¹; an odometry group's (X_i⁻¹ X_j)⁻¹, the measurement's yaw
// and ‖t‖.  Nine floats.
__device__ void group_constants(const float* xi, const float* xj, const float* meas, bool sensor,
                                float* out) {
  D<1> a[7], ai[7], rel[7];
  if (sensor) {
    load_pose(meas, a);
    pose_inverse(a, ai);
  } else {
    load_pose(xi, a);
    pose_inverse(a, ai);
    load_pose(xj, a);
    pose_compose(ai, a, rel);
    pose_inverse(rel, ai);
    const float w = meas[3], x = meas[4], y = meas[5], z = meas[6];
    out[7] = atan2f(2.f * (w * z + x * y), 1.f - 2.f * (y * y + z * z));
    out[8] = sqrtf(meas[0] * meas[0] + meas[1] * meas[1] + meas[2] * meas[2]);
  }
#pragma unroll
  for (int k = 0; k < 7; ++k) out[k] = ai[k].v;
}

// r = log(T_e⁻¹ · (X_i L_sf)⁻¹ (X_j L_st)), T_e⁻¹ given
template <int P>
__device__ void sensor_residual(const float* xi, const float* xj, const float* meas_inv,
                                const D<P>* li, const D<P>* lj, D<P>* r) {
  D<P> a[7], b[7], c[7], ai[7];
  load_pose(xi, c);
  pose_compose(c, li, a);
  load_pose(xj, c);
  pose_compose(c, lj, b);
  pose_inverse(a, ai);
  pose_compose(ai, b, c);      // pred
  load_pose(meas_inv, ai);
  pose_compose(ai, c, b);
  se3_log(b, r);
}

// r = log((X_i⁻¹ X_j)⁻¹ · warp(T_e, p)), warp = calibration.odometry_drift_correct;
// fixed = (X_i⁻¹ X_j)⁻¹, yaw, ‖t‖ (group_constants)
template <int P>
__device__ void odometry_residual(const float* meas, const float* fixed, const D<P>* p,
                                  D<P>* r) {
  const float yaw = fixed[7], tn = fixed[8];
  const D<P> drift = fabsf(yaw) * p[1] + tn * p[2];
  const D<P> c = dcos(drift), s = dsin(drift);
  D<P> warped[7];
  warped[0] = p[0] * (meas[0] * c - meas[1] * s);
  warped[1] = p[0] * (meas[0] * s + meas[1] * c);
  warped[2] = meas[2] * p[0];
  const D<P> z0 = cst<P>(0.f);
  const D<P> dq[4] = {dcos(drift / 2.f), z0, z0, dsin(drift / 2.f)};
  D<P> qm[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qm[i] = cst<P>(meas[3 + i]);
  quat_mul(dq, qm, warped + 3);
  quat_normalize(warped + 3);
  D<P> a[7], ai[7];
  load_pose(fixed, ai);
  pose_compose(ai, warped, a);
  se3_log(a, r);
}

// UZ_CALIB_STAMPS makes a timing build only (scripts/k19_k20_variants.py):
// at its end the leader writes its phases' ns over the first 64 bytes of
// the scratch, which the kernel no longer reads by then
#ifdef UZ_CALIB_STAMPS
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

// a dual of parameter `idx` (value x) as seen by the lane whose tangents
// are off .. off + kT - 1
__device__ __forceinline__ D<kT> seeded(float x, int idx, int off) {
  D<kT> r = cst<kT>(x);
#pragma unroll
  for (int q = 0; q < kT; ++q) r.d[q] = idx == off + q ? 1.f : 0.f;
  return r;
}

// the exclusive prefix sum of v over the CTA, and the CTA's total
__device__ __forceinline__ int block_scan(int v, int* tmp, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += tmp[w];
    total += tmp[w];
  }
  __syncthreads();
  return before + incl - v;
}

// The leader's warp 0: the priors, ½‖r‖² of the current θ into the cost
// history, then (but at the last step) the damping and the P x P solve by
// Gauss-Jordan elimination with partial pivoting (the largest pivot, of two
// within 4 bits of the mantissa the first) in float64, a lane a row, and the
// float32 update of θ; at the last step θ is written out.
template <int S>
__device__ void solve_step(const double* tot, float* theta, float* theta_out, float* hist,
                           int step, int iterations, float sqrt_prior, float damping) {
  constexpr int P = 6 * S + 3, W = P + 1;
  const int lane = threadIdx.x & 31;
  // lane r holds row r of [H | g]; entry (a, b) of the triangle lies at
  // a·W - a(a-1)/2 + (b - a)
  const int r = lane < P ? lane : P - 1;
  double A[W];
#pragma unroll
  for (int b = 0; b < W; ++b) {
    const int a0 = r < b ? r : b, b0 = r < b ? b : r;
    A[b] = tot[a0 * W - a0 * (a0 - 1) / 2 + (b0 - a0)];
  }
  // priors: r = √w·δL on the extrinsics, 1e-2·(p - [1, 0, 0]) on the drift
  const bool ext = r < 6 * S;
  const float jac = ext ? sqrt_prior : 0.01f;
  const float x = theta[r];
  const float res = ext ? __fmul_rn(sqrt_prior, x)
                        : __fmul_rn(0.01f, __fsub_rn(x, r == 6 * S ? 1.f : 0.f));
  const double prior_cost = 0.5 * static_cast<double>(res) * res;
#pragma unroll
  for (int b = 0; b < W; ++b) {
    if (b == r) A[b] += static_cast<double>(jac) * jac;
    if (b == P) A[b] += static_cast<double>(jac) * res;
  }
  double cost = 0.5 * tot[W * (W + 1) / 2 - 1];
#pragma unroll
  for (int k = 0; k < P; ++k) cost += __shfl_sync(kFull, prior_cost, k);
  if (lane == 0) hist[step] = static_cast<float>(cost);
  if (step == iterations) {
    if (lane < P) theta_out[lane] = theta[lane];
    return;
  }
#pragma unroll
  for (int b = 0; b < P; ++b)
    if (b == r) A[b] += static_cast<double>(damping);
#pragma unroll
  for (int c = 0; c < P; ++c) {
    // the pivot among rows c..P-1: a butterfly over the first 16 lanes on
    // one 64-bit key, |A[r][c]|'s bits (which order like the values) with
    // 15 - r in the 4 lowest, so that of two rows within 4 bits of the
    // mantissa the lower one wins
    unsigned long long key =
        (lane >= c && lane < P)
            ? (static_cast<unsigned long long>(__double_as_longlong(fabs(A[c]))) & ~0xFull) |
                  static_cast<unsigned long long>(15 - lane)
            : 0ull;
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFull, key, o, 16);
      key = other > key ? other : key;
    }
    const int piv = 15 - static_cast<int>(__shfl_sync(kFull, key, 0) & 0xFull);
    // the pivot row and row c, read from their lanes at once; swapped
    double prow[W], crow[W];
#pragma unroll
    for (int k = c; k < W; ++k) {
      prow[k] = __shfl_sync(kFull, A[k], piv);
      crow[k] = __shfl_sync(kFull, A[k], c);
    }
#pragma unroll
    for (int k = c; k < W; ++k) {
      if (lane == c) A[k] = prow[k];
      else if (lane == piv) A[k] = crow[k];
    }
    // column c out of every other row
    if (lane != c && lane < P) {
      const double f = A[c] / prow[c];
#pragma unroll
      for (int k = c; k < W; ++k) A[k] -= f * prow[k];
    }
  }
  double diag = 1.0;
#pragma unroll
  for (int b = 0; b < P; ++b)
    if (b == lane) diag = A[b];
  if (lane < P) theta[lane] = __fsub_rn(theta[lane], __double2float_rn(A[P] / diag));
}

template <int S>
struct Shape {
  static constexpr int P = 6 * S + 3;          // parameters: 2S + 1 blocks of 3 tangents
  static constexpr int W = P + 1;              // a tile row: J (P), r
  static constexpr int NT = W * (W + 1) / 2;   // the upper triangle of [J r]ᵀ[J r]
  static constexpr int SLICES = kThreads / NT; // row slices of the sums
  static constexpr size_t TILE_BYTES = static_cast<size_t>(kMaxRows) * W * sizeof(double);
  static_assert(SLICES >= 1, "a thread an entry");
};

template <int S>
__global__ void __launch_bounds__(kThreads, 1)
calib_cluster(const float* __restrict__ Xi, const float* __restrict__ Xj,
              const float* __restrict__ meas, const bool* __restrict__ is_sensor,
              const bool* __restrict__ is_odom, const int* __restrict__ sf,
              const int* __restrict__ st, const float* __restrict__ L0, int E, int iterations,
              float sqrt_prior, float damping, int* __restrict__ scratch,
              float* __restrict__ theta_out, float* __restrict__ hist) {
  using Sh = Shape<S>;
  constexpr int P = Sh::P, W = Sh::W, NT = Sh::NT;
  extern __shared__ double tile_mem[];   // kMaxRows rows of W
  double (*tile)[W] = reinterpret_cast<double (*)[W]>(tile_mem);
  __shared__ double slice_sum[Sh::SLICES][NT];
  __shared__ double part[NT];      // this CTA's sums, read by the leader
  __shared__ double tot[NT];       // the leader's cluster sums
  __shared__ float theta[P];
  __shared__ float Lv[S][7];       // the extrinsics at θ and their 6 tangents
  __shared__ float Ld[S][7][6];
  __shared__ int tmp[kWarps];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

#ifdef UZ_CALIB_STAMPS
  // %globaltimer ns of the leader's thread 0, summed by phase over the steps
  unsigned long long stamp = now_ns(), phase[8] = {};
  const unsigned long long t_start = stamp;
  const auto lap = [&](int q) {
    if (rank == 0 && threadIdx.x == 0) {
      const unsigned long long t = now_ns();
      phase[q] += t - stamp;
      stamp = t;
    }
  };
#define UZ_LAP(q) lap(q)
#else
#define UZ_LAP(q)
#endif

  // this thread's entry (a, b) of the sums, and its slice of the rows
  const int slice = threadIdx.x / NT, entry = threadIdx.x - slice * NT;
  int ea = 0, eb = 0;
  if (slice < Sh::SLICES) {
    int idx = 0;
    for (int a = 0; a < W; ++a)
      for (int b = a; b < W; ++b, ++idx)
        if (idx == entry) {
          ea = a;
          eb = b;
        }
  }
  if (threadIdx.x < P) theta[threadIdx.x] = threadIdx.x == 6 * S ? 1.f : 0.f;

  // The residual groups of the edges e ≡ rank (mod kCtas), in order, and
  // their units: a group and one of its tangent blocks that can be nonzero
  // (an odometry group: the drift parameters' block; a sensor group: the
  // blocks of δL_sf and δL_st).  A unit is (group << 4 | first << 3 | block).
  const int per_cta = (E + kCtas - 1) / kCtas;
  int* items = scratch + static_cast<long long>(rank) * (kScratchPerEdge * per_cta + 1);
  int* units = items + 2 * per_cta;
  int* ustart = items + 10 * per_cta;   // each group's first unit, then the count
  float* consts = reinterpret_cast<float*>(items + 12 * per_cta + 1);   // 9 floats a group
  int n_items = 0, n_units = 0, n_sensor = 0;
  for (int m0 = 0; m0 < per_cta; m0 += kThreads) {
    const int m = m0 + threadIdx.x;
    const long long e = rank + static_cast<long long>(kCtas) * m;
    const bool ok_e = m < per_cta && e < E;
    const bool s_on = ok_e && is_sensor[e], o_on = ok_e && is_odom[e];
    const int bf = s_on ? 2 * min(max(sf[e], 0), S - 1) : 0;
    const int bt = s_on ? 2 * min(max(st[e], 0), S - 1) : 0;
    const int nu = (s_on ? (bf == bt ? 2 : 4) : 0) + (o_on ? 1 : 0);
    int ti, tu, ts;
    const int at = n_items + block_scan(static_cast<int>(s_on) + static_cast<int>(o_on), tmp, ti);
    int ua = n_units + block_scan(nu, tmp, tu);
    block_scan(static_cast<int>(s_on), tmp, ts);
    if (s_on) {
      items[at] = static_cast<int>(2 * e);
      ustart[at] = ua;
      units[ua++] = at << 4 | 8 | bf;
      units[ua++] = at << 4 | (bf + 1);
      if (bt != bf) {
        units[ua++] = at << 4 | bt;
        units[ua++] = at << 4 | (bt + 1);
      }
    }
    if (o_on) {
      const int it = at + static_cast<int>(s_on);
      items[it] = static_cast<int>(2 * e + 1);
      ustart[it] = ua;
      units[ua] = it << 4 | 8 | (2 * S);
    }
    n_items += ti;
    n_units += tu;
    n_sensor += ts;
  }
  if (threadIdx.x == 0) ustart[n_items] = n_units;
  __syncthreads();
  for (int g = threadIdx.x; g < n_items; g += kThreads) {
    const long long e = items[g] >> 1;
    group_constants(Xi + 7 * e, Xj + 7 * e, meas + 7 * e, (items[g] & 1) == 0, consts + 9 * g);
  }
  __syncthreads();
  UZ_LAP(0);

  for (int step = 0; step <= iterations; ++step) {
    // L_s = L0_s ∘ exp(δL_s) with the tangents of δL_s, a lane a block
    // (only where the CTA has a sensor group)
    if (n_sensor > 0 && warp == 0 && lane < 2 * S) {
      const int s = lane >> 1, o = 6 * s + kT * (lane & 1);
      D<kT> dl[6], ex[7], l0[7], l[7];
#pragma unroll
      for (int k = 0; k < 6; ++k) dl[k] = seeded(theta[6 * s + k], 6 * s + k, o);
      se3_exp(dl, ex);
      load_pose(L0 + 7 * s, l0);
      pose_compose(l0, ex, l);
#pragma unroll
      for (int k = 0; k < 7; ++k) {
        if ((lane & 1) == 0) Lv[s][k] = l[k].v;
#pragma unroll
        for (int q = 0; q < kT; ++q) Ld[s][k][o - 6 * s + q] = l[k].d[q];
      }
    }
    __syncthreads();
    UZ_LAP(1);
    double acc = 0.0;
    // passes of at most kThreads units, ending on a group's first unit
    for (int ub = 0; ub < n_units;) {
      int ue = min(n_units, ub + kThreads);
      if (ue < n_units) ue = ustart[units[ue] >> 4];
      const int g0 = units[ub] >> 4, g1 = ue < n_units ? units[ue] >> 4 : n_items;
      const int rows = 6 * (g1 - g0);
      for (int q = threadIdx.x; q < rows * W; q += kThreads) tile_mem[q] = 0.0;
      __syncthreads();
      const int u = ub + threadIdx.x;
      if (u < ue) {
        const int code = units[u];
        const int g = code >> 4, block = code & 7, off = kT * block;
        const int e = items[g] >> 1;
        D<kT> r[6];
        if ((items[g] & 1) == 0) {
          D<kT> li[7], lj[7];
          const int si = min(max(sf[e], 0), S - 1), sj = min(max(st[e], 0), S - 1);
          const int qi = off - 6 * si, qj = off - 6 * sj;   // the block within δL_s
#pragma unroll
          for (int k = 0; k < 7; ++k) {
            li[k].v = Lv[si][k];
            lj[k].v = Lv[sj][k];
#pragma unroll
            for (int q = 0; q < kT; ++q) {
              li[k].d[q] = qi >= 0 && qi < 6 ? Ld[si][k][qi + q] : 0.f;
              lj[k].d[q] = qj >= 0 && qj < 6 ? Ld[sj][k][qj + q] : 0.f;
            }
          }
          sensor_residual(Xi + 7LL * e, Xj + 7LL * e, consts + 9 * g, li, lj, r);
        } else {
          D<kT> pd[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) pd[k] = seeded(theta[6 * S + k], 6 * S + k, off);
          odometry_residual(meas + 7LL * e, consts + 9 * g, pd, r);
        }
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          double* row = tile[6 * (g - g0) + k];
#pragma unroll
          for (int q = 0; q < kT; ++q) row[off + q] = r[k].d[q];
          if (code & 8) row[P] = r[k].v;
        }
      }
      __syncthreads();
      if (slice < Sh::SLICES)
        for (int q = slice; q < rows; q += Sh::SLICES) acc += tile[q][ea] * tile[q][eb];
      __syncthreads();
      ub = ue;
    }
    UZ_LAP(2);
    if (slice < Sh::SLICES) slice_sum[slice][entry] = acc;
    __syncthreads();
    if (threadIdx.x < NT) {
      double s = slice_sum[0][threadIdx.x];
#pragma unroll
      for (int q = 1; q < Sh::SLICES; ++q) s += slice_sum[q][threadIdx.x];
      part[threadIdx.x] = s;
    }
    cluster.sync();   // every CTA's sums are in place
    UZ_LAP(3);
    if (rank == 0) {
      if (threadIdx.x < NT) {
        double v[kCtas];   // every CTA's entry in flight at once, summed in rank order
#pragma unroll
        for (int q = 0; q < kCtas; ++q) v[q] = *cluster.map_shared_rank(&part[threadIdx.x], q);
        double s = 0.0;
#pragma unroll
        for (int q = 0; q < kCtas; ++q) s += v[q];
        tot[threadIdx.x] = s;
      }
      __syncthreads();
      UZ_LAP(4);
      if (warp == 0) solve_step<S>(tot, theta, theta_out, hist, step, iterations, sqrt_prior,
                                   damping);
    }
    UZ_LAP(5);
    cluster.sync();   // the leader has read the sums and updated θ
    // the new θ, read from the leader (which writes it again only after the
    // next step's first barrier, which this CTA reaches after the read)
    if (step < iterations && rank != 0 && threadIdx.x < P)
      theta[threadIdx.x] = *cluster.map_shared_rank(&theta[threadIdx.x], 0);
    __syncthreads();
    UZ_LAP(6);
  }
#ifdef UZ_CALIB_STAMPS
  if (rank == 0 && threadIdx.x == 0) {
    phase[7] = now_ns() - t_start;
    unsigned long long* out = reinterpret_cast<unsigned long long*>(scratch);
    for (int q = 0; q < 8; ++q) out[q] = phase[q];
  }
#endif
#undef UZ_LAP
}

template <int S>
int launch(const float* Xi, const float* Xj, const float* meas, const bool* is_sensor,
           const bool* is_odom, const int* sf, const int* st, const float* L0, int E,
           int iterations, float sqrt_prior, float damping, int* scratch, float* theta,
           float* hist, cudaStream_t stream) {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCtas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Shape<S>::TILE_BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (dev >= kMaxDevices || !ready[dev]) {
    // once per device: the tile's shared memory and a cluster above the
    // portable 8 must be allowed, and the cluster must fit the card
    err = cudaFuncSetAttribute(calib_cluster<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(Shape<S>::TILE_BYTES));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(calib_cluster<S>, cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return static_cast<int>(err);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, calib_cluster<S>, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    if (dev < kMaxDevices) ready[dev] = true;
  }
  return static_cast<int>(cudaLaunchKernelEx(&cfg, calib_cluster<S>, Xi, Xj, meas, is_sensor,
                                             is_odom, sf, st, L0, E, iterations, sqrt_prior,
                                             damping, scratch, theta, hist));
}

}  // namespace

// theta (6S + 3,) and the cost history (iterations + 1,) of `iterations`
// Gauss-Newton steps from θ = [0, 1, 0, 0] over E edges: endpoint poses
// Xi, Xj (E, 7), measurements meas (E, 7), the factor flags, the sensor
// indices sf, st (E,) (clamped to 0..S-1) and the initial extrinsics L0
// (S, 7); scratch, kCtas·(30·⌈E/kCtas⌉ + 1) int32 (each CTA's groups, their
// units, first units and constants).  One cluster of kCtas CTAs; S is 1 or 2;
// 701 = cudaErrorLaunchOutOfResources if the cluster does not fit the card.
extern "C" int uz_calib_gn(const float* Xi, const float* Xj, const float* meas,
                           const bool* is_sensor, const bool* is_odom, const int* sf,
                           const int* st, const float* L0, int E, int S, int iterations,
                           float sqrt_prior, float damping, int* scratch, float* theta,
                           float* hist, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (E < 0 || iterations < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (S == 1)
    return launch<1>(Xi, Xj, meas, is_sensor, is_odom, sf, st, L0, E, iterations,
                     sqrt_prior, damping, scratch, theta, hist, s);
  if (S == 2)
    return launch<2>(Xi, Xj, meas, is_sensor, is_odom, sf, st, L0, E, iterations,
                     sqrt_prior, damping, scratch, theta, hist, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
