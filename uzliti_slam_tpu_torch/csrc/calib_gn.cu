// K20 calib_gn: the calibration's Gauss-Newton steps.
//
// Replaces uzliti_slam_tpu/graph/calibration.py:calibrate (:63-133).  Each
// of the reference's steps evaluates the residual vector and its dense
// forward-mode Jacobian (jax.jacfwd), (6E + 6S + 3) x (6S + 3) floats, forms
// JᵀJ + damping·I and Jᵀr by matrix products, solves, and evaluates the
// cost again.  Here, per step:
//   - calib_edges: a grid-stride pass over the edges.  Each thread evaluates
//     its edge's sensor residual (is_sensor) and drift-corrected odometry
//     residual (is_odom) in forward-mode dual numbers with P = 6S + 3
//     tangents: the same function of the same float32 values that jacfwd
//     differentiates, taking the tangent of whichever small-angle branch
//     the value selects, as jacfwd does (not an analytic Jacobian).  Each
//     residual's contribution to JᵀJ (upper triangle), Jᵀr and ‖r‖² is
//     summed in float64 over the warp by a shuffle tree and added by lane
//     0 into the warp's row of shared memory; the CTA then sums its warps in
//     order into one row of partials.  No atomics: the sums are the same
//     whatever order the threads run in.
//   - calib_solve: one CTA sums the partial rows in order, adds the priors
//     analytically (√w·I on the extrinsics' block, 1e-2·I on the drift
//     parameters, with their residuals), records ½‖r‖² of the current θ in
//     the cost history, adds the damping, solves the P x P system by
//     Gaussian elimination with partial pivoting in float64, and updates θ
//     on the device.
// One call runs all steps (2 launches each, then a last edge pass and a
// cost-only solve pass for the final cost): no host read.
// The dual numbers follow uzliti_slam_tpu_torch/ops/lie.py (the port of the
// reference's lie ops) function for function; where torch.func.jacfwd
// and jax.jacfwd differ (clamp's tangent at its bound: torch 1, JAX 1/2),
// this follows the plain version.
//
// What bounds it on the card: the operations, ~20 dual operations of P + 1
// floats per pose operation, ~40 pose operations per edge and P(P+1)/2
// products per residual row: ~1e4 per edge at P = 9 (4e7 for 4,096 edges
// over 20 steps: 0.6 us at 67 TFLOP/s); the bytes are the edge tables,
// read once per step (~0.3 MB).
#include <cuda_runtime.h>

namespace {

constexpr int kCalibThreads = 256;
constexpr int kWarps = kCalibThreads / 32;
constexpr int kSolveThreads = 128;
constexpr float kEps = 1e-6f;

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

// r = log(T_e⁻¹ · (X_i L_sf)⁻¹ (X_j L_st))
template <int P>
__device__ void sensor_residual(const float* xi, const float* xj, const float* meas,
                                const D<P>* li, const D<P>* lj, D<P>* r) {
  D<P> a[7], b[7], c[7], ai[7];
  load_pose(xi, c);
  pose_compose(c, li, a);
  load_pose(xj, c);
  pose_compose(c, lj, b);
  pose_inverse(a, ai);
  pose_compose(ai, b, c);      // pred
  load_pose(meas, a);
  pose_inverse(a, ai);
  pose_compose(ai, c, b);
  se3_log(b, r);
}

// r = log((X_i⁻¹ X_j)⁻¹ · warp(T_e, p)), warp = calibration.odometry_drift_correct
template <int P>
__device__ void odometry_residual(const float* xi, const float* xj, const float* meas,
                                  const D<P>* p, D<P>* r) {
  const float w = meas[3], x = meas[4], y = meas[5], z = meas[6];
  const float yaw = atan2f(2.f * (w * z + x * y), 1.f - 2.f * (y * y + z * z));
  const float tn = sqrtf(meas[0] * meas[0] + meas[1] * meas[1] + meas[2] * meas[2]);
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
  D<P> a[7], ai[7], rel[7];
  load_pose(xi, a);
  pose_inverse(a, ai);
  load_pose(xj, a);
  pose_compose(ai, a, rel);
  pose_inverse(rel, ai);
  pose_compose(ai, warped, a);
  se3_log(a, r);
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// acc[...] += this warp's Σ of one residual group's JᵀJ (upper), Jᵀr, ‖r‖²
template <int P>
__device__ __forceinline__ void accumulate(const D<P>* r, double* acc, int lane) {
  int idx = 0;
  for (int a = 0; a < P; ++a) {
    for (int b = a; b < P; ++b) {
      double s = 0.0;
#pragma unroll
      for (int k = 0; k < 6; ++k) s += static_cast<double>(r[k].d[a]) * r[k].d[b];
      s = warp_sum(s);
      if (lane == 0) acc[idx] += s;
      ++idx;
    }
  }
  for (int a = 0; a < P; ++a) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < 6; ++k) s += static_cast<double>(r[k].d[a]) * r[k].v;
    s = warp_sum(s);
    if (lane == 0) acc[idx] += s;
    ++idx;
  }
  double s = 0.0;
#pragma unroll
  for (int k = 0; k < 6; ++k) s += static_cast<double>(r[k].v) * r[k].v;
  s = warp_sum(s);
  if (lane == 0) acc[idx] += s;
}

template <int S>
__global__ void init_theta(float* theta) {
  const int k = threadIdx.x;
  if (k < 6 * S + 3) theta[k] = (k == 6 * S) ? 1.f : 0.f;
}

template <int S>
__global__ void __launch_bounds__(kCalibThreads)
calib_edges(const float* __restrict__ Xi, const float* __restrict__ Xj,
            const float* __restrict__ meas, const bool* __restrict__ is_sensor,
            const bool* __restrict__ is_odom, const int* __restrict__ sf,
            const int* __restrict__ st, const float* __restrict__ L0,
            const float* __restrict__ theta, int E, double* __restrict__ partials) {
  constexpr int P = 6 * S + 3;
  constexpr int NT = P * (P + 1) / 2 + P + 1;
  __shared__ double acc[kWarps][NT];
  __shared__ D<P> L[S][7];   // the extrinsics at θ, with their tangents
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = threadIdx.x; k < kWarps * NT; k += kCalibThreads) (&acc[0][0])[k] = 0.0;
  if (threadIdx.x < S) {   // L_s = L0_s ∘ exp(δL_s)
    const int s = threadIdx.x;
    D<P> dl[6], ex[7], l0[7];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      dl[k] = cst<P>(theta[6 * s + k]);
      dl[k].d[6 * s + k] = 1.f;
    }
    se3_exp(dl, ex);
    load_pose(L0 + 7 * s, l0);
    pose_compose(l0, ex, L[s]);
  }
  D<P> p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = cst<P>(theta[6 * S + k]);
    p[k].d[6 * S + k] = 1.f;
  }
  __syncthreads();
  const int stride = gridDim.x * kCalibThreads;
  for (int base = blockIdx.x * kCalibThreads; base < E; base += stride) {   // uniform per CTA
    const int e = base + threadIdx.x;
    D<P> r[6];
    if (e < E && is_sensor[e]) {
      sensor_residual(Xi + 7 * e, Xj + 7 * e, meas + 7 * e, L[min(max(sf[e], 0), S - 1)],
                      L[min(max(st[e], 0), S - 1)], r);
    } else {
#pragma unroll
      for (int k = 0; k < 6; ++k) r[k] = cst<P>(0.f);
    }
    accumulate(r, acc[warp], lane);
    if (e < E && is_odom[e]) {
      odometry_residual(Xi + 7 * e, Xj + 7 * e, meas + 7 * e, p, r);
    } else {
#pragma unroll
      for (int k = 0; k < 6; ++k) r[k] = cst<P>(0.f);
    }
    accumulate(r, acc[warp], lane);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < NT; k += kCalibThreads) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += acc[w][k];
    partials[static_cast<long long>(blockIdx.x) * NT + k] = s;
  }
}

template <int S>
__global__ void __launch_bounds__(kSolveThreads)
calib_solve(const double* __restrict__ partials, int nb, float* __restrict__ theta,
            float* __restrict__ hist, int step, int update, float sqrt_prior, float damping) {
  constexpr int P = 6 * S + 3;
  constexpr int NT = P * (P + 1) / 2 + P + 1;
  __shared__ double tot[NT];
  __shared__ double A[P][P + 1];
  for (int k = threadIdx.x; k < NT; k += kSolveThreads) {
    double s = 0.0;
    for (int b = 0; b < nb; ++b) s += partials[static_cast<long long>(b) * NT + k];
    tot[k] = s;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  int idx = 0;
  for (int a = 0; a < P; ++a)
    for (int b = a; b < P; ++b) {
      A[a][b] = tot[idx];
      A[b][a] = tot[idx];
      ++idx;
    }
  for (int a = 0; a < P; ++a) A[a][P] = tot[idx++];
  double cost = 0.5 * tot[idx];
  // priors: r = √w·δL on the extrinsics, 1e-2·(p - [1, 0, 0]) on the drift
  for (int k = 0; k < P; ++k) {
    const bool ext = k < 6 * S;
    const float jac = ext ? sqrt_prior : 0.01f;
    const float x = theta[k];
    const float res = ext ? __fmul_rn(sqrt_prior, x)
                          : __fmul_rn(0.01f, __fsub_rn(x, k == 6 * S ? 1.f : 0.f));
    A[k][k] += static_cast<double>(jac) * jac;
    A[k][P] += static_cast<double>(jac) * res;
    cost += 0.5 * static_cast<double>(res) * res;
  }
  hist[step] = static_cast<float>(cost);
  if (!update) return;
  for (int k = 0; k < P; ++k) A[k][k] += static_cast<double>(damping);
  // Gaussian elimination with partial pivoting on [H | g]
  for (int c = 0; c < P; ++c) {
    int piv = c;
    for (int r = c + 1; r < P; ++r)
      if (fabs(A[r][c]) > fabs(A[piv][c])) piv = r;
    if (piv != c)
      for (int k = c; k <= P; ++k) {
        const double t = A[c][k];
        A[c][k] = A[piv][k];
        A[piv][k] = t;
      }
    for (int r = c + 1; r < P; ++r) {
      const double f = A[r][c] / A[c][c];
      for (int k = c; k <= P; ++k) A[r][k] -= f * A[c][k];
    }
  }
  double x[P];
  for (int r = P - 1; r >= 0; --r) {
    double s = A[r][P];
    for (int k = r + 1; k < P; ++k) s -= A[r][k] * x[k];
    x[r] = s / A[r][r];
  }
  for (int k = 0; k < P; ++k) theta[k] = __fsub_rn(theta[k], __double2float_rn(x[k]));
}

template <int S>
int run(const float* Xi, const float* Xj, const float* meas, const bool* is_sensor,
        const bool* is_odom, const int* sf, const int* st, const float* L0, int E,
        int iterations, float sqrt_prior, float damping, int nb, double* partials,
        float* theta, float* hist, cudaStream_t s) {
  init_theta<S><<<1, 32, 0, s>>>(theta);
  cudaError_t err = cudaGetLastError();
  for (int step = 0; step <= iterations && err == cudaSuccess; ++step) {
    calib_edges<S><<<nb, kCalibThreads, 0, s>>>(Xi, Xj, meas, is_sensor, is_odom, sf, st, L0,
                                                theta, E, partials);
    err = cudaGetLastError();
    if (err != cudaSuccess) break;
    calib_solve<S><<<1, kSolveThreads, 0, s>>>(partials, nb, theta, hist, step,
                                               step < iterations, sqrt_prior, damping);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// theta (6S + 3,) and the cost history (iterations + 1,) of `iterations`
// Gauss-Newton steps from θ = [0, 1, 0, 0] over E edges: endpoint poses
// Xi, Xj (E, 7), measurements meas (E, 7), the factor flags, the sensor
// indices sf, st (E,) (clamped to 0..S-1) and the initial extrinsics L0
// (S, 7); partials (nb, NT) float64 scratch, NT = P(P+1)/2 + P + 1.
extern "C" int uz_calib_gn(const float* Xi, const float* Xj, const float* meas,
                           const bool* is_sensor, const bool* is_odom, const int* sf,
                           const int* st, const float* L0, int E, int S, int iterations,
                           float sqrt_prior, float damping, int nb, double* partials,
                           float* theta, float* hist, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nb <= 0 || iterations < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (S == 1)
    return run<1>(Xi, Xj, meas, is_sensor, is_odom, sf, st, L0, E, iterations, sqrt_prior,
                  damping, nb, partials, theta, hist, s);
  if (S == 2)
    return run<2>(Xi, Xj, meas, is_sensor, is_odom, sf, st, L0, E, iterations, sqrt_prior,
                  damping, nb, partials, theta, hist, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
