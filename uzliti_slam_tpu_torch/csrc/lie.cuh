// SE(3)/SO(3) algebra for one edge, in registers.
//
// Device twin of uzliti_slam_tpu_torch/ops/lie.py (itself the port of
// uzliti_slam_tpu/ops/lie.py): the same layouts (pose [t, q_wxyz], twist
// [v, w]), the same small-angle branches and cutoffs (_EPS = 1e-6, the
// 1e-2 Taylor switch of _se3_Q, the 1e-30 floor of _safe_norm, the w >= 0
// quaternion sign rule) and the same order of operations where it changes
// float32 rounding.  Built without --use_fast_math: sinf/cosf/atan2f/sqrtf
// and '/' are the IEEE-accurate versions, so the branches sit where the
// reference puts them.
#pragma once

#include <cuda_runtime.h>

namespace uz {

constexpr float kEps = 1e-6f;

// max(x, lo) that propagates NaN, as jnp.maximum does (fmaxf would not).
__device__ __forceinline__ float floor_at(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float safe_norm3(const float v[3]) {
  return sqrtf(floor_at(v[0] * v[0] + v[1] * v[1] + v[2] * v[2], 1e-30f));
}

// ---------------------------------------------------------------- quaternions

__device__ __forceinline__ void quat_normalize(float q[4]) {
  const float n = sqrtf(floor_at(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], 1e-30f));
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
  if (q[0] < 0.f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
  }
}

__device__ __forceinline__ void quat_mul(const float a[4], const float b[4], float o[4]) {
  o[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  o[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  o[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  o[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3], float o[3]) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// v' = v + 2*qw*(qv x v) + 2*qv x (qv x v)
__device__ __forceinline__ void quat_rotate(const float q[4], const float v[3], float o[3]) {
  const float qv[3] = {q[1], q[2], q[3]};
  float uv[3], uuv[3];
  cross3(qv, v, uv);
  cross3(qv, uv, uuv);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = v[i] + 2.f * (q[0] * uv[i] + uuv[i]);
}

__device__ __forceinline__ void quat_to_matrix(const float q[4], float R[3][3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  R[0][0] = 1.f - 2.f * (yy + zz); R[0][1] = 2.f * (xy - wz); R[0][2] = 2.f * (xz + wy);
  R[1][0] = 2.f * (xy + wz); R[1][1] = 1.f - 2.f * (xx + zz); R[1][2] = 2.f * (yz - wx);
  R[2][0] = 2.f * (xz - wy); R[2][1] = 2.f * (yz + wx); R[2][2] = 1.f - 2.f * (xx + yy);
}

// ---------------------------------------------------------------------- SO(3)

__device__ __forceinline__ void hat3(const float p[3], float K[3][3]) {
  K[0][0] = 0.f;   K[0][1] = -p[2]; K[0][2] = p[1];
  K[1][0] = p[2];  K[1][1] = 0.f;   K[1][2] = -p[0];
  K[2][0] = -p[1]; K[2][1] = p[0];  K[2][2] = 0.f;
}

__device__ __forceinline__ void mm3(const float A[3][3], const float B[3][3], float C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

__device__ __forceinline__ void mv3(const float A[3][3], const float v[3], float o[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = A[i][0] * v[0] + A[i][1] * v[1] + A[i][2] * v[2];
}

// out = I + a*K + b*(K@K)
__device__ __forceinline__ void eye_plus(const float K[3][3], float a, float b, float out[3][3]) {
  float KK[3][3];
  mm3(K, K, KK);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      out[i][j] = ((i == j) ? 1.f : 0.f) + a * K[i][j] + b * KK[i][j];
}

__device__ __forceinline__ void quat_from_axis_angle(const float phi[3], float q[4]) {
  const float theta = safe_norm3(phi);
  const float half = 0.5f * theta;
  const bool small = theta < kEps;
  // sin(t/2)/t with Taylor fallback 0.5 - t^2/48
  const float k = small ? 0.5f - theta * theta / 48.f : sinf(half) / theta;
  q[0] = cosf(half);
  q[1] = k * phi[0]; q[2] = k * phi[1]; q[3] = k * phi[2];
  quat_normalize(q);
}

__device__ __forceinline__ void quat_to_axis_angle(const float q_in[4], float phi[3]) {
  float q[4] = {q_in[0], q_in[1], q_in[2], q_in[3]};
  quat_normalize(q);
  const float w = fminf(fmaxf(q[0], -1.f), 1.f);
  const float v[3] = {q[1], q[2], q[3]};
  const float vn = safe_norm3(v);
  const float theta = 2.f * atan2f(vn, w);
  const bool small = vn < kEps;
  const float scale = small ? 2.f / (fabsf(w) < 1e-12f ? 1.f : w) : theta / vn;
#pragma unroll
  for (int i = 0; i < 3; ++i) phi[i] = scale * v[i];
}

__device__ __forceinline__ void so3_left_jacobian(const float phi[3], float J[3][3]) {
  const float theta = safe_norm3(phi);
  const bool small = theta < kEps;
  const float t2 = theta * theta;
  const float b = small ? 0.5f - t2 / 24.f : (1.f - cosf(theta)) / t2;
  const float c = small ? 1.f / 6.f - t2 / 120.f : (theta - sinf(theta)) / (t2 * theta);
  float K[3][3];
  hat3(phi, K);
  eye_plus(K, b, c, J);
}

__device__ __forceinline__ void so3_left_jacobian_inv(const float phi[3], float J[3][3]) {
  const float theta = safe_norm3(phi);
  const bool small = theta < kEps;
  const float t2 = theta * theta;
  const float half = 0.5f * theta;
  // 1/t^2 - (1+cos t)/(2 t sin t)  ==  (1 - t/2 * cot(t/2)) / t^2
  const float cot = small ? 1.f / 12.f + t2 / 720.f
                          : (1.f - half * cosf(half) / sinf(half)) / t2;
  float K[3][3];
  hat3(phi, K);
  eye_plus(K, -0.5f, cot, J);
}

// ---------------------------------------------------------------------- SE(3)

__device__ __forceinline__ void pose_compose(const float a[7], const float b[7], float o[7]) {
  float rt[3];
  quat_rotate(a + 3, b, rt);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = a[i] + rt[i];
  quat_mul(a + 3, b + 3, o + 3);
  quat_normalize(o + 3);
}

__device__ __forceinline__ void pose_inverse(const float p[7], float o[7]) {
  o[3] = p[3]; o[4] = -p[4]; o[5] = -p[5]; o[6] = -p[6];
  float rt[3];
  quat_rotate(o + 3, p, rt);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = -rt[i];
}

__device__ __forceinline__ void se3_exp(const float xi[6], float p[7]) {
  quat_from_axis_angle(xi + 3, p + 3);
  float V[3][3];
  so3_left_jacobian(xi + 3, V);
  mv3(V, xi, p);
}

__device__ __forceinline__ void se3_log(const float p[7], float xi[6]) {
  quat_to_axis_angle(p + 3, xi + 3);
  float Vinv[3][3];
  so3_left_jacobian_inv(xi + 3, Vinv);
  mv3(Vinv, p, xi);
}

// r = log(meas^-1 · (X_i^-1 · X_j))
__device__ __forceinline__ void edge_residual(const float pi[7], const float pj[7],
                                              const float meas[7], float r[6]) {
  float inv[7], pred[7], d[7];
  pose_inverse(pi, inv);
  pose_compose(inv, pj, pred);
  pose_inverse(meas, inv);
  pose_compose(inv, pred, d);
  se3_log(d, r);
}

__device__ __forceinline__ void se3_adjoint(const float p[7], float A[6][6]) {
  float R[3][3], tK[3][3], tKR[3][3];
  quat_to_matrix(p + 3, R);
  hat3(p, tK);
  mm3(tK, R, tKR);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i][j] = R[i][j];
      A[i][j + 3] = tKR[i][j];
      A[i + 3][j] = 0.f;
      A[i + 3][j + 3] = R[i][j];
    }
}

// Barfoot's Q(rho, phi) (State Estimation for Robotics eq. 7.86).
__device__ __forceinline__ void se3_Q(const float rho[3], const float phi[3], float Q[3][3]) {
  const float t = safe_norm3(phi);
  const bool small = t < 1e-2f;
  const float t2 = t * t;
  const float t4 = t2 * t2;
  const float st = sinf(t), ct = cosf(t);
  // (θ - sinθ)/θ³ ; (θ²/2 + cosθ - 1)/θ⁴ ; (θ - sinθ - θ³/6)/θ⁵
  const float c1 = small ? 1.f / 6.f - t2 / 120.f : (t - st) / (t2 * t);
  const float c2 = small ? 1.f / 24.f - t2 / 720.f : (t2 / 2.f + ct - 1.f) / t4;
  const float c3 = small ? -1.f / 120.f + t2 / 5040.f : (t - st - t2 * t / 6.f) / (t4 * t);
  float rx[3][3], px[3][3], pxrx[3][3], rxpx[3][3], pxrxpx[3][3];
  float a[3][3], b[3][3], c[3][3], d[3][3];
  hat3(rho, rx);
  hat3(phi, px);
  mm3(px, rx, pxrx);
  mm3(rx, px, rxpx);
  mm3(pxrx, px, pxrxpx);
  mm3(px, pxrx, a);
  mm3(rxpx, px, b);
  mm3(pxrxpx, px, c);
  mm3(px, pxrxpx, d);
  const float c4 = 0.5f * (c2 + 3.f * c3);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Q[i][j] = 0.5f * rx[i][j]
              + c1 * (pxrx[i][j] + rxpx[i][j] + pxrxpx[i][j])
              + c2 * (a[i][j] + b[i][j] - 3.f * pxrxpx[i][j])
              + c4 * (c[i][j] + d[i][j]);
}

// Inverse left Jacobian of SE(3): [[J⁻¹, -J⁻¹ Q J⁻¹], [0, J⁻¹]].
__device__ __forceinline__ void se3_left_jacobian_inv(const float xi[6], float J[6][6]) {
  float Jinv[3][3], Q[3][3], JQ[3][3], TR[3][3];
  so3_left_jacobian_inv(xi + 3, Jinv);
  se3_Q(xi, xi + 3, Q);
  mm3(Jinv, Q, JQ);
  mm3(JQ, Jinv, TR);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      J[i][j] = Jinv[i][j];
      J[i][j + 3] = -TR[i][j];
      J[i + 3][j] = 0.f;
      J[i + 3][j + 3] = Jinv[i][j];
    }
}

// Huber weight on the Mahalanobis norm (g2o RobustKernelHuber).
__device__ __forceinline__ float huber_weight(float chi2, float delta) {
  const float e = sqrtf(floor_at(chi2, 1e-12f));
  return e <= delta ? 1.f : delta / e;
}

// r^T L r for a 6x6 L stored row-major.
__device__ __forceinline__ float quad6(const float r[6], const float* L) {
  float chi2 = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) s += L[i * 6 + j] * r[j];
    chi2 += r[i] * s;
  }
  return chi2;
}

}  // namespace uz

// Launch geometry shared by every kernel of the package.
constexpr int kThreads = 256;

static inline int blocks_for(long long n) {
  return static_cast<int>((n + kThreads - 1) / kThreads);
}
