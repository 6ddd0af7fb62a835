// Small dense linear algebra in one thread's registers, shared by K7
// (ransac_rigid.cu), K27 (gicp.cu) and K28 (pnp.cu): the Shepperd
// quaternion of a rotation matrix (lie.matrix_to_quat), the proper rotation
// of a 3x3 by one-sided cyclic Jacobi (the Kabsch optimum; the reference
// takes it from an SVD), a 6x6 solve by LU with partial pivoting in
// registers, and fixed-order warp reductions (a reduce-scatter of up to 32
// floats; a butterfly of float or double).  No library call:
// cuSOLVER's solves check an info flag on the host.
#pragma once

#include <cuda_runtime.h>

#include "lie.cuh"

namespace uz {

constexpr int kRotationSweeps = 12;   // one-sided Jacobi sweeps at most

// lie.matrix_to_quat: Shepperd's four candidates, the largest pivot kept
__device__ inline void matrix_to_quat(const float m[3][3], float q[4]) {
  const float tr = m[0][0] + m[1][1] + m[2][2];
  const float piv[4] = {1.f + tr, 1.f + m[0][0] - m[1][1] - m[2][2],
                        1.f - m[0][0] + m[1][1] - m[2][2], 1.f - m[0][0] - m[1][1] + m[2][2]};
  int b = 0;
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (piv[i] > piv[b]) b = i;
  if (b == 0) {
    q[0] = piv[0]; q[1] = m[2][1] - m[1][2]; q[2] = m[0][2] - m[2][0]; q[3] = m[1][0] - m[0][1];
  } else if (b == 1) {
    q[0] = m[2][1] - m[1][2]; q[1] = piv[1]; q[2] = m[0][1] + m[1][0]; q[3] = m[0][2] + m[2][0];
  } else if (b == 2) {
    q[0] = m[0][2] - m[2][0]; q[1] = m[0][1] + m[1][0]; q[2] = piv[2]; q[3] = m[1][2] + m[2][1];
  } else {
    q[0] = m[1][0] - m[0][1]; q[1] = m[0][2] + m[2][0]; q[2] = m[1][2] + m[2][1]; q[3] = piv[3];
  }
  quat_normalize(q);
}

__device__ __forceinline__ void normalize3(float v[3]) {
  const float n = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
#pragma unroll
  for (int i = 0; i < 3; ++i) v[i] = v[i] / n;
}

// The rotation (c, s) = (cs, sn) of a one-sided Jacobi pair from alpha,
// beta, gamma: IEEE divisions and square roots (kFast false: K7's, which
// its plain version mirrors), or the hardware's reciprocal and reciprocal
// square root (kFast true: K28's; a few ulps in (c, s) scale the pair's
// columns alike and leave them orthogonal).
template <bool kFast>
__device__ __forceinline__ void jacobi_rotation(float alpha, float beta, float gamma, float& cs,
                                                float& sn) {
  if (kFast) {
    const float zeta = __fdividef(beta - alpha, 2.f * gamma);
    const float q = fmaf(zeta, zeta, 1.f);
    const float root = q < 3.0e38f ? q * rsqrtf(q) : fabsf(zeta);   // sqrt(1 + zeta^2)
    const float t = __fdividef(copysignf(1.f, zeta), fabsf(zeta) + root);
    cs = rsqrtf(fmaf(t, t, 1.f));
    sn = cs * t;
    return;
  }
  const float zeta = (beta - alpha) / (2.f * gamma);
  const float t = copysignf(1.f, zeta) / (fabsf(zeta) + sqrtf(1.f + zeta * zeta));
  cs = 1.f / sqrtf(1.f + t * t);
  sn = cs * t;
}

// One one-sided Jacobi rotation of columns p < q of A (V alongside); false
// where the two are already orthogonal.  Compile-time p and q keep A and V
// in registers (a run-time column index puts them in local memory).
template <int p, int q, bool kFast = false>
__device__ __forceinline__ bool jacobi_pair(float (&A)[3][3], float (&V)[3][3]) {
  float alpha = 0.f, beta = 0.f, gamma = 0.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    alpha += A[i][p] * A[i][p];
    beta += A[i][q] * A[i][q];
    gamma += A[i][p] * A[i][q];
  }
  if (kFast ? !(gamma * gamma > 1e-14f * (alpha * beta))
            : !(fabsf(gamma) > 1e-7f * sqrtf(alpha * beta)))
    return false;
  float cs, sn;
  jacobi_rotation<kFast>(alpha, beta, gamma, cs, sn);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float ap = A[i][p], aq = A[i][q];
    A[i][p] = cs * ap - sn * aq;
    A[i][q] = sn * ap + cs * aq;
    const float vp = V[i][p], vq = V[i][q];
    V[i][p] = cs * vp - sn * vq;
    V[i][q] = sn * vp + cs * vq;
  }
  return true;
}

// x[k] for a run-time k in 0..2, by selects (registers, not local memory)
__device__ __forceinline__ float pick3(const float x[3], int k) {
  return k == 0 ? x[0] : (k == 1 ? x[1] : x[2]);
}

// The proper rotation of C = U S V^T: R = U diag(1, 1, sign(det U det V))
// V^T (Kabsch's optimum; the polar factor where det C > 0), by one-sided
// cyclic Jacobi (its rotations by jacobi_rotation<kFast>); returns the
// singular values' sum.
template <bool kFast = false>
__device__ inline float proper_rotation(const float C[3][3], float R[3][3]) {
  float A[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i][j] = C[i][j];
      V[i][j] = i == j ? 1.f : 0.f;
    }
  for (int sweep = 0; sweep < kRotationSweeps; ++sweep) {
    const bool r01 = jacobi_pair<0, 1, kFast>(A, V);
    const bool r02 = jacobi_pair<0, 2, kFast>(A, V);
    const bool r12 = jacobi_pair<1, 2, kFast>(A, V);
    if (!(r01 || r02 || r12)) break;
  }
  float sig[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) sig[k] = sqrtf(A[0][k] * A[0][k] + A[1][k] * A[1][k] + A[2][k] * A[2][k]);
  int i1 = 0;
#pragma unroll
  for (int k = 1; k < 3; ++k)
    if (sig[k] > pick3(sig, i1)) i1 = k;
  int i2 = i1 == 0 ? 1 : 0;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (k != i1 && sig[k] > pick3(sig, i2)) i2 = k;
  const float ssum = sig[0] + sig[1] + sig[2];
  const float s1 = pick3(sig, i1), s2 = pick3(sig, i2);
  if (!(s1 > 1e-30f)) {   // no spread at all: the SVD of 0 gives U = V = I
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = i == j ? 1.f : 0.f;
    return ssum;
  }
  float u1[3], u2[3], v1[3], v2[3], u3[3], v3[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u1[i] = pick3(A[i], i1);
    u2[i] = pick3(A[i], i2);
    v1[i] = pick3(V[i], i1);
    v2[i] = pick3(V[i], i2);
  }
  normalize3(u1);
  if (s2 > 1e-7f * s1) {
    const float d = u1[0] * u2[0] + u1[1] * u2[1] + u1[2] * u2[2];
#pragma unroll
    for (int i = 0; i < 3; ++i) u2[i] -= d * u1[i];
  } else {   // rank 1: any unit vector orthogonal to u1
    const int k = fabsf(u1[0]) < 0.9f ? 0 : 1;
    const float e[3] = {k == 0 ? 1.f : 0.f, k == 1 ? 1.f : 0.f, 0.f};
    cross3(u1, e, u2);
  }
  normalize3(u2);
  cross3(u1, u2, u3);
  cross3(v1, v2, v3);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) R[i][j] = u1[i] * v1[j] + u2[i] * v2[j] + u3[i] * v3[j];
  return ssum;
}

// LU with partial pivoting (the first largest pivot) of a 6x6 system, the
// right-hand side eliminated alongside, then back substitution
// (kernels/ops.py:lu_solve_plain, which divides where this multiplies by
// the pivot's correctly rounded reciprocal: the same to a rounding, six
// divisions in place of 21).  Unrolled, every index a constant: the
// pivot row is marked by one flag a row (the last row whose magnitude beat
// the running largest), never by an index, and the exchange is a
// predicated swap, so A, b and x stay in registers.  Every lane of a warp
// can solve the same system at once.
__device__ __forceinline__ void lu_solve6(float (&A)[6][6], float (&b)[6], float (&x)[6]) {
  float rcp[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    bool beat[6];
    float mx = fabsf(A[k][k]);
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      beat[i] = fabsf(A[i][k]) > mx;
      mx = beat[i] ? fabsf(A[i][k]) : mx;
    }
    bool later = false;
#pragma unroll
    for (int i = 5; i > k; --i) {
      const bool sw = beat[i] && !later;   // row i holds the first largest
      later = later || beat[i];
#pragma unroll
      for (int j = k; j < 6; ++j) {
        const float a = A[k][j], c = A[i][j];
        A[k][j] = sw ? c : a;
        A[i][j] = sw ? a : c;
      }
      const float a = b[k], c = b[i];
      b[k] = sw ? c : a;
      b[i] = sw ? a : c;
    }
    // one division a pivot: its reciprocal scales the multipliers and, in
    // the back substitution, the solution's entry (off the critical path)
    rcp[k] = 1.f / A[k][k];
#pragma unroll
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] * rcp[k];
#pragma unroll
      for (int j = k + 1; j < 6; ++j) A[i][j] = A[i][j] - l * A[k][j];
      b[i] = b[i] - l * b[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int j = i + 1; j < 6; ++j) s = s - A[i][j] * x[j];
    x[i] = s * rcp[i];
  }
}

// One level of warp_sum_scatter: lanes whose bit O is set keep the upper
// half of their first 2 O values, the others the lower half, each adding its
// partner's partials of the half it keeps (O a template constant, so that
// every index of w is a constant and w stays in registers).
template <int O>
__device__ __forceinline__ void scatter_level(float (&w)[32], int lane) {
  const bool upper = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = upper ? w[i] : w[i + O];
    const float keep = upper ? w[i + O] : w[i];
    w[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// quat_normalize by the norm's reciprocal (one division in place of four)
__device__ __forceinline__ void quat_normalize_rcp(float q[4]) {
  const float n = sqrtf(floor_at(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3], 1e-30f));
  const float r = 1.f / n;
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = q[i] * r;
  if (q[0] < 0.f) {
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = -q[i];
  }
}

// se3_exp (lie.cuh) with its divisions by theta, theta^2 and theta^3 and the
// quaternion's normalisation taken as products with reciprocals, sine and
// cosine from one sincosf a angle: the same to a rounding, in a fraction of
// the latency (each IEEE division a slow-path check on the solve's chain).
// K27's and K28's updates, which their plain versions hold within a
// tolerance.
__device__ __forceinline__ void se3_exp_rcp(const float xi[6], float p[7]) {
  const float* phi = xi + 3;
  const float theta = safe_norm3(phi);   // >= 1e-15
  const bool small = theta < kEps;
  const float t2 = theta * theta;
  const float inv_t = 1.f / theta, inv_t2 = inv_t * inv_t;
  float sh, ch, st, ct;
  sincosf(0.5f * theta, &sh, &ch);
  sincosf(theta, &st, &ct);
  // sin(t/2)/t with Taylor fallback 0.5 - t^2/48
  const float k = small ? 0.5f - t2 * (1.f / 48.f) : sh * inv_t;
  p[3] = ch;
  p[4] = k * phi[0];
  p[5] = k * phi[1];
  p[6] = k * phi[2];
  quat_normalize_rcp(p + 3);
  const float b = small ? 0.5f - t2 * (1.f / 24.f) : (1.f - ct) * inv_t2;
  const float c = small ? 1.f / 6.f - t2 * (1.f / 120.f) : (theta - st) * (inv_t2 * inv_t);
  float K[3][3], V[3][3];
  hat3(phi, K);
  eye_plus(K, b, c, V);
  mv3(V, xi, p);
}

// pose_compose (lie.cuh) with quat_normalize_rcp
__device__ __forceinline__ void pose_compose_rcp(const float a[7], const float b[7], float o[7]) {
  float rt[3];
  quat_rotate(a + 3, b, rt);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = a[i] + rt[i];
  quat_mul(a + 3, b + 3, o + 3);
  quat_normalize_rcp(o + 3);
}

// The warp's sums of up to 32 per-lane values by a reduce-scatter butterfly
// (a fixed order, 31 shuffles in place of 5 a value): after the five levels
// lane l holds the sum of value l.  All 32 lanes take part.
template <int N>
__device__ __forceinline__ float warp_sum_scatter(const float (&v)[N], int lane) {
  static_assert(N <= 32, "warp_sum_scatter: at most 32 values");
  float w[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) w[i] = i < N ? v[i] : 0.f;
  scatter_level<16>(w, lane);
  scatter_level<8>(w, lane);
  scatter_level<4>(w, lane);
  scatter_level<2>(w, lane);
  scatter_level<1>(w, lane);
  return w[0];
}

// Sums each lane's acc[0, N) over a warp by a butterfly of shuffles, a fixed
// order: at each step the two lanes of a pair add the same two values, so
// every lane ends with the same bits.  All 32 lanes take part.
template <typename S, int N>
__device__ __forceinline__ void warp_tree_sum(S (&acc)[N]) {
#pragma unroll
  for (int q = 0; q < N; ++q)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc[q] = acc[q] + __shfl_xor_sync(0xffffffffu, acc[q], off);
}

}  // namespace uz
