// Small dense linear algebra in one thread's registers, shared by K7
// (ransac_rigid.cu), K27 (gicp.cu) and K28 (pnp.cu): the Shepperd
// quaternion of a rotation matrix (lie.matrix_to_quat), the proper rotation
// of a 3x3 by one-sided cyclic Jacobi (the Kabsch optimum; the reference
// takes it from an SVD), a 6x6 solve by LU with partial pivoting, and a
// fixed-order block reduction of per-thread float sums.  No library call:
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

// The proper rotation of C = U S V^T: R = U diag(1, 1, sign(det U det V))
// V^T (Kabsch's optimum; the polar factor where det C > 0), by one-sided
// cyclic Jacobi; returns the singular values' sum.
__device__ inline float proper_rotation(const float C[3][3], float R[3][3]) {
  float A[3][3], V[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      A[i][j] = C[i][j];
      V[i][j] = i == j ? 1.f : 0.f;
    }
  const int P[3] = {0, 0, 1}, Q[3] = {1, 2, 2};
  for (int sweep = 0; sweep < kRotationSweeps; ++sweep) {
    bool rotated = false;
    for (int pq = 0; pq < 3; ++pq) {
      const int p = P[pq], q = Q[pq];
      float alpha = 0.f, beta = 0.f, gamma = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        alpha += A[i][p] * A[i][p];
        beta += A[i][q] * A[i][q];
        gamma += A[i][p] * A[i][q];
      }
      if (!(fabsf(gamma) > 1e-7f * sqrtf(alpha * beta))) continue;
      rotated = true;
      const float zeta = (beta - alpha) / (2.f * gamma);
      const float t = copysignf(1.f, zeta) / (fabsf(zeta) + sqrtf(1.f + zeta * zeta));
      const float cs = 1.f / sqrtf(1.f + t * t), sn = cs * t;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float ap = A[i][p], aq = A[i][q];
        A[i][p] = cs * ap - sn * aq;
        A[i][q] = sn * ap + cs * aq;
        const float vp = V[i][p], vq = V[i][q];
        V[i][p] = cs * vp - sn * vq;
        V[i][q] = sn * vp + cs * vq;
      }
    }
    if (!rotated) break;
  }
  float sig[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) sig[k] = sqrtf(A[0][k] * A[0][k] + A[1][k] * A[1][k] + A[2][k] * A[2][k]);
  int i1 = 0;
  for (int k = 1; k < 3; ++k)
    if (sig[k] > sig[i1]) i1 = k;
  int i2 = i1 == 0 ? 1 : 0;
  for (int k = 0; k < 3; ++k)
    if (k != i1 && sig[k] > sig[i2]) i2 = k;
  const float ssum = sig[0] + sig[1] + sig[2];
  if (!(sig[i1] > 1e-30f)) {   // no spread at all: the SVD of 0 gives U = V = I
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) R[i][j] = i == j ? 1.f : 0.f;
    return ssum;
  }
  float u1[3], u2[3], v1[3], v2[3], u3[3], v3[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u1[i] = A[i][i1];
    u2[i] = A[i][i2];
    v1[i] = V[i][i1];
    v2[i] = V[i][i2];
  }
  normalize3(u1);
  if (sig[i2] > 1e-7f * sig[i1]) {
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
// (kernels/ops.py:lu_solve_plain).
__device__ inline void lu_solve6(float A[6][6], float b[6], float x[6]) {
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float mx = fabsf(A[k][k]);
    for (int i = k + 1; i < 6; ++i)
      if (fabsf(A[i][k]) > mx) {
        mx = fabsf(A[i][k]);
        p = i;
      }
    if (p != k) {
      for (int j = 0; j < 6; ++j) {
        const float t = A[k][j];
        A[k][j] = A[p][j];
        A[p][j] = t;
      }
      const float t = b[k];
      b[k] = b[p];
      b[p] = t;
    }
    for (int i = k + 1; i < 6; ++i) {
      const float l = A[i][k] / A[k][k];
      for (int j = k + 1; j < 6; ++j) A[i][j] = A[i][j] - l * A[k][j];
      b[i] = b[i] - l * b[k];
    }
  }
  for (int i = 5; i >= 0; --i) {
    float s = b[i];
    for (int j = i + 1; j < 6; ++j) s = s - A[i][j] * x[j];
    x[i] = s / A[i][i];
  }
}

// Sums each thread's acc[0, N) over a block of T threads into red[q][0], in
// a fixed tree order (the same result run to run).
template <int N, int T>
__device__ inline void block_tree_sum(const float (&acc)[N], float (*red)[T]) {
#pragma unroll
  for (int q = 0; q < N; ++q) red[q][threadIdx.x] = acc[q];
  __syncthreads();
  for (int stride = T / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
#pragma unroll
      for (int q = 0; q < N; ++q) red[q][threadIdx.x] = red[q][threadIdx.x] + red[q][threadIdx.x + stride];
    }
    __syncthreads();
  }
}

}  // namespace uz
