// K3 chain_apply: the substitution sweeps of the chain preconditioner.
//
// Replaces uzliti_slam_tpu/graph/tridiag.py:block_tridiag_apply for one
// right-hand side (the form PCG uses).  block_tridiag_factor stored, per
// cyclic-reduction level of size m = 2·half, the products
// (Dinv_o, P1m, P2, G1, G2), each (half, 6, 6).  The forward sweep reduces
//   b'[j]  = b[2j] - P1m[j]·b[2j-1] - P2[j]·b[2j+1]     (b[-1] = 0)
// level by level down to the dense root, x' = root_inv·b' (one launch, a
// warp per row of root_inv, lanes striding the row and a fixed shuffle
// tree, so no library call); the back sweep expands
//   x[2j]   = x'[j]
//   x[2j+1] = Dinv_o[j]·b[2j+1] - G1[j]·x'[j] - G2[j]·x'[j+1]   (x'[half] = 0).
// The two shifts are the reference's roll-and-zero (tridiag.py:221, 239).
// The pad to a power of two is done by reading: rows at or past the valid
// count of the caller's vector read as zero, and the last back level writes
// only the valid rows, so no padded copy of b or x is ever made.
//
// With no reduction level the root launch reads the caller's b and writes
// only its valid rows.
//
// One launch per level and direction, one thread per (block row, row): a
// level is a batch of 6x6 matvecs, bound by launch latency at the headline
// (1024 blocks, 4 levels) and by reading the level's 6x6 products at 1e5
// nodes.
#include <cuda_runtime.h>

#include "lie.cuh"

namespace {

__device__ __forceinline__ float row_or_zero(const float* b, int row, int m_valid, int c) {
  return (row >= 0 && row < m_valid) ? b[row * 6 + c] : 0.f;
}

__global__ void chain_forward(const float* __restrict__ b, int m_valid,
                              const float* __restrict__ P1m, const float* __restrict__ P2,
                              int half, float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= half * 6) return;
  const int j = t / 6, i = t % 6;
  float a = 0.f, c = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    a += P1m[j * 36 + i * 6 + k] * row_or_zero(b, 2 * j - 1, m_valid, k);
    c += P2[j * 36 + i * 6 + k] * row_or_zero(b, 2 * j + 1, m_valid, k);
  }
  out[t] = row_or_zero(b, 2 * j, m_valid, i) - a - c;
}

__global__ void chain_backward(const float* __restrict__ b, int m_valid,
                               const float* __restrict__ xh, const float* __restrict__ Dinv_o,
                               const float* __restrict__ G1, const float* __restrict__ G2,
                               int half, float* __restrict__ x, int out_rows) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= half * 6) return;
  const int j = t / 6, i = t % 6;
  float a = 0.f, g1 = 0.f, g2 = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    a += Dinv_o[j * 36 + i * 6 + k] * row_or_zero(b, 2 * j + 1, m_valid, k);
    g1 += G1[j * 36 + i * 6 + k] * xh[j * 6 + k];
    g2 += G2[j * 36 + i * 6 + k] * (j + 1 < half ? xh[(j + 1) * 6 + k] : 0.f);
  }
  if (2 * j < out_rows) x[(2 * j) * 6 + i] = xh[t];
  if (2 * j + 1 < out_rows) x[(2 * j + 1) * 6 + i] = a - g1 - g2;
}

__global__ void chain_root(const float* __restrict__ root_inv, const float* __restrict__ b,
                           int m_valid, int n, float* __restrict__ x, int out_rows) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= n) return;
  const int valid = 6 * m_valid;
  float s = 0.f;
  for (int k = lane; k < valid && k < n; k += 32)
    s += root_inv[static_cast<long long>(row) * n + k] * b[k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0 && row < 6 * out_rows) x[row] = s;
}

}  // namespace

// x (out_rows, 6) = root_inv (n, n) · b, with b's rows at or past m_valid
// (of n / 6) reading as zero.
extern "C" int uz_chain_root(const float* root_inv, const float* b, int m_valid, int n, float* x,
                             int out_rows, void* stream) {
  const int rows_per_block = kThreads / 32;
  if (n > 0)
    chain_root<<<(n + rows_per_block - 1) / rows_per_block, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(root_inv, b, m_valid, n, x, out_rows);
  return static_cast<int>(cudaGetLastError());
}

// out (half, 6) = one forward level over b (m_valid valid rows of 2·half).
extern "C" int uz_chain_forward(const float* b, int m_valid, const float* P1m, const float* P2,
                                int half, float* out, void* stream) {
  if (half > 0)
    chain_forward<<<blocks_for(6LL * half), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        b, m_valid, P1m, P2, half, out);
  return static_cast<int>(cudaGetLastError());
}

// x (out_rows, 6) = one back level from the coarse solution xh (half, 6).
extern "C" int uz_chain_backward(const float* b, int m_valid, const float* xh, const float* Dinv_o,
                                 const float* G1, const float* G2, int half, float* x,
                                 int out_rows, void* stream) {
  if (half > 0)
    chain_backward<<<blocks_for(6LL * half), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        b, m_valid, xh, Dinv_o, G1, G2, half, x, out_rows);
  return static_cast<int>(cudaGetLastError());
}
