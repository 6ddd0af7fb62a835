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
//
// The fleet (kernels/ops.chain_apply of a factor of many chains, for
// parallel/sharded.py:optimize_batch) runs the same launches over B instances
// at once: each instance keeps its own levels and root (each is its own
// chain, cut at the fleet's cutoff: 2 levels and a 16-block root at N = 64),
// the block rows of all instances side by side in one grid, so the launches
// per apply do not grow with B. One flattened chain of B·N blocks would be
// the same matrix but take log2(B·N / 16) levels.  At 4096 x 64 nodes an
// apply reads the stacked roots (4096 x 96 x 96 floats, 151 MB): the bytes
// bound it.
#include <cuda_runtime.h>

#include "lie.cuh"

namespace {

__device__ __forceinline__ float row_or_zero(const float* b, int row, int m_valid, int c) {
  return (row >= 0 && row < m_valid) ? b[row * 6 + c] : 0.f;
}

// Block row jg of the level's (n_batch·half) odd blocks belongs to instance
// jg / half; each instance's right-hand side holds in_stride rows, of which
// m_valid are read.
__global__ void chain_forward(const float* __restrict__ b, int m_valid, int in_stride,
                              const float* __restrict__ P1m, const float* __restrict__ P2,
                              int half, int n_batch, float* __restrict__ out) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= 6LL * half * n_batch) return;
  const long long jg = t / 6;
  const int i = static_cast<int>(t % 6), j = static_cast<int>(jg % half);
  const float* bb = b + (jg / half) * in_stride * 6;
  float a = 0.f, c = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    a += P1m[jg * 36 + i * 6 + k] * row_or_zero(bb, 2 * j - 1, m_valid, k);
    c += P2[jg * 36 + i * 6 + k] * row_or_zero(bb, 2 * j + 1, m_valid, k);
  }
  out[t] = row_or_zero(bb, 2 * j, m_valid, i) - a - c;
}

__global__ void chain_backward(const float* __restrict__ b, int m_valid, int in_stride,
                               const float* __restrict__ xh, const float* __restrict__ Dinv_o,
                               const float* __restrict__ G1, const float* __restrict__ G2,
                               int half, int n_batch, float* __restrict__ x, int out_rows) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= 6LL * half * n_batch) return;
  const long long jg = t / 6, inst = jg / half;
  const int i = static_cast<int>(t % 6), j = static_cast<int>(jg % half);
  const float* bb = b + inst * in_stride * 6;
  const float* xb = xh + inst * half * 6;
  float* xo = x + inst * out_rows * 6;
  float a = 0.f, g1 = 0.f, g2 = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    a += Dinv_o[jg * 36 + i * 6 + k] * row_or_zero(bb, 2 * j + 1, m_valid, k);
    g1 += G1[jg * 36 + i * 6 + k] * xb[j * 6 + k];
    g2 += G2[jg * 36 + i * 6 + k] * (j + 1 < half ? xb[(j + 1) * 6 + k] : 0.f);
  }
  if (2 * j < out_rows) xo[(2 * j) * 6 + i] = xh[t];
  if (2 * j + 1 < out_rows) xo[(2 * j + 1) * 6 + i] = a - g1 - g2;
}

// Row rg of the n_batch stacked (n, n) roots belongs to instance rg / n.
__global__ void chain_root(const float* __restrict__ root_inv, const float* __restrict__ b,
                           int m_valid, int in_stride, int n, int n_batch, float* __restrict__ x,
                           int out_rows) {
  const long long rg = static_cast<long long>(blockIdx.x) * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (rg >= static_cast<long long>(n) * n_batch) return;
  const long long inst = rg / n;
  const int row = static_cast<int>(rg % n);
  const float* ri = root_inv + inst * n * n;
  const float* bb = b + inst * in_stride * 6;
  const int valid = 6 * m_valid;
  float s = 0.f;
  for (int k = lane; k < valid && k < n; k += 32)
    s += ri[static_cast<long long>(row) * n + k] * bb[k];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0 && row < 6 * out_rows) x[inst * out_rows * 6 + row] = s;
}

int launch_root(const float* root_inv, const float* b, int m_valid, int in_stride, int n,
                int n_batch, float* x, int out_rows, void* stream) {
  const int rows_per_block = kThreads / 32;
  const long long rows = static_cast<long long>(n) * n_batch;
  if (rows > 0)
    chain_root<<<static_cast<unsigned>((rows + rows_per_block - 1) / rows_per_block), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(root_inv, b, m_valid, in_stride, n,
                                                      n_batch, x, out_rows);
  return static_cast<int>(cudaGetLastError());
}

int launch_forward(const float* b, int m_valid, int in_stride, const float* P1m, const float* P2,
                   int half, int n_batch, float* out, void* stream) {
  if (half > 0 && n_batch > 0)
    chain_forward<<<blocks_for(6LL * half * n_batch), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(b, m_valid, in_stride, P1m, P2, half,
                                                         n_batch, out);
  return static_cast<int>(cudaGetLastError());
}

int launch_backward(const float* b, int m_valid, int in_stride, const float* xh,
                    const float* Dinv_o, const float* G1, const float* G2, int half, int n_batch,
                    float* x, int out_rows, void* stream) {
  if (half > 0 && n_batch > 0)
    chain_backward<<<blocks_for(6LL * half * n_batch), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(b, m_valid, in_stride, xh, Dinv_o, G1,
                                                          G2, half, n_batch, x, out_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// n_batch instances at once (a single chain is the batch of one): each
// instance's vectors in_stride (b) or out_rows (x) rows apart, its level
// products (n_batch, half, 6, 6) and roots (n_batch, n, n) stacked.

// x (out_rows, 6) per instance = root_inv (n, n) · b, with b's rows at or
// past m_valid (of n / 6) reading as zero.
extern "C" int uz_chain_root(const float* root_inv, const float* b, int m_valid, int in_stride,
                             int n, int n_batch, float* x, int out_rows, void* stream) {
  return launch_root(root_inv, b, m_valid, in_stride, n, n_batch, x, out_rows, stream);
}

// out (half, 6) per instance = one forward level over b (m_valid valid rows
// of 2·half).
extern "C" int uz_chain_forward(const float* b, int m_valid, int in_stride, const float* P1m,
                                const float* P2, int half, int n_batch, float* out,
                                void* stream) {
  return launch_forward(b, m_valid, in_stride, P1m, P2, half, n_batch, out, stream);
}

// x (out_rows, 6) per instance = one back level from the coarse solution xh
// (half, 6).
extern "C" int uz_chain_backward(const float* b, int m_valid, int in_stride, const float* xh,
                                 const float* Dinv_o, const float* G1, const float* G2, int half,
                                 int n_batch, float* x, int out_rows, void* stream) {
  return launch_backward(b, m_valid, in_stride, xh, Dinv_o, G1, G2, half, n_batch, x, out_rows,
                         stream);
}
