// The atomic K1 edge pass that csrc/linearize.cu replaced, kept as
// chip_smoke.py's A/B reference (phase 3): the new kernel's Jᵢ, Jⱼ and W
// must equal this one's bit for bit, while its node rows differ only by
// the order of their float sums.  Built by chip_smoke.py alone (nvcc -I
// uzliti_slam_tpu_torch/csrc, one shared library of its own); the package
// never calls it.
//
// K1 linearize: the fused per-edge linearization of the LM step.
//
// Replaces uzliti_slam_tpu/graph/solver.py:_make_fused_linearize (with
// factors.jacobians_from_residual and solver._weighted_info).  Per edge, from
// the carried residual twist r:
//   W  = huber(rᵀΛr)·valid·Λ
//   Jⱼ = Jr⁻¹(r),  Jᵢ = -Jⱼ·(Ad(exp(-r))·Ad(meas⁻¹))
// then JᵀWr, JᵢᵀWJᵢ, JⱼᵀWJⱼ and the spine coupling JᵢᵀWJⱼ (edges e_to ==
// e_from + 1 only) are added into node rows: [g | Hii | Uc] to the 'from'
// node and [g | Hjj] to the 'to' node.  A node pass then masks the gradient
// to free nodes and the spine blocks to consecutive free pairs.
//
// What bounds it on the card: at E ~ 1e3 (the 1k headline) the launch
// itself; at E ~ 1e5 the few thousand flops of 6x6 algebra per edge and up
// to 120 float atomics per edge into node rows.  The JAX version
// concatenated the payloads into (E,78)/(E,42) rows so that five TPU
// scatters became two; here one
// thread owns one edge, keeps every 6x6 block in registers (no payload ever
// reaches device memory) and adds straight into the node rows with atomicAdd.
// The order of those float sums varies from run to run; PERF.md records the
// resulting χ² spread.
#include <cuda_runtime.h>

#include "lie.cuh"

namespace {

__device__ __forceinline__ void add_block_t(float* dst, const float A[6][6], const float B[6][6]) {
  // dst += Aᵀ·B (6x6), atomically.
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) s += A[j][i] * B[j][k];
      atomicAdd(dst + i * 6 + k, s);
    }
}

__device__ __forceinline__ void mm6(const float A[6][6], const float B[6][6], float C[6][6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) s += A[i][j] * B[j][k];
      C[i][k] = s;
    }
}

__global__ void linearize_edges(const float* __restrict__ r, const float* __restrict__ adj_meas_inv,
                                const float* __restrict__ info, const float* __restrict__ valid,
                                const int* __restrict__ e_from, const int* __restrict__ e_to,
                                const float* __restrict__ is_chain, float huber_delta, int n_edges,
                                int col_keep, float* __restrict__ Ji_out, float* __restrict__ Jj_out,
                                float* __restrict__ W_out, float* grad, float* Hb, float* U) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_edges) return;

  float re[6], nr[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    re[i] = r[e * 6 + i];
    nr[i] = -re[i];
  }
  const float* L = info + e * 36;
  const float w = uz::huber_weight(uz::quad6(re, L), huber_delta) * valid[e];
  float W[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) W[i][j] = L[i * 6 + j] * w;

  // Jⱼ = Jr⁻¹(r) = Jl⁻¹(-r);  Jᵢ = -(Jⱼ · (Ad(exp(-r)) · Ad(meas⁻¹)))
  float Jj[6][6], Ji[6][6], T[6][6];
  uz::se3_left_jacobian_inv(nr, Jj);
  {
    float p[7], A[6][6], M[6][6];
    uz::se3_exp(nr, p);
    uz::se3_adjoint(p, A);
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) M[i][j] = adj_meas_inv[e * 36 + i * 6 + j];
    mm6(A, M, T);
  }
  mm6(Jj, T, Ji);
  float keep[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) keep[j] = (col_keep >> j) & 1 ? 1.f : 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      Ji[i][j] = -Ji[i][j] * keep[j];
      Jj[i][j] *= keep[j];
      Ji_out[e * 36 + i * 6 + j] = Ji[i][j];
      Jj_out[e * 36 + i * 6 + j] = Jj[i][j];
      W_out[e * 36 + i * 6 + j] = W[i][j];
    }

  const int f = e_from[e], t = e_to[e];
  // gradient: Jᵀ(W r)
  float Wr[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) s += W[i][j] * re[j];
    Wr[i] = s;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float gi = 0.f, gj = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      gi += Ji[j][i] * Wr[j];
      gj += Jj[j][i] * Wr[j];
    }
    atomicAdd(grad + f * 6 + i, gi);
    atomicAdd(grad + t * 6 + i, gj);
  }
  // T = W·Jⱼ:  Hjj = JⱼᵀWJⱼ to 'to', spine Uc = JᵢᵀWJⱼ to 'from'
  mm6(W, Jj, T);
  add_block_t(Hb + t * 36, Jj, T);
  if (is_chain[e] != 0.f) add_block_t(U + f * 36, Ji, T);
  // T = W·Jᵢ:  Hii = JᵢᵀWJᵢ to 'from'
  mm6(W, Ji, T);
  add_block_t(Hb + f * 36, Ji, T);
}

// grad *= free[n];  U *= both_free[n]
__global__ void linearize_mask(const float* __restrict__ free, const float* __restrict__ both_free,
                               int n_nodes, float* grad, float* U) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_nodes * 36) return;
  const int n = t / 36;
  U[t] *= both_free[n];
  if (t < n_nodes * 6) grad[t] *= free[t / 6];
}

}  // namespace

// grad (N,6), Hb (N,36) and U (N,36) must be zero on entry; col_keep 63
// keeps every Jacobian column.
extern "C" int uz_linearize_atomic(const float* r, const float* adj_meas_inv, const float* info,
                                   const float* valid, const int* e_from, const int* e_to,
                                   const float* free, const float* both_free,
                                   const float* is_chain, float huber_delta, int n_edges,
                                   int n_nodes, int col_keep, float* Ji, float* Jj, float* W,
                                   float* grad, float* Hb, float* U, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_edges > 0)
    linearize_edges<<<blocks_for(n_edges), kThreads, 0, s>>>(
        r, adj_meas_inv, info, valid, e_from, e_to, is_chain, huber_delta, n_edges, col_keep, Ji,
        Jj, W, grad, Hb, U);
  if (n_nodes > 0)
    linearize_mask<<<blocks_for(36LL * n_nodes), kThreads, 0, s>>>(free, both_free, n_nodes, grad, U);
  return static_cast<int>(cudaGetLastError());
}
