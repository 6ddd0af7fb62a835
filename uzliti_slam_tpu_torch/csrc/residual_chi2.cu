// K4 residual_chi2: edge residuals and the robust χ² of a set of poses.
//
// Replaces uzliti_slam_tpu/graph/factors.py:batched_residuals plus
// uzliti_slam_tpu/graph/solver.py:_robust_chi2_from_r.  One thread per edge
// gathers both endpoint poses, computes r = log(meas⁻¹·Xᵢ⁻¹Xⱼ) with the
// branches of ops/lie.py, writes r (the LM loop carries it into the next
// linearization) and its Huber cost ρ(rᵀΛr)·valid.  The sum is taken in two
// fixed-order passes (a tree inside each block, then one block over the block
// partials), so χ² is the same from run to run for the same poses: the LM
// accept test compares two such sums.
//
// What bounds it on the card: launch latency at 1e3 edges; at 1e5 edges the
// few hundred flops of pose algebra per edge and the ~240 bytes it reads.
#include <cuda_runtime.h>

#include "lie.cuh"

namespace {

__device__ __forceinline__ void block_sum_to(float v, float* dst) {
  __shared__ float buf[kThreads];
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  if (threadIdx.x == 0) *dst = buf[0];
}

__global__ void residual_edges(const float* __restrict__ poses, const int* __restrict__ e_from,
                               const int* __restrict__ e_to, const float* __restrict__ meas,
                               const float* __restrict__ info, const float* __restrict__ valid,
                               float huber_delta, int n_edges, float* __restrict__ r_out,
                               float* __restrict__ partials) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  float rho = 0.f;
  if (e < n_edges) {
    float pi[7], pj[7], m[7], r[6];
    const int f = e_from[e], t = e_to[e];
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      pi[k] = poses[f * 7 + k];
      pj[k] = poses[t * 7 + k];
      m[k] = meas[e * 7 + k];
    }
    uz::edge_residual(pi, pj, m, r);
#pragma unroll
    for (int k = 0; k < 6; ++k) r_out[e * 6 + k] = r[k];
    const float chi2 = uz::quad6(r, info + e * 36);
    const float en = sqrtf(uz::floor_at(chi2, 1e-12f));
    rho = (en <= huber_delta ? chi2 : 2.f * huber_delta * en - huber_delta * huber_delta) * valid[e];
  }
  block_sum_to(rho, partials + blockIdx.x);
}

__global__ void sum_partials(const float* __restrict__ partials, int n, float* __restrict__ out) {
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) s += partials[i];
  block_sum_to(s, out);
}

}  // namespace

// partials must hold blocks_for(n_edges) floats; chi2 is one float.
extern "C" int uz_residual_chi2(const float* poses, const int* e_from, const int* e_to,
                                const float* meas, const float* info, const float* valid,
                                float huber_delta, int n_edges, float* r, float* partials,
                                float* chi2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = blocks_for(n_edges);
  if (nb > 0)
    residual_edges<<<nb, kThreads, 0, s>>>(poses, e_from, e_to, meas, info, valid, huber_delta,
                                           n_edges, r, partials);
  sum_partials<<<1, kThreads, 0, s>>>(partials, nb, chi2);
  return static_cast<int>(cudaGetLastError());
}
