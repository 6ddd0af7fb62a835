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
// The fleet (kernels/ops.residual_chi2 with batch > 1, for
// parallel/sharded.py:optimize_batch) runs the same two passes over B
// instances of E edges each: the edge pass on a (blocks per instance, B)
// grid, every block's partial in the instance's own row, then one block per
// instance over its row, so each instance's χ² is summed in exactly the order
// of a single solve of it.  The poses and the edges' endpoints are the
// flattened fleet's (instance b's endpoints offset by b·N).  A single graph
// is the batch of one.
//
// What bounds it on the card: launch latency at 1e3 edges; at 1e5 edges the
// few hundred flops of pose algebra per edge and the ~240 bytes it reads; the
// 4096 x 128-edge fleet, the same per edge over 524,288 edges.
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
  const int el = blockIdx.x * blockDim.x + threadIdx.x;   // the edge within its instance
  const long long e = static_cast<long long>(blockIdx.y) * n_edges + el;
  float rho = 0.f;
  if (el < n_edges) {
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
  block_sum_to(rho, partials + static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x);
}

// One block per instance: out[b] = the sum of the instance's n partials.
__global__ void sum_partials(const float* __restrict__ partials, int n, float* __restrict__ out) {
  const float* row = partials + static_cast<long long>(blockIdx.x) * n;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kThreads) s += row[i];
  block_sum_to(s, out + blockIdx.x);
}

cudaError_t launch(const float* poses, const int* e_from, const int* e_to, const float* meas,
                   const float* info, const float* valid, float huber_delta, int n_edges,
                   int n_batch, float* r, float* partials, float* chi2, cudaStream_t s) {
  const int nb = blocks_for(n_edges);
  if (nb > 0)
    residual_edges<<<dim3(nb, n_batch), kThreads, 0, s>>>(poses, e_from, e_to, meas, info, valid,
                                                         huber_delta, n_edges, r, partials);
  sum_partials<<<n_batch, kThreads, 0, s>>>(partials, nb, chi2);
  return cudaGetLastError();
}

}  // namespace

// n_batch instances of n_edges edges each, flattened (instance b's edges at
// b·n_edges, their endpoints into the flattened poses; a single graph is the
// batch of one); partials must hold n_batch·blocks_for(n_edges) floats;
// chi2 is (n_batch,).
extern "C" int uz_residual_chi2(const float* poses, const int* e_from, const int* e_to,
                                const float* meas, const float* info, const float* valid,
                                float huber_delta, int n_edges, int n_batch, float* r,
                                float* partials, float* chi2, void* stream) {
  if (n_batch < 1 || n_batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch(poses, e_from, e_to, meas, info, valid, huber_delta, n_edges,
                                n_batch, r, partials, chi2, static_cast<cudaStream_t>(stream)));
}
