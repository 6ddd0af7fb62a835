// K2 hvp: the matrix-free Gauss-Newton Hessian-vector product of PCG.
//
// Replaces uzliti_slam_tpu/graph/solver.py:_make_hvp (and, at every size,
// the TPU-only dense/sparse split _make_split_hvp, which computes the same
// operator):
//   y = [ Σₑ scatter(JᵀW(Jᵢ·vm[from] + Jⱼ·vm[to])) + damp·vm ] · free,
//   vm = v · free.
// A node pass seeds y = damp·vm (zero on non-free nodes); an edge pass, one
// thread per edge, gathers both endpoint rows, applies the three 6x6 blocks
// from registers and atomically adds Jᵢᵀ(Wu) and Jⱼᵀ(Wu) into the free
// endpoints' rows (adding only to free rows is the final mask).
//
// What bounds it on the card: reading Jᵢ, Jⱼ, W (432 bytes per edge) once per
// product, i.e. device-memory bandwidth at 1e5 edges and launch latency at
// 1e3.  It runs 12 times per LM iteration, so at the headline it is launch
// bound; fusing it with the PCG vector updates is later work.
#include <cuda_runtime.h>

#include "lie.cuh"

namespace {

__global__ void hvp_seed(const float* __restrict__ v, const float* __restrict__ damp,
                         const float* __restrict__ free, int n_nodes, float* __restrict__ y) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_nodes * 6) return;
  y[t] = damp[t] * (v[t] * free[t / 6]);
}

__global__ void hvp_edges(const float* __restrict__ Ji, const float* __restrict__ Jj,
                          const float* __restrict__ W, const int* __restrict__ e_from,
                          const int* __restrict__ e_to, const float* __restrict__ v,
                          const float* __restrict__ free, int n_edges, float* y) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n_edges) return;
  const int f = e_from[e], t = e_to[e];
  const float ff = free[f], ft = free[t];
  float vf[6], vt[6], u[6], Wu[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    vf[i] = v[f * 6 + i] * ff;
    vt[i] = v[t * 6 + i] * ft;
  }
  const float* A = Ji + e * 36;
  const float* B = Jj + e * 36;
  const float* C = W + e * 36;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      a += A[i * 6 + j] * vf[j];
      b += B[i * 6 + j] * vt[j];
    }
    u[i] = a + b;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) s += C[i * 6 + j] * u[j];
    Wu[i] = s;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      a += A[j * 6 + i] * Wu[j];
      b += B[j * 6 + i] * Wu[j];
    }
    if (ff > 0.f) atomicAdd(y + f * 6 + i, a);
    if (ft > 0.f) atomicAdd(y + t * 6 + i, b);
  }
}

}  // namespace

extern "C" int uz_hvp(const float* Ji, const float* Jj, const float* W, const int* e_from,
                      const int* e_to, const float* v, const float* damp, const float* free,
                      int n_edges, int n_nodes, float* y, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_nodes > 0) hvp_seed<<<blocks_for(6LL * n_nodes), kThreads, 0, s>>>(v, damp, free, n_nodes, y);
  if (n_edges > 0)
    hvp_edges<<<blocks_for(n_edges), kThreads, 0, s>>>(Ji, Jj, W, e_from, e_to, v, free, n_edges, y);
  return static_cast<int>(cudaGetLastError());
}
