// K8 components: connected components and gauge fixing of the pose graph.
//
// Replaces uzliti_slam_tpu/graph/solver.py:connected_components (:212-239)
// and gauge_fix_mask (:242-262), which every solve runs once.
//
// uz_components: n_iters rounds of
//   (1) for every valid edge, labels'[from] and labels'[to] take the min of
//       min(labels[from], labels[to]) (both read from the round's start
//       labels, as the JAX body's two scatter-mins do), then
//   (2) two pointer jumps, labels = labels[labels], each reading only the
//       previous pass.
// uz_gauge_fix, from those labels: per component, whether it holds a valid
// pre-fixed node (segment max), its least stamp over valid nodes (segment
// min), the least slot among the valid nodes with that stamp (segment min);
// a node is held fixed if it is valid and pre-fixed, or it is that oldest
// node of a component without a pre-fixed one.
//
// Design: every pass is a __device__ function over an index range, run
// either inside one CTA with the arrays in shared memory and __syncthreads
// between passes (one launch per call, while 3*N*4 bytes fit: N <= 19370),
// or as one grid-wide launch per pass with the arrays in global scratch
// (1 + 3*n_iters launches for the labels, 4 for the gauge: 103 + 4 at 100k
// nodes).  Labels use three buffers, so that no pass reads what it writes.
// Stamps are min-reduced as order-preserving int keys, so atomicMin is exact
// for negative stamps too.  Results are exact: integer minima and maxima.
//
// What bounds it on the card: launch latency and the serial chain of
// passes; the bytes (the edge table read once per round) are small.
#include <cuda_runtime.h>

#include <climits>

#include "lie.cuh"

namespace {

constexpr int kCtaThreads = 1024;
constexpr int kSmemMax = 232448;   // bytes of shared memory a CTA can use

struct Span {
  int start, stride;
};

__device__ __forceinline__ Span cta_span() { return {static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x)}; }
__device__ __forceinline__ Span grid_span() {
  return {static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x),
          static_cast<int>(gridDim.x * blockDim.x)};
}

// order-preserving int key of a float (an involution)
__device__ __forceinline__ int float_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// ------------------------------------------------------------------ labels

__device__ __forceinline__ void init_labels(int* a, int* t, int n, Span s) {
  for (int i = s.start; i < n; i += s.stride) a[i] = t[i] = i;
}

__device__ __forceinline__ void scatter_min(const int* __restrict__ e_from,
                                            const int* __restrict__ e_to,
                                            const unsigned char* __restrict__ e_valid,
                                            int n_edges, const int* a, int* t, Span s) {
  for (int e = s.start; e < n_edges; e += s.stride) {
    if (!e_valid[e]) continue;
    const int f = e_from[e], to = e_to[e];
    const int m = min(a[f], a[to]);
    if (m < t[f]) atomicMin(t + f, m);
    if (m < t[to]) atomicMin(t + to, m);
  }
}

__device__ __forceinline__ void jump(const int* src, int* dst, int n, Span s) {
  for (int i = s.start; i < n; i += s.stride) dst[i] = src[src[i]];
}

// the round's second jump writes the labels and the next round's scatter target
__device__ __forceinline__ void jump_out(const int* src, int* a, int* t, int n, Span s) {
  for (int i = s.start; i < n; i += s.stride) a[i] = t[i] = src[src[i]];
}

__global__ void components_cta(const int* __restrict__ e_from, const int* __restrict__ e_to,
                               const unsigned char* __restrict__ e_valid, int n_edges,
                               int n_nodes, int n_iters, int* __restrict__ labels) {
  extern __shared__ int sm[];
  int* a = sm;
  int* t = sm + n_nodes;
  int* l = sm + 2 * n_nodes;
  const Span s = cta_span();
  init_labels(a, t, n_nodes, s);
  __syncthreads();
  for (int it = 0; it < n_iters; ++it) {
    scatter_min(e_from, e_to, e_valid, n_edges, a, t, s);
    __syncthreads();
    jump(t, l, n_nodes, s);
    __syncthreads();
    jump_out(l, a, t, n_nodes, s);
    __syncthreads();
  }
  for (int i = s.start; i < n_nodes; i += s.stride) labels[i] = a[i];
}

__global__ void k_init_labels(int* a, int* t, int n) { init_labels(a, t, n, grid_span()); }
__global__ void k_scatter_min(const int* e_from, const int* e_to, const unsigned char* e_valid,
                              int n_edges, const int* a, int* t) {
  scatter_min(e_from, e_to, e_valid, n_edges, a, t, grid_span());
}
__global__ void k_jump(const int* src, int* dst, int n) { jump(src, dst, n, grid_span()); }
__global__ void k_jump_out(const int* src, int* a, int* t, int n) {
  jump_out(src, a, t, n, grid_span());
}

// ------------------------------------------------------------------- gauge

__device__ __forceinline__ void gauge_init(int* has_fixed, int* min_key, int* min_idx, int n,
                                           Span s) {
  for (int i = s.start; i < n; i += s.stride) {
    has_fixed[i] = 0;
    min_key[i] = INT_MAX;
    min_idx[i] = n;
  }
}

__device__ __forceinline__ float stamp_key(const unsigned char* valid, const float* stamp, int i) {
  return valid[i] ? stamp[i] : __int_as_float(0x7f800000);   // where(valid, stamp, inf)
}

__device__ __forceinline__ void gauge_reduce_stamp(const int* labels, const unsigned char* valid,
                                                   const unsigned char* fixed,
                                                   const float* stamp, int* has_fixed,
                                                   int* min_key, int n, Span s) {
  for (int i = s.start; i < n; i += s.stride) {
    const int lab = labels[i];
    if (valid[i] && fixed[i]) atomicMax(has_fixed + lab, 1);
    atomicMin(min_key + lab, float_key(stamp_key(valid, stamp, i)));
  }
}

__device__ __forceinline__ bool oldest_candidate(const int* labels, const unsigned char* valid,
                                                 const float* stamp, const int* min_key, int i) {
  return valid[i] && stamp_key(valid, stamp, i) == key_float(min_key[labels[i]]);
}

__device__ __forceinline__ void gauge_reduce_slot(const int* labels, const unsigned char* valid,
                                                  const float* stamp, const int* min_key,
                                                  int* min_idx, int n, Span s) {
  for (int i = s.start; i < n; i += s.stride) {
    if (oldest_candidate(labels, valid, stamp, min_key, i)) atomicMin(min_idx + labels[i], i);
  }
}

__device__ __forceinline__ void gauge_write(const int* labels, const unsigned char* valid,
                                            const unsigned char* fixed, const float* stamp,
                                            const int* has_fixed, const int* min_key,
                                            const int* min_idx, int n, unsigned char* gauge,
                                            Span s) {
  for (int i = s.start; i < n; i += s.stride) {
    const int lab = labels[i];
    const bool oldest = oldest_candidate(labels, valid, stamp, min_key, i) && min_idx[lab] == i;
    gauge[i] = (valid[i] && fixed[i]) || (oldest && has_fixed[lab] == 0);
  }
}

__global__ void gauge_cta(const int* __restrict__ labels, const unsigned char* __restrict__ valid,
                          const unsigned char* __restrict__ fixed,
                          const float* __restrict__ stamp, int n,
                          unsigned char* __restrict__ gauge) {
  extern __shared__ int sm[];
  int* has_fixed = sm;
  int* min_key = sm + n;
  int* min_idx = sm + 2 * n;
  const Span s = cta_span();
  gauge_init(has_fixed, min_key, min_idx, n, s);
  __syncthreads();
  gauge_reduce_stamp(labels, valid, fixed, stamp, has_fixed, min_key, n, s);
  __syncthreads();
  gauge_reduce_slot(labels, valid, stamp, min_key, min_idx, n, s);
  __syncthreads();
  gauge_write(labels, valid, fixed, stamp, has_fixed, min_key, min_idx, n, gauge, s);
}

__global__ void k_gauge_init(int* has_fixed, int* min_key, int* min_idx, int n) {
  gauge_init(has_fixed, min_key, min_idx, n, grid_span());
}
__global__ void k_gauge_reduce_stamp(const int* labels, const unsigned char* valid,
                                     const unsigned char* fixed, const float* stamp,
                                     int* has_fixed, int* min_key, int n) {
  gauge_reduce_stamp(labels, valid, fixed, stamp, has_fixed, min_key, n, grid_span());
}
__global__ void k_gauge_reduce_slot(const int* labels, const unsigned char* valid,
                                    const float* stamp, const int* min_key, int* min_idx, int n) {
  gauge_reduce_slot(labels, valid, stamp, min_key, min_idx, n, grid_span());
}
__global__ void k_gauge_write(const int* labels, const unsigned char* valid,
                              const unsigned char* fixed, const float* stamp,
                              const int* has_fixed, const int* min_key, const int* min_idx,
                              int n, unsigned char* gauge) {
  gauge_write(labels, valid, fixed, stamp, has_fixed, min_key, min_idx, n, gauge, grid_span());
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// labels: (n_nodes,) int32.  scratch: NULL when 3*n_nodes*4 <= 232448 (one
// CTA, shared memory), else 2*n_nodes ints of device memory.
extern "C" int uz_components(const int* e_from, const int* e_to, const unsigned char* e_valid,
                             int n_edges, int n_nodes, int n_iters, int* labels, int* scratch,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_nodes <= 0) return 0;
  if (scratch == nullptr) {
    const size_t smem = 3ull * n_nodes * sizeof(int);
    if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = allow_smem(reinterpret_cast<const void*>(components_cta), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    components_cta<<<1, kCtaThreads, smem, s>>>(e_from, e_to, e_valid, n_edges, n_nodes,
                                                 n_iters, labels);
    return static_cast<int>(cudaGetLastError());
  }
  int* t = scratch;
  int* l = scratch + n_nodes;
  const int nb = blocks_for(n_nodes), eb = blocks_for(n_edges);
  k_init_labels<<<nb, kThreads, 0, s>>>(labels, t, n_nodes);
  for (int it = 0; it < n_iters; ++it) {
    if (eb > 0) k_scatter_min<<<eb, kThreads, 0, s>>>(e_from, e_to, e_valid, n_edges, labels, t);
    k_jump<<<nb, kThreads, 0, s>>>(t, l, n_nodes);
    k_jump_out<<<nb, kThreads, 0, s>>>(l, labels, t, n_nodes);
  }
  return static_cast<int>(cudaGetLastError());
}

// gauge: (n_nodes,) bool.  scratch: NULL when 3*n_nodes*4 <= 232448, else
// 3*n_nodes ints of device memory.
extern "C" int uz_gauge_fix(const int* labels, const unsigned char* node_valid,
                            const unsigned char* node_fixed, const float* stamp, int n_nodes,
                            unsigned char* gauge, int* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_nodes <= 0) return 0;
  if (scratch == nullptr) {
    const size_t smem = 3ull * n_nodes * sizeof(int);
    if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = allow_smem(reinterpret_cast<const void*>(gauge_cta), smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    gauge_cta<<<1, kCtaThreads, smem, s>>>(labels, node_valid, node_fixed, stamp, n_nodes, gauge);
    return static_cast<int>(cudaGetLastError());
  }
  int* has_fixed = scratch;
  int* min_key = scratch + n_nodes;
  int* min_idx = scratch + 2 * n_nodes;
  const int nb = blocks_for(n_nodes);
  k_gauge_init<<<nb, kThreads, 0, s>>>(has_fixed, min_key, min_idx, n_nodes);
  k_gauge_reduce_stamp<<<nb, kThreads, 0, s>>>(labels, node_valid, node_fixed, stamp, has_fixed,
                                               min_key, n_nodes);
  k_gauge_reduce_slot<<<nb, kThreads, 0, s>>>(labels, node_valid, stamp, min_key, min_idx,
                                              n_nodes);
  k_gauge_write<<<nb, kThreads, 0, s>>>(labels, node_valid, node_fixed, stamp, has_fixed,
                                        min_key, min_idx, n_nodes, gauge);
  return static_cast<int>(cudaGetLastError());
}
