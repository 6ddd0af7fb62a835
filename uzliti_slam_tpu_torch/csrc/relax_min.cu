// K5 relax_min: multi-source Bellman-Ford over the pose graph's edges.
//
// Replaces uzliti_slam_tpu/graph/shortest_path.py:shortest_paths (its
// fori_loop body, :50-55), vmapped over sources by pairwise_graph_distance
// (:60-72) and run on one row by reevaluate_uncertainty (:75-84).  Each of R
// independent rows runs n_iters sweeps
//   d'[to]   = min(d[to],    min(d[from] + w, INF))
//   d'[from] = min(d'[from], min(d[to]   + w, INF))
// where both relaxations read the sweep's START values d, as the JAX body
// does (it gathers dist[ef] and dist[et] before either scatter-min).  The
// sweep must be Jacobi: an in-place (Gauss-Seidel) sweep carries a distance
// further than one hop per sweep, and with n_iters below the hop diameter
// (64 sweeps against ~250 hops on the 500-node epoch graph) it would return
// smaller distances than the reference.
//
// Design: one CTA per row loops over all sweeps with __syncthreads, so a call
// is one launch.  The row is double-buffered: `cur` holds the start values,
// `nxt` starts as their copy and takes an atomicMin of every relaxation.
// Distances are >= 0 and finite (at most INF = 3.4e38 < FLT_MAX), so their
// float order is the order of their int bits and the int atomicMin is exact.
// Both buffers sit in shared memory when 2*N*4 bytes fit in a CTA's 227 KB
// (N <= 29056), else in a global scratch of 2*R*N floats.
//
// What bounds it on the card: the R*n_iters*E relaxations (two adds, two
// compares and up to two shared-memory atomics each), not bytes: dist in and
// out and the edge table are read or written once and are small next to it.
#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.4e38f;   // shortest_path.INF
constexpr int kRelaxThreads = 512;

// jnp.minimum(d + w, INF)
__device__ __forceinline__ float relax(float d, float w) {
  const float v = d + w;
  return v < kInf ? v : kInf;
}

__device__ __forceinline__ void relax_into(float* slot, float v) {
  // values only fall, so a stale read that is already <= v can skip the atomic
  if (v < *slot) atomicMin(reinterpret_cast<int*>(slot), __float_as_int(v));
}

__global__ void relax_rows(const float* __restrict__ dist0, const int* __restrict__ e_from,
                           const int* __restrict__ e_to, const float* __restrict__ w,
                           int n_nodes, int n_edges, int n_iters, float* __restrict__ out,
                           float* scratch) {
  extern __shared__ float smem[];
  const long long row = blockIdx.x;
  float* cur = scratch == nullptr ? smem : scratch + row * 2 * n_nodes;
  float* nxt = cur + n_nodes;
  const float* d0 = dist0 + row * n_nodes;
  for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) cur[i] = d0[i];
  __syncthreads();
  for (int it = 0; it < n_iters; ++it) {
    for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) nxt[i] = cur[i];
    __syncthreads();
    for (int e = threadIdx.x; e < n_edges; e += blockDim.x) {
      const int f = e_from[e], t = e_to[e];
      const float we = w[e];
      relax_into(nxt + t, relax(cur[f], we));
      relax_into(nxt + f, relax(cur[t], we));
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  float* o = out + row * n_nodes;
  for (int i = threadIdx.x; i < n_nodes; i += blockDim.x) o[i] = cur[i];
}

}  // namespace

// dist0, out: (n_rows, n_nodes) row-major.  scratch: NULL to keep the rows in
// shared memory (the caller checks 2*n_nodes*4 <= 232448), else 2*n_rows*n_nodes
// floats of device memory.
extern "C" int uz_relax_min(const float* dist0, const int* e_from, const int* e_to,
                            const float* w, int n_rows, int n_nodes, int n_edges, int n_iters,
                            float* out, float* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || n_nodes <= 0) return 0;
  const size_t smem = scratch == nullptr ? 2ull * n_nodes * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        relax_rows, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  relax_rows<<<n_rows, kRelaxThreads, smem, s>>>(dist0, e_from, e_to, w, n_nodes, n_edges,
                                                 n_iters, out, scratch);
  return static_cast<int>(cudaGetLastError());
}
