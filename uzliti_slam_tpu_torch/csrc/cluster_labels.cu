// K6 cluster_labels: spatio-temporal clustering of loop-closure candidates.
//
// Replaces uzliti_slam_tpu/graph/filter.py:_cluster_labels (:66-83): min-label
// propagation over the (B, B) adjacency "both endpoint stamp gaps < max_dt,
// both candidates valid", n_iters rounds,
//   labels'[i] = min(labels[i], min_{j adjacent to i} labels[j]),
// starting from labels[i] = valid ? i : B.  The JAX package builds the B x B
// adjacency in memory; here each thread computes its row on the fly from the
// stamps, which sit in shared memory.
//
// Design: one CTA, one thread per candidate (strided past 1024), labels
// double-buffered in shared memory, all rounds in one launch.  Every round
// reads only the previous round's labels (Jacobi), as the reference's
// fori_loop body does: 16 rounds need not converge, and an in-place update
// would merge clusters the reference leaves apart.  The result is exact
// (integer minima of exact float compares).
//
// What bounds it on the card: n_iters * B * B adjacency tests in one CTA, a
// few microseconds at B = 256; it is launch latency at the epoch's size.
#include <cuda_runtime.h>

namespace {

__global__ void cluster_rounds(const float* __restrict__ stamp_from,
                               const float* __restrict__ stamp_to,
                               const unsigned char* __restrict__ valid, int b, float max_dt,
                               int n_iters, int* __restrict__ labels_out) {
  extern __shared__ int sm[];
  int* cur = sm;
  int* nxt = sm + b;
  int* ok = sm + 2 * b;
  float* sf = reinterpret_cast<float*>(sm + 3 * b);
  float* st = sf + b;
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    ok[i] = valid[i] != 0;
    cur[i] = ok[i] ? i : b;
    sf[i] = stamp_from[i];
    st[i] = stamp_to[i];
  }
  __syncthreads();
  for (int it = 0; it < n_iters; ++it) {
    for (int i = threadIdx.x; i < b; i += blockDim.x) {
      int m = cur[i];
      if (ok[i]) {
        const float fi = sf[i], ti = st[i];
        for (int j = 0; j < b; ++j) {
          if (ok[j] && fabsf(fi - sf[j]) < max_dt && fabsf(ti - st[j]) < max_dt)
            m = min(m, cur[j]);
        }
      }
      nxt[i] = m;
    }
    __syncthreads();
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  for (int i = threadIdx.x; i < b; i += blockDim.x) labels_out[i] = cur[i];
}

}  // namespace

// stamp_from, stamp_to: (b,) float; valid: (b,) bool; labels: (b,) int32.
// The caller keeps 20*b bytes within a CTA's shared memory (b <= 11622).
extern "C" int uz_cluster_labels(const float* stamp_from, const float* stamp_to,
                                 const unsigned char* valid, int b, float max_dt, int n_iters,
                                 int* labels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (b <= 0) return 0;
  const size_t smem = 5ull * b * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_rounds, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = b >= 1024 ? 1024 : ((b + 31) / 32) * 32;
  cluster_rounds<<<1, threads, smem, s>>>(stamp_from, stamp_to, valid, b, max_dt, n_iters,
                                          labels);
  return static_cast<int>(cudaGetLastError());
}
