// K8 on a thread-block cluster: a measurement variant of
// uzliti_slam_tpu_torch/csrc/components.cu, not part of the package.
//
// The same rounds and gauge as the package's K8 (labels bit-equal to
// n_iters rounds, stopped at the fixed point; the gauge by one 64-bit
// minimum of (stamp key, slot) a component), with the node arrays spread
// over the shared memory of kCluster CTAs (CTA r holds nodes [r·chunk,
// (r+1)·chunk)) and read, written and atomically lowered through
// distributed shared memory; the passes are separated by cluster barriers,
// and CTA 0 holds the rounds' changed flags.  Exports uz_components_gauge
// with the package's signature: with scratch == NULL it runs the cluster
// form (N up to kCluster x the one-CTA form's shared memory), else it
// refuses.  scripts/k8_k11_variants.py builds it as the variant
// "k8:cluster=C" (kCluster = C) and times it beside the shipped forms.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 1024;
constexpr int kSmemMax = 232448;
constexpr unsigned long long kNoKey = ~0ull;

struct Args {
  const int* e_from;
  const int* e_to;
  const unsigned char* e_valid;
  int n_edges;
  int n;
  int n_iters;
  const int* labels_in;
  const unsigned char* node_valid;
  const unsigned char* node_fixed;
  const float* stamp;
  int* labels;
  unsigned char* gauge;
  int* rounds;
};

__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.cluster.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned stamp_key(float f) {
  const unsigned u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

int chunk_of(int n) { return (n + kCluster - 1) / kCluster; }
size_t smem_of(int chunk) { return 12ull * chunk + 4ull * ((chunk + 31) / 32); }

__global__ void __launch_bounds__(kThreads) components_cluster(Args p) {
  cg::cluster_group cl = cg::this_cluster();
  const int rank = static_cast<int>(cl.block_rank());
  const int tid = threadIdx.x;
  const int chunk = (p.n + kCluster - 1) / kCluster;
  extern __shared__ __align__(16) int sm[];
  int* t = sm;
  int* l = sm + chunk;
  int* a = sm + 2 * chunk;
  unsigned* fixed = reinterpret_cast<unsigned*>(sm + 3 * chunk);
  unsigned long long* key = reinterpret_cast<unsigned long long*>(sm);
  __shared__ int flag[3];
  const int lo = rank * chunk, hi = min(p.n, lo + chunk);
  auto T = [&](int i) { return cl.map_shared_rank(t, i / chunk) + i % chunk; };
  auto L = [&](int i) { return cl.map_shared_rank(l, i / chunk) + i % chunk; };
  auto A = [&](int i) { return cl.map_shared_rank(a, i / chunk) + i % chunk; };
  auto K = [&](int c) { return cl.map_shared_rank(key, c / chunk) + c % chunk; };
  auto F = [&](int c) {
    return cl.map_shared_rank(fixed, c / chunk) + (c % chunk) / 32;
  };
  int* flag0 = cl.map_shared_rank(flag, 0);
  const int* lab = p.labels_in;
  if (lab == nullptr) {
    for (int i = lo + tid; i < hi; i += kThreads) a[i - lo] = t[i - lo] = i;
    if (tid < 3) flag[tid] = 0;
    cl.sync();
    int it = 0;
    while (it < p.n_iters) {
      if (rank == 0 && tid == 0) flag[(it + 1) % 3] = 0;
      for (int e = rank * kThreads + tid; e < p.n_edges; e += kCluster * kThreads) {
        if (!p.e_valid[e]) continue;
        const int f = p.e_from[e], to = p.e_to[e];
        const int v = min(*A(f), *A(to));
        int* tf = T(f);
        int* tt = T(to);
        if (v < *tf) atomicMin(tf, v);
        if (v < *tt) atomicMin(tt, v);
      }
      cl.sync();
      for (int i = lo + tid; i < hi; i += kThreads) l[i - lo] = *T(t[i - lo]);
      cl.sync();
      int changed = 0;
      for (int i = lo + tid; i < hi; i += kThreads) {
        const int v = *L(l[i - lo]);
        changed |= v != a[i - lo];
        a[i - lo] = t[i - lo] = v;
      }
      if (__syncthreads_or(changed) && tid == 0) atomicOr(flag0 + it % 3, 1);
      cl.sync();
      const int any = *reinterpret_cast<volatile int*>(flag0 + it % 3);
      ++it;
      if (!any) break;
    }
    if (p.rounds != nullptr && rank == 0 && tid == 0) *p.rounds = it;
    for (int i = lo + tid; i < hi; i += kThreads) p.labels[i] = a[i - lo];
  }
  if (p.gauge != nullptr) {
    cl.sync();   // t and l hold the keys from here
    for (int i = tid; i < chunk; i += kThreads) key[i] = kNoKey;
    for (int w = tid; w < (chunk + 31) / 32; w += kThreads) fixed[w] = 0u;
    cl.sync();
    for (int i = lo + tid; i < hi; i += kThreads) {
      if (!p.node_valid[i]) continue;
      const int c = lab ? lab[i] : a[i - lo];
      if (p.node_fixed[i]) atomicOr(F(c), 1u << ((c % chunk) & 31));
      const unsigned long long k =
          (static_cast<unsigned long long>(stamp_key(p.stamp[i])) << 32) | static_cast<unsigned>(i);
      unsigned long long* kc = K(c);
      if (k < load_relaxed(kc)) atomicMin(kc, k);
    }
    cl.sync();
    for (int i = lo + tid; i < hi; i += kThreads) {
      const bool valid = p.node_valid[i] != 0;
      const int c = lab ? lab[i] : a[i - lo];
      const bool has_fixed = (*F(c) >> ((c % chunk) & 31)) & 1u;
      const bool oldest = valid && (*K(c) & 0xffffffffull) == static_cast<unsigned>(i);
      p.gauge[i] = (valid && p.node_fixed[i]) || (oldest && !has_fixed);
    }
  }
  cl.sync();   // no CTA leaves while another reads its shared memory
}

}  // namespace

extern "C" int uz_components_gauge(const int* e_from, const int* e_to,
                                   const unsigned char* e_valid, int n_edges, int n_nodes,
                                   int n_iters, const int* labels_in,
                                   const unsigned char* node_valid,
                                   const unsigned char* node_fixed, const float* stamp,
                                   int* labels, unsigned char* gauge, int* rounds, int* scratch,
                                   void* stream) {
  if (n_nodes <= 0) return 0;
  if (scratch != nullptr || (labels_in == nullptr) == (labels == nullptr) ||
      (gauge == nullptr) != (stamp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_of(chunk_of(n_nodes));
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(components_cluster,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kCluster > 8) {
    err = cudaFuncSetAttribute(components_cluster,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  Args p{e_from, e_to, e_valid, n_edges, n_nodes, n_iters, labels_in, node_valid, node_fixed,
         stamp, labels, gauge, rounds};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, components_cluster, p));
}
