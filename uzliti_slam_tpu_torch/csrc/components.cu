// K8 components: connected components and gauge fixing of the pose graph,
// in one launch that stops at the labels' fixed point.
//
// Replaces uzliti_slam_tpu/graph/solver.py:connected_components (:212-239)
// and gauge_fix_mask (:242-262), which every solve runs once.
//
// Labels: up to n_iters rounds of
//   (1) for every valid edge, labels'[from] and labels'[to] take the min of
//       min(labels[from], labels[to]) (both read from the round's start
//       labels, as the JAX body's two scatter-mins do), then
//   (2) two pointer jumps, labels = labels[labels], each reading only the
//       previous pass.
// A round is a function of its start labels alone, so a round that changes
// no label leaves a fixed point and every later round is the identity: the
// rounds stop there (the labels are bit-equal to all n_iters rounds), and
// never run past n_iters (so an unconverged graph keeps the reference's
// labels too).  `rounds` reports how many ran.
// Gauge, from those labels: per component whether it holds a valid
// pre-fixed node (a bit, atomicOr) and its least (stamp, slot) over valid
// nodes (one 64-bit atomicMin of the stamp's order-preserving key above the
// slot; ±0 share a key, so the least slot among the oldest stamps wins, as
// the reference's stamp == min(stamp) test then min(slot) picks); a node is
// held fixed if it is valid and pre-fixed, or it is that oldest node of a
// component without a pre-fixed one.  Integer minima and maxima: exact.
//
// One entry, uz_components_gauge, serves connected_components (labels
// only), gauge_fix_mask (the gauge from given labels) and the solve's call
// (both).  Two forms, one launch each:
//   - one CTA of 1024 threads with every array in shared memory (labels,
//     the scatter target and the jump buffer, the 64-bit keys over the last
//     two, the fixed bits), while 12·N + 4·⌈N/32⌉ bytes fit (N <= 19,170);
//     __syncthreads_or ends the rounds;
//   - above it, one cooperative launch over the card (two CTAs of 256
//     threads an SM, fewer where the work is smaller), the passes between
//     grid barriers, the arrays in global scratch, a flag a round (three,
//     rotated) ends the rounds.  (Measured, scripts/k8_k11_variants.py:
//     every resident CTA, 8 an SM, 0.0996 / 0.0804 device ms at 100k / the
//     4096 x 64 fleet; 2 an SM 0.0975 / 0.0676; 1 an SM 0.1044 / 0.0967.
//     A 16-CTA thread-block cluster with the labels in distributed shared
//     memory, scripts/k8_cluster.cu, took 0.0392 against the one CTA's
//     0.0410 at 10k: not adopted.)
//
// What bounds it on the card: latency — the serial chain of passes, three
// barriers a round — not the bytes (the edge table read once a round).
// Stopping at the fixed point cuts the rounds 3-4x on the solve's graphs
// (5 / 6 / 8 changing rounds at 1k / 10k / 100k against 20 / 28 / 34),
// and the one launch replaces 2 (one CTA) or 107 (the old grid route).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCtaThreads = 1024;
constexpr int kGridThreads = 256;
constexpr int kGridCtasPerSm = 2;  // the cooperative grid's CTAs an SM (0: as many as fit)
constexpr int kSmemMax = 232448;   // bytes of shared memory a CTA can use
constexpr int kMaxDevices = 16;
constexpr unsigned long long kNoKey = ~0ull;

struct Args {
  const int* e_from;
  const int* e_to;
  const unsigned char* e_valid;
  int n_edges;
  int n;
  int n_iters;
  const int* labels_in;              // gauge from these labels (no rounds), or null
  const unsigned char* node_valid;   // null: no gauge
  const unsigned char* node_fixed;
  const float* stamp;
  int* labels;                       // (n,) out, null with labels_in
  unsigned char* gauge;              // (n,) out, or null
  int* rounds;                       // () out: the rounds run, or null
  int* scratch;                      // the grid form's arrays
};

struct Span {
  int start, stride;
};

__device__ __forceinline__ Span cta_span() {
  return {static_cast<int>(threadIdx.x), static_cast<int>(blockDim.x)};
}
__device__ __forceinline__ Span grid_span() {
  return {static_cast<int>(blockIdx.x * blockDim.x + threadIdx.x),
          static_cast<int>(gridDim.x * blockDim.x)};
}

// a 64-bit word read whole while other threads atomicMin it
__device__ __forceinline__ unsigned long long load_relaxed(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// order-preserving unsigned key of a float, ±0 alike
__device__ __forceinline__ unsigned stamp_key(float f) {
  const unsigned u = __float_as_uint(f == 0.0f ? 0.0f : f);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

// The arrays of one call: a the labels, t the scatter target, l the jump
// buffer; key (n 64-bit words, over t and l once the rounds are done) and
// fixed (⌈n/32⌉ words) the gauge's.
struct Arrays {
  int* a;
  int* t;
  int* l;
  unsigned long long* key;
  unsigned* fixed;
  int* flags;   // grid form: a flag a round, three
};

__device__ __forceinline__ void init_labels(const Args& p, const Arrays& m, Span s) {
  for (int i = s.start; i < p.n; i += s.stride) m.a[i] = m.t[i] = i;
}

__device__ __forceinline__ void scatter_min(const Args& p, const Arrays& m, Span s) {
  for (int e = s.start; e < p.n_edges; e += s.stride) {
    if (!p.e_valid[e]) continue;
    const int f = p.e_from[e], to = p.e_to[e];
    const int v = min(m.a[f], m.a[to]);
    if (v < m.t[f]) atomicMin(m.t + f, v);
    if (v < m.t[to]) atomicMin(m.t + to, v);
  }
}

__device__ __forceinline__ void jump(const Args& p, const Arrays& m, Span s) {
  for (int i = s.start; i < p.n; i += s.stride) m.l[i] = m.t[m.t[i]];
}

// the round's second jump writes the labels and the next round's scatter
// target; returns whether this thread changed a label
__device__ __forceinline__ int jump_out(const Args& p, const Arrays& m, Span s) {
  int changed = 0;
  for (int i = s.start; i < p.n; i += s.stride) {
    const int v = m.l[m.l[i]];
    changed |= v != m.a[i];
    m.a[i] = m.t[i] = v;
  }
  return changed;
}

__device__ __forceinline__ void gauge_init(const Args& p, const Arrays& m, Span s) {
  for (int i = s.start; i < p.n; i += s.stride) m.key[i] = kNoKey;
  for (int w = s.start; w < (p.n + 31) / 32; w += s.stride) m.fixed[w] = 0u;
}

__device__ __forceinline__ void gauge_reduce(const Args& p, const Arrays& m, const int* lab,
                                             Span s) {
  for (int i = s.start; i < p.n; i += s.stride) {
    if (!p.node_valid[i]) continue;
    const int c = lab[i];
    if (p.node_fixed[i]) atomicOr(m.fixed + (c >> 5), 1u << (c & 31));
    const unsigned long long k =
        (static_cast<unsigned long long>(stamp_key(p.stamp[i])) << 32) | static_cast<unsigned>(i);
    if (k < load_relaxed(m.key + c)) atomicMin(m.key + c, k);
  }
}

__device__ __forceinline__ void gauge_write(const Args& p, const Arrays& m, const int* lab,
                                            Span s) {
  for (int i = s.start; i < p.n; i += s.stride) {
    const bool valid = p.node_valid[i] != 0;
    const int c = lab[i];
    const bool has_fixed = (m.fixed[c >> 5] >> (c & 31)) & 1u;
    const bool oldest = valid && (m.key[c] & 0xffffffffull) == static_cast<unsigned>(i);
    p.gauge[i] = (valid && p.node_fixed[i]) || (oldest && !has_fixed);
  }
}

// Shared memory of the one-CTA form: t and l first (their 8n bytes hold
// the n 64-bit keys once the rounds are done), then a, then the fixed bits.
// kernels/ops.py:components_smem repeats this.
size_t cta_smem(int n) { return 12ull * n + 4ull * ((n + 31) / 32); }

__global__ void __launch_bounds__(kCtaThreads) components_cta(Args p) {
  extern __shared__ __align__(16) int sm[];
  Arrays m;
  m.t = sm;
  m.l = sm + p.n;
  m.key = reinterpret_cast<unsigned long long*>(sm);
  m.a = sm + 2 * p.n;
  m.fixed = reinterpret_cast<unsigned*>(sm + 3 * p.n);
  m.flags = nullptr;
  const Span s = cta_span();
  const int* lab = p.labels_in;
  if (lab == nullptr) {
    init_labels(p, m, s);
    __syncthreads();
    int it = 0;
    while (it < p.n_iters) {
      scatter_min(p, m, s);
      __syncthreads();
      jump(p, m, s);
      __syncthreads();
      const int any = __syncthreads_or(jump_out(p, m, s));
      ++it;
      if (!any) break;
    }
    if (p.rounds != nullptr && threadIdx.x == 0) *p.rounds = it;
    for (int i = s.start; i < p.n; i += s.stride) p.labels[i] = m.a[i];
    lab = m.a;
  }
  if (p.gauge == nullptr) return;
  __syncthreads();   // t and l are the keys from here
  gauge_init(p, m, s);
  __syncthreads();
  gauge_reduce(p, m, lab, s);
  __syncthreads();
  gauge_write(p, m, lab, s);
}

// Scratch ints of the grid form: the keys (2n, first: 8-byte aligned), t,
// l, the fixed bits and three flags.  kernels/ops.py:components_scratch
// repeats this.
long long grid_scratch_ints(int n) { return 4LL * n + (n + 31) / 32 + 3; }

__global__ void __launch_bounds__(kGridThreads) components_grid(Args p) {
  cg::grid_group grid = cg::this_grid();
  Arrays m;
  m.key = reinterpret_cast<unsigned long long*>(p.scratch);
  m.t = p.scratch + 2LL * p.n;
  m.l = m.t + p.n;
  m.fixed = reinterpret_cast<unsigned*>(m.l + p.n);
  m.flags = reinterpret_cast<int*>(m.fixed + (p.n + 31) / 32);
  m.a = p.labels;
  const Span s = grid_span();
  const bool first = blockIdx.x == 0 && threadIdx.x == 0;
  const int* lab = p.labels_in;
  if (p.gauge != nullptr) gauge_init(p, m, s);
  if (lab == nullptr) {
    init_labels(p, m, s);
    if (first) m.flags[0] = m.flags[1] = 0;
    grid.sync();
    // round it sets flags[it % 3] and clears flags[(it + 1) % 3], the next
    // round's; flags[(it + 2) % 3] was read before the round began
    int it = 0;
    while (it < p.n_iters) {
      if (first) m.flags[(it + 1) % 3] = 0;
      scatter_min(p, m, s);
      grid.sync();
      jump(p, m, s);
      grid.sync();
      const int changed = jump_out(p, m, s);
      if (__any_sync(0xffffffffu, changed) && (threadIdx.x & 31) == 0)
        atomicOr(m.flags + it % 3, 1);
      grid.sync();
      const int any = *reinterpret_cast<volatile int*>(m.flags + it % 3);
      ++it;
      if (!any) break;
    }
    if (p.rounds != nullptr && first) *p.rounds = it;
    lab = m.a;
  } else {
    grid.sync();
  }
  if (p.gauge == nullptr) return;
  gauge_reduce(p, m, lab, s);
  grid.sync();
  gauge_write(p, m, lab, s);
}

// CTAs of the cooperative grid the card holds at once (cached per device).
int resident_ctas() {
  static int cache[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (cache[dev] == 0) {
    int fit = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, components_grid, kGridThreads, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    if (kGridCtasPerSm > 0 && fit > kGridCtasPerSm) fit = kGridCtasPerSm;
    cache[dev] = fit * sms;
  }
  return cache[dev];
}

}  // namespace

// One call of K8.  e_from, e_to (E,) int32, e_valid (E,) bool; labels_in
// (n,) int32 or NULL (then n_iters rounds at most, labels (n,) int32 out);
// node_valid, node_fixed (n,) bool and stamp (n,) float, with gauge (n,)
// bool out, or all NULL (labels only); rounds () int32 out or NULL; scratch
// NULL while 12n + 4⌈n/32⌉ <= 232448 bytes (one CTA), else 4n + ⌈n/32⌉ + 3
// ints of device memory (one cooperative grid).
extern "C" int uz_components_gauge(const int* e_from, const int* e_to,
                                   const unsigned char* e_valid, int n_edges, int n_nodes,
                                   int n_iters, const int* labels_in,
                                   const unsigned char* node_valid,
                                   const unsigned char* node_fixed, const float* stamp,
                                   int* labels, unsigned char* gauge, int* rounds, int* scratch,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_nodes <= 0) return 0;
  if ((labels_in == nullptr) == (labels == nullptr) || (gauge == nullptr) != (stamp == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args p{e_from, e_to, e_valid, n_edges, n_nodes, n_iters, labels_in, node_valid, node_fixed,
         stamp, labels, gauge, rounds, scratch};
  if (scratch == nullptr) {
    const size_t smem = cta_smem(n_nodes);
    if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          components_cta, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    components_cta<<<1, kCtaThreads, smem, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const long long work = n_edges > n_nodes ? n_edges : n_nodes;
  const int need = static_cast<int>((work + kGridThreads - 1) / kGridThreads);
  const int fit = resident_ctas();
  if (fit <= 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const int grid = need < fit ? need : fit;
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(components_grid),
                                                      dim3(grid), dim3(kGridThreads), args, 0, s));
}
