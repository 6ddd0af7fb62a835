// K16 hamming_top2: Hamming nearest neighbours of packed 256-bit binary
// descriptors, two entry points.
//
// Replaces uzliti_slam_tpu/ops/matching.py:hamming_matrix (:53-72),
// knn_match (:80-97) and ratio_test (:100-113), reached through
// match_descriptors (:116-133), and the Hamming top-k of
// uzliti_slam_tpu/recognition/recognizer.py:gist_query (:76-94).  The
// reference unpacks the bits and runs an int8 matrix product (the form the
// TPU's matrix unit wanted; a packed popcount lost there, matching.py:9-21),
// writes the (Na, Nb) distance matrix, masks it and takes a top_k.  On Hopper
// the packed form is the natural one: XOR and __popc on a descriptor's two
// 128-bit halves, and no distance matrix goes to device memory.
//
// Both entries order candidates by a 64-bit key (distance << 32 | index):
// the smallest keys are the smallest distances, ties to the lower index, as
// XLA's top_k and a sequential scan with strict '<' in ascending index.
//
// uz_hamming_top2 — the keyframe step's matching, all candidates in one
// launch: grid (query blocks of 8, candidates), 64 threads a CTA, so the
// step's 256 queries x 5 candidates take 160 CTAs (more than the 132 SMs).
// A CTA stages its candidate's stored descriptors (gathered from the node
// bank by the candidate's slot) in shared memory, kTile at a time, with
// 128-bit loads all in flight together.  Each query's scan of them is
// split over 8 lanes, lane l taking stored j = l, l + 8, ...; each lane keeps
// its (best, second) keys branch-free, then the 8 lanes' pairs merge by xor
// shuffles: top-2 of two sorted pairs = (min(a1, b1), min(max(a1, b1),
// min(a2, b2))), which is the sequential scan's result exactly.  Masked
// pairs (invalid query or stored descriptor) are 1e9, as knn_match masks
// them (not +inf): a query with one valid stored descriptor has second =
// 1e9 and passes the ratio test, and a row with none returns indices 0 and
// 1.  Then ok = valid_a & best <= fl(ratio * second) & best <= max_dist, in
// float32 as the reference's gates.
//
// uz_gist_topk — the GIST query: one pass over the bank per kKeep keys
// taken, with no distance kept in shared memory (the bank's size is not
// capped).  The bank is split over the CTAs of one thread-block cluster (1
// to 8 CTAs of 512 threads, by its size); each thread keeps its kKeep
// smallest keys in registers (a sorted insertion, unrolled), +inf distance
// where an entry is not eligible (invalid, or |stamp - query stamp| < min_dt
// in float32); a warp takes its smallest by rounds of a butterfly minimum
// of the lanes' heads (one round a key the pass takes), the CTA's warp 0
// the same over the warps' lists, and, in a cluster of more than one CTA,
// CTA 0's warp 0 over the CTAs' lists read through distributed shared
// memory.  k > kKeep takes passes, each over the keys above the last key
// taken (K13's passes of 8).
//
// What bounds it on the card: launch latency at the keyframe's size (the
// matching's bytes are 5 candidates x 8 KB of stored descriptors, its
// operations 5 x 256 x 256 x ~25 = 8 M, 0.1 us at 67 T/s); the GIST query
// at map scale reads its bank once a pass (100k nodes: 3.7 MB, 1.1 us at
// 3.35 TB/s), over the cluster's SMs.
#include <algorithm>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

using ull = unsigned long long;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMasked = 1000000000;              // knn_match's 1e9 padding
// an empty slot, after every key (its distance INT_MAX, as the sequential
// scan's initial second)
constexpr ull kEmpty = (0x7fffffffULL << 32) | 0xffffffffULL;

constexpr int kLanes = 8;                        // lanes a query's scan is split over
constexpr int kMatchThreads = 64;                // 8 queries a CTA
constexpr int kTile = 256;                       // stored descriptors staged at a time

constexpr int kGistThreads = 512;
constexpr int kGistWarps = kGistThreads / 32;
constexpr int kGistMaxCtas = 8;                  // the portable cluster size
constexpr int kGistPerThread = 8;                // entries a thread, sizing the cluster
constexpr int kKeep = 8;                         // keys a pass

__device__ __forceinline__ void load32(const unsigned char* p, uint4& a, uint4& b) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  a = __ldg(q);
  b = __ldg(q + 1);
}

__device__ __forceinline__ int hamming(const uint4& qa, const uint4& qb, const uint4& a,
                                       const uint4& b) {
  return __popc(qa.x ^ a.x) + __popc(qa.y ^ a.y) + __popc(qa.z ^ a.z) + __popc(qa.w ^ a.w) +
         __popc(qb.x ^ b.x) + __popc(qb.y ^ b.y) + __popc(qb.z ^ b.z) + __popc(qb.w ^ b.w);
}

__global__ void __launch_bounds__(kMatchThreads)
match_top2_lanes(const unsigned char* __restrict__ query, const unsigned char* __restrict__ bank,
                 const unsigned char* __restrict__ bank_valid, const int* __restrict__ cslot,
                 const unsigned char* __restrict__ valid_a, int Na, int F, float ratio,
                 float max_dist, int* __restrict__ idx, unsigned char* __restrict__ ok,
                 float* __restrict__ best_out) {
  __shared__ uint4 s_desc[2 * kTile];
  __shared__ unsigned char s_valid[kTile];
  const int c = blockIdx.y;
  const int i = blockIdx.x * (kMatchThreads / kLanes) + threadIdx.x / kLanes;
  const int l = threadIdx.x % kLanes;
  // every lane reaches the barriers and shuffles: a query past Na scans a
  // clamped row and writes nothing
  const int qi = min(i, Na - 1);
  const size_t slot = static_cast<size_t>(cslot[c]);
  const uint4* cb = reinterpret_cast<const uint4*>(bank + slot * F * 32);
  const unsigned char* cv = bank_valid + slot * F;
  uint4 qa, qb;
  load32(query + static_cast<size_t>(qi) * 32, qa, qb);
  const bool va = valid_a[qi] != 0;
  ull k1 = kEmpty, k2 = kEmpty;
  for (int t0 = 0; t0 < F; t0 += kTile) {
    const int n = min(kTile, F - t0);
    __syncthreads();                                           // the last tile is scanned
    for (int e = threadIdx.x; e < 2 * n; e += kMatchThreads) s_desc[e] = __ldg(cb + 2 * t0 + e);
    for (int e = threadIdx.x; e < n; e += kMatchThreads) s_valid[e] = cv[t0 + e];
    __syncthreads();
    for (int j = l; j < n; j += kLanes) {
      const int d = (va && s_valid[j]) ? hamming(qa, qb, s_desc[2 * j], s_desc[2 * j + 1])
                                       : kMasked;
      const ull key = (static_cast<ull>(d) << 32) | static_cast<unsigned>(t0 + j);
      k2 = min(k2, max(k1, key));
      k1 = min(k1, key);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const ull o1 = __shfl_xor_sync(kFull, k1, off), o2 = __shfl_xor_sync(kFull, k2, off);
    k2 = min(max(k1, o1), min(k2, o2));
    k1 = min(k1, o1);
  }
  if (l == 0 && i < Na) {
    const float best = static_cast<float>(static_cast<int>(k1 >> 32));
    const float second = static_cast<float>(static_cast<int>(k2 >> 32));
    const size_t o = static_cast<size_t>(c) * Na + i;
    idx[o] = static_cast<int>(k1 & 0xffffffffULL);
    best_out[o] = best;
    ok[o] = va && best <= __fmul_rn(ratio, second) && best <= max_dist;
  }
}

// x into the sorted list v (ascending; the largest falls out)
__device__ __forceinline__ void insert(ull x, ull (&v)[kKeep]) {
#pragma unroll
  for (int i = kKeep - 1; i > 0; --i) v[i] = x < v[i - 1] ? v[i - 1] : min(v[i], x);
  v[0] = min(v[0], x);
}

// The n <= kKeep smallest keys of the warp's lanes' sorted lists,
// ascending, in every lane: n rounds of a butterfly minimum of the heads,
// the lane whose head was taken popping it (keys are unique, but for
// kEmpty).  n is the same in every lane.
__device__ __forceinline__ void warp_select(ull (&v)[kKeep], ull (&out)[kKeep], int n) {
#pragma unroll
  for (int r = 0; r < kKeep; ++r) {
    if (r < n) {
      ull m = v[0];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) m = min(m, __shfl_xor_sync(kFull, m, off));
      out[r] = m;
      if (v[0] == m) {
#pragma unroll
        for (int i = 0; i < kKeep - 1; ++i) v[i] = v[i + 1];
        v[kKeep - 1] = kEmpty;
      }
    }
  }
}

// The pass's keys (out[0..n)) written at slots taken..taken+n.
__device__ __forceinline__ void write_keys(const ull (&out)[kKeep], int n, int taken, int lane,
                                           float max_dist, int* slots, float* dist,
                                           unsigned char* ok) {
#pragma unroll
  for (int r = 0; r < kKeep; ++r) {
    if (lane == r && r < n) {
      const float d = __uint_as_float(static_cast<unsigned>(out[r] >> 32));
      slots[taken + r] = static_cast<int>(out[r] & 0xffffffffULL);
      dist[taken + r] = d;
      ok[taken + r] = isfinite(d) && d <= max_dist;
    }
  }
}

__global__ void __launch_bounds__(kGistThreads)
gist_topk_cluster(const unsigned char* __restrict__ query, const unsigned char* __restrict__ bank,
                  const float* __restrict__ stamp, const unsigned char* __restrict__ valid,
                  const float* __restrict__ q_stamp, int N, int k, float min_dt, float max_dist,
                  int* __restrict__ slots, float* __restrict__ dist,
                  unsigned char* __restrict__ ok) {
  __shared__ ull s_warp[kGistWarps][kKeep];
  __shared__ ull s_cta[kKeep];
  __shared__ ull s_last;
  // one CTA: launched without a cluster, it merges alone
  const int ctas = gridDim.x, rank = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int stride = ctas * kGistThreads;
  uint4 qa, qb;
  load32(query, qa, qb);
  const float qs = *q_stamp;
  ull last = 0;
  for (int taken = 0; taken < k; taken += kKeep) {
    const bool first = taken == 0;
    // the keys this pass takes; all kKeep when a pass follows (its last key)
    const int n = min(kKeep, k - taken);
    ull v[kKeep];
#pragma unroll
    for (int i = 0; i < kKeep; ++i) v[i] = kEmpty;
    for (int j = rank * kGistThreads + tid; j < N; j += stride) {
      unsigned bits = 0x7f800000u;                               // +inf: not eligible
      if (valid[j] && fabsf(__fsub_rn(__ldg(stamp + j), qs)) >= min_dt) {
        uint4 a, b;
        load32(bank + static_cast<size_t>(j) * 32, a, b);
        bits = __float_as_uint(static_cast<float>(hamming(qa, qb, a, b)));
      }
      const ull key = (static_cast<ull>(bits) << 32) | static_cast<unsigned>(j);
      if (first || key > last) insert(key, v);
    }
    ull out[kKeep];
#pragma unroll
    for (int i = 0; i < kKeep; ++i) out[i] = kEmpty;
    warp_select(v, out, n);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kKeep; ++r) s_warp[warp][r] = out[r];
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int i = 0; i < kKeep; ++i) v[i] = lane < kGistWarps ? s_warp[lane][i] : kEmpty;
      warp_select(v, out, n);
      if (ctas == 1) {
        write_keys(out, n, taken, lane, max_dist, slots, dist, ok);
        last = out[kKeep - 1];
      } else if (lane == 0) {
#pragma unroll
        for (int r = 0; r < kKeep; ++r) s_cta[r] = out[r];
      }
    }
    if (ctas == 1) {
      // warp 0 holds the last key; the s_warp lists are read
      if (lane == 0 && warp == 0) s_last = last;
      __syncthreads();
      last = s_last;
      continue;
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (rank == 0 && warp == 0) {
#pragma unroll
      for (int i = 0; i < kKeep; ++i)
        v[i] = lane < ctas ? *cluster.map_shared_rank(&s_cta[i], lane) : kEmpty;
      warp_select(v, out, n);
      write_keys(out, n, taken, lane, max_dist, slots, dist, ok);
      if (lane == 0) s_last = out[kKeep - 1];
    }
    // CTA 0 has read every CTA's list; the others wait for its last key
    cluster.sync();
    if (taken + kKeep < k) last = *cluster.map_shared_rank(&s_last, 0);
  }
}

}  // namespace

// query: (Na, 32) uint8; bank: (N, F, 32) uint8; bank_valid: (N, F) bool;
// cslot: (C,) int32 node slots in [0, N); valid_a: (Na,) bool; query and
// bank 16-byte aligned.  Out: idx (C, Na) int32, ok (C, Na) bool, best (C,
// Na) float32.
extern "C" int uz_hamming_top2(const unsigned char* query, const unsigned char* bank,
                               const unsigned char* bank_valid, const int* cslot,
                               const unsigned char* valid_a, int C, int Na, int F, float ratio,
                               float max_dist, int* idx, unsigned char* ok, float* best,
                               void* stream) {
  if (C <= 0 || Na <= 0) return 0;
  if (F < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Na + kMatchThreads / kLanes - 1) / (kMatchThreads / kLanes), C);
  match_top2_lanes<<<grid, kMatchThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      query, bank, bank_valid, cslot, valid_a, Na, F, ratio, max_dist, idx, ok, best);
  return static_cast<int>(cudaGetLastError());
}

// query: (32,) uint8; bank: (N, 32) uint8, both 16-byte aligned; stamp: (N,)
// float32; valid: (N,) bool; q_stamp: () float32 on the device.  Out: slots
// (k,) int32, dist (k,) float32 (+inf where not eligible), ok (k,) bool.
// 1 <= k <= N.  One CTA up to 4,096 entries, else one cluster of 2 to 8
// CTAs, by N.
extern "C" int uz_gist_topk(const unsigned char* query, const unsigned char* bank,
                            const float* stamp, const unsigned char* valid, const float* q_stamp,
                            int N, int k, float min_dt, float max_dist, int* slots, float* dist,
                            unsigned char* ok, void* stream) {
  if (N <= 0 || k <= 0) return 0;
  if (k > N) return static_cast<int>(cudaErrorInvalidValue);
  const long long per_cta = static_cast<long long>(kGistThreads) * kGistPerThread;
  const int ctas = static_cast<int>(
      std::min<long long>(kGistMaxCtas, std::max<long long>(1, (N + per_cta - 1) / per_cta)));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ctas == 1) {
    gist_topk_cluster<<<1, kGistThreads, 0, s>>>(query, bank, stamp, valid, q_stamp, N, k,
                                                  min_dt, max_dist, slots, dist, ok);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, 1, 1);
  cfg.blockDim = dim3(kGistThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, gist_topk_cluster, query, bank, stamp, valid,
                                             q_stamp, N, k, min_dt, max_dist, slots, dist, ok));
}
