// K19 merge_pairs: the node-merge pair search, in one launch.
//
// Replaces uzliti_slam_tpu/graph/lifecycle.py:find_merge_pairs (:77-133).
// The reference builds the full N x N score (dt where the pair is close,
// +inf elsewhere: dt = |t_i - t_j|, dr = degrees(rotation_angle(conj(q_i) ·
// q_j)), both nodes eligible, stamp_i < stamp_j), then takes max_pairs
// rounds of an argmin over all N² entries, masking both chosen nodes' rows
// and columns: max_pairs passes over N² floats, a 400 MB temporary each at
// 10k nodes.
//
// What bounds it on the card: the operations the function needs on these
// inputs, counted by chip_smoke.kernel_work: a stamp compare for every
// ordered pair of eligible nodes, the distance test (~9 operations) for
// each pair whose stamps are in order, the rotation gate (~150) only for
// the pairs within dist_thresh, and the greedy rounds over the candidates
// kept (~8 an entry a round).  At 10k eligible nodes that is ~5·10⁸
// operations, 0.008 ms at 67 TFLOP/s; the bytes (the N poses, stamps and
// flags) are fewer.
//
// Design: one launch, a warp a row i, 16 rows a CTA.
//   - Column tiles of (x, y, z, stamp) float4 in shared memory, the stamp
//     NaN where the node is not eligible, so one compare si < sj tests the
//     column's eligibility and the pair's order.  Each lane tests a column:
//     the stamps, then a float32 bound on the squared distance,
//     fl(fl(d0²) + fl(d1²)) + fl(d2²) <= s_hi, where s_hi lies 64 ulps above
//     s*, the least float s with fl(√s) >= dist_thresh (kops.merge_dist_bound):
//     the exact sum differs from this one by a few ulps, so no pair within
//     dist_thresh fails it.  Almost every pair stops there.
//   - The few lanes that pass evaluate the gates exactly as
//     merge_pair_gates_plain (kernels/ops.py) does, operation for operation:
//     the quaternion product and the sums of squares as chains of fused
//     multiply-adds taken in float64 and rounded once to float32 (the
//     products of two floats are exact there), the rotation gate only where
//     dt < dist_thresh, degrees as a multiply by fl(180/pi).  sqrt64(x) of a
//     float x is __fsqrt_rn(x): double's 53 bits exceed 2·24 + 2, so the
//     double root rounded to float is the correctly rounded float root.
//   - A close pair (i, j) is the 64-bit key (float_bits(dt) << 32) | (i·N +
//     j); for dt >= 0 the float bits order like the floats, so the smallest
//     key is argmin's answer with ties to the lower flat index (N <= 65535
//     keeps i·N + j in 32 bits).  A row keeps its K = 2·max_pairs - 1
//     smallest keys: when round r picks (i*, j*), every smaller key of row
//     i* has a column among the <= 2r <= K - 1 nodes already used, else it
//     would have won, so the winner is always among its row's K smallest and
//     no pair is lost, whatever the density.  The keys are gathered by warp
//     ballot into the warp's 128-entry buffer in shared memory; only a row
//     whose buffer would overflow (more than 96 keys) is sorted (a bitonic
//     sort by the warp) and cut to K mid-row.  At its end the row's keys are
//     sorted (in registers when there are at most 32) and cut to K, written
//     to the row's K slots padded with empty keys, and their runs of equal
//     top 16 bits (dt's exponent and 7 bits) and top 8 bits added to two
//     histograms.
//   - The last CTA to finish (a __threadfence and an arrival counter) reads
//     the histograms: the largest prefix of bins whose keys fit its shared
//     memory gives the smallest keys, gathered from the sorted rows (a row
//     stops at its first larger key).  It puts the bins it touched and the
//     counter back to 0 for the next call and runs the max_pairs greedy
//     rounds over that subset: a block minimum over the keys whose nodes are
//     both unused (a bitmap in shared memory; each thread keeps its
//     entries' smallest live key), then the winner's nodes are marked used.
//     While the subset holds such a key it holds the smallest (every key
//     outside it is larger); once it holds none, the rounds search every
//     row's slots.  A round with no key left writes (0, 0, false), as argmin
//     over an all-inf score does, and so does every round after it.
// No atomic decides a result (the histogram's counts and the subset do not
// depend on the order of its atomics): two launches give the same answer.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;                 // rows a CTA: a warp a row
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 3072;                // columns staged a pass (48 KB)
constexpr int kBuf = 128;                  // a row's key buffer: K + 32 <= 95 after a cut
constexpr int kMaxK = 63;                  // 2·32 - 1: max_pairs <= 32
constexpr int kMaxNodes = 65535;
constexpr int kUsedWords = (kMaxNodes + 32) / 32;
constexpr int kHistBins = 1 << 16;         // the keys' top 16 bits: dt's sign, exponent, 7 bits
constexpr int kCoarseBins = 1 << 8;        // their top 8 bits
constexpr size_t kSmemBytes = kTile * sizeof(float4) + kWarps * kBuf * sizeof(unsigned long long);
// the last CTA's tables in the same shared memory: the used bitmap, the
// scan's and the minimum's per-warp slots, then the list of candidates
constexpr size_t kTables = kUsedWords * 4 + 32 * 4 + 32 * 8;
constexpr int kListCap = static_cast<int>((kSmemBytes - kTables) / 8);
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;
static_assert(kMaxK + 32 <= kBuf, "a cut buffer must take one more chunk");
static_assert(kCoarseBins <= kThreads, "a thread a coarse bin");

#ifdef UZ_MERGE_STAMPS
// UZ_MERGE_STAMPS makes a timing build only (scripts/k19_k20_variants.py):
// the last CTA's %globaltimer ns at its start, after the histogram, after
// the gather and at its end, written over the first key slots once its
// rounds no longer read them
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#endif

__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__fma_rn(static_cast<double>(a), static_cast<double>(b),
                                    static_cast<double>(c)));
}

__device__ __forceinline__ float floor_at(float x, float lo) { return x < lo ? lo : x; }

// dr (degrees) of a pose pair, as merge_pair_gates_plain.
__device__ __forceinline__ float rotation_gate(const float* qi, const float* qj) {
  const float aw = qi[0], ax = -qi[1], ay = -qi[2], az = -qi[3];
  const float bw = qj[0], bx = qj[1], by = qj[2], bz = qj[3];
  float w = fma64(-az, bz, fma64(-ay, by, fma64(aw, bw, -__fmul_rn(ax, bx))));
  float x = fma64(-az, by, fma64(ay, bz, fma64(aw, bx, __fmul_rn(ax, bw))));
  float y = fma64(az, bx, fma64(ay, bw, fma64(aw, by, -__fmul_rn(ax, bz))));
  float z = fma64(az, bw, fma64(-ay, bx, fma64(aw, bz, __fmul_rn(ax, by))));
  const float n = __fsqrt_rn(floor_at(fma64(z, z, fma64(y, y, fma64(x, x, __fmul_rn(w, w)))),
                                      1e-30f));
  w = __fdiv_rn(w, n); x = __fdiv_rn(x, n); y = __fdiv_rn(y, n); z = __fdiv_rn(z, n);
  if (w < 0.f) { w = -w; x = -x; y = -y; z = -z; }
  w = fminf(fmaxf(w, -1.f), 1.f);
  const float vn = __fsqrt_rn(floor_at(fma64(z, z, fma64(y, y, __fmul_rn(x, x))), 1e-30f));
  const bool small = vn < 1e-6f;
  const float scale = small ? __fdiv_rn(2.f, fabsf(w) < 1e-12f ? 1.f : w)
                            : __fdiv_rn(__fmul_rn(2.f, atan2f(vn, w)), vn);
  const float px = __fmul_rn(scale, x), py = __fmul_rn(scale, y), pz = __fmul_rn(scale, z);
  const float ang = __fsqrt_rn(floor_at(fma64(pz, pz, fma64(py, py, __fmul_rn(px, px))), 1e-30f));
  return __fmul_rn(ang, 57.2957802f);   // fl(180/pi)
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(kFull, v, o);
    v = u < v ? u : v;
  }
  return v;
}

// Sort the warp's buffer ascending, its entries from `count` on set empty
// first: a bitonic network, two compare-exchanges a lane a stage.
__device__ void sort_buffer(unsigned long long* buf, int count, int lane) {
  for (int r = count + lane; r < kBuf; r += 32) buf[r] = kNone;
  __syncwarp();
  for (int k = 2; k <= kBuf; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < kBuf / 2; t += 32) {
        const int lo = (t / j) * 2 * j + (t % j), hi = lo + j;
        const unsigned long long a = buf[lo], b = buf[hi];
        if ((a > b) == ((lo & k) == 0)) {
          buf[lo] = b;
          buf[hi] = a;
        }
      }
      __syncwarp();
    }
  }
}

// Sort the first count <= 32 entries of the buffer ascending: a bitonic
// network in registers, a key a lane.
__device__ void sort_small(unsigned long long* buf, int count, int lane) {
  unsigned long long key = lane < count ? buf[lane] : kNone;
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, key, j);
      const bool up = (lane & k) == 0, lower = (lane & j) == 0;
      key = (lower == up) ? (o < key ? o : key) : (o > key ? o : key);
    }
  }
  __syncwarp();
  if (lane < count) buf[lane] = key;
  __syncwarp();
}

// The exclusive prefix sum of v over the CTA, and its total (scan: kWarps
// ints of shared scratch).
__device__ int cta_scan(int v, int* scan, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) scan[warp] = incl;
  __syncthreads();
  int before = 0;
  total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += scan[w];
    total += scan[w];
  }
  __syncthreads();
  return before + incl - v;
}

__device__ __forceinline__ bool pair_used(unsigned long long key, const unsigned int* used,
                                          unsigned int n) {
  const unsigned int flat = static_cast<unsigned int>(key);
  const unsigned int a = flat / n, b = flat - (flat / n) * n;
  return ((used[a >> 5] >> (a & 31)) | (used[b >> 5] >> (b & 31))) & 1u;
}

// The smallest key among this thread's entries of list[0, len) (every
// kThreads-th from its index) whose nodes are both unused.
__device__ __forceinline__ unsigned long long thread_min_live(const unsigned long long* list,
                                                              int len, const unsigned int* used,
                                                              unsigned int n) {
  unsigned long long best = kNone;
  for (int e0 = threadIdx.x; e0 < len; e0 += 4 * kThreads) {
    unsigned long long k[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) k[u] = e0 + u * kThreads < len ? list[e0 + u * kThreads] : kNone;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (k[u] < best && !pair_used(k[u], used, n)) best = k[u];
  }
  return best;
}

// The smallest of the threads' keys, in every thread; the caller
// synchronises before best_of is written again.
__device__ __forceinline__ unsigned long long cta_min(unsigned long long v,
                                                      unsigned long long* best_of) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_min(v);
  if (lane == 0) best_of[warp] = v;
  __syncthreads();
  v = kNone;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v = best_of[w] < v ? best_of[w] : v;
  return v;
}

// The last CTA's part.  Every row added its keys' runs to two histograms,
// of their top 8 bits (coarse) and top 16 bits (fine: dt's exponent and 7
// bits); the largest prefix of coarse bins whose keys fit the list, then of
// the fine bins inside the next coarse bin, gives the smallest keys, which
// are gathered from the sorted rows (a row stops at its first larger key).
// The touched bins and the counter go back to 0 for the next call.  The
// greedy rounds search that subset: while it holds a key whose nodes are
// both unused it holds the smallest such key (every key outside it is
// larger); once it holds none, every row's slots.  Each thread keeps the
// smallest live key of its entries and searches them again only when that
// key's nodes are used: keys die and never come back.
__device__ void greedy_rounds(unsigned char* smem, int n, int K, int max_pairs,
                              const unsigned long long* cand, int* hist, int* keep, int* absorb,
                              bool* ok) {
  __shared__ int pick[4];
  __shared__ int coarse_count[kCoarseBins];
#ifdef UZ_MERGE_STAMPS
  unsigned long long stamps[4] = {now_ns(), 0, 0, 0};
#endif
  unsigned int* used = reinterpret_cast<unsigned int*>(smem);
  int* scan = reinterpret_cast<int*>(smem + kUsedWords * 4);
  unsigned long long* best_of = reinterpret_cast<unsigned long long*>(
      smem + kUsedWords * 4 + 32 * 4);
  unsigned long long* list = reinterpret_cast<unsigned long long*>(smem + kTables);
  int* fine = hist;
  int* coarse = hist + kHistBins;
  const unsigned int un = static_cast<unsigned int>(n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = threadIdx.x;
  // the largest prefix of coarse bins that fits
  const int c = t < kCoarseBins ? __ldcg(coarse + t) : 0;
  if (t < kCoarseBins) coarse_count[t] = c;
  if (t == 0) {
    pick[0] = -1;
    pick[2] = -1;
    pick[3] = 0;
  }
  int total;
  const int incl = cta_scan(c, scan, total) + c;
  if (t < kCoarseBins && incl <= kListCap) atomicMax(pick, t);
  __syncthreads();
  const int cb = pick[0];
  if (t == cb) pick[1] = incl;
  __syncthreads();
  // then of the fine bins of the next coarse bin
  const int nb = cb + 1, base = cb >= 0 ? pick[1] : 0;
  int thr = kHistBins - 1;   // the subset: keys whose top 16 bits are at most thr
  if (nb < kCoarseBins) {
    const int f = t < 256 ? __ldcg(fine + nb * 256 + t) : 0;
    int ftot;
    const int finc = cta_scan(f, scan, ftot) + f;
    if (t < 256 && base + finc <= kListCap) atomicMax(pick + 2, t);
    __syncthreads();
    thr = pick[2] >= 0 ? nb * 256 + pick[2] : nb * 256 - 1;
  }
  // the bins back to 0: the fine runs of every coarse bin that holds a key
  for (int q = warp; q < kCoarseBins; q += kWarps)
    if (coarse_count[q] > 0)
      for (int b = lane; b < 256; b += 32) fine[q * 256 + b] = 0;
  if (t < kCoarseBins) coarse[t] = 0;
  for (int w = t; w < (n + 31) / 32; w += kThreads) used[w] = 0u;
#ifdef UZ_MERGE_STAMPS
  stamps[1] = now_ns();
#endif
  // the subset, from the sorted rows: four rows' first keys in flight
  for (int r0 = t; r0 < n; r0 += 4 * kThreads) {
    unsigned long long first[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + u * kThreads;
      first[u] = r < n ? __ldcg(cand + static_cast<long long>(r) * K) : kNone;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const long long row = static_cast<long long>(r0 + u * kThreads) * K;
      unsigned long long key = first[u];
      for (int q = 1; key != kNone && static_cast<int>(key >> 48) <= thr; ++q) {
        // one shared atomic for the lanes that append together
        const cg::coalesced_group g = cg::coalesced_threads();
        int at = 0;
        if (g.thread_rank() == 0) at = atomicAdd(pick + 3, static_cast<int>(g.size()));
        list[g.shfl(at, 0) + static_cast<int>(g.thread_rank())] = key;
        key = q < K ? __ldcg(cand + row + q) : kNone;
      }
    }
  }
  __syncthreads();
#ifdef UZ_MERGE_STAMPS
  stamps[2] = now_ns();
#endif
  const unsigned long long* src = list;
  int len = pick[3];
  bool whole = nb >= kCoarseBins, exhausted = false;
  unsigned long long mine = thread_min_live(src, len, used, un);
  for (int r = 0; r < max_pairs; ++r) {
    unsigned long long best = kNone;
    if (!exhausted) {
      if (mine != kNone && pair_used(mine, used, un)) mine = thread_min_live(src, len, used, un);
      best = cta_min(mine, best_of);
      if (best == kNone && !whole) {   // the subset is spent: every row's slots from here on
        whole = true;
        src = cand;
        len = n * K;
        __syncthreads();
        mine = thread_min_live(src, len, used, un);
        best = cta_min(mine, best_of);
      }
    }
    if (t == 0) {
      if (best == kNone) {
        keep[r] = 0;
        absorb[r] = 0;
        ok[r] = false;
      } else {
        const unsigned int flat = static_cast<unsigned int>(best);
        const unsigned int a = flat / un, b = flat - (flat / un) * un;
        keep[r] = static_cast<int>(a);
        absorb[r] = static_cast<int>(b);
        ok[r] = true;
        used[a >> 5] |= 1u << (a & 31);
        used[b >> 5] |= 1u << (b & 31);
      }
    }
    exhausted = best == kNone;   // no key now: none in any later round
    __syncthreads();
  }
#ifdef UZ_MERGE_STAMPS
  if (t == 0) {
    stamps[3] = now_ns();
    for (int q = 0; q < 4; ++q) const_cast<unsigned long long*>(cand)[q] = stamps[q];
  }
#endif
}

__global__ void __launch_bounds__(kThreads, 2)
merge_pairs_kernel(const float* __restrict__ pose, const float* __restrict__ stamp,
                   const bool* __restrict__ eligible, int n, float dist_thresh, float s_hi,
                   float angle_thresh, int max_pairs, unsigned long long* __restrict__ cand,
                   int* __restrict__ hist, unsigned int* __restrict__ arrivals, int* __restrict__ keep,
                   int* __restrict__ absorb, bool* __restrict__ ok) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* tile = reinterpret_cast<float4*>(smem);
  unsigned long long* bufs = reinterpret_cast<unsigned long long*>(smem + kTile * sizeof(float4));
  __shared__ bool last;
  const int K = 2 * max_pairs - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kWarps + warp;
  unsigned long long* buf = bufs + warp * kBuf;
  const bool active = i < n && eligible[i];
  float pi[7] = {}, si = 0.f;
  if (active) {
#pragma unroll
    for (int c = 0; c < 7; ++c) pi[c] = pose[7 * i + c];
    si = stamp[i];
  }
  int count = 0;   // the warp's keys in its buffer (the same in every lane)
  if (__syncthreads_or(active)) {
    for (int t0 = 0; t0 < n; t0 += kTile) {
      const int width = min(kTile, n - t0);
      __syncthreads();
      for (int c = threadIdx.x; c < width; c += kThreads) {
        const int j = t0 + c;
        tile[c] = make_float4(pose[7 * j], pose[7 * j + 1], pose[7 * j + 2],
                              eligible[j] ? stamp[j] : __int_as_float(0x7fc00000));
      }
      __syncthreads();
      if (!active) continue;
      for (int c0 = 0; c0 < width; c0 += 32) {
        const int c = c0 + lane;
        const float4 v = tile[c < width ? c : 0];
        // the stamps first: a chunk of older or non-eligible columns ends here
        bool pass = c < width && si < v.w;
        if (!__any_sync(kFull, pass)) continue;
        const float d0 = __fsub_rn(pi[0], v.x), d1 = __fsub_rn(pi[1], v.y),
                    d2 = __fsub_rn(pi[2], v.z);
        pass = pass && __fadd_rn(__fadd_rn(__fmul_rn(d0, d0), __fmul_rn(d1, d1)),
                                 __fmul_rn(d2, d2)) <= s_hi;
        if (!__any_sync(kFull, pass)) continue;
        unsigned long long key = kNone;
        if (pass) {   // the exact gates, as the plain version
          const int j = t0 + c;
          const float dt = __fsqrt_rn(fma64(d2, d2, fma64(d1, d1, __fmul_rn(d0, d0))));
          pass = dt < dist_thresh && rotation_gate(pi + 3, pose + 7 * j + 3) < angle_thresh;
          key = (static_cast<unsigned long long>(__float_as_uint(dt)) << 32) |
                (static_cast<unsigned int>(i) * static_cast<unsigned int>(n) +
                 static_cast<unsigned int>(j));
        }
        const unsigned bal = __ballot_sync(kFull, pass);
        if (bal == 0u) continue;
        if (count + __popc(bal) > kBuf) {   // cut to the K smallest first
          sort_buffer(buf, count, lane);
          count = min(count, K);
        }
        if (pass) buf[count + __popc(bal & ((1u << lane) - 1u))] = key;
        count += __popc(bal);
        __syncwarp();
      }
    }
  }
  if (i < n) {
    // the row's K smallest, ascending, padded with empty keys; its runs of
    // equal top 16 bits into the histogram
    if (count > 32 || count > K) {
      sort_buffer(buf, count, lane);
      count = min(count, K);
    } else if (count > 1) {
      sort_small(buf, count, lane);
    }
    for (int r = lane; r < K; r += 32)
      cand[static_cast<long long>(i) * K + r] = r < count ? buf[r] : kNone;
    for (int r = lane; r < count; r += 32) {
      const unsigned int bin = static_cast<unsigned int>(buf[r] >> 48);
      const unsigned int prev = r > 0 ? static_cast<unsigned int>(buf[r - 1] >> 48) : ~0u;
      if (prev == bin) continue;
      int len = 1;   // the run of equal top 16 bits from here
      while (r + len < count && static_cast<unsigned int>(buf[r + len] >> 48) == bin) ++len;
      atomicAdd(hist + bin, len);
      if (prev >> 8 == bin >> 8) continue;
      len = 1;       // and of equal top 8 bits
      while (r + len < count && static_cast<unsigned int>(buf[r + len] >> 56) == bin >> 8) ++len;
      atomicAdd(hist + kHistBins + (bin >> 8), len);
    }
  }

  // the last CTA to arrive runs the rounds
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(arrivals, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) *arrivals = 0u;   // as found, for the next call
  greedy_rounds(smem, n, K, max_pairs, cand, hist, keep, absorb, ok);
}

int prepare() {
  static bool ready = false;
  if (ready) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      merge_pairs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ready = true;
  return 0;
}

}  // namespace

// keep, absorb (max_pairs,) int32 and ok (max_pairs,) bool of the greedy
// merge pairs of n poses (n, 7) with stamps (n,) and eligibility (n,):
// dist_thresh and its squared-distance bound s_hi (kops.merge_dist_bound),
// angle_thresh in degrees.  Scratch: cand (n·(2·max_pairs - 1),) uint64 a
// call; hist (65,536 + 256 int32) and arrivals (one uint32), 0 before the
// call and left 0 after it.  1 <= n <= 65535, 1 <= max_pairs <= 32.
extern "C" int uz_merge_pairs(const float* pose, const float* stamp, const bool* eligible, int n,
                              float dist_thresh, float s_hi, float angle_thresh, int max_pairs,
                              unsigned long long* cand, int* hist, unsigned int* arrivals,
                              int* keep, int* absorb, bool* ok, void* stream) {
  if (n <= 0 || n > kMaxNodes || max_pairs <= 0 || 2 * max_pairs - 1 > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = prepare();
  if (err != 0) return err;
  merge_pairs_kernel<<<(n + kWarps - 1) / kWarps, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(
      pose, stamp, eligible, n, dist_thresh, s_hi, angle_thresh, max_pairs, cand, hist, arrivals,
      keep, absorb, ok);
  return static_cast<int>(cudaGetLastError());
}
