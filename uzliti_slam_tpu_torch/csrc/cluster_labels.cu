// K6 cluster_labels: spatio-temporal clustering of loop-closure candidates,
// and the cluster roots that run RANSAC, in one launch.
//
// Replaces uzliti_slam_tpu/graph/filter.py:_cluster_labels (:66-83) and,
// through the second entry, filter_loop_closures' steps before RANSAC
// (:105-154): the candidates' endpoint stamps and validity, the per-cluster
// size and stamp spans (segment_sum / segment_min / segment_max), the
// size and span gates, the root compaction (nonzero(size=n_roots)) and the
// roots' member masks.  Entries:
//   uz_cluster_labels  stamps + validity -> labels
//   uz_cluster_roots   candidate edge slots -> validity, labels, stamps,
//                      root_live, root_safe, member (the PyTorch side keeps
//                      only the endpoint positions' lie math)
//
// The labels are n_iters Jacobi rounds of min-label propagation over the
// (B, B) adjacency "both endpoint stamp gaps < max_dt, both valid",
//   labels'[i] = min(labels[i], min_{j adjacent to i} labels[j]),
// from labels[i] = valid ? i : B.  A label is the least index within
// n_iters hops, not a connected component: union-find, or an in-place
// round, would merge clusters the reference leaves apart.  A round that
// changes nothing is a fixed point, so the rounds stop there (exact).
//
// Design, B <= 256 (the epoch's candidates, pipeline.MAX_CANDIDATES): one
// CTA of 1024 threads.  The adjacency is
// built once as a bit matrix in shared memory, lane-interleaved: row i's
// word for lane l holds bit w for column 32·w + l (B x 32 words, 32 KB at
// B = 256).  A warp takes up to kW = 8 rows, unrolled so that their loads
// and reductions overlap: to build a row each lane tests its ⌈B/32⌉ <= 8
// columns against stamps it keeps in registers, and in a round each lane visits only its set bits whose label
// changed in the round before (a bitmask in the same layout) and takes
// their labels; __reduce_min_sync merges the lanes, and each row's lane
// finishes it.  Round 1 needs no labels: a valid slot's label is its index,
// so it is each row's lowest set bit, taken as the matrix is built.  The
// labels are double-buffered and __syncthreads_or ends the rounds at the
// fixed point.  (Measured at B = 256, scripts/k5_k6_variants.py: row words
// of ⌈B/32⌉ bits packed by __ballot_sync, every lane reading every word
// every round, 46 µs a call; each lane's set bits, 32 µs; the changed
// labels only, round 1 from the build and the rows unrolled, 18 µs.)
// The roots' statistics are shared-memory atomics over the B + 1 segments:
// integer counts, and stamp minima and maxima through the order-preserving
// map of their bits (so any order gives the reference's floats, ±inf
// initial values and negative stamps included); the gates repeat the
// reference's float subtractions; the roots are compacted in ascending slot
// order by ballots and a prefix over the warps' counts.
//
// Above 256 candidates (the reference's apply_filter(max_candidates=) and
// filter_loop_closures take any B): one cooperative launch over the card,
// the same algorithm on global scratch.  The bit matrix is row-major, B x
// ⌈B/32⌉ words (2 MB at B = 4,096), each word one __ballot_sync of a warp's
// 32 column tests; a round gives a warp a row, its lanes the row's words,
// and visits only the set bits whose label changed the round before (round
// 1: every valid slot), merged by __reduce_min_sync; the rounds are
// separated by grid barriers, double-buffered, and a flag a round (three,
// rotated) stops them at the fixed point.  The roots' statistics are
// global atomics, the compaction a block-wide scan of the words' counts.
//
// What bounds it on the card: latency.  The work is B² adjacency tests once
// (~4·10⁵ operations at B = 256) and, a round, a minimum a set bit: a
// microsecond or two of one SM's issue, then a round's dependent shared
// loads and barrier; the launch replaces ~45 PyTorch launches of gathers,
// segment statistics and compaction around the old labels kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kW = 8;   // column words a lane keeps in registers, and rows a warp takes
constexpr int kMaxB = 32 * kW;

struct Args {
  // labels entry: the candidates' stamps and validity
  const float* stamp_from;
  const float* stamp_to;
  const unsigned char* valid_in;
  // roots entry: the candidates' edge slots and the graph's tables
  const int* cand_idx;
  const int* e_from;
  const int* e_to;
  const unsigned char* mask;       // (B,) per candidate, or the (E,) edge validity
  int mask_by_edge;
  const unsigned char* node_valid;
  const float* stamp;
  int b;
  float max_dt;
  int n_iters;
  int min_size;
  float min_span;
  int n_roots;
  // outputs (the roots entry writes all of them, the labels entry labels)
  int* labels;
  unsigned char* valid_out;
  float* sf_out;
  float* st_out;
  unsigned char* root_live;
  long long* root_safe;
  unsigned char* member;
  int* scratch;   // the grid route's arrays (B > 256)
};

__device__ __forceinline__ unsigned order_key(float f) {
  const unsigned u = __float_as_uint(f);
  return u ^ ((u >> 31) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float from_key(unsigned k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

template <bool kRoots>
__global__ void __launch_bounds__(kThreads) cluster_block(Args a) {
  extern __shared__ __align__(16) int sm[];
  const int b = a.b, words = (b + 31) / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  unsigned* adj = reinterpret_cast<unsigned*>(sm);
  int* cur = sm + 32 * b;
  int* nxt = cur + b;
  int* ok = nxt + b;
  float* sf = reinterpret_cast<float*>(ok + b);
  float* st = sf + b;

  for (int i = tid; i < b; i += kThreads) {
    int v;
    float f, t;
    if (kRoots) {
      const int c = a.cand_idx[i];
      const int ci = c >= 0 ? c : 0;
      const int ef = a.e_from[ci], et = a.e_to[ci];
      const bool m = a.mask[a.mask_by_edge ? ci : i] != 0;
      v = c >= 0 && m && a.node_valid[ef] != 0 && a.node_valid[et] != 0;
      f = a.stamp[ef];
      t = a.stamp[et];
      a.valid_out[i] = static_cast<unsigned char>(v);
      a.sf_out[i] = f;
      a.st_out[i] = t;
    } else {
      v = a.valid_in[i] != 0;
      f = a.stamp_from[i];
      t = a.stamp_to[i];
    }
    ok[i] = v;
    sf[i] = f;
    st[i] = t;
    cur[i] = v ? i : b;
  }
  __syncthreads();

  // The adjacency, once: bit w of word (i, l) is column 32·w + l; each lane
  // keeps its columns' stamps and validity in registers (kW words).  A warp
  // takes rows i = warp + r·kWarps (r < kW, as B <= 256), and lane r keeps
  // row r's minimum and finishes that row after the warp's rows.  Round 1
  // comes with the matrix: a valid slot's label is its own index, so a row's
  // label after one round is min(its own, the least adjacent slot), the
  // lowest set bit over its lanes.
  __shared__ unsigned moved[3][32];
  if (tid < 32) moved[0][tid] = moved[1][tid] = moved[2][tid] = 0u;
  float cf[kW], ct[kW];
  bool cok[kW];
#pragma unroll
  for (int w = 0; w < kW; ++w) {
    const int j = 32 * w + lane;
    cok[w] = w < words && j < b && ok[j];
    cf[w] = cok[w] ? sf[j] : 0.0f;
    ct[w] = cok[w] ? st[j] : 0.0f;
  }
  // a warp's rows (at most kW) are unrolled, so that their
  // loads and warp reductions overlap
  int low[kW];
#pragma unroll
  for (int r = 0; r < kW; ++r) {
    const int i = warp + r * kWarps;
    unsigned bits = 0u;
    if (i < b && ok[i]) {
      const float fi = sf[i], ti = st[i];
#pragma unroll
      for (int w = 0; w < kW; ++w)
        if (cok[w] && fabsf(fi - cf[w]) < a.max_dt && fabsf(ti - ct[w]) < a.max_dt)
          bits |= 1u << w;
    }
    if (i < b) adj[i * 32 + lane] = bits;
    low[r] = bits ? 32 * (__ffs(bits) - 1) + lane : INT_MAX;
  }
  int row_min = INT_MAX;
#pragma unroll
  for (int r = 0; r < kW; ++r) {
    const int m = __reduce_min_sync(0xffffffffu, low[r]);
    if (lane == r) row_min = m;
  }
  // a row's epilogue on its lane: the new label, and the slot's bit in
  // `next` (lane-interleaved as the matrix) when it changed
  auto finish = [&](unsigned* next) {
    const int i = warp + lane * kWarps;
    int changed = 0;
    if (i < b) {
      const int c = cur[i], v = min(c, row_min);
      nxt[i] = v;
      if (v != c) {
        changed = 1;
        atomicOr(next + (i & 31), 1u << (i >> 5));
      }
    }
    return changed;
  };
  __syncthreads();
  int any = 0;
  if (a.n_iters > 0) {
    any = __syncthreads_or(finish(moved[1]));
    int* t = cur;
    cur = nxt;
    nxt = t;
  }

  // The later rounds take only the labels that changed in the round before:
  // a neighbour whose label did not change offered it a round earlier, so
  // it lowers nothing now.  Round it reads moved[it % 3], sets
  // moved[(it + 1) % 3] and clears moved[(it + 2) % 3], last read in the
  // round before.
  for (int it = 1; it < a.n_iters && any; ++it) {
    const unsigned mine = moved[it % 3][lane];
    if (tid < 32) moved[(it + 2) % 3][tid] = 0u;
    int m[kW];
#pragma unroll
    for (int r = 0; r < kW; ++r) {
      const int i = warp + r * kWarps;
      m[r] = INT_MAX;
      for (unsigned hit = i < b ? adj[i * 32 + lane] & mine : 0u; hit != 0u; hit &= hit - 1u)
        m[r] = min(m[r], cur[32 * (__ffs(hit) - 1) + lane]);
    }
    row_min = INT_MAX;
#pragma unroll
    for (int r = 0; r < kW; ++r) {
      const int v = __reduce_min_sync(0xffffffffu, m[r]);
      if (lane == r) row_min = v;
    }
    any = __syncthreads_or(finish(moved[(it + 1) % 3]));
    int* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = tid; i < b; i += kThreads) a.labels[i] = cur[i];
  if (!kRoots) return;

  // per-cluster size and stamp spans over the b + 1 segments
  int* csize = reinterpret_cast<int*>(st + b);
  unsigned* fmin = reinterpret_cast<unsigned*>(csize + b + 1);
  unsigned* fmax = fmin + b + 1;
  unsigned* tmin = fmax + b + 1;
  unsigned* tmax = tmin + b + 1;
  int* wcount = reinterpret_cast<int*>(tmax + b + 1);   // words + 1
  unsigned* wball = reinterpret_cast<unsigned*>(wcount + words + 1);
  int* slot = reinterpret_cast<int*>(wball + words);     // n_roots
  for (int l = tid; l <= b; l += kThreads) {
    csize[l] = 0;
    fmin[l] = tmin[l] = order_key(INFINITY);
    fmax[l] = tmax[l] = order_key(-INFINITY);
  }
  for (int k = tid; k < a.n_roots; k += kThreads) slot[k] = -1;
  __syncthreads();
  for (int i = tid; i < b; i += kThreads) {
    if (!ok[i]) continue;
    const int l = cur[i];
    atomicAdd(csize + l, 1);
    atomicMin(fmin + l, order_key(sf[i]));
    atomicMax(fmax + l, order_key(sf[i]));
    atomicMin(tmin + l, order_key(st[i]));
    atomicMax(tmax + l, order_key(st[i]));
  }
  __syncthreads();

  // roots: label == own slot, valid, and the cluster passed the gates
  for (int base = warp * 32; base < b; base += kThreads) {
    const int i = base + lane;
    bool root = false;
    if (i < b && ok[i] && cur[i] == i) {
      root = csize[i] >= a.min_size &&
             (from_key(fmax[i]) - from_key(fmin[i])) >= a.min_span &&
             (from_key(tmax[i]) - from_key(tmin[i])) >= a.min_span;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, root);
    if (lane == 0) {
      wball[base / 32] = ball;
      wcount[base / 32] = __popc(ball);
    }
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int w = 0; w < words; ++w) {
      const int c = wcount[w];
      wcount[w] = run;
      run += c;
    }
  }
  __syncthreads();
  for (int i = tid; i < b; i += kThreads) {
    const unsigned ball = wball[i >> 5];
    if ((ball >> (i & 31)) & 1u) {
      const int pos = wcount[i >> 5] + __popc(ball & ((1u << (i & 31)) - 1u));
      if (pos < a.n_roots) slot[pos] = i;
    }
  }
  __syncthreads();
  for (int k = tid; k < a.n_roots; k += kThreads) {
    a.root_live[k] = static_cast<unsigned char>(slot[k] >= 0);
    a.root_safe[k] = slot[k] >= 0 ? slot[k] : 0;
  }
  // the member masks, a warp a root row
  for (int k = warp; k < a.n_roots; k += kWarps) {
    const int s = slot[k];
    unsigned char* row = a.member + static_cast<long long>(k) * b;
    for (int j = lane; j < b; j += 32)
      row[j] = static_cast<unsigned char>(s >= 0 && ok[j] && cur[j] == s);
  }
}

// ----------------------------------------------------- the grid route, B > 256

constexpr int kGridThreads = 256;
constexpr int kMaxDevices = 16;

// Scratch ints of the grid route: the bit matrix (B x words), two label
// buffers, the validity and both stamps, three changed-bit masks and three
// flags; the roots entry adds five (B + 1) segment arrays, the words'
// counts and ballots and the root slots.  kernels/ops.py:cluster_scratch
// repeats this.
long long grid_scratch_ints(int b, bool roots, int n_roots) {
  const long long words = (b + 31) / 32;
  long long n = static_cast<long long>(b) * words + 5LL * b + 3 * words + 3;
  if (roots) n += 5LL * (b + 1) + 2 * words + 1 + n_roots;
  return n;
}

template <bool kRoots>
__global__ void __launch_bounds__(kGridThreads) cluster_grid(Args a) {
  cg::grid_group grid = cg::this_grid();
  const int b = a.b, words = (b + 31) / 32;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  const int lane = threadIdx.x & 31, gwarp = tid >> 5, nwarps = nthreads >> 5;
  unsigned* adj = reinterpret_cast<unsigned*>(a.scratch);
  int* cur = a.scratch + static_cast<long long>(b) * words;
  int* nxt = cur + b;
  int* ok = nxt + b;
  float* sf = reinterpret_cast<float*>(ok + b);
  float* st = sf + b;
  unsigned* moved = reinterpret_cast<unsigned*>(st + b);   // 3 x words
  int* flags = reinterpret_cast<int*>(moved + 3 * words);
  int* csize = flags + 3;
  unsigned* fmin = reinterpret_cast<unsigned*>(csize + b + 1);
  unsigned* fmax = fmin + b + 1;
  unsigned* tmin = fmax + b + 1;
  unsigned* tmax = tmin + b + 1;
  int* wcount = reinterpret_cast<int*>(tmax + b + 1);   // words + 1
  unsigned* wball = reinterpret_cast<unsigned*>(wcount + words + 1);
  int* slot = reinterpret_cast<int*>(wball + words);     // n_roots

  // the candidates, a warp per 32 slots: round 1 visits every valid slot,
  // so its changed-bit mask is the validity's ballot
  for (int base = gwarp * 32; base < b; base += nwarps * 32) {
    const int i = base + lane;
    int v = 0;
    if (i < b) {
      float f, t;
      if (kRoots) {
        const int c = a.cand_idx[i];
        const int ci = c >= 0 ? c : 0;
        const int ef = a.e_from[ci], et = a.e_to[ci];
        const bool m = a.mask[a.mask_by_edge ? ci : i] != 0;
        v = c >= 0 && m && a.node_valid[ef] != 0 && a.node_valid[et] != 0;
        f = a.stamp[ef];
        t = a.stamp[et];
        a.valid_out[i] = static_cast<unsigned char>(v);
        a.sf_out[i] = f;
        a.st_out[i] = t;
      } else {
        v = a.valid_in[i] != 0;
        f = a.stamp_from[i];
        t = a.stamp_to[i];
      }
      ok[i] = v;
      sf[i] = f;
      st[i] = t;
      cur[i] = v ? i : b;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, v);
    if (lane == 0) {
      moved[base / 32] = ball;
      moved[words + base / 32] = moved[2 * words + base / 32] = 0u;
    }
  }
  if (kRoots) {
    for (int l = tid; l <= b; l += nthreads) {
      csize[l] = 0;
      fmin[l] = tmin[l] = order_key(INFINITY);
      fmax[l] = tmax[l] = order_key(-INFINITY);
    }
    for (int k = tid; k < a.n_roots; k += nthreads) slot[k] = -1;
  }
  if (tid == 0) flags[0] = flags[1] = flags[2] = 0;
  grid.sync();

  // the matrix, a warp a (row, word): bit l of word w is column 32·w + l
  const long long items = static_cast<long long>(b) * words;
  for (long long it = gwarp; it < items; it += nwarps) {
    const int i = static_cast<int>(it / words);
    const int j = 32 * static_cast<int>(it % words) + lane;
    const bool bit = ok[i] && j < b && ok[j] && fabsf(sf[i] - sf[j]) < a.max_dt &&
                     fabsf(st[i] - st[j]) < a.max_dt;
    const unsigned word = __ballot_sync(0xffffffffu, bit);
    if (lane == 0) adj[it] = word;
  }
  grid.sync();

  // Jacobi rounds, a warp a row.  Round it reads moved[it % 3], sets
  // moved[(it + 1) % 3] and flags[it % 3], and clears moved[(it + 2) % 3]
  // and flags[(it + 1) % 3], both last read in the round before.
  int* c = cur;
  int* nx = nxt;
  for (int it = 0; it < a.n_iters; ++it) {
    const unsigned* mine = moved + (it % 3) * words;
    unsigned* next = moved + ((it + 1) % 3) * words;
    unsigned* clear = moved + ((it + 2) % 3) * words;
    for (int w = tid; w < words; w += nthreads) clear[w] = 0u;
    if (tid == 0) flags[(it + 1) % 3] = 0;
    for (int i = gwarp; i < b; i += nwarps) {
      const unsigned* row = adj + static_cast<long long>(i) * words;
      int m = INT_MAX;
      for (int w = lane; w < words; w += 32)
        for (unsigned hit = row[w] & mine[w]; hit != 0u; hit &= hit - 1u)
          m = min(m, c[32 * w + __ffs(hit) - 1]);
      m = __reduce_min_sync(0xffffffffu, m);
      if (lane == 0) {
        const int old = c[i], v = min(old, m);
        nx[i] = v;
        if (v != old) {
          atomicOr(next + (i >> 5), 1u << (i & 31));
          flags[it % 3] = 1;
        }
      }
    }
    grid.sync();
    const int any = *reinterpret_cast<volatile int*>(flags + it % 3);
    int* t = c;
    c = nx;
    nx = t;
    if (!any) break;
  }
  for (int i = tid; i < b; i += nthreads) a.labels[i] = c[i];
  if (!kRoots) return;

  // per-cluster size and stamp spans over the b + 1 segments
  for (int i = tid; i < b; i += nthreads) {
    if (!ok[i]) continue;
    const int l = c[i];
    atomicAdd(csize + l, 1);
    atomicMin(fmin + l, order_key(sf[i]));
    atomicMax(fmax + l, order_key(sf[i]));
    atomicMin(tmin + l, order_key(st[i]));
    atomicMax(tmax + l, order_key(st[i]));
  }
  grid.sync();
  // roots: label == own slot, valid, and the cluster passed the gates
  for (int base = gwarp * 32; base < b; base += nwarps * 32) {
    const int i = base + lane;
    bool root = false;
    if (i < b && ok[i] && c[i] == i) {
      root = csize[i] >= a.min_size &&
             (from_key(fmax[i]) - from_key(fmin[i])) >= a.min_span &&
             (from_key(tmax[i]) - from_key(tmin[i])) >= a.min_span;
    }
    const unsigned ball = __ballot_sync(0xffffffffu, root);
    if (lane == 0) {
      wball[base / 32] = ball;
      wcount[base / 32] = __popc(ball);
    }
  }
  grid.sync();
  // the words' exclusive prefix, in block 0: a run of words a thread, then
  // a scan of the runs' sums in shared memory
  if (blockIdx.x == 0) {
    __shared__ int part[kGridThreads];
    const int per = (words + kGridThreads - 1) / kGridThreads;
    const int w0 = min(words, static_cast<int>(threadIdx.x) * per), w1 = min(words, w0 + per);
    int sum = 0;
    for (int w = w0; w < w1; ++w) sum += wcount[w];
    part[threadIdx.x] = sum;
    __syncthreads();
    for (int d = 1; d < kGridThreads; d <<= 1) {
      const int add = threadIdx.x >= d ? part[threadIdx.x - d] : 0;
      __syncthreads();
      part[threadIdx.x] += add;
      __syncthreads();
    }
    int run = part[threadIdx.x] - sum;
    for (int w = w0; w < w1; ++w) {
      const int cnt = wcount[w];
      wcount[w] = run;
      run += cnt;
    }
  }
  grid.sync();
  for (int i = tid; i < b; i += nthreads) {
    const unsigned ball = wball[i >> 5];
    if ((ball >> (i & 31)) & 1u) {
      const int pos = wcount[i >> 5] + __popc(ball & ((1u << (i & 31)) - 1u));
      if (pos < a.n_roots) slot[pos] = i;
    }
  }
  grid.sync();
  for (int k = tid; k < a.n_roots; k += nthreads) {
    a.root_live[k] = static_cast<unsigned char>(slot[k] >= 0);
    a.root_safe[k] = slot[k] >= 0 ? slot[k] : 0;
  }
  const long long cells = static_cast<long long>(a.n_roots) * b;
  for (long long e = tid; e < cells; e += nthreads) {
    const int s = slot[e / b], j = static_cast<int>(e % b);
    a.member[e] = static_cast<unsigned char>(s >= 0 && ok[j] && c[j] == s);
  }
}

template <bool kRoots>
int launch_grid(const Args& a, long long scratch_ints, cudaStream_t s) {
  if (a.scratch == nullptr || scratch_ints < grid_scratch_ints(a.b, kRoots, a.n_roots))
    return static_cast<int>(cudaErrorInvalidValue);
  static int cache[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (cache[dev] == 0) {
    int fit = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, cluster_grid<kRoots>, kGridThreads,
                                                      0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    cache[dev] = fit * sms;
  }
  if (cache[dev] <= 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // a warp a row in the rounds
  const int need = (a.b + kGridThreads / 32 - 1) / (kGridThreads / 32);
  const int grid = need < cache[dev] ? need : cache[dev];
  Args p = a;
  void* args[] = {&p};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(cluster_grid<kRoots>), dim3(grid), dim3(kGridThreads), args,
      0, s));
}

// Shared memory of one launch in 4-byte words: the bit matrix (32 lane
// words a row), two label buffers, the validity and both stamps; the roots
// entry adds five (b + 1) segment arrays, the warps' counts and ballots and
// the root slots.  kernels/ops.py:_cluster_smem repeats this.
size_t smem_bytes(int b, bool roots, int n_roots) {
  const size_t words = (b + 31) / 32;
  size_t n = 32ull * b + 5ull * b;
  if (roots) n += 5ull * (b + 1) + 2 * words + 1 + n_roots;
  return 4 * n;
}

template <bool kRoots>
int launch(const Args& a, long long scratch_ints, cudaStream_t s) {
  if (a.b > kMaxB) return launch_grid<kRoots>(a, scratch_ints, s);
  const size_t smem = smem_bytes(a.b, kRoots, a.n_roots);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        cluster_block<kRoots>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cluster_block<kRoots><<<1, kThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// stamp_from, stamp_to: (b,) float; valid: (b,) bool; labels: (b,) int32;
// scratch: NULL for b <= 256 (one CTA), else grid_scratch_ints(b) ints of
// device memory (the grid route).
extern "C" int uz_cluster_labels(const float* stamp_from, const float* stamp_to,
                                 const unsigned char* valid, int b, float max_dt, int n_iters,
                                 int* labels, int* scratch, long long scratch_ints,
                                 void* stream) {
  if (b <= 0) return 0;
  Args a{};
  a.stamp_from = stamp_from;
  a.stamp_to = stamp_to;
  a.valid_in = valid;
  a.b = b;
  a.max_dt = max_dt;
  a.n_iters = n_iters;
  a.labels = labels;
  a.scratch = scratch;
  return launch<false>(a, scratch_ints, static_cast<cudaStream_t>(stream));
}

// cand_idx: (b,) int32 edge slots, -1 padded; e_from, e_to: (E,) int32;
// mask: (b,) bool per candidate (mask_by_edge = 0) or the (E,) edge validity
// (1); node_valid: (N,) bool; stamp: (N,) float.  Out: valid (b,) bool,
// labels (b,) int32, sf, st (b,) float, root_live (n_roots,) bool,
// root_safe (n_roots,) int64, member (n_roots, b) bool; scratch as
// uz_cluster_labels' (with the roots' arrays).
extern "C" int uz_cluster_roots(const int* cand_idx, const int* e_from, const int* e_to,
                                const unsigned char* mask, int mask_by_edge,
                                const unsigned char* node_valid, const float* stamp, int b,
                                float max_dt, int n_iters, int min_size, float min_span,
                                int n_roots, unsigned char* valid, int* labels, float* sf,
                                float* st, unsigned char* root_live, long long* root_safe,
                                unsigned char* member, int* scratch, long long scratch_ints,
                                void* stream) {
  Args a{};
  a.cand_idx = cand_idx;
  a.e_from = e_from;
  a.e_to = e_to;
  a.mask = mask;
  a.mask_by_edge = mask_by_edge;
  a.node_valid = node_valid;
  a.stamp = stamp;
  a.b = b;
  a.max_dt = max_dt;
  a.n_iters = n_iters;
  a.min_size = min_size;
  a.min_span = min_span;
  a.n_roots = n_roots;
  a.labels = labels;
  a.valid_out = valid;
  a.sf_out = sf;
  a.st_out = st;
  a.root_live = root_live;
  a.root_safe = root_safe;
  a.member = member;
  a.scratch = scratch;
  return launch<true>(a, scratch_ints, static_cast<cudaStream_t>(stream));
}
