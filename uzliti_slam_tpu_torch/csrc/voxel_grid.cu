// K25 voxel_grid: the gicp estimator's voxel cloud.
//
// Replaces uzliti_slam_tpu/ops/gicp.py:voxel_downsample (:56-86), which the
// keyframe step runs on every pixel of the frame's raw depth (VGA: 307,200
// points a camera) with V = gicp_max_voxels = 256.  The reference hashes
// each point's voxel index floor(p / voxel) (compiled by XLA into
// floor(p * fl(1/voxel))) into a uint32 id ((q + 32768) times three primes
// with wrap-around, XORed; 0xFFFFFFFF for an invalid point), keeps the V
// smallest DISTINCT ids ascending (jnp.unique(size=V), 0xFFFFFFFF padding),
// finds each point's slot by a left binary search clipped to V - 1, and
// averages the hits' points and Lab colors per slot (segment sums).
//
// Design, in four launches on the caller's stream:
//   1. voxel_sort_chunks: one CTA per 4096 points computes their ids (kept
//      in device memory for pass 3), sorts them in shared memory (bitonic),
//      and writes the chunk's V smallest distinct ids (a block scan of the
//      "differs from its left neighbour" flags gives each distinct id its
//      rank);
//   2. voxel_merge, a tree of launches: each CTA merges two sorted distinct
//      lists into the V smallest distinct of their union (every element's
//      rank in the other list by binary search, the right list's duplicates
//      of the left's dropped and its kept elements counted by a block scan),
//      until one list is left: the kept ids;
//   3. voxel_accumulate: each point binary-searches its slot among the kept
//      ids in shared memory; a hit adds 1 and round(v * 2^28) of each of its
//      six values into shared-memory int64 sums, flushed by integer atomics.
//      Integer sums are exact, so their order does not matter and the
//      result is the same from run to run (float atomics would not be);
//   4. voxel_finish: the means in float64, rounded to float32.  A point with
//      a non-finite coordinate marks its slot's coordinate NaN (the
//      reference's p * 0 sum).
// The plain version (kernels/ops.py:voxel_grid_plain) does the same
// fixed-point arithmetic, so the two agree exactly.
//
// What bounds it on the card: the bytes of the points (24 B each in, 4 B of
// id out and in again), 8.6 MB at VGA, 2.6 us at 3.35 TB/s; the sorts
// (75 CTAs x 4096 x 78 compare-exchange stages) are a few tens of
// microseconds on 75 of the 132 SMs.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 4096;          // points a CTA sorts
constexpr int kSortThreads = 1024;
constexpr int kPerThread = kChunk / kSortThreads;
constexpr int kAccThreads = 256;
constexpr int kMergeThreads = 256;
constexpr unsigned kEmpty = 0xFFFFFFFFu;
constexpr double kFixed = 268435456.0;   // 2^28: VOXEL_FIXED in kernels/ops.py

__device__ __forceinline__ unsigned voxel_id(const float* p, float inv) {
  const unsigned primes[3] = {73856093u, 19349663u, 83492791u};
  unsigned h = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const int q = static_cast<int>(floorf(__fmul_rn(p[a], inv)));
    h ^= static_cast<unsigned>(q + 32768) * primes[a];
  }
  return h;
}

// first index in a[0, n) whose value is not below x
__device__ __forceinline__ int lower_bound(const unsigned* a, int n, unsigned x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kSortThreads)
voxel_sort_chunks(const float* __restrict__ pts, const unsigned char* __restrict__ valid, int N,
                  float inv, int V, unsigned* __restrict__ ids, unsigned* __restrict__ lists,
                  long long* __restrict__ sums, int* __restrict__ counts) {
  __shared__ unsigned s[kChunk];
  __shared__ int warp_off[kSortThreads / 32];
  const int base = blockIdx.x * kChunk;
  unsigned* out = lists + static_cast<size_t>(blockIdx.x) * V;
  if (blockIdx.x == 0) {   // the accumulators of pass 3, zeroed once
    for (int i = threadIdx.x; i < 6 * V; i += blockDim.x) sums[i] = 0;
    for (int i = threadIdx.x; i < 2 * V; i += blockDim.x) counts[i] = 0;
  }
  for (int i = threadIdx.x; i < V; i += blockDim.x) out[i] = kEmpty;
  for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
    const int g = base + i;
    unsigned id = kEmpty;
    if (g < N) {
      if (valid[g]) id = voxel_id(pts + 3 * static_cast<size_t>(g), inv);
      ids[g] = id;
    }
    s[i] = id;
  }
  __syncthreads();
  for (int k = 2; k <= kChunk; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < kChunk; i += blockDim.x) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned a = s[i], b = s[l];
          if ((a > b) == ((i & k) == 0)) {
            s[i] = b;
            s[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  // rank of each distinct id: an exclusive block scan of the flags
  const int i0 = threadIdx.x * kPerThread;
  int flags[kPerThread], local = 0;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    const int i = i0 + e;
    flags[e] = (i == 0 || s[i] != s[i - 1]) ? 1 : 0;
    local += flags[e];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = local;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int v = warp_off[lane];
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    warp_off[lane] = inc - v;
  }
  __syncthreads();
  int rank = warp_off[warp] + incl - local;
#pragma unroll
  for (int e = 0; e < kPerThread; ++e) {
    if (flags[e]) {
      if (rank < V) out[rank] = s[i0 + e];
      ++rank;
    }
  }
}

// lists in: n_lists sorted distinct lists of V (kEmpty padded); CTA c merges
// lists 2c (A) and 2c + 1 (B) into out[c], the V smallest distinct of their
// union.  An element of B already in A is dropped; P[j] counts B's kept
// elements before j (an exclusive block scan), so a of A lands at
// i + P[lower_bound(B, a)] and a kept b of B at P[j] + lower_bound(A, b).
__global__ void __launch_bounds__(kMergeThreads)
voxel_merge(const unsigned* __restrict__ in, int n_lists, int V, unsigned* __restrict__ out) {
  extern __shared__ unsigned sm[];
  unsigned* sa = sm;                                  // V
  unsigned* sb = sa + V;                              // V
  int* lb = reinterpret_cast<int*>(sb + V);           // V: lower_bound(A, b_j)
  int* P = lb + V;                                    // V + 1
  __shared__ int warp_off[kMergeThreads / 32];
  const int c = blockIdx.x;
  const unsigned* A = in + static_cast<size_t>(2 * c) * V;
  unsigned* o = out + static_cast<size_t>(c) * V;
  if (2 * c + 1 >= n_lists) {
    for (int i = threadIdx.x; i < V; i += blockDim.x) o[i] = A[i];
    return;
  }
  const unsigned* B = A + V;
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    sa[i] = A[i];
    sb[i] = B[i];
    o[i] = kEmpty;
  }
  __syncthreads();
  const int per = (V + kMergeThreads - 1) / kMergeThreads;
  const int j0 = threadIdx.x * per;
  int local = 0;
  for (int e = 0; e < per; ++e) {
    const int j = j0 + e;
    if (j >= V) break;
    const int l = lower_bound(sa, V, sb[j]);
    lb[j] = l;
    local += (l < V && sa[l] == sb[j]) ? 0 : 1;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = local;
#pragma unroll
  for (int o2 = 1; o2 < 32; o2 <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o2);
    if (lane >= o2) incl += v;
  }
  if (lane == 31) warp_off[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kMergeThreads / 32; ++w) {
      const int t = warp_off[w];
      warp_off[w] = run;
      run += t;
    }
  }
  __syncthreads();
  int run = warp_off[warp] + incl - local;
  for (int e = 0; e < per; ++e) {
    const int j = j0 + e;
    if (j >= V) break;
    P[j] = run;
    const int l = lb[j];
    run += (l < V && sa[l] == sb[j]) ? 0 : 1;
  }
  if (j0 < V && V <= j0 + per) P[V] = run;
  __syncthreads();
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    const unsigned a = sa[i];
    const int pos = i + P[lower_bound(sb, V, a)];
    if (pos < V) o[pos] = a;
    const int l = lb[i];
    if (l < V && sa[l] == sb[i]) continue;   // A holds it
    if (P[i] + l < V) o[P[i] + l] = sb[i];
  }
}

__global__ void __launch_bounds__(kAccThreads)
voxel_accumulate(const float* __restrict__ pts, const float* __restrict__ lab,
                 const unsigned char* __restrict__ valid, const unsigned* __restrict__ ids,
                 int N, const unsigned* __restrict__ uids, int V, long long* __restrict__ sums,
                 int* __restrict__ counts) {
  extern __shared__ long long sacc[];
  long long* ssum = sacc;                           // V x 6
  int* scnt = reinterpret_cast<int*>(ssum + 6 * V);  // V
  int* spoison = scnt + V;                           // V
  unsigned* su = reinterpret_cast<unsigned*>(spoison + V);
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    su[i] = uids[i];
    scnt[i] = 0;
    spoison[i] = 0;
  }
  for (int i = threadIdx.x; i < 6 * V; i += blockDim.x) ssum[i] = 0;
  __syncthreads();
  const int begin = blockIdx.x * kChunk;
  const int end = min(N, begin + kChunk);
  for (int g = begin + threadIdx.x; g < end; g += blockDim.x) {
    const unsigned id = ids[g];
    const int slot = min(lower_bound(su, V, id), V - 1);
    const bool hit = valid[g] && su[slot] == id;
    const size_t o = 3 * static_cast<size_t>(g);
    const float v[6] = {pts[o], pts[o + 1], pts[o + 2], lab[o], lab[o + 1], lab[o + 2]};
    int bad = 0;
#pragma unroll
    for (int c = 0; c < 6; ++c)
      if (!isfinite(v[c])) bad |= 1 << c;
    if (bad) atomicOr(&spoison[slot], bad);
    if (!hit) continue;
    atomicAdd(&scnt[slot], 1);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      if (bad & (1 << c)) continue;
      const long long q = __double2ll_rn(static_cast<double>(v[c]) * kFixed);
      atomicAdd(reinterpret_cast<unsigned long long*>(&ssum[6 * slot + c]),
                static_cast<unsigned long long>(q));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < V; i += blockDim.x) {
    if (scnt[i]) atomicAdd(&counts[i], scnt[i]);
    if (spoison[i]) atomicOr(&counts[V + i], spoison[i]);
  }
  for (int i = threadIdx.x; i < 6 * V; i += blockDim.x) {
    if (ssum[i]) {
      atomicAdd(reinterpret_cast<unsigned long long*>(&sums[i]),
                static_cast<unsigned long long>(ssum[i]));
    }
  }
}

__global__ void voxel_finish(const unsigned* __restrict__ uids, const long long* __restrict__ sums,
                             const int* __restrict__ counts, int V, float* __restrict__ out_pts,
                             float* __restrict__ out_lab, unsigned char* __restrict__ out_valid) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= V) return;
  const int cnt = counts[s], poison = counts[V + s];
  const double den = static_cast<double>(cnt > 1 ? cnt : 1);
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const double mean = (static_cast<double>(sums[6 * s + c]) / kFixed) / den;
    const float f = (poison & (1 << c)) ? __int_as_float(0x7fc00000) : static_cast<float>(mean);
    if (c < 3) out_pts[3 * s + c] = f; else out_lab[3 * s + c - 3] = f;
  }
  out_valid[s] = cnt > 0 && uids[s] != kEmpty;
}

}  // namespace

// pts, lab: (N, 3) float32; valid: (N,) bool; inv_voxel = fl32(1 / voxel);
// V kept voxels.  Scratch from the wrapper: ids (max(N, 1)) uint32, lists
// (2, n_chunks, V) uint32, sums (V, 6) int64, counts (2, V) int32.  Out:
// out_pts (V, 3), out_lab (V, 3) float32, out_valid (V,) bool.
extern "C" int uz_voxel_grid(const float* pts, const float* lab, const unsigned char* valid,
                             int N, float inv_voxel, int V, unsigned* ids, unsigned* lists,
                             long long* sums, int* counts, float* out_pts, float* out_lab,
                             unsigned char* out_valid, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = N > 0 ? (N + kChunk - 1) / kChunk : 1;
  voxel_sort_chunks<<<n_chunks, kSortThreads, 0, s>>>(pts, valid, N, inv_voxel, V, ids, lists,
                                                      sums, counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned* cur = lists;
  unsigned* nxt = lists + static_cast<size_t>(n_chunks) * V;
  const size_t merge_smem = (4 * static_cast<size_t>(V) + 1) * sizeof(unsigned);
  for (int n = n_chunks; n > 1; n = (n + 1) / 2) {
    voxel_merge<<<(n + 1) / 2, kMergeThreads, merge_smem, s>>>(cur, n, V, nxt);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    unsigned* t = cur;
    cur = nxt;
    nxt = t;
  }
  const size_t acc_smem = static_cast<size_t>(V) * (6 * sizeof(long long) + 3 * sizeof(int));
  if (acc_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(voxel_accumulate, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(acc_smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  voxel_accumulate<<<n_chunks, kAccThreads, acc_smem, s>>>(pts, lab, valid, ids, N, cur, V, sums,
                                                           counts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  voxel_finish<<<(V + 255) / 256, 256, 0, s>>>(cur, sums, counts, V, out_pts, out_lab, out_valid);
  return static_cast<int>(cudaGetLastError());
}
