// K22 repository: the global feature repository's search and query, two
// entry points, one launch each.
//
// Replaces the distance work of uzliti_slam_tpu/recognition/recognizer.py:
// repository_add (:223-241: the nearest unique descriptor of each query
// descriptor and the in-frame duplicates) and repository_query (:298-316:
// the stored descriptors any query hits, the votes per node over their
// links, the gates, top_k).  The reference unpacks the query and the whole
// descriptor bank to float bits and materialises the (F, D) distance
// matrix (128 x 16,384 at 512 nodes) for each; here no distance matrix:
// the distances come a warp's 16 x 8 tile at a time off the tensor cores
// (hamming_mma.cuh: one b1 mma with AND + popcount a tile, exact integers).
//
// repo_nearest_kernel — a CTA per tile of W stored descriptors (W = 64 at
// the step's D = 16,384: 256 CTAs; up to kCols at larger D), the grid at
// most what the card holds at once, each CTA walking its tiles with the
// next one's cp.async in flight, each descriptor's popcount taken once as
// its tile lands (kBig where invalid).  Warps take strips of 16 queries
// against the tile's columns; each query keeps the smallest 64-bit key
// (distance << 32 | index) over its valid descriptors in shared memory
// across the CTA's tiles, and one atomicMax of the key's complement a
// (CTA, query) merges them in the device scratch, which is zero between
// calls: the smallest distance, and among equal distances the first index,
// whatever order the CTAs run in (argmin's rule).  The last CTA to finish
// (an integer ticket) decodes the keys (+inf and index 0 where no stored
// descriptor is valid, as argmin of an all-inf row), puts them back to zero,
// and runs the F x F duplicate test on the same mma: query i has a valid
// j < i within thresh.
//
// repo_votes_kernel — the queries' popcounts in shared memory (kBig where
// invalid); each warp takes strips of 16 stored descriptors (kBig where
// invalid; the next strip's rows loaded while this one is compared)
// against the queries, 8 at a time, and stops once every valid one has
// hit.  A hit adds one vote to the node of each of its valid links by
// integer atomicAdd into the device scratch (zero between calls), exact in
// any order.  The gates (node valid, |stamp - query stamp| >= min_dt, else
// -1) go in first: an ineligible node's count starts far below 0.  The last
// CTA reads the counts once (uz_topk::block_topk's one pass, a negative
// count -1), sets ok = votes >= min_votes (float32) and zeroes the votes.  thresh =
// +inf hits every stored descriptor (an invalid one is +inf away, and
// inf <= inf) where any query is valid; thresh < 0 or NaN none.
//
// What bounds it on the card: F x D pairs of 512 bit operations against
// 32 bytes a stored descriptor (+ 5·L bytes of links in repo_votes), the
// operations at the b1 mma's measured rate (~9.9·10¹⁵ a second on an H100
// SXM, scripts/hamming_mma_rates.cu; the card publishes no binary rate):
// at the step's 256 x 16,384, 2.1·10⁹ operations, 0.0002 ms; at D = 320k,
// 0.0043 ms.  What holds it in practice is the instruction stream around
// each mma and, in repo_votes, the last CTA's one pass over the N counts.
// The scalar form it replaces issued __popc at 16 a clock an SM.
#include <cuda_runtime.h>

#include "hamming_mma.cuh"
#include "topk.cuh"

namespace {

using uz_mma::kBig;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 256;                   // the widest tile of repo_nearest
constexpr int kMinCols = 64;                 // the narrowest
constexpr int kScratchData = 16;             // byte offset of the keys / votes (after the ticket)
constexpr unsigned long long kNoKey = ~0ull;

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(uz_mma::kFull, v, off);
  return v;
}

__device__ __forceinline__ int popc_row(const unsigned char* rows, int j) {
  const unsigned* p = reinterpret_cast<const unsigned*>(rows) + static_cast<size_t>(j) * 8;
  int c = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) c += __popc(__ldg(p + w));
  return c;
}

// Every thread fences its writes, then thread 0 takes a ticket: true in the
// last CTA to arrive, which fences again before it reads.
__device__ __forceinline__ bool last_to_finish(unsigned* ticket) {
  __shared__ bool last_s;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (last_s) __threadfence();
  return last_s;
}

__global__ void __launch_bounds__(kThreads) repo_nearest_kernel(
    const unsigned char* __restrict__ query, const unsigned char* __restrict__ qvalid, int F,
    const unsigned char* __restrict__ bank, const unsigned char* __restrict__ bank_valid, int D,
    int W, float thresh, unsigned long long* inv, unsigned* ticket, float* __restrict__ nn_dist,
    int* __restrict__ nn_idx, unsigned char* __restrict__ dup) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* sb = smem;                                                   // 2 x kCols x 8 words
  int* pb = reinterpret_cast<int*>(smem + 2 * kCols * 8);                // 2 x kCols popcounts
  unsigned long long* best = reinterpret_cast<unsigned long long*>(pb + 2 * kCols);   // RT·16
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int RT = (F + 15) / 16;
  unsigned short* dup16 = reinterpret_cast<unsigned short*>(best + RT * 16);
  for (int i = tid; i < RT * 16; i += kThreads) best[i] = kNoKey;
  for (int i = tid; i < RT; i += kThreads) dup16[i] = 0;
  const int ntiles = (D + W - 1) / W;
  int tile = blockIdx.x, buf = 0;
  auto issue = [&](int tl, int b) {
    const int col0 = tl * W;
    uz_mma::stage_cols(sb + b * kCols * 8, bank + static_cast<size_t>(col0) * 32, min(W, D - col0));
  };
  if (tile < ntiles) issue(tile, 0);
  uz_mma::cp_async_commit();
  while (tile < ntiles) {
    const int t2 = tile + gridDim.x;
    if (t2 < ntiles) issue(t2, buf ^ 1);
    uz_mma::cp_async_commit();
    uz_mma::cp_async_wait<1>();
    __syncthreads();                                                     // this tile has landed
    const int col0 = tile * W, ncols = min(W, D - col0), ncols8 = (ncols + 7) & ~7;
    const unsigned* stile = sb + buf * kCols * 8;
    int* pt = pb + buf * kCols;
    for (int j = tid; j < ncols8; j += kThreads)
      pt[j] = j < ncols && bank_valid[col0 + j] ? uz_mma::popc_col(stile, j) : kBig;
    __syncthreads();
    const uz_mma::SharedCols cols{stile};
    for (int rt = warp; rt < RT; rt += kWarps) {
      const uz_mma::Rows A = uz_mma::load_rows(query, rt * 16, F, nullptr);
      unsigned long long ka = best[rt * 16 + g], kb = best[rt * 16 + g + 8];
      for (int c0 = 0; c0 < ncols8; c0 += 32) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int ct = c0 + 8 * u;
          if (ct >= ncols8) continue;
          int d[4];
          uz_mma::distances(A, cols, pt, ct, d);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const unsigned j = static_cast<unsigned>(col0 + ct + 2 * t + e);
            const unsigned long long k0 = static_cast<unsigned long long>(d[e]) << 32 | j;
            const unsigned long long k1 = static_cast<unsigned long long>(d[2 + e]) << 32 | j;
            if (d[e] <= 256 && k0 < ka) ka = k0;
            if (d[2 + e] <= 256 && k1 < kb) kb = k1;
          }
        }
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const unsigned long long oa = __shfl_xor_sync(uz_mma::kFull, ka, off);
        const unsigned long long ob = __shfl_xor_sync(uz_mma::kFull, kb, off);
        ka = oa < ka ? oa : ka;
        kb = ob < kb ? ob : kb;
      }
      if (t == 0) {
        best[rt * 16 + g] = ka;
        best[rt * 16 + g + 8] = kb;
      }
    }
    __syncthreads();                                                     // the tile's buffer is free
    tile = t2;
    buf ^= 1;
  }
  uz_mma::cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < F; i += kThreads)
    if (best[i] != kNoKey) atomicMax(inv + i, ~best[i]);
  if (!last_to_finish(ticket)) return;
  for (int i = tid; i < F; i += kThreads) {
    const unsigned long long v = __ldcg(inv + i);
    inv[i] = 0ull;
    nn_dist[i] = v == 0ull ? __int_as_float(0x7f800000) : static_cast<float>(static_cast<unsigned>(~v >> 32));
    nn_idx[i] = v == 0ull ? 0 : static_cast<int>(~v & 0xffffffffull);
  }
  // the duplicates: query i against the valid queries j < i, columns in
  // chunks whose popcounts fill the tile buffers
  const int it = uz_mma::int_thresh(thresh);
  constexpr int kDupCols = 2 * kCols * 8;
  int* pq = reinterpret_cast<int*>(sb);
  for (int cs = 0; cs < F && it >= 0; cs += kDupCols) {
    const int nc = min(kDupCols, F - cs), nc8 = (nc + 7) & ~7;
    for (int j = tid; j < nc8; j += kThreads)
      pq[j] = j < nc && qvalid[cs + j] ? popc_row(query, cs + j) : kBig;
    __syncthreads();
    const uz_mma::GlobalCols cols{reinterpret_cast<const unsigned*>(query) + static_cast<size_t>(cs) * 8,
                                  F - cs};
    for (int rt = warp; rt < RT; rt += kWarps) {
      const int lim = min(nc8, rt * 16 + 16 - cs);                       // columns j < i possible
      if (lim <= 0) continue;
      const uz_mma::Rows A = uz_mma::load_rows(query, rt * 16, F, nullptr);
      const unsigned live = uz_mma::row_mask(A.p0 < kBig, A.p1 < kBig);
      const unsigned prior = dup16[rt];
      if (prior == live) continue;
      const int ia = rt * 16 + g, ib = ia + 8;
      bool ha = (prior >> g) & 1u, hb = (prior >> (g + 8)) & 1u;
      for (int ct = 0; ct < lim; ct += 8) {
        int d[4];
        uz_mma::distances(A, cols, pq, ct, d);
        const int j0 = cs + ct + 2 * t, j1 = j0 + 1;
        ha |= (d[0] <= it && j0 < ia) | (d[1] <= it && j1 < ia);
        hb |= (d[2] <= it && j0 < ib) | (d[3] <= it && j1 < ib);
        if ((ct & 31) == 24 && uz_mma::row_mask(ha, hb) == live) break;
      }
      const unsigned got = uz_mma::row_mask(ha, hb);
      __syncwarp();                                                      // every lane has read it
      if (lane == 0) dup16[rt] = static_cast<unsigned short>(got);
    }
    __syncthreads();
  }
  for (int i = tid; i < F; i += kThreads) dup[i] = (dup16[i >> 4] >> (i & 15)) & 1u;
  if (tid == 0) *ticket = 0u;
}

#ifdef UZ_RECOG_STAMPS
// ns a phase in CTA 0's warp 0: the queries' popcounts, a strip's rows, its
// column loop, its votes, the ticket; the last CTA's top-k and its zeroing;
// warp 0's strips
__device__ unsigned long long votes_ns[8];
#endif

// repo_votes' dynamic shared memory: the queries' popcounts, and at least
// the one-pass top-k's slots
__host__ __device__ __forceinline__ size_t votes_smem(int F) {
  const size_t pq = static_cast<size_t>((F + 7) & ~7) * 4;
  const size_t slots = static_cast<size_t>(uz_topk::kList) * kThreads * 8;
  return pq > slots ? pq : slots;
}

// An ineligible node's votes start at kGated instead of 0 (an atomicAdd
// before any vote can be read), so that its count stays negative and the
// top-k reads one array: votes + links of any real repository stay far
// below 2^30.
constexpr int kGated = -(1 << 30);

struct GatedVotes {
  const int* votes;
  __device__ int operator()(int j) const {
    const int v = __ldcg(votes + j);
    return v < 0 ? -1 : v;
  }
};

__global__ void __launch_bounds__(kThreads) repo_votes_kernel(
    const unsigned char* __restrict__ query, const unsigned char* __restrict__ qvalid, int F,
    const unsigned char* __restrict__ bank, const unsigned char* __restrict__ bank_valid, int D,
    const int* __restrict__ links, const unsigned char* __restrict__ link_valid, int L,
    const float* __restrict__ node_stamp, const unsigned char* __restrict__ node_valid,
    const float* __restrict__ q_stamp, int N, int k, float thresh, float min_votes, float min_dt,
    int* votes, unsigned* ticket, int* __restrict__ slots, int* __restrict__ top,
    unsigned char* __restrict__ ok) {
  extern __shared__ __align__(16) int pq[];                              // F8 query popcounts
  __shared__ int red[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#ifdef UZ_RECOG_STAMPS
  unsigned long long t0 = uz_mma::stamp_now();
#endif
  // the gates (node valid, |stamp - query stamp| >= min_dt), a thread a node
  const float qs = *q_stamp;
  for (int j = blockIdx.x * kThreads + tid; j < N; j += gridDim.x * kThreads)
    if (!(node_valid[j] && fabsf(__fsub_rn(node_stamp[j], qs)) >= min_dt))
      atomicAdd(votes + j, kGated);
  const int F8 = (F + 7) & ~7;
  int c = 0;
  for (int j = tid; j < F8; j += kThreads) {
    const bool v = j < F && qvalid[j];
    pq[j] = v ? popc_row(query, j) : kBig;
    c += v;
  }
  c = warp_sum(c);
  if (lane == 0) red[warp] = c;
  __syncthreads();
  bool any_valid = false;
  for (int w = 0; w < kWarps; ++w) any_valid |= red[w] > 0;
  const int it = uz_mma::int_thresh(thresh);
  const bool all_hit = thresh == __int_as_float(0x7f800000);
  UZ_STAMP(votes_ns, 0, t0);
  if (any_valid && (all_hit || it >= 0)) {
    const uz_mma::GlobalCols cols{reinterpret_cast<const unsigned*>(query), F};
    const int RTD = (D + 15) / 16, stride = gridDim.x * kWarps;
    int rt = blockIdx.x * kWarps + warp;
    // each strip's rows loaded while the one before is compared
    uz_mma::Rows next{};
    if (!all_hit && rt < RTD) next = uz_mma::load_rows(bank, rt * 16, D, bank_valid);
    for (; rt < RTD; rt += stride) {
      unsigned got;
      if (all_hit) {
        const int rows = D - rt * 16;
        got = rows >= 16 ? 0xffffu : (1u << rows) - 1u;
      } else {
        const uz_mma::Rows A = next;
        if (rt + stride < RTD) next = uz_mma::load_rows(bank, (rt + stride) * 16, D, bank_valid);
        const unsigned live = uz_mma::row_mask(A.p0 < kBig, A.p1 < kBig);
        UZ_STAMP(votes_ns, 1, t0);
        got = uz_mma::hit_rows(A, cols, pq, F8, it, 0u, live);
      }
      UZ_STAMP(votes_ns, 2, t0);
      for (int p = lane; got != 0 && p < 16 * L; p += 32) {
        const int r = p / L, l = p - r * L;
        if (!((got >> r) & 1u)) continue;
        const size_t o = static_cast<size_t>(rt * 16 + r) * L + l;
        const int node = links[o];
        if (link_valid[o] && static_cast<unsigned>(node) < static_cast<unsigned>(N))
          atomicAdd(votes + node, 1);
      }
      UZ_STAMP(votes_ns, 3, t0);
#ifdef UZ_RECOG_STAMPS
      if (blockIdx.x == 0 && tid == 0) votes_ns[7] += 1;
#endif
    }
  }
  UZ_STAMP(votes_ns, 0, t0);
  const bool last = last_to_finish(ticket);
  UZ_STAMP(votes_ns, 4, t0);
  if (!last) return;
#ifdef UZ_RECOG_STAMPS
  const unsigned long long tk = uz_mma::stamp_now();
#endif
  // the queries' popcounts, done with, lend the top-k its one-pass slots
  uz_topk::block_topk<int>(GatedVotes{votes}, N, k, slots, top, pq, votes_smem(F));
  if (tid == 0) {
    for (int r = 0; r < k; ++r) ok[r] = static_cast<float>(top[r]) >= min_votes;
    *ticket = 0u;
#ifdef UZ_RECOG_STAMPS
    votes_ns[5] += uz_mma::stamp_now() - tk;
#endif
  }
  for (int j = tid; j < N; j += kThreads) votes[j] = 0;
#ifdef UZ_RECOG_STAMPS
  __syncthreads();
  if (tid == 0) votes_ns[6] += uz_mma::stamp_now() - tk;
#endif
}

}  // namespace

// query: (F, 32) uint8, qvalid (F,) bool; bank: (D, 32) uint8, bank_valid
// (D,) bool; query and bank 16-byte aligned.  Scratch: 16 + 8·F bytes, zero
// on entry and on exit (a ticket, then the keys' complements from byte 16).
// Out: nn_dist (F,) float32, nn_idx (F,) int32, dup (F,) bool.  D < 2^31;
// calls on a device must not overlap (they share the scratch).
extern "C" int uz_repo_nearest(const unsigned char* query, const unsigned char* qvalid,
                               const unsigned char* bank, const unsigned char* bank_valid, int F,
                               int D, float thresh, void* scratch, float* nn_dist, int* nn_idx,
                               unsigned char* dup, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F <= 0) return 0;
  const int RT = (F + 15) / 16;
  const size_t smem =
      (static_cast<size_t>(2 * kCols * 9) * 4 + static_cast<size_t>(RT) * (16 * 8 + 2) + 15) / 16 * 16;
  static size_t occ_smem = 0;
  static int occ_n = 0;
  const int occ = uz_mma::occupancy(repo_nearest_kernel, kThreads, smem, &occ_smem, &occ_n);
  if (occ < 0) return -occ;
  // tiles of W columns: at least two a SM where D allows, kMinCols to kCols wide
  const int sms = uz_mma::sm_count();
  int W = static_cast<int>((static_cast<long long>(D) + 2LL * sms - 1) / (2LL * sms));
  W = (W + 7) & ~7;
  W = W < kMinCols ? kMinCols : (W > kCols ? kCols : W);
  const long long ntiles = (static_cast<long long>(D) + W - 1) / W;
  const long long cap = static_cast<long long>(sms) * occ;
  const int grid = static_cast<int>(ntiles < 1 ? 1 : (ntiles < cap ? ntiles : cap));
  unsigned char* base = static_cast<unsigned char*>(scratch);
  repo_nearest_kernel<<<grid, kThreads, smem, s>>>(
      query, qvalid, F, bank, bank_valid, D, W, thresh,
      reinterpret_cast<unsigned long long*>(base + kScratchData), reinterpret_cast<unsigned*>(base),
      nn_dist, nn_idx, dup);
  return static_cast<int>(cudaGetLastError());
}

// query, qvalid, bank, bank_valid as above; links (D, L) int32, link_valid
// (D, L) bool; node_stamp (N,) float32, node_valid (N,) bool; q_stamp ()
// float32 on the device.  Scratch: 16 + 4·N bytes, zero on entry and on
// exit (a ticket, then the votes from byte 16).  Out: slots (k,) int32, top
// (k,) int32, ok (k,) bool.  1 <= k <= N; calls on a device must not
// overlap.
extern "C" int uz_repo_votes(const unsigned char* query, const unsigned char* qvalid,
                             const unsigned char* bank, const unsigned char* bank_valid,
                             const int* links, const unsigned char* link_valid,
                             const float* node_stamp, const unsigned char* node_valid,
                             const float* q_stamp, int F, int D, int L, int N, int k, float thresh,
                             float min_votes, float min_dt, void* scratch, int* slots, int* top,
                             unsigned char* ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || k <= 0) return 0;
  const size_t smem = votes_smem(F);
  static size_t occ_smem = 0;
  static int occ_n = 0;
  const int occ = uz_mma::occupancy(repo_votes_kernel, kThreads, smem, &occ_smem, &occ_n);
  if (occ < 0) return -occ;
  const long long strips = (static_cast<long long>(D) + 15) / 16;
  const long long want = (strips + kWarps - 1) / kWarps;
  const long long cap = static_cast<long long>(uz_mma::sm_count()) * occ;
  const int grid = static_cast<int>(want < 1 ? 1 : (want < cap ? want : cap));
  unsigned char* base = static_cast<unsigned char*>(scratch);
  repo_votes_kernel<<<grid, kThreads, smem, s>>>(
      query, qvalid, F, bank, bank_valid, D, links, link_valid, L, node_stamp, node_valid, q_stamp,
      N, k, thresh, min_votes, min_dt, reinterpret_cast<int*>(base + kScratchData),
      reinterpret_cast<unsigned*>(base), slots, top, ok);
  return static_cast<int>(cudaGetLastError());
}

#ifdef UZ_RECOG_STAMPS
// Timing builds only: repo_votes' stamps (votes_ns) into host memory, then
// zeroed (not an entry of the package's library).
extern "C" int stamps_repo_votes(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, votes_ns, sizeof(votes_ns));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(votes_ns, zero, sizeof(zero)));
}
#endif
