// K21 feature_votes: the feature-set place recognizer's query, one launch.
//
// Replaces uzliti_slam_tpu/recognition/recognizer.py:feature_set_query
// (:145-177).  The reference unpacks the query's F descriptors and the whole
// bank's N x F to float bits and runs one matrix product, (F, N·F)
// distances in device memory (at 50k nodes x 128, a (128, 6.4M) float
// matrix, 3.3 GB a query), then takes the minimum over each node's
// descriptors, the votes, the gates and a top_k.  Here nothing of that size
// exists.
//
// feature_votes_kernel — as many CTAs as the card holds at once (at most
// N), each claiming nodes from a device counter a batch at a time (about a
// quarter of its share, at most kBatch), so that a CTA that runs slower
// takes fewer.  A claimed node that is not eligible (invalid, or |stamp -
// query stamp| < min_dt in float32) is written -1 and nothing else of it is
// read.  Eligible nodes' stored descriptors come into shared memory by
// cp.async, 16 bytes a copy, in stages of kCols columns: as many whole
// nodes as fit twice or more (two at 14b's 128 a node), else one node a
// stage, or a slice of one (the step's 256), double-buffered: the CTA's next stage is in flight while it
// computes this one, its flags read into registers as it is issued.  Each
// stored descriptor's popcount is taken once as the stage lands (kBig
// where invalid).  Each warp takes strips of 16 query rows (its
// A fragment kept in registers where one strip a warp covers the query)
// against the stage's columns, 8 at a time on the tensor cores
// (hamming_mma.cuh: one b1 mma a 16 x 8 tile); a row hits where some valid
// stored descriptor lies within thresh, and the strip stops once every
// valid row has hit.  A node's hits are a 16-bit mask a strip (kept in
// shared memory across a sliced node's stages), counted into an integer;
// sim = votes / max(#valid queries, 1), one IEEE float32 division.  The
// last CTA to finish (an integer ticket after __threadfence; it resets the
// ticket and the counter) runs uz_topk::block_topk over the sims in one
// pass with the stage buffers as its slots (value descending, then index
// ascending) and sets ok = sim >= min_sim.  thresh = +inf (every valid query
// hits: an invalid stored descriptor is +inf away, and inf <= inf) and
// thresh < 0 or NaN (none does) read no descriptor.
//
// What bounds it on the card: per eligible node Fq x Fb pairs of 512 bit
// operations (AND and popcount over 256 bits), against 33 bytes a stored
// descriptor; at 50k nodes x 128 x 128 that is 3.8·10¹¹ operations, ~0.04
// ms at the b1 mma's measured rate (1,141 a µs an SM on an H100 SXM,
// scripts/hamming_mma_rates.cu: ~9.9·10¹⁵ operations a second; 0.19 ms at
// the int8 tensor line, the card publishing no binary rate), against 211
// MB, 0.063 ms: bytes.  What holds it in practice is
// each warp's instruction stream around the mma (fragment loads, the
// distance and threshold arithmetic, the hit masks), ~2 µs a 128 x 128
// node a CTA at 5 CTAs an SM, and the stages' barriers.  The scalar form it
// replaces issued __popc at 16 a clock an SM (1.6 ms at that size).
#include <cuda_runtime.h>

#include "hamming_mma.cuh"
#include "topk.cuh"

namespace {

using uz_mma::kBig;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = kThreads;        // stored descriptors a stage (a node, or a slice of one)
constexpr int kBatch = 32;             // nodes a CTA claims at a time
constexpr int kScratchSims = 16;       // byte offset of the sims (after the ticket and the counter)
constexpr int kMinCtas = 5;            // CTAs an SM in the launch bounds (4-6 within 3 %)
constexpr int kStageNodes = kCols / 8;  // whole nodes a stage at most (Fb <= 8)

#ifdef UZ_RECOG_STAMPS
// ns a phase in CTA 0: start, the next stage's node and issue, wait,
// popcounts, strips, the stage's last barrier, the node's sim, the ticket;
// then the last CTA's top-k, CTA 0's stages, and the spread of the CTAs:
// the complement of the first start (atomicMax), the last start, the last
// CTA's ticket
__device__ unsigned long long k21_ns[13];
#endif

__device__ __forceinline__ bool eligible(const unsigned char* valid, const float* stamp, int n,
                                         float qs, float min_dt) {
  return valid[n] && fabsf(__fsub_rn(stamp[n], qs)) >= min_dt;
}

// The next `batch` (<= kBatch) nodes, claimed from the device's counter by
// warp 0: the eligible ones listed in `list`, each ineligible one written
// -1.  Returns how many were listed, or -1 once every node has been
// claimed.  Every thread calls it; the first barrier keeps warp 0 from
// overwriting `list` while another warp has yet to read the last batch's
// entries.
__device__ int claim_batch(unsigned* counter, int batch, int N, const unsigned char* valid,
                           const float* stamp, float qs, float min_dt, float* sims, int* list) {
  __shared__ int listed_s;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    unsigned base = 0;
    if (lane == 0) base = atomicAdd(counter, static_cast<unsigned>(batch));
    base = __shfl_sync(uz_mma::kFull, base, 0);
    const long long n = static_cast<long long>(base) + lane;
    bool e = false;
    if (lane < batch && n < N) {
      e = eligible(valid, stamp, static_cast<int>(n), qs, min_dt);
      if (!e) sims[n] = -1.0f;
    }
    const unsigned b = __ballot_sync(uz_mma::kFull, e);
    if (e) list[__popc(b & ((1u << lane) - 1u))] = static_cast<int>(n);
    if (lane == 0) listed_s = base >= static_cast<unsigned>(N) ? -1 : __popc(b);
  }
  __syncthreads();
  const int listed = listed_s;
  __syncthreads();
  return listed;
}

struct SimAt {
  const float* sims;
  __device__ float operator()(int j) const { return __ldcg(sims + j); }
};

__global__ void __launch_bounds__(kThreads, kMinCtas) feature_votes_kernel(
    const unsigned char* __restrict__ query, const unsigned char* __restrict__ qvalid, int Fq,
    const unsigned char* __restrict__ bank, const unsigned char* __restrict__ bank_valid, int Fb,
    const float* __restrict__ stamp, const unsigned char* __restrict__ valid,
    const float* __restrict__ q_stamp, int N, int k, float thresh, float min_sim, float min_dt,
    int batch, float* sims, unsigned* ticket, unsigned* counter, int* __restrict__ slots,
    float* __restrict__ top, unsigned char* __restrict__ ok) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* sb = smem;                                                 // 2 x kCols x 8 words
  int* pb = reinterpret_cast<int*>(smem + 2 * kCols * 8);              // 2 x kCols popcounts
  unsigned short* hit16 = reinterpret_cast<unsigned short*>(pb + 2 * kCols);   // a strip's hits
  __shared__ int list[kBatch];                                         // eligible nodes
  __shared__ int counts[kWarps];
  __shared__ int votes_s[kStageNodes];                                 // a stage's nodes' votes
  __shared__ bool last_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
#ifdef UZ_RECOG_STAMPS
  unsigned long long t0 = uz_mma::stamp_now();
  if (tid == 0) {
    atomicMax(k21_ns + 10, ~t0);
    atomicMax(k21_ns + 11, t0);
  }
#endif
  const int RT = (Fq + 15) / 16;
  const int nchunks = Fb > kCols ? (Fb + kCols - 1) / kCols : 1;
  const float qs = *q_stamp;
  const int it = uz_mma::int_thresh(thresh);
  int c = 0;
  for (int i = tid; i < Fq; i += kThreads) c += qvalid[i] != 0;
  for (int i = tid; i < RT; i += kThreads) hit16[i] = 0;
  if (tid < kStageNodes) votes_s[tid] = 0;
  c = __reduce_add_sync(uz_mma::kFull, c);
  if (lane == 0) counts[warp] = c;
  __syncthreads();
  int nvq = 0;
  for (int w = 0; w < kWarps; ++w) nvq += counts[w];
  __syncthreads();
  const float nq = static_cast<float>(nvq > 1 ? nvq : 1);
  const bool all_hit = thresh == __int_as_float(0x7f800000);
  if (all_hit || it < 0) {
    const float sim = __fdiv_rn(all_hit ? static_cast<float>(nvq) : 0.0f, nq);
    for (int n = blockIdx.x * kThreads + tid; n < N; n += gridDim.x * kThreads)
      sims[n] = eligible(valid, stamp, n, qs, min_dt) ? sim : -1.0f;
  } else {
    // a warp whose one strip fits keeps it in registers for every node
    const bool held = RT <= kWarps;
    uz_mma::Rows Ah{};
    if (held && warp < RT) Ah = uz_mma::load_rows(query, warp * 16, Fq, qvalid);
    // nodes claimed a batch at a time, so that a CTA that runs slower takes
    // fewer; the eligible ones listed
    int listed = 0, pos = 0;
    auto next_node = [&]() {
      while (pos == listed && listed >= 0) {
        listed = claim_batch(counter, batch, N, valid, stamp, qs, min_dt, sims, list);
        pos = 0;
      }
      return pos < listed ? list[pos++] : N;
    };
    // A stage: G whole nodes, each in a slot of Fb8 columns, where they fit
    // twice or more in kCols; else one node, kCols columns at a time.  Its
    // descriptors come by cp.async; each thread reads its column's flag
    // into a register (for the stage's popcounts) and, thread g, slot g's
    // node (for its sim).
    const int Fb8 = Fb > 8 ? (Fb + 7) & ~7 : 8;
    const int G = Fb8 <= kCols / 2 ? kCols / Fb8 : 1;
    const int slot_cols = G > 1 ? Fb8 : kCols;
    struct Stage {
      int cnt, ch, first;      // nodes; the chunk (G = 1); slot 0's node
      int node;                // slot threadIdx.x's node, where it has one
      unsigned char flag;      // column threadIdx.x's flag
    };
    // stage `st` into buffer b: chunk ch > 0 of node `cont`, or the next
    // G nodes
    auto issue = [&](Stage& st, int ch, int cont, int b) {
      st.cnt = 0;
      st.ch = ch;
      st.flag = 0;
      for (int g = 0; g < G; ++g) {
        const int node = ch > 0 ? cont : next_node();
        if (node >= N) break;
        const int col0 = ch * kCols, ncols = min(slot_cols, Fb - col0);
        uz_mma::stage_cols(sb + (b * kCols + g * slot_cols) * 8,
                           bank + (static_cast<size_t>(node) * Fb + col0) * 32, ncols);
        const int c = tid - g * slot_cols;
        if (c >= 0 && c < ncols) st.flag = bank_valid[static_cast<size_t>(node) * Fb + col0 + c];
        if (tid == g) st.node = node;
        if (g == 0) st.first = node;
        ++st.cnt;
      }
    };
    Stage cur{0, 0, N, N, 0}, nxt{0, 0, N, N, 0};
    int buf = 0;
    issue(cur, 0, N, buf);
    uz_mma::cp_async_commit();
    UZ_STAMP(k21_ns, 0, t0);
    while (cur.cnt > 0) {
      // the next stage: the next chunk of this node, or the next nodes
      const bool more = G == 1 && cur.ch + 1 < nchunks;
      issue(nxt, more ? cur.ch + 1 : 0, cur.first, buf ^ 1);
      uz_mma::cp_async_commit();
      UZ_STAMP(k21_ns, 1, t0);
      uz_mma::cp_async_wait<1>();
      __syncthreads();                                                 // this stage has landed
      UZ_STAMP(k21_ns, 2, t0);
      const int ncols = G > 1 ? Fb : min(kCols, Fb - cur.ch * kCols);
      const int ncols8 = (ncols + 7) & ~7;
      const unsigned* tile = sb + buf * kCols * 8;
      int* pt = pb + buf * kCols;
      if (tid < cur.cnt * slot_cols)
        pt[tid] = cur.flag ? uz_mma::popc_col(tile, tid) : kBig;
      __syncthreads();
      UZ_STAMP(k21_ns, 3, t0);
      const bool last_chunk = G > 1 || cur.ch == nchunks - 1;
      for (int rt = warp; rt < RT; rt += kWarps) {
        const uz_mma::Rows A = held ? Ah : uz_mma::load_rows(query, rt * 16, Fq, qvalid);
        const unsigned live = uz_mma::row_mask(A.p0 < kBig, A.p1 < kBig);
        for (int g = 0; g < cur.cnt; ++g) {
          const unsigned prior = G > 1 ? 0u : hit16[rt];
          const unsigned got =
              uz_mma::hit_rows(A, uz_mma::SharedCols(tile + g * slot_cols * 8),
                               pt + g * slot_cols, ncols8, it, prior, live);
          __syncwarp();                                                // every lane has read it
          if (lane == 0) {
            if (G == 1) hit16[rt] = last_chunk ? 0 : static_cast<unsigned short>(got);
            if (last_chunk) atomicAdd(&votes_s[g], __popc(got));
          }
        }
      }
      UZ_STAMP(k21_ns, 4, t0);
      __syncthreads();                                                 // the stage's buffer is free
      UZ_STAMP(k21_ns, 5, t0);
      if (last_chunk && tid < cur.cnt) {
        sims[cur.node] = __fdiv_rn(static_cast<float>(votes_s[tid]), nq);
        votes_s[tid] = 0;
      }
      UZ_STAMP(k21_ns, 6, t0);
#ifdef UZ_RECOG_STAMPS
      if (blockIdx.x == 0 && tid == 0) k21_ns[9] += 1;
#endif
      cur = nxt;
      buf ^= 1;
    }
    uz_mma::cp_async_wait<0>();
  }
  // the last CTA to finish takes the top-k
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  UZ_STAMP(k21_ns, 7, t0);
  if (!last_s) return;
  __threadfence();
  if (tid == 0) {
    *ticket = 0u;
    *counter = 0u;
  }
#ifdef UZ_RECOG_STAMPS
  const unsigned long long tk = uz_mma::stamp_now();
  if (tid == 0) k21_ns[12] = tk;
#endif
  // the stage buffers, free now, lend the top-k its one-pass slots
  uz_topk::block_topk<float>(SimAt{sims}, N, k, slots, top, smem,
                             static_cast<size_t>(2 * kCols * 9) * 4);
  if (tid == 0) {
    for (int r = 0; r < k; ++r) ok[r] = top[r] >= min_sim;
#ifdef UZ_RECOG_STAMPS
    k21_ns[8] += uz_mma::stamp_now() - tk;
#endif
  }
}

size_t smem_bytes(int Fq) {
  return (static_cast<size_t>(2 * kCols * 9) * 4 + 2 * ((Fq + 15) / 16) + 15) / 16 * 16;
}

}  // namespace

// query: (Fq, 32) uint8, qvalid (Fq,) bool; bank: (N, Fb, 32) uint8,
// bank_valid (N, Fb) bool; stamp (N,) float32, valid (N,) bool; q_stamp ()
// float32 on the device; query and bank 16-byte aligned.  Scratch:
// kScratchSims + 4·N bytes, its first two words 0 on entry and on exit
// (the ticket, the node counter), the sims from byte kScratchSims.  Out: slots (k,) int32, top (k,) float32,
// ok (k,) bool.  1 <= k <= N; calls on a device must not overlap (they share
// the scratch).
extern "C" int uz_feature_votes(const unsigned char* query, const unsigned char* qvalid,
                                const unsigned char* bank, const unsigned char* bank_valid,
                                const float* stamp, const unsigned char* valid,
                                const float* q_stamp, int Fq, int Fb, int N, int k, float thresh,
                                float min_sim, float min_dt, void* scratch, int* slots, float* top,
                                unsigned char* ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || k <= 0) return 0;
  const size_t smem = smem_bytes(Fq);
  static size_t occ_smem = 0;
  static int occ_n = 0;
  const int occ = uz_mma::occupancy(feature_votes_kernel, kThreads, smem, &occ_smem, &occ_n);
  if (occ < 0) return -occ;
  const long long cap = static_cast<long long>(uz_mma::sm_count()) * occ;
  const int grid = static_cast<int>(N < cap ? N : cap);
  // claims of about a quarter of a CTA's share, at most kBatch nodes
  const long long share = N / (4LL * grid);
  const int batch = static_cast<int>(share < 1 ? 1 : (share > kBatch ? kBatch : share));
  unsigned char* base = static_cast<unsigned char*>(scratch);
  feature_votes_kernel<<<grid, kThreads, smem, s>>>(
      query, qvalid, Fq, bank, bank_valid, Fb, stamp, valid, q_stamp, N, k, thresh, min_sim,
      min_dt, batch, reinterpret_cast<float*>(base + kScratchSims), reinterpret_cast<unsigned*>(base),
      reinterpret_cast<unsigned*>(base) + 1, slots, top, ok);
  return static_cast<int>(cudaGetLastError());
}

#ifdef UZ_RECOG_STAMPS
// Timing builds only: K21's stamps (k21_ns) into host memory, then zeroed
// (not an entry of the package's library).
extern "C" int stamps_feature_votes(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, k21_ns, sizeof(k21_ns));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[13] = {};
  return static_cast<int>(cudaMemcpyToSymbol(k21_ns, zero, sizeof(zero)));
}
#endif
