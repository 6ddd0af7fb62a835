// K21 feature_votes: the feature-set place recognizer's query.
//
// Replaces uzliti_slam_tpu/recognition/recognizer.py:feature_set_query
// (:145-177).  The reference unpacks the query's F descriptors and the whole
// bank's N x F to float bits and runs one matrix product, (F, N·F)
// distances in device memory (at 50k nodes x 128, a (128, 6.4M) float
// matrix, 3.3 GB a query), then takes the minimum over each node's
// descriptors, the votes, the gates and a top_k.  Here nothing of that size
// exists: XOR and __popc on the eight 32-bit words, as K16.
//
// node_sims — a CTA per node (grid-stride).  The query's descriptors and
// flags sit in shared memory for the whole launch; a node that is not
// eligible (invalid, or |stamp - query stamp| < min_dt in float32) writes
// -1 and reads nothing else.  An eligible node's F stored descriptors and
// flags come into shared memory; a thread per query descriptor keeps the
// minimum distance over the valid stored ones (an invalid one counts as
// +inf, so a node with none gets no hit), hit = min <= thresh and the query
// valid; the CTA sums the hits as an integer and
// sim = votes / max(#valid queries, 1), one IEEE float32 division.
//
// topk_sims — one CTA: uz_topk::block_topk over the N sims, ok = sim >=
// min_sim.
//
// What bounds it on the card: per eligible node F x F pairs of 8 XORs, 8
// popcounts and 8 adds, 24 x 128 x 128 = 393k operations for 4 KB of
// descriptors, so operations; __popc issues at 16 a clock per SM on sm_90,
// below the 67 T scalar line that the bound is stated against.
#include <cuda_runtime.h>

#include "hamming.cuh"
#include "topk.cuh"

namespace {

using uz_hamming::kWords;
constexpr int kThreads = 128;
constexpr int kTopkThreads = 256;
constexpr int kNoHit = 1 << 30;

__global__ void node_sims(const unsigned char* __restrict__ query,
                          const unsigned char* __restrict__ qvalid, int Fq,
                          const unsigned char* __restrict__ bank,
                          const unsigned char* __restrict__ bank_valid, int Fb,
                          const float* __restrict__ stamp, const unsigned char* __restrict__ valid,
                          const float* __restrict__ q_stamp, int N, float thresh, float min_dt,
                          float* __restrict__ sims) {
  extern __shared__ unsigned sm[];
  unsigned* sq = sm;                                             // Fq x 8 words
  unsigned* sb = sm + Fq * kWords;                               // Fb x 8 words
  unsigned char* sqv = reinterpret_cast<unsigned char*>(sb + Fb * kWords);
  unsigned char* sbv = sqv + Fq;
  __shared__ int red[kThreads / 32];
  __shared__ int nq_s;
  int nq = 0;
  for (int i = threadIdx.x; i < Fq; i += blockDim.x) {
    uz_hamming::load(query + static_cast<size_t>(i) * 32, sq + i * kWords);
    sqv[i] = qvalid[i];
    nq += qvalid[i] != 0;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) nq += __shfl_down_sync(0xffffffffu, nq, off);
  if (lane == 0) red[warp] = nq;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w];
    nq_s = s > 1 ? s : 1;
  }
  const float qs = *q_stamp;
  for (int n = blockIdx.x; n < N; n += gridDim.x) {
    // the same for every thread of the CTA, so the barriers below stay uniform
    if (!valid[n] || !(fabsf(__fsub_rn(stamp[n], qs)) >= min_dt)) {
      if (threadIdx.x == 0) sims[n] = -1.0f;
      continue;
    }
    __syncthreads();                                             // the last node's reads are done
    const unsigned char* nb = bank + static_cast<size_t>(n) * Fb * 32;
    for (int j = threadIdx.x; j < Fb; j += blockDim.x) {
      uz_hamming::load(nb + static_cast<size_t>(j) * 32, sb + j * kWords);
      sbv[j] = bank_valid[static_cast<size_t>(n) * Fb + j];
    }
    __syncthreads();
    int hits = 0;
    for (int i = threadIdx.x; i < Fq; i += blockDim.x) {
      if (!sqv[i]) continue;
      unsigned q[kWords];
#pragma unroll
      for (int w = 0; w < kWords; ++w) q[w] = sq[i * kWords + w];
      int best = kNoHit;
      for (int j = 0; j < Fb; ++j) {
        if (!sbv[j]) continue;
        const int d = uz_hamming::distance(q, sb + j * kWords);
        best = d < best ? d : best;
      }
      hits += best != kNoHit && static_cast<float>(best) <= thresh;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) hits += __shfl_down_sync(0xffffffffu, hits, off);
    if (lane == 0) red[warp] = hits;
    __syncthreads();
    if (threadIdx.x == 0) {
      int votes = 0;
      for (int w = 0; w < kThreads / 32; ++w) votes += red[w];
      sims[n] = __fdiv_rn(static_cast<float>(votes), static_cast<float>(nq_s));
    }
  }
}

struct SimAt {
  const float* sims;
  __device__ float operator()(int j) const { return sims[j]; }
};

__global__ void topk_sims(const float* __restrict__ sims, int N, int k, float min_sim,
                          int* __restrict__ slots, float* __restrict__ top,
                          unsigned char* __restrict__ ok) {
  uz_topk::block_topk<float>(SimAt{sims}, N, k, slots, top);
  if (threadIdx.x == 0) {
    for (int r = 0; r < k; ++r) ok[r] = top[r] >= min_sim;
  }
}

}  // namespace

// query: (Fq, 32) uint8, qvalid (Fq,) bool; bank: (N, Fb, 32) uint8,
// bank_valid (N, Fb) bool; stamp (N,) float32, valid (N,) bool; q_stamp ()
// float32 on the device.  Scratch: sims (N,) float32.  Out: slots (k,)
// int32, top (k,) float32, ok (k,) bool.  1 <= k <= N, (Fq + Fb) x 33 bytes
// fit a CTA's shared memory (the wrapper checks).
extern "C" int uz_feature_votes(const unsigned char* query, const unsigned char* qvalid,
                                const unsigned char* bank, const unsigned char* bank_valid,
                                const float* stamp, const unsigned char* valid,
                                const float* q_stamp, int Fq, int Fb, int N, int k, float thresh,
                                float min_sim, float min_dt, float* sims, int* slots, float* top,
                                unsigned char* ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || k <= 0) return 0;
  const size_t smem = static_cast<size_t>(Fq + Fb) * (kWords * 4 + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        node_sims, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int grid = N < 65536 ? N : 65536;
  node_sims<<<grid, kThreads, smem, s>>>(query, qvalid, Fq, bank, bank_valid, Fb, stamp, valid,
                                         q_stamp, N, thresh, min_dt, sims);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_sims<<<1, kTopkThreads, 0, s>>>(sims, N, k, min_sim, slots, top, ok);
  return static_cast<int>(cudaGetLastError());
}
