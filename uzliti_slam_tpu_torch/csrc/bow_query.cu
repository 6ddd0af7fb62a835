// K24 bow_query: the bag-of-words place recognizer's query.
//
// Replaces uzliti_slam_tpu/recognition/vocabulary.py:bow_query (:161-185)
// with bow_score (:117-120): the DBoW2 L1 score 1 - ½‖v_n - q‖₁ of every
// bank row against the query's tf-idf vector, the gates (the row valid and
// nonzero, Σ|v_n| > 1e-9; the query nonzero; |stamp - query stamp| >=
// min_dt), -1 where a gate fails, and top_k.
//
// row_scores — a warp per bank row (grid-stride); a row that fails the
// validity or time gate is not read.  Lane l sums |v - q| and
// |v| over the words l, l + 32, ... in that order, then a fixed butterfly
// of shuffles adds the 32 partial sums, so a score does not depend on the
// launch.  The query sits in shared memory; each warp also sums |q| (the
// same order for every warp).  The sums are float32 in another order than
// XLA's, so a score agrees with the reference within ~1e-6, not bit for
// bit.  topk_scores: one CTA, uz_topk::block_topk, ok = score >= min_score.
//
// What bounds it on the card: the K floats of each row that passes the
// validity and time gates read once (51 MB at 50k valid nodes and 256
// words): bytes.
#include <cuda_runtime.h>

#include "topk.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void row_scores(const float* __restrict__ bank, const float* __restrict__ stamp,
                           const unsigned char* __restrict__ valid, const float* __restrict__ q,
                           const float* __restrict__ q_stamp, int N, int K, float min_dt,
                           float* __restrict__ scores) {
  extern __shared__ float sq[];                                  // K floats
  for (int j = threadIdx.x; j < K; j += blockDim.x) sq[j] = q[j];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warps = (gridDim.x * blockDim.x) >> 5;
  const float qs = *q_stamp;
  for (int n = (blockIdx.x * blockDim.x + threadIdx.x) >> 5; n < N; n += warps) {
    // the validity and time gates first (the same for the whole warp): a
    // row that fails them scores -1 without being read
    if (!valid[n] || !(fabsf(__fsub_rn(stamp[n], qs)) >= min_dt)) {
      if (lane == 0) scores[n] = -1.0f;
      continue;
    }
    const float* v = bank + static_cast<size_t>(n) * K;
    float diff = 0.0f, mass = 0.0f, qmass = 0.0f;
    for (int j = lane; j < K; j += 32) {
      const float x = v[j];
      diff = __fadd_rn(diff, fabsf(__fsub_rn(x, sq[j])));
      mass = __fadd_rn(mass, fabsf(x));
      qmass = __fadd_rn(qmass, fabsf(sq[j]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      diff = __fadd_rn(diff, __shfl_xor_sync(0xffffffffu, diff, off));
      mass = __fadd_rn(mass, __shfl_xor_sync(0xffffffffu, mass, off));
      qmass = __fadd_rn(qmass, __shfl_xor_sync(0xffffffffu, qmass, off));
    }
    if (lane == 0) {
      const bool eligible = mass > 1e-9f && qmass > 1e-9f;
      scores[n] = eligible ? __fsub_rn(1.0f, __fmul_rn(0.5f, diff)) : -1.0f;
    }
  }
}

struct ScoreAt {
  const float* scores;
  __device__ float operator()(int j) const { return scores[j]; }
};

__global__ void topk_scores(const float* __restrict__ scores, int N, int k, float min_score,
                            int* __restrict__ slots, float* __restrict__ top,
                            unsigned char* __restrict__ ok) {
  uz_topk::block_topk<float>(ScoreAt{scores}, N, k, slots, top);
  if (threadIdx.x == 0) {
    for (int r = 0; r < k; ++r) ok[r] = top[r] >= min_score;
  }
}

}  // namespace

// bank: (N, K) float32, stamp (N,) float32, valid (N,) bool; q (K,)
// float32; q_stamp () float32 on the device.  Scratch: scores (N,) float32.
// Out: slots (k,) int32, top (k,) float32, ok (k,) bool.  1 <= k <= N;
// K floats fit a CTA's shared memory (the wrapper checks).
extern "C" int uz_bow_query(const float* bank, const float* stamp, const unsigned char* valid,
                            const float* q, const float* q_stamp, int N, int K, int k,
                            float min_score, float min_dt, float* scores, int* slots, float* top,
                            unsigned char* ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || k <= 0) return 0;
  const size_t smem = static_cast<size_t>(K) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        row_scores, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int rows_per_cta = kThreads / 32;
  int grid = (N + rows_per_cta - 1) / rows_per_cta;
  grid = grid < 4096 ? grid : 4096;
  row_scores<<<grid, kThreads, smem, s>>>(bank, stamp, valid, q, q_stamp, N, K, min_dt, scores);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  topk_scores<<<1, kThreads, 0, s>>>(scores, N, k, min_score, slots, top, ok);
  return static_cast<int>(cudaGetLastError());
}
