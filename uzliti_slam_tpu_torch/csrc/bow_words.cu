// K23 bow_words: the bag-of-words vocabulary's word assignment and
// k-majority update, two entry points.
//
// Replaces uzliti_slam_tpu/recognition/vocabulary.py:quantize (:100-114:
// the nearest word of each descriptor and the term histogram) and the
// rounds of build_vocabulary (:69-78, :90-94: the assignment, the per-word
// bit counts and member counts, the majority bits).  The reference unpacks
// descriptors and words to float bits, materialises the (M, K) distance
// matrix by an int8 matrix product and sums bits with segment_sum; here
// XOR and __popc on the packed words, integer atomics for the counts.
//
// uz_word_assign — assign_words: the K words in shared memory, a thread per
// descriptor scans them in order with a strict '<' (the first word among
// equal distances, argmin's rule) whatever the descriptor's validity; a
// valid descriptor adds one to its word's histogram by atomicAdd.
//
// uz_word_majority — count_bits: a thread per valid descriptor adds each
// of its set bits to its word's 256 counters (atomicAdd; integers, exact
// in any order).  majority_bytes: a thread per (word, byte) sets bit t
// where 2 x count > members, the reference's sums > 0.5 x counts.
//
// What bounds it on the card: the assignment's M x K x 24 operations (0.6 G
// for 100k descriptors and 256 words), at the popcount's issue rate; the
// update's atomics, about 128 per descriptor.
#include <cuda_runtime.h>

#include "hamming.cuh"

namespace {

using uz_hamming::kWords;
constexpr int kThreads = 256;

__global__ void assign_words(const unsigned char* __restrict__ desc,
                             const unsigned char* __restrict__ valid,
                             const unsigned char* __restrict__ centers, int M, int K,
                             int* __restrict__ word, int* __restrict__ dist,
                             int* __restrict__ hist) {
  extern __shared__ unsigned sc[];                               // K x 8 words
  for (int c = threadIdx.x; c < K; c += blockDim.x)
    uz_hamming::load(centers + static_cast<size_t>(c) * 32, sc + c * kWords);
  __syncthreads();
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  unsigned q[kWords];
  uz_hamming::load(desc + static_cast<size_t>(m) * 32, q);
  int best = 2147483647, w = 0;
  for (int c = 0; c < K; ++c) {
    const int d = uz_hamming::distance(q, sc + c * kWords);
    if (d < best) { best = d; w = c; }
  }
  word[m] = w;
  dist[m] = best;
  if (valid[m]) atomicAdd(hist + w, 1);
}

__global__ void count_bits(const unsigned char* __restrict__ desc,
                           const unsigned char* __restrict__ valid,
                           const int* __restrict__ word, int M, int* __restrict__ sums) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M || !valid[m]) return;
  int* row = sums + static_cast<size_t>(word[m]) * 256;
  const unsigned char* p = desc + static_cast<size_t>(m) * 32;
  for (int b = 0; b < 32; ++b) {
    const unsigned byte = p[b];
    for (int t = 0; t < 8; ++t)
      if ((byte >> t) & 1u) atomicAdd(row + 8 * b + t, 1);
  }
}

__global__ void majority_bytes(const int* __restrict__ sums, const int* __restrict__ counts,
                               int K, unsigned char* __restrict__ centers) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;          // word o / 32, byte o % 32
  if (o >= K * 32) return;
  const int w = o >> 5;
  const int* s = sums + static_cast<size_t>(o) * 8;
  unsigned byte = 0;
  for (int t = 0; t < 8; ++t) byte |= static_cast<unsigned>(2 * s[t] > counts[w]) << t;
  centers[o] = static_cast<unsigned char>(byte);
}

}  // namespace

// desc: (M, 32) uint8, valid (M,) bool; centers (K, 32) uint8.  Out: word
// (M,) int32, dist (M,) int32; hist (K,) int32, zero on entry.  K x 32
// bytes fit a CTA's shared memory (the wrapper checks).
extern "C" int uz_word_assign(const unsigned char* desc, const unsigned char* valid,
                              const unsigned char* centers, int M, int K, int* word, int* dist,
                              int* hist, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M <= 0 || K <= 0) return 0;
  const size_t smem = static_cast<size_t>(K) * kWords * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        assign_words, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  assign_words<<<(M + kThreads - 1) / kThreads, kThreads, smem, s>>>(desc, valid, centers, M, K,
                                                                     word, dist, hist);
  return static_cast<int>(cudaGetLastError());
}

// desc, valid as above; word (M,) int32 in [0, K); counts (K,) int32, the
// valid members of each word.  Scratch: sums (K, 256) int32, zero on entry.
// Out: centers (K, 32) uint8.
extern "C" int uz_word_majority(const unsigned char* desc, const unsigned char* valid,
                                const int* word, const int* counts, int M, int K, int* sums,
                                unsigned char* centers, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K <= 0) return 0;
  if (M > 0) {
    count_bits<<<(M + kThreads - 1) / kThreads, kThreads, 0, s>>>(desc, valid, word, M, sums);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  majority_bytes<<<(K * 32 + kThreads - 1) / kThreads, kThreads, 0, s>>>(sums, counts, K,
                                                                         centers);
  return static_cast<int>(cudaGetLastError());
}
