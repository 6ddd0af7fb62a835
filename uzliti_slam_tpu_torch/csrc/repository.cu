// K22 repository: the global feature repository's search and query, two
// entry points.
//
// Replaces the distance work of uzliti_slam_tpu/recognition/recognizer.py:
// repository_add (:223-241: the nearest unique descriptor of each query
// descriptor and the in-frame duplicates) and repository_query (:298-316:
// the stored descriptors any query hits, the votes per node over their
// links, the gates, top_k).  The reference unpacks the query and the whole
// descriptor bank to float bits and materialises the (F, D) distance
// matrix (128 x 16,384 at 512 nodes) for each; here XOR and __popc on the
// packed words, and no distance matrix.
//
// uz_repo_nearest — nearest_chunk: a CTA per chunk of kChunk stored
// descriptors, held in shared memory and read from device memory once;
// each query takes kThreads / F threads, each keeping the smallest 64-bit
// key (distance << 32 | index) over its share of the chunk's valid
// descriptors; the CTA merges them and one atomicMin per (CTA, query)
// merges the chunks: the smallest distance, and among equal distances the
// first index, whatever order the CTAs run in (argmin's rule).  nearest_finish: one CTA decodes the keys
// (+inf and index 0 where no stored descriptor is valid, as argmin of an
// all-inf row) and tests the F x F duplicates: query i has a valid j < i
// within thresh.
//
// uz_repo_votes — desc_hits: a thread per stored descriptor (the queries in
// shared memory) looks for a valid query within thresh (stopping at the
// first); a hit adds one vote to the node of each of its valid links by
// integer atomicAdd, exact in any order.  topk_votes: one CTA, the gates
// (node valid, |stamp - query stamp| >= min_dt, else -1) applied as the
// values are read, uz_topk::block_topk, ok = votes >= min_votes (float32).
//
// What bounds it on the card: F x D pairs of 24 operations (50 M at
// D = 16,384) against 0.5 MB of descriptors: operations, at the popcount's
// issue rate (16 a clock per SM).
#include <cuda_runtime.h>

#include "hamming.cuh"
#include "topk.cuh"

namespace {

using uz_hamming::kWords;
constexpr int kThreads = 256;
constexpr int kChunk = 1024;                 // stored descriptors per CTA of nearest_chunk
constexpr unsigned long long kNoKey = ~0ull;

__global__ void nearest_chunk(const unsigned char* __restrict__ query, int F,
                              const unsigned char* __restrict__ bank,
                              const unsigned char* __restrict__ bank_valid, int D,
                              unsigned long long* __restrict__ keys) {
  __shared__ unsigned sb[kChunk * kWords];                       // the chunk's descriptors
  __shared__ unsigned char sv[kChunk];
  __shared__ unsigned long long part_min[kThreads];
  const int start = blockIdx.x * kChunk;
  const int n = D - start < kChunk ? D - start : kChunk;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    uz_hamming::load(bank + static_cast<size_t>(start + j) * 32, sb + j * kWords);
    sv[j] = bank_valid[start + j];
  }
  __syncthreads();
  // P threads per query, each scanning every P-th descriptor of the chunk;
  // the threads of a warp share a part, so they read the same word (a
  // broadcast)
  const int P = F >= kThreads ? 1 : kThreads / F;
  const int per = kThreads / P;
  const int part = threadIdx.x / per;
  for (int q0 = 0; q0 < F; q0 += per) {
    const int i = q0 + threadIdx.x % per;
    unsigned long long best = kNoKey;
    if (i < F && part < P) {
      unsigned q[kWords];
      uz_hamming::load(query + static_cast<size_t>(i) * 32, q);
      for (int j = part; j < n; j += P) {
        if (!sv[j]) continue;
        const unsigned long long key =
            (static_cast<unsigned long long>(uz_hamming::distance(q, sb + j * kWords)) << 32) |
            static_cast<unsigned>(start + j);
        best = key < best ? key : best;
      }
    }
    part_min[threadIdx.x] = best;
    __syncthreads();
    if (part == 0 && i < F) {
      for (int p = 1; p < P; ++p) {
        const unsigned long long o = part_min[threadIdx.x + p * per];
        best = o < best ? o : best;
      }
      if (best != kNoKey) atomicMin(keys + i, best);
    }
    __syncthreads();
  }
}

__global__ void nearest_finish(const unsigned char* __restrict__ query,
                               const unsigned char* __restrict__ qvalid, int F, float thresh,
                               const unsigned long long* __restrict__ keys,
                               float* __restrict__ nn_dist, int* __restrict__ nn_idx,
                               unsigned char* __restrict__ dup) {
  extern __shared__ unsigned sq[];                               // F x 8 words
  for (int i = threadIdx.x; i < F; i += blockDim.x)
    uz_hamming::load(query + static_cast<size_t>(i) * 32, sq + i * kWords);
  __syncthreads();
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    const unsigned long long key = keys[i];
    nn_dist[i] = key == kNoKey ? __int_as_float(0x7f800000)
                               : static_cast<float>(static_cast<unsigned>(key >> 32));
    nn_idx[i] = key == kNoKey ? 0 : static_cast<int>(key & 0xffffffffu);
    bool any = false;
    for (int j = 0; j < i && !any; ++j)
      any = qvalid[j] && static_cast<float>(uz_hamming::distance(sq + i * kWords,
                                                                 sq + j * kWords)) <= thresh;
    dup[i] = any;
  }
}

__global__ void desc_hits(const unsigned char* __restrict__ query,
                          const unsigned char* __restrict__ qvalid, int F,
                          const unsigned char* __restrict__ bank,
                          const unsigned char* __restrict__ bank_valid, int D,
                          const int* __restrict__ links,
                          const unsigned char* __restrict__ link_valid, int L, int N,
                          float thresh, int* __restrict__ votes) {
  extern __shared__ unsigned sq[];                               // F x 8 words, then F flags
  unsigned char* sqv = reinterpret_cast<unsigned char*>(sq + F * kWords);
  for (int i = threadIdx.x; i < F; i += blockDim.x) {
    uz_hamming::load(query + static_cast<size_t>(i) * 32, sq + i * kWords);
    sqv[i] = qvalid[i];
  }
  __syncthreads();
  const int d = blockIdx.x * blockDim.x + threadIdx.x;
  if (d >= D || !bank_valid[d]) return;
  unsigned b[kWords];
  uz_hamming::load(bank + static_cast<size_t>(d) * 32, b);
  bool hit = false;
  for (int i = 0; i < F && !hit; ++i)
    hit = sqv[i] && static_cast<float>(uz_hamming::distance(b, sq + i * kWords)) <= thresh;
  if (!hit) return;
  for (int l = 0; l < L; ++l) {
    const size_t o = static_cast<size_t>(d) * L + l;
    const int node = links[o];
    if (link_valid[o] && static_cast<unsigned>(node) < static_cast<unsigned>(N))
      atomicAdd(votes + node, 1);
  }
}

struct GatedVotes {
  const int* votes;
  const float* stamp;
  const unsigned char* valid;
  float qs, min_dt;
  __device__ int operator()(int j) const {
    return valid[j] && fabsf(__fsub_rn(stamp[j], qs)) >= min_dt ? votes[j] : -1;
  }
};

__global__ void topk_votes(const int* __restrict__ votes, const float* __restrict__ stamp,
                           const unsigned char* __restrict__ valid,
                           const float* __restrict__ q_stamp, int N, int k, float min_votes,
                           float min_dt, int* __restrict__ slots, int* __restrict__ top,
                           unsigned char* __restrict__ ok) {
  uz_topk::block_topk<int>(GatedVotes{votes, stamp, valid, *q_stamp, min_dt}, N, k, slots, top);
  if (threadIdx.x == 0) {
    for (int r = 0; r < k; ++r) ok[r] = static_cast<float>(top[r]) >= min_votes;
  }
}

}  // namespace

// query: (F, 32) uint8, qvalid (F,) bool; bank: (D, 32) uint8, bank_valid
// (D,) bool.  Scratch: keys (F,) uint64, all ones on entry.  Out: nn_dist
// (F,) float32, nn_idx (F,) int32, dup (F,) bool.  D < 2^31; F x 32 bytes
// fit a CTA's shared memory (the wrapper checks).
extern "C" int uz_repo_nearest(const unsigned char* query, const unsigned char* qvalid,
                               const unsigned char* bank, const unsigned char* bank_valid, int F,
                               int D, float thresh, unsigned long long* keys, float* nn_dist,
                               int* nn_idx, unsigned char* dup, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F <= 0) return 0;
  if (D > 0) {
    nearest_chunk<<<(D + kChunk - 1) / kChunk, kThreads, 0, s>>>(query, F, bank, bank_valid, D,
                                                                  keys);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t smem = static_cast<size_t>(F) * kWords * 4;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        nearest_finish, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nearest_finish<<<1, kThreads, smem, s>>>(query, qvalid, F, thresh, keys, nn_dist, nn_idx, dup);
  return static_cast<int>(cudaGetLastError());
}

// query, qvalid, bank, bank_valid as above; links (D, L) int32, link_valid
// (D, L) bool; node_stamp (N,) float32, node_valid (N,) bool; q_stamp ()
// float32 on the device.  Scratch: votes (N,) int32, zero on entry.  Out:
// slots (k,) int32, top (k,) int32, ok (k,) bool.  1 <= k <= N.
extern "C" int uz_repo_votes(const unsigned char* query, const unsigned char* qvalid,
                             const unsigned char* bank, const unsigned char* bank_valid,
                             const int* links, const unsigned char* link_valid,
                             const float* node_stamp, const unsigned char* node_valid,
                             const float* q_stamp, int F, int D, int L, int N, int k, float thresh,
                             float min_votes, float min_dt, int* votes, int* slots, int* top,
                             unsigned char* ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || k <= 0) return 0;
  if (D > 0 && F > 0) {
    const size_t smem = static_cast<size_t>(F) * (kWords * 4 + 1);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          desc_hits, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    desc_hits<<<(D + kThreads - 1) / kThreads, kThreads, smem, s>>>(
        query, qvalid, F, bank, bank_valid, D, links, link_valid, L, N, thresh, votes);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  topk_votes<<<1, kThreads, 0, s>>>(votes, node_stamp, node_valid, q_stamp, N, k, min_votes,
                                    min_dt, slots, top, ok);
  return static_cast<int>(cudaGetLastError());
}
