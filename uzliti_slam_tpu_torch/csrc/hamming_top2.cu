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
// the packed form is the natural one: XOR and __popc on the eight 32-bit words
// of a descriptor, and no distance matrix goes to device memory.
//
// uz_hamming_top2 — the keyframe step's matching, all candidates in one
// launch: grid (query blocks, candidates).  A CTA copies its candidate's
// stored descriptors and validity (gathered from the node bank by the
// candidate's slot) into shared memory; each thread holds one query
// descriptor in registers and keeps a running best and second over the
// stored ones in ascending index with strict '<', so ties keep the lower
// index, as XLA's top_k.  Masked pairs (invalid query or stored descriptor)
// are 1e9, as knn_match masks them (not +inf): a query with one valid stored
// descriptor has second = 1e9 and passes the ratio test, and a row with none
// returns indices 0 and 1.  Then ok = valid_a & best <= fl(ratio * second) &
// best <= max_dist, in float32 as the reference's float32 gates.
//
// uz_gist_topk — the GIST query: one CTA computes the query's distance to
// every bank entry into shared memory, +inf where an entry is not eligible
// (invalid, or |stamp - query stamp| < min_dt in float32), then k rounds of a
// block-wide (distance, index) minimum, ties to the lower index.
//
// What bounds it on the card: the matching's bytes are tiny (10 candidates x
// 8 KB of stored descriptors), its operations 10 x 256 x 256 x ~20 = 13 M
// (0.2 us at 67 T/s) — it is launch latency at the keyframe's size.
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 8;                        // 256 bits
constexpr int kThreads = 256;
constexpr int kMasked = 1000000000;              // knn_match's 1e9 padding

__device__ __forceinline__ void load_desc(const unsigned char* p, unsigned w[kWords]) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    w[i] = static_cast<unsigned>(p[4 * i]) | (static_cast<unsigned>(p[4 * i + 1]) << 8) |
           (static_cast<unsigned>(p[4 * i + 2]) << 16) |
           (static_cast<unsigned>(p[4 * i + 3]) << 24);
  }
}

__global__ void match_top2(const unsigned char* __restrict__ query,
                           const unsigned char* __restrict__ bank,
                           const unsigned char* __restrict__ bank_valid,
                           const int* __restrict__ cslot, const unsigned char* __restrict__ valid_a,
                           int Na, int F, float ratio, float max_dist, int* __restrict__ idx,
                           unsigned char* __restrict__ ok, float* __restrict__ best_out) {
  extern __shared__ unsigned sm[];
  unsigned* sdesc = sm;                                          // F x 8 words
  unsigned char* svalid = reinterpret_cast<unsigned char*>(sm + F * kWords);
  const int c = blockIdx.y;
  const size_t slot = static_cast<size_t>(cslot[c]);
  const unsigned char* cb = bank + slot * F * 32;
  for (int j = threadIdx.x; j < F; j += blockDim.x) {
    load_desc(cb + static_cast<size_t>(j) * 32, sdesc + j * kWords);
    svalid[j] = bank_valid[slot * F + j];
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= Na) return;
  unsigned q[kWords];
  load_desc(query + static_cast<size_t>(i) * 32, q);
  const bool va = valid_a[i] != 0;
  int b1 = 2147483647, b2 = 2147483647, i1 = 0, i2 = 0;
  for (int j = 0; j < F; ++j) {
    int d = kMasked;
    if (va && svalid[j]) {
      d = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) d += __popc(q[w] ^ sdesc[j * kWords + w]);
    }
    if (d < b1) {
      b2 = b1; i2 = i1; b1 = d; i1 = j;
    } else if (d < b2) {
      b2 = d; i2 = j;
    }
  }
  (void)i2;
  const float best = static_cast<float>(b1), second = static_cast<float>(b2);
  const size_t o = static_cast<size_t>(c) * Na + i;
  idx[o] = i1;
  best_out[o] = best;
  ok[o] = va && best <= __fmul_rn(ratio, second) && best <= max_dist;
}

__global__ void gist_rounds(const unsigned char* __restrict__ query,
                            const unsigned char* __restrict__ bank,
                            const float* __restrict__ stamp,
                            const unsigned char* __restrict__ valid,
                            const float* __restrict__ q_stamp, int N, int k, float min_dt,
                            float max_dist, int* __restrict__ slots, float* __restrict__ dist,
                            unsigned char* __restrict__ ok) {
  extern __shared__ float sdist[];                               // N distances
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  unsigned q[kWords];
  load_desc(query, q);
  const float qs = *q_stamp;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    float d = __int_as_float(0x7f800000);                        // +inf: not eligible
    if (valid[j] && fabsf(__fsub_rn(stamp[j], qs)) >= min_dt) {
      unsigned b[kWords];
      load_desc(bank + static_cast<size_t>(j) * 32, b);
      int n = 0;
#pragma unroll
      for (int w = 0; w < kWords; ++w) n += __popc(q[w] ^ b[w]);
      d = static_cast<float>(n);
    }
    sdist[j] = d;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = 0; r < k; ++r) {
    // (distance, index) minimum over entries not yet taken (taken = NaN)
    float bv = __int_as_float(0x7fc00000);
    int bi = 2147483647;
    for (int j = threadIdx.x; j < N; j += blockDim.x) {
      const float v = sdist[j];
      if (v != v) continue;
      if (bv != bv || v < bv) { bv = v; bi = j; }               // ascending j: ties keep the lower
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      const bool take = (ov == ov) && (bv != bv || ov < bv || (ov == bv && oi < bi));
      if (take) { bv = ov; bi = oi; }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (threadIdx.x == 0) {
      float v = red_v[0];
      int ix = red_i[0];
      for (int w = 1; w < kThreads / 32; ++w) {
        const float ov = red_v[w];
        const int oi = red_i[w];
        if ((ov == ov) && (v != v || ov < v || (ov == v && oi < ix))) { v = ov; ix = oi; }
      }
      slots[r] = ix;
      dist[r] = v;
      ok[r] = isfinite(v) && v <= max_dist;
      sdist[ix] = __int_as_float(0x7fc00000);
    }
    __syncthreads();
  }
}

}  // namespace

// query: (Na, 32) uint8; bank: (N, F, 32) uint8; bank_valid: (N, F) bool;
// cslot: (C,) int32 node slots in [0, N); valid_a: (Na,) bool.  Out: idx
// (C, Na) int32, ok (C, Na) bool, best (C, Na) float32.  F * 33 bytes fit a
// CTA's shared memory (the wrapper checks).
extern "C" int uz_hamming_top2(const unsigned char* query, const unsigned char* bank,
                               const unsigned char* bank_valid, const int* cslot,
                               const unsigned char* valid_a, int C, int Na, int F, float ratio,
                               float max_dist, int* idx, unsigned char* ok, float* best,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || Na <= 0) return 0;
  const size_t smem = static_cast<size_t>(F) * (kWords * 4 + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        match_top2, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((Na + kThreads - 1) / kThreads, C);
  match_top2<<<grid, kThreads, smem, s>>>(query, bank, bank_valid, cslot, valid_a, Na, F, ratio,
                                          max_dist, idx, ok, best);
  return static_cast<int>(cudaGetLastError());
}

// query: (32,) uint8; bank: (N, 32) uint8; stamp: (N,) float32; valid: (N,)
// bool; q_stamp: () float32 on the device.  Out: slots (k,) int32, dist (k,)
// float32 (+inf where not eligible), ok (k,) bool.  1 <= k <= N, and N
// floats fit a CTA's shared memory (the wrapper checks).
extern "C" int uz_gist_topk(const unsigned char* query, const unsigned char* bank,
                            const float* stamp, const unsigned char* valid, const float* q_stamp,
                            int N, int k, float min_dt, float max_dist, int* slots, float* dist,
                            unsigned char* ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || k <= 0) return 0;
  const size_t smem = static_cast<size_t>(N) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        gist_rounds, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gist_rounds<<<1, kThreads, smem, s>>>(query, bank, stamp, valid, q_stamp, N, k, min_dt,
                                        max_dist, slots, dist, ok);
  return static_cast<int>(cudaGetLastError());
}
