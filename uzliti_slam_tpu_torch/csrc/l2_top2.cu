// K30 l2_top2: squared-L2 nearest neighbours of float descriptors, with the
// ratio test.
//
// Replaces uzliti_slam_tpu/ops/matching.py:l2_matrix (:136-151) with
// knn_match (:80-97) and ratio_test (:100-113), as match_descriptors_l2
// (:154-174) chains them.  The reference writes the (Na, Nb) matrix
// ‖a‖² + ‖b‖² - 2·a·bᵀ clamped at 0, sets masked rows and columns to 1e9,
// and takes a top_k of 2 per row.  Here no distance matrix goes to device
// memory: a CTA holds 32 queries and walks the stored descriptors in tiles
// of 32, both tiles in shared memory (rows padded by one float, so the 8
// stored rows a warp reads at once fall on different banks).  Each of the
// 256 threads computes 4 of the tile's 32 x 32 dot products in float32 on the
// CUDA cores (no TF32: the tensor cores' 10-bit mantissa would change the
// distances), d = max((‖a‖² + ‖b‖²) - 2·(a·b), 0) with the reference's
// expansion and order (not Σ(a - b)²), 1e9 where a query or a stored
// descriptor is masked; then one thread per query scans the tile's row in
// ascending index with strict '<' for a running best and second, so ties
// keep the lower index, as XLA's top_k.  ok = valid_a & best <=
// fl(ratio²·second) & best <= max_dist², in float32 as the reference gates.
// Norms are sums over the dimension in order; the dot products too.
//
// What bounds it on the card: at 300 x 300 x 128 the operations (2·11.5 M
// flops: 0.34 us at 67 TFLOP/s) and the bytes (307 KB: 0.09 us) are far
// below the launch's own latency; at keyframe sizes it is latency-bound.
#include <cuda_runtime.h>

namespace {

constexpr int kDMax = 128;        // descriptor width one tile holds
constexpr int kTq = 32;           // queries per CTA
constexpr int kTb = 32;           // stored descriptors per tile
constexpr int kThreads = 256;
constexpr int kDotsPerThread = kTq * kTb / kThreads;
constexpr float kMasked = 1e9f;   // knn_match's padding (not +inf)

__global__ void __launch_bounds__(kThreads)
l2_top2_tiles(const float* __restrict__ a, const float* __restrict__ b,
              const unsigned char* __restrict__ valid_a, const unsigned char* __restrict__ valid_b,
              int Na, int Nb, int D, float ratio_sq, float max_sq, int* __restrict__ idx,
              unsigned char* __restrict__ ok, float* __restrict__ best_out) {
  __shared__ float sa[kTq][kDMax + 1];
  __shared__ float sb[kTb][kDMax + 1];
  __shared__ float sd[kTq][kTb + 1];
  __shared__ float na[kTq], nb[kTb];
  __shared__ unsigned char va[kTq], vb[kTb];
  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kTq;
  for (int e = t; e < kTq * D; e += kThreads) {
    const int qi = e / D, k = e % D;
    sa[qi][k] = q0 + qi < Na ? a[static_cast<long long>(q0 + qi) * D + k] : 0.f;
  }
  __syncthreads();
  if (t < kTq) {
    float s = 0.f;
    for (int k = 0; k < D; ++k) s = __fadd_rn(s, __fmul_rn(sa[t][k], sa[t][k]));
    na[t] = s;
    va[t] = q0 + t < Na ? valid_a[q0 + t] : 0;
  }
  float b1 = __int_as_float(0x7f800000), b2 = b1;   // running best and second (query t)
  int i1 = 0, i2 = 0;
  const int qi = t / (kThreads / kTq), jl = t % (kThreads / kTq);
  for (int j0 = 0; j0 < Nb; j0 += kTb) {
    __syncthreads();                                   // the previous tile is scanned
    for (int e = t; e < kTb * D; e += kThreads) {
      const int jj = e / D, k = e % D;
      sb[jj][k] = j0 + jj < Nb ? b[static_cast<long long>(j0 + jj) * D + k] : 0.f;
    }
    __syncthreads();
    if (t < kTb) {
      float s = 0.f;
      for (int k = 0; k < D; ++k) s = __fadd_rn(s, __fmul_rn(sb[t][k], sb[t][k]));
      nb[t] = s;
      vb[t] = j0 + t < Nb ? valid_b[j0 + t] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kDotsPerThread; ++r) {
      const int jj = jl + r * (kThreads / kTq);
      float dot = 0.f;
      for (int k = 0; k < D; ++k) dot = __fadd_rn(dot, __fmul_rn(sa[qi][k], sb[jj][k]));
      const float d = __fsub_rn(__fadd_rn(na[qi], nb[jj]), __fmul_rn(2.f, dot));
      sd[qi][jj] = (va[qi] && vb[jj]) ? fmaxf(d, 0.f) : kMasked;
    }
    __syncthreads();
    if (t < kTq) {
      const int n = min(kTb, Nb - j0);
      for (int jj = 0; jj < n; ++jj) {
        const float d = sd[t][jj];
        if (d < b1) {
          b2 = b1; i2 = i1; b1 = d; i1 = j0 + jj;
        } else if (d < b2) {
          b2 = d; i2 = j0 + jj;
        }
      }
    }
  }
  (void)i2;
  if (t < kTq && q0 + t < Na) {
    const int q = q0 + t;
    idx[q] = i1;
    best_out[q] = b1;
    ok[q] = va[t] && b1 <= __fmul_rn(ratio_sq, b2) && b1 <= max_sq;
  }
}

}  // namespace

// a (Na, D), b (Nb, D) float32 row-major, D <= 128; valid_a (Na,), valid_b
// (Nb,) bool.  Out: idx (Na,) int32, ok (Na,) bool, best (Na,) float32.
// Nb >= 2 (the reference's top_k of 2).
extern "C" int uz_l2_top2(const float* a, const float* b, const unsigned char* valid_a,
                          const unsigned char* valid_b, int Na, int Nb, int D, float ratio_sq,
                          float max_sq, int* idx, unsigned char* ok, float* best, void* stream) {
  if (Na <= 0) return 0;
  if (D < 1 || D > kDMax || Nb < 2) return static_cast<int>(cudaErrorInvalidValue);
  l2_top2_tiles<<<(Na + kTq - 1) / kTq, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, valid_a, valid_b, Na, Nb, D, ratio_sq, max_sq, idx, ok, best);
  return static_cast<int>(cudaGetLastError());
}
