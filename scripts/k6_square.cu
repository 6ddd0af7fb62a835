// K6's labels by boolean matrix powers: a variant of
// uzliti_slam_tpu_torch/csrc/cluster_labels.cu, timed beside it by
// scripts/k5_k6_variants.py (spec "k6:square").
//
// n_iters Jacobi rounds of min-label propagation give a valid slot the least
// valid index within n_iters hops of the adjacency A (both stamp gaps below
// max_dt, both ends valid).  That is the lowest set bit of its row of
// (A ∪ I)^n_iters, I the valid slots' diagonal: the powers by squaring, four
// squarings at the epoch's n_iters = 16 and a product for each further set
// bit of n_iters.  The package's kernel instead runs the rounds over the
// labels that changed and stops at the fixed point.
//
// One CTA of 1024 threads, B <= 256: three row-major bit matrices of B x 8
// words in shared memory; a product C = X ∘ Y ORs, for each (row, word) on
// its own thread, Y's rows at X's set bits.  Exports uz_cluster_labels with
// the package's signature (the labels entry only).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -shared -o libk6_square.so scripts/k6_square.cu
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxB = 256;
constexpr int kWords = kMaxB / 32;   // a row's words

// C = X ∘ Y over b rows of `words` words
__device__ __forceinline__ void product(const unsigned* X, const unsigned* Y, unsigned* C, int b,
                                        int words) {
  for (int t = threadIdx.x; t < b * words; t += blockDim.x) {
    const int i = t / words, w = t % words;
    unsigned acc = 0u;
    for (int kw = 0; kw < words; ++kw)
      for (unsigned m = X[i * kWords + kw]; m != 0u; m &= m - 1u)
        acc |= Y[(32 * kw + __ffs(m) - 1) * kWords + w];
    C[i * kWords + w] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
cluster_square(const float* __restrict__ sf, const float* __restrict__ st,
               const unsigned char* __restrict__ valid, int b, float max_dt, int n_iters,
               int* __restrict__ labels) {
  __shared__ unsigned buf[3][kMaxB * kWords];
  __shared__ float s_f[kMaxB], s_t[kMaxB];
  __shared__ unsigned char ok[kMaxB];
  const int words = (b + 31) / 32;
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    s_f[i] = sf[i];
    s_t[i] = st[i];
    ok[i] = valid[i] != 0;
  }
  __syncthreads();
  unsigned* P = buf[0];
  unsigned* acc = buf[1];
  unsigned* tmp = buf[2];
  // P = A ∪ I over the valid slots, a thread a (row, word)
  for (int t = threadIdx.x; t < b * words; t += blockDim.x) {
    const int i = t / words, w = t % words;
    unsigned bits = 0u;
    if (ok[i]) {
      const float fi = s_f[i], ti = s_t[i];
      for (int l = 0; l < 32; ++l) {
        const int j = 32 * w + l;
        if (j < b && ok[j] &&
            (j == i || (fabsf(fi - s_f[j]) < max_dt && fabsf(ti - s_t[j]) < max_dt)))
          bits |= 1u << l;
      }
    }
    P[i * kWords + w] = bits;
  }
  __syncthreads();
  // acc = P^n_iters by squaring; `have` false while acc is still I
  bool have = false;
  for (int n = n_iters; n > 0;) {
    if (n & 1) {
      if (!have) {
        for (int t = threadIdx.x; t < b * kWords; t += blockDim.x) acc[t] = P[t];
      } else {
        product(acc, P, tmp, b, words);
        unsigned* s = acc;
        acc = tmp;
        tmp = s;
      }
      have = true;
      __syncthreads();
    }
    n >>= 1;
    if (n > 0) {
      product(P, P, tmp, b, words);
      unsigned* s = P;
      P = tmp;
      tmp = s;
      __syncthreads();
    }
  }
  for (int i = threadIdx.x; i < b; i += blockDim.x) {
    int lab = b;
    if (ok[i]) {
      lab = i;
      if (have)
        for (int w = 0; w < words; ++w) {
          const unsigned m = acc[i * kWords + w];
          if (m != 0u) {
            lab = 32 * w + __ffs(m) - 1;
            break;
          }
        }
    }
    labels[i] = lab;
  }
}

}  // namespace

extern "C" int uz_cluster_labels(const float* stamp_from, const float* stamp_to,
                                 const unsigned char* valid, int b, float max_dt, int n_iters,
                                 int* labels, void* stream) {
  if (b <= 0) return 0;
  if (b > kMaxB) return static_cast<int>(cudaErrorInvalidValue);
  cluster_square<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      stamp_from, stamp_to, valid, b, max_dt, n_iters, labels);
  return static_cast<int>(cudaGetLastError());
}
