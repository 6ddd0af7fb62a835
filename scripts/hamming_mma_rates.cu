// The issue rate of the tensor-core instructions K21 and K22 can compute
// Hamming distances with, on the card at hand (the card publishes no
// binary tensor-core rate): mma.sync m16n8k256 on b1 operands with AND +
// popcount (form 0) and XOR + popcount (1), m16n8k32 on u8 operands (2),
// and __popc of AND on 32-bit words (3, per lane: a popcount of 32 bits).
// Each warp keeps kChains independent accumulators so that the rate, not
// the latency, bounds the loop; `iters` rounds of kChains instructions a
// warp.  Built and timed by scripts/k21_k22_variants.py --rates:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o build/mma_rates.so scripts/hamming_mma_rates.cu
#include <cuda_runtime.h>

namespace {

constexpr int kChains = 8;

template <int Form>
__global__ void rate_kernel(const unsigned* __restrict__ in, int iters, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  unsigned a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = in[(lane * 7 + i) & 255];
  b[0] = in[(lane * 5 + 1) & 255];
  b[1] = in[(lane * 3 + 2) & 255];
  int c[kChains][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < kChains; ++j) {
      if (Form == 0) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else if (Form == 1) {
        asm volatile(
            "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.xor.popc "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else if (Form == 2) {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      } else {
        unsigned x;
        asm volatile("and.b32 %0, %1, %2;\n" : "=r"(x) : "r"(a[j & 3] ^ it), "r"(b[j & 1]));
        asm volatile("popc.b32 %0, %1;\n" : "=r"(x) : "r"(x));
        c[j][0] += static_cast<int>(x);
      }
    }
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < kChains; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

// in: 256 words; out: blocks x threads ints.  kChains instructions a round
// and warp.
extern "C" int uz_mma_rate(int form, const unsigned* in, int blocks, int threads, int iters,
                           int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
    case 0: rate_kernel<0><<<blocks, threads, 0, s>>>(in, iters, out); break;
    case 1: rate_kernel<1><<<blocks, threads, 0, s>>>(in, iters, out); break;
    case 2: rate_kernel<2><<<blocks, threads, 0, s>>>(in, iters, out); break;
    default: rate_kernel<3><<<blocks, threads, 0, s>>>(in, iters, out); break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int uz_mma_rate_chains() { return kChains; }
