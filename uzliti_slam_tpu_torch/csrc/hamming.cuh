// Packed 256-bit binary descriptors (32 bytes, LSB first) as eight 32-bit
// words, and their Hamming distance by XOR and popcount.  Shared by K21-K23.
#pragma once

#include <cuda_runtime.h>

namespace uz_hamming {

constexpr int kWords = 8;

__device__ __forceinline__ void load(const unsigned char* p, unsigned w[kWords]) {
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    w[i] = static_cast<unsigned>(p[4 * i]) | (static_cast<unsigned>(p[4 * i + 1]) << 8) |
           (static_cast<unsigned>(p[4 * i + 2]) << 16) |
           (static_cast<unsigned>(p[4 * i + 3]) << 24);
  }
}

__device__ __forceinline__ int distance(const unsigned a[kWords], const unsigned* b) {
  int n = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) n += __popc(a[i] ^ b[i]);
  return n;
}

}  // namespace uz_hamming
