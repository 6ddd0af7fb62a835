// Hamming distances of packed 256-bit descriptors (32 bytes, eight 32-bit
// words) on the tensor cores, a warp's 16 x 8 tile at a time; shared by K21
// feature_votes and K22 repository.
//
// One mma.sync.m16n8k256 on b1 operands with AND + popcount gives
// c = popc(a & b) for 16 rows x 8 columns over all 256 bits, and
// d = popc(a) + popc(b) - 2·popc(a & b), each descriptor's popcount taken
// once.  The distances are exact integers.  A row or column that is padding
// or masked out carries the popcount kBig: every distance it takes part in
// exceeds 256, so it never lies within a threshold (at most 256) and never
// wins a minimum.
//
// Lane (g, t) = (lane / 4, lane % 4) holds the A fragment's words t and
// t + 4 of rows g and g + 8, the B fragment's words t and t + 4 of column g,
// and the result's columns 2t and 2t + 1 of rows g and g + 8 (the PTX ISA's
// fragment layouts for m16n8k256 .b1).  Columns in shared memory are
// swizzled by 16-byte halves (swz): the 32 lanes reading word t of eight
// consecutive columns hit 32 distinct banks.
//
// The engine was chosen on the card against the b1 mma with .xor.popc
// (emulated, ~6x slower), mma.m16n8k32 on u8 operands of bits expanded to
// 0/1 bytes, and a __popc loop; scripts/hamming_mma_rates.cu times the four
// instructions alone.
#pragma once

#include <cuda_runtime.h>

namespace uz_mma {

constexpr int kBig = 1 << 20;        // popcount of a padded or masked descriptor
constexpr unsigned kFull = 0xffffffffu;

// word w of column j in a swizzled shared tile: its two 16-byte halves
// swapped where bit 2 of j is set
__device__ __forceinline__ int swz(int j, int w) {
  return j * 8 + ((((w >> 2) ^ (j >> 2)) & 1) << 2) + (w & 3);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy columns [0, n) of packed rows at src (32 bytes each, 16-byte
// aligned) into the swizzled tile dst, 16 bytes a cp.async; the caller
// commits and waits.
__device__ __forceinline__ void stage_cols(unsigned* dst, const unsigned char* src, int n) {
  for (int i = threadIdx.x; i < 2 * n; i += blockDim.x) {
    const int j = i >> 1, h = i & 1;
    cp_async16(dst + swz(j, 4 * h), src + static_cast<size_t>(j) * 32 + h * 16);
  }
}

// The popcount of column j of a shared tile, by two 16-byte loads.
__device__ __forceinline__ int popc_col(const unsigned* tile, int j) {
  const uint4 a = *reinterpret_cast<const uint4*>(tile + j * 8);
  const uint4 b = *reinterpret_cast<const uint4*>(tile + j * 8 + 4);
  return __popc(a.x) + __popc(a.y) + __popc(a.z) + __popc(a.w) + __popc(b.x) + __popc(b.y) +
         __popc(b.z) + __popc(b.w);
}

// A warp's 16 rows r0 .. r0 + 15 of packed (n, 32) uint8 rows, from device
// memory (read-only path).  p0, p1: the popcounts of rows g and g + 8, kBig
// where the row is >= n or mask[row] is 0 (mask may be null).
struct Rows {
  unsigned w[4];                     // words t, t + 4 of rows g and g + 8
  int p0, p1;
};

__device__ __forceinline__ Rows load_rows(const unsigned char* base, int r0, int n,
                                          const unsigned char* mask) {
  const int lane = threadIdx.x & 31, g = lane >> 2;
  const int ra = r0 + g, rb = ra + 8;
  const bool ia = ra < n, ib = rb < n;
  const unsigned* pa = reinterpret_cast<const unsigned*>(base) + static_cast<size_t>(ia ? ra : 0) * 8;
  const unsigned* pb = reinterpret_cast<const unsigned*>(base) + static_cast<size_t>(ib ? rb : 0) * 8;
  Rows r;
  const int t = lane & 3;
  r.w[0] = ia ? __ldg(pa + t) : 0u;
  r.w[1] = ib ? __ldg(pb + t) : 0u;
  r.w[2] = ia ? __ldg(pa + 4 + t) : 0u;
  r.w[3] = ib ? __ldg(pb + 4 + t) : 0u;
  int ca = __popc(r.w[0]) + __popc(r.w[2]), cb = __popc(r.w[1]) + __popc(r.w[3]);
  ca += __shfl_xor_sync(kFull, ca, 1);
  cb += __shfl_xor_sync(kFull, cb, 1);
  ca += __shfl_xor_sync(kFull, ca, 2);
  cb += __shfl_xor_sync(kFull, cb, 2);
  r.p0 = ia && (mask == nullptr || mask[ra]) ? ca : kBig;
  r.p1 = ib && (mask == nullptr || mask[rb]) ? cb : kBig;
  return r;
}

// Columns from a swizzled shared tile, or straight from device memory
// (packed rows; zero past n).  frag(c0, b0, b1): lane (g, t)'s B fragment
// of the 8 columns from c0 (a multiple of 8), words t and t + 4 of column
// c0 + g; in the shared tile the lane's two offsets are fixed, since bit 2
// of c0 + g is bit 2 of g.
struct SharedCols {
  const unsigned* s;
  int o0, o1;
  __device__ __forceinline__ explicit SharedCols(const unsigned* tile) : s(tile) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, h = (g >> 2) & 1;
    o0 = g * 8 + (h << 2) + t;
    o1 = g * 8 + ((h ^ 1) << 2) + t;
  }
  __device__ __forceinline__ void frag(int c0, unsigned& b0, unsigned& b1) const {
    b0 = s[c0 * 8 + o0];
    b1 = s[c0 * 8 + o1];
  }
};
struct GlobalCols {
  const unsigned* p;
  int n;
  __device__ __forceinline__ void frag(int c0, unsigned& b0, unsigned& b1) const {
    const int lane = threadIdx.x & 31, j = c0 + (lane >> 2), t = lane & 3;
    const unsigned* q = p + static_cast<size_t>(j) * 8 + t;
    b0 = j < n ? __ldg(q) : 0u;
    b1 = j < n ? __ldg(q + 4) : 0u;
  }
};

// c[] of rows g, g + 8 and columns c0 + 2t, c0 + 2t + 1, in the order (g,
// 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1): popc(a & b).
template <typename Cols>
__device__ __forceinline__ void and_popc(const Rows& A, const Cols& col, int c0, int c[4]) {
  c[0] = c[1] = c[2] = c[3] = 0;
  unsigned b0, b1;
  col.frag(c0, b0, b1);
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(A.w[0]), "r"(A.w[1]), "r"(A.w[2]), "r"(A.w[3]), "r"(b0), "r"(b1));
}

// The distances of rows g, g + 8 to columns c0 + 2t, c0 + 2t + 1, in
// and_popc's order.  pcol: the columns' popcounts (kBig where padded or
// masked), 8-byte aligned at c0.
template <typename Cols>
__device__ __forceinline__ void distances(const Rows& A, const Cols& col, const int* pcol, int c0,
                                          int d[4]) {
  int c[4];
  and_popc(A, col, c0, c);
  const int2 p = *reinterpret_cast<const int2*>(pcol + c0 + 2 * (threadIdx.x & 3));
  d[0] = A.p0 + p.x - 2 * c[0];
  d[1] = A.p0 + p.y - 2 * c[1];
  d[2] = A.p1 + p.x - 2 * c[2];
  d[3] = A.p1 + p.y - 2 * c[3];
}

// 16-bit mask of a warp's rows: bit r (r < 8) set where some lane of group
// r has a, bit 8 + r where some lane of group r has b.  Warp-uniform.
__device__ __forceinline__ unsigned group_bits(unsigned x) {
  x = (x | x >> 1 | x >> 2 | x >> 3) & 0x11111111u;     // group r's OR at bit 4r
  x = (x | x >> 3) & 0x03030303u;
  x = (x | x >> 6) & 0x000f000fu;
  return (x | x >> 12) & 0xffu;
}
__device__ __forceinline__ unsigned row_mask(bool a, bool b) {
  return group_bits(__ballot_sync(kFull, a)) | group_bits(__ballot_sync(kFull, b)) << 8;
}

// The rows of A (a warp's 16-bit mask) within `it` of some column in
// [0, ncols8), from `got` on; 4 tiles of 8 columns a round, and no round
// after every row of `live` has hit.  A row lies within `it` of a column
// where e = it - popc(a) - popc(b) + 2·popc(a & b) >= 0: the lane ANDs its
// e's, and bit 31 of the AND stays clear once one of them is >= 0 (a kBig
// popcount keeps e far below 0).
template <typename Cols>
__device__ __forceinline__ unsigned hit_rows(const Rows& A, const Cols& col, const int* pcol,
                                             int ncols8, int it, unsigned got, unsigned live) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  int ea = (got >> g) & 1u ? 0 : -1, eb = (got >> (g + 8)) & 1u ? 0 : -1;
  const int ra = it - A.p0, rb = it - A.p1;
  for (int c0 = 0; c0 < ncols8 && got != live; c0 += 32) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int ct = c0 + 8 * u;
      if (ct < ncols8) {
        int c[4];
        and_popc(A, col, ct, c);
        const int2 p = *reinterpret_cast<const int2*>(pcol + ct + 2 * t);
        ea &= (2 * c[0] + (ra - p.x)) & (2 * c[1] + (ra - p.y));
        eb &= (2 * c[2] + (rb - p.x)) & (2 * c[3] + (rb - p.y));
      }
    }
    got = row_mask(ea >= 0, eb >= 0);
  }
  return got;
}

// The largest integer distance d with d <= thresh in float32: -1 where no
// distance is (thresh negative or NaN), 256 where every one is.
__device__ __forceinline__ int int_thresh(float thresh) {
  return thresh >= 256.0f ? 256 : (thresh >= 0.0f ? static_cast<int>(floorf(thresh)) : -1);
}

#ifdef UZ_RECOG_STAMPS
// Timing builds only (scripts/k21_k22_variants.py, ":stamps=1"): CTA 0's
// thread 0 adds the %globaltimer ns of each phase into a file's stamp
// array, and the last CTA its tail's.
__device__ __forceinline__ unsigned long long stamp_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define UZ_STAMP(arr, slot, prev)                                                   \
  do {                                                                              \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                                      \
      const unsigned long long t_ = uz_mma::stamp_now();                            \
      arr[slot] += t_ - prev;                                                       \
      prev = t_;                                                                    \
    }                                                                               \
  } while (0)
#else
#define UZ_STAMP(arr, slot, prev) \
  do {                            \
  } while (0)
#endif

// SMs of the current device and the CTAs of `kernel` an SM holds, both
// cached (the latter by the dynamic shared memory asked).
__host__ inline int sm_count() {
  static int cached[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return 132;
  if (cached[dev] == 0) cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount, dev);
  return cached[dev] > 0 ? cached[dev] : 132;
}

// The CTAs of `kernel` an SM holds at `threads` threads and `smem` bytes
// of dynamic shared memory, the carveout set to as much shared memory as
// they want and the dynamic limit raised past 48 KB; cached by the last
// size asked.  A CUDA error comes back negated.
template <typename Kernel>
__host__ int occupancy(Kernel kernel, int threads, size_t smem, size_t* cached_smem, int* cached) {
  if (*cached_smem != smem || *cached == 0) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                           cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess && smem > 48 * 1024)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(cached, kernel, threads, smem);
    if (err != cudaSuccess) return -static_cast<int>(err);
    *cached_smem = smem;
  }
  return *cached > 0 ? *cached : 1;
}

}  // namespace uz_mma
