// Block-wide top-k of (value, index) pairs, shared by K21 feature_votes,
// K22's repo_votes and K24 bow_query: the k largest values of n entries,
// ties to the lower index, as XLA's top_k.
//
// Round r takes the first entry, in the order (value descending, index
// ascending), that lies strictly behind round r - 1's pick.  The order is
// total (indices are distinct), so k rounds give the k first entries and
// nothing is marked: no buffer of n entries is held, and a bank of any
// size fits one CTA (a 50k-node bank's floats, 200 KB, would not leave room
// for anything else in shared memory).  Each round reads the n values
// again, k x n reads in all, from L2 at the banks' sizes.
//
// value(j) gives entry j's value (a load, or a load and the gates); every
// thread of the block calls block_topk, blockDim.x a multiple of 32, and
// 1 <= k <= n.  Values are finite: no NaN.
#pragma once

#include <cuda_runtime.h>

namespace uz_topk {

constexpr int kNone = 2147483647;

template <typename T>
__device__ __forceinline__ bool ahead(T va, int ia, T vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// out_idx[r], out_val[r] for r < k, written by thread 0.
template <typename T, typename ValueAt>
__device__ void block_topk(ValueAt value, int n, int k, int* out_idx, T* out_val) {
  __shared__ T red_v[32];
  __shared__ int red_i[32];
  __shared__ T prev_v;
  __shared__ int prev_i;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int r = 0; r < k; ++r) {
    const T pv = r > 0 ? prev_v : T();
    const int pi = r > 0 ? prev_i : -1;
    T bv = T();
    int bi = kNone;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const T v = value(j);
      if (r > 0 && !ahead(pv, pi, v, j)) continue;               // taken in an earlier round
      if (bi == kNone || ahead(v, j, bv, bi)) { bv = v; bi = j; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const T ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (oi != kNone && (bi == kNone || ahead(ov, oi, bv, bi))) { bv = ov; bi = oi; }
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (threadIdx.x == 0) {
      T v = red_v[0];
      int ix = red_i[0];
      for (int w = 1; w < n_warps; ++w) {
        if (red_i[w] != kNone && (ix == kNone || ahead(red_v[w], red_i[w], v, ix))) {
          v = red_v[w];
          ix = red_i[w];
        }
      }
      out_idx[r] = ix;
      out_val[r] = v;
      prev_v = v;
      prev_i = ix;
    }
    __syncthreads();
  }
}

}  // namespace uz_topk
