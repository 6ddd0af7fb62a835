// Block-wide top-k of (value, index) pairs, shared by K21 feature_votes,
// K22's repo_votes and K24 bow_query: the k largest values of n entries,
// ties to the lower index, as XLA's top_k.
//
// Rounds: round r takes the first entry, in the order (value descending,
// index ascending), that lies strictly behind round r - 1's pick.  The
// order is total (indices are distinct), so k rounds give the k first
// entries and nothing is marked: no buffer of n entries is held, and a bank
// of any size fits one CTA (a 50k-node bank's floats, 200 KB, would not
// leave room for anything else in shared memory).  Each round reads the n
// values again, k x n reads in all, kBatch loads in flight a thread.
//
// One pass, where the caller lends kList x blockDim.x (value, index) slots
// of shared memory and k <= kList: each thread reads its strided share of
// the n values once (kBatch loads in flight) and keeps its own k first in
// its slots, sorted; the rounds then run over the threads' kList x
// blockDim.x slots.  At 50k entries a round over device memory waits tens
// of µs on L2 latency, so k rounds cost k times one pass.
//
// value(j) gives entry j's value (a load, or a load and the gates); every
// thread of the block calls block_topk, blockDim.x a multiple of 32, and
// 1 <= k <= n.  Values are finite: no NaN.
#pragma once

#include <cuda_runtime.h>

namespace uz_topk {

constexpr int kNone = 2147483647;
constexpr int kBatch = 8;   // values a thread loads before it compares them
constexpr int kList = 8;    // the one-pass form's slots a thread

template <typename T>
__device__ __forceinline__ bool ahead(T va, int ia, T vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// The rounds over entries j < n of value(j), key(j): key is the entry's
// index for the order and the output, kNone for an empty entry.
// out_idx[r] (the key), out_val[r] for r < k, written by thread 0.
template <typename T, typename ValueAt, typename KeyAt>
__device__ void topk_rounds(ValueAt value, KeyAt key, int n, int k, int* out_idx, T* out_val) {
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
    for (int j0 = threadIdx.x; j0 < n; j0 += kBatch * blockDim.x) {
      T v[kBatch];
      int id[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int j = j0 + u * static_cast<int>(blockDim.x);
        v[u] = j < n ? value(j) : T();
        id[u] = j < n ? key(j) : kNone;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (id[u] == kNone || (r > 0 && !ahead(pv, pi, v[u], id[u]))) continue;   // taken
        if (bi == kNone || ahead(v[u], id[u], bv, bi)) { bv = v[u]; bi = id[u]; }
      }
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

struct SelfKey {
  __device__ int operator()(int j) const { return j; }
};

template <typename T>
struct SlotValue {
  const T* v;
  __device__ T operator()(int j) const { return v[j]; }
};
struct SlotKey {
  const int* i;
  __device__ int operator()(int j) const { return i[j]; }
};

// out_idx[r], out_val[r] for r < k, written by thread 0.  buf, when given
// with at least kList x blockDim.x x (sizeof(T) + 4) bytes (16-byte
// aligned) and k <= kList, takes the one-pass form; its contents are
// overwritten.
template <typename T, typename ValueAt>
__device__ void block_topk(ValueAt value, int n, int k, int* out_idx, T* out_val,
                           void* buf = nullptr, size_t buf_bytes = 0) {
  const int nt = blockDim.x, t = threadIdx.x;
  if (buf == nullptr || k > kList ||
      buf_bytes < static_cast<size_t>(kList) * nt * (sizeof(T) + sizeof(int))) {
    topk_rounds<T>(value, SelfKey{}, n, k, out_idx, out_val);
    return;
  }
  T* lv = static_cast<T*>(buf);                      // slot r of thread t: lv[r * nt + t]
  int* li = reinterpret_cast<int*>(lv + kList * nt);
  int cnt = 0, wi = kNone;                           // the thread's kept entries, its k-th
  T wv = T();
  for (int j0 = t; j0 < n; j0 += kBatch * nt) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * nt;
      v[u] = j < n ? value(j) : T();
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int j = j0 + u * nt;
      if (j >= n || (cnt == k && !ahead(v[u], j, wv, wi))) continue;
      int r = cnt < k ? cnt : k - 1;                 // insert, the k-th dropping out
      while (r > 0 && ahead(v[u], j, lv[(r - 1) * nt + t], li[(r - 1) * nt + t])) {
        lv[r * nt + t] = lv[(r - 1) * nt + t];
        li[r * nt + t] = li[(r - 1) * nt + t];
        --r;
      }
      lv[r * nt + t] = v[u];
      li[r * nt + t] = j;
      if (cnt < k) ++cnt;
      if (cnt == k) {
        wv = lv[(k - 1) * nt + t];
        wi = li[(k - 1) * nt + t];
      }
    }
  }
  for (int r = cnt; r < kList; ++r) li[r * nt + t] = kNone;
  __syncthreads();
  topk_rounds<T>(SlotValue<T>{lv}, SlotKey{li}, kList * nt, k, out_idx, out_val);
}

}  // namespace uz_topk
