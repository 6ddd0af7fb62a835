// K13 grid_topk: the grid-adapted top-K of every pyramid level's score maps
// in one launch.
//
// Replaces uzliti_slam_tpu/ops/features.py:select_topk_grid (:114-156),
// which detect_and_describe calls once per pyramid level.  The reference
// crops the (H, W) scores to a multiple of the grid, takes approx_max_k (the
// TPU's PartialReduce) of each of the grid² cells, and then keeps the global
// top k_total of the cells' candidates with top_k when they are more than
// k_total, or pads with invalid slots when fewer.  On the CPU both of XLA's
// calls are exact; their ties go to the lower row-major index in the cell
// (top_k, and approx_max_k with k >= 2), except that approx_max_k with k = 1
// is a max reduction whose ties keep the last index.  Here the selection is
// exact and follows those tie rules.
//
// What bounds it on the card: the bytes — each score read once, 1.2 MB per
// camera at VGA level 0 and 2.6 MB over four levels (0.8 us at 3.35 TB/s).
//
// Design:
//   - The levels (score pointer and shape each) come by value in the kernel's
//     parameter struct (__grid_constant__, read in place), from a host table:
//     no device copy, and one launch for all levels and cameras.  Outputs
//     are (levels, C, k_total, ...), each level's block contiguous.
//   - grid_cells: one CTA per (cell, camera, level) reads its cell once per
//     pass of kKeep picks: each thread keeps its best kKeep in registers
//     (a sorted insertion, unrolled), then a bitonic merge of the lanes'
//     lists by butterfly shuffles and of the warps' lists in one warp.  The
//     order is "score descending, then index ascending" (descending for
//     k_cell = 1: the last tied index).  k_cell <= 8 takes one pass; a larger
//     k_cell takes passes of 8, each over the elements after the last pick.
//     The loads are unrolled four deep and the cell position is stepped, not
//     divided.
//   - The kernel writes every output slot: the padding slots (k_total above
//     the cells' grid²·k_cell) from the first cell's CTA; so the wrapper
//     allocates with torch.empty.
//   - grid_global (a second launch, only when grid²·k_cell > k_total): one
//     CTA per (camera, level); each candidate's rank under "key descending,
//     then candidate index ascending", key = score where > 0 else -1, is
//     counted against every other candidate, and ranks below k_total write
//     their slot.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 8;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Level {
  const float* score;   // (C, H, W)
  int H, W;
};

struct Levels {
  Level lv[kMaxLevels];
  int n_levels, C, grid, k_cell, k_total;
  float* uv;      // (levels, C, k_total, 2)
  float* resp;    // (levels, C, k_total)
  bool* valid;    // (levels, C, k_total)
  float* cand;    // (levels, C, grid²·k_cell, 3) when the global pass follows, else null
};

// a before b in the selection order
template <bool kLast>
__device__ __forceinline__ bool before(float va, int ea, float vb, int eb) {
  return va > vb || (va == vb && (kLast ? ea > eb : ea < eb));
}

// an empty slot, after every score
template <bool kLast>
__device__ __forceinline__ int empty_index() { return kLast ? -1 : INT_MAX; }

template <int kKeep, bool kLast>
__device__ __forceinline__ void insert(float x, int i, float (&v)[kKeep], int (&e)[kKeep]) {
  if (!before<kLast>(x, i, v[kKeep - 1], e[kKeep - 1])) return;
  bool moving = true;   // the candidate still goes above slot k
#pragma unroll
  for (int k = kKeep - 1; k > 0; --k) {
    if (!moving) continue;
    if (before<kLast>(x, i, v[k - 1], e[k - 1])) {
      v[k] = v[k - 1];
      e[k] = e[k - 1];
    } else {
      v[k] = x;
      e[k] = i;
      moving = false;
    }
  }
  if (moving) {
    v[0] = x;
    e[0] = i;
  }
}

// The best kKeep of two sorted lists (mine and the lane `off` away), sorted,
// in both lanes: the elementwise better of mine and the partner's reversed
// is a bitonic sequence holding the best kKeep; a bitonic merge sorts it.
template <int kKeep, bool kLast>
__device__ __forceinline__ void merge_lanes(float (&v)[kKeep], int (&e)[kKeep], int off) {
  float ov[kKeep];
  int oe[kKeep];
#pragma unroll
  for (int k = 0; k < kKeep; ++k) {
    ov[k] = __shfl_xor_sync(kFull, v[k], off);
    oe[k] = __shfl_xor_sync(kFull, e[k], off);
  }
#pragma unroll
  for (int k = 0; k < kKeep; ++k) {
    const int r = kKeep - 1 - k;
    if (before<kLast>(ov[r], oe[r], v[k], e[k])) {
      v[k] = ov[r];
      e[k] = oe[r];
    }
  }
#pragma unroll
  for (int stride = kKeep / 2; stride > 0; stride >>= 1) {
#pragma unroll
    for (int k = 0; k < kKeep; ++k) {
      if ((k & stride) == 0 && before<kLast>(v[k + stride], e[k + stride], v[k], e[k])) {
        const float tv = v[k];
        const int te = e[k];
        v[k] = v[k + stride];
        e[k] = e[k + stride];
        v[k + stride] = tv;
        e[k + stride] = te;
      }
    }
  }
}

template <int kKeep, bool kLast>
__device__ __forceinline__ void merge_warp(float (&v)[kKeep], int (&e)[kKeep]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) merge_lanes<kKeep, kLast>(v, e, off);
}

template <int kKeep, bool kLast>
__global__ void __launch_bounds__(kThreads) grid_cells(const __grid_constant__ Levels P) {
  __shared__ float s_v[kWarps][kKeep];
  __shared__ int s_e[kWarps][kKeep];
  __shared__ float pick_v;
  __shared__ int pick_e;
  const int cell = blockIdx.x, c = blockIdx.y, lvl = blockIdx.z;
  const Level L = P.lv[lvl];
  const int grid = P.grid, gh = L.H / grid, gw = L.W / grid, n = gh * gw;
  const int gy = cell / grid, gx = cell % grid;
  const float* base = L.score + static_cast<long long>(c) * L.H * L.W
                      + static_cast<long long>(gy * gh) * L.W + gx * gw;
  const int k_cell = P.k_cell, n_cand = grid * grid * k_cell;
  const long long out0 = static_cast<long long>(lvl * P.C + c) * P.k_total;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the stride's step in the cell: kThreads elements, row-major
  const int dy = kThreads / gw, dx = kThreads % gw;
  float pv = 0.f;
  int pe = 0;
  for (int done = 0; done < k_cell; done += kKeep) {
    float v[kKeep];
    int e[kKeep];
#pragma unroll
    for (int k = 0; k < kKeep; ++k) {
      v[k] = -__int_as_float(0x7f800000);
      e[k] = empty_index<kLast>();
    }
    int y = threadIdx.x / gw, x = threadIdx.x % gw;
    for (int el = threadIdx.x; el < n; el += kUnroll * kThreads) {
      float s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        s[u] = el + u * kThreads < n ? base[y * L.W + x] : 0.f;
        x += dx;
        y += dy;
        if (x >= gw) {
          x -= gw;
          ++y;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = el + u * kThreads;
        if (i < n && (done == 0 || before<kLast>(pv, pe, s[u], i)))
          insert<kKeep, kLast>(s[u], i, v, e);
      }
    }
    merge_warp<kKeep, kLast>(v, e);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kKeep; ++k) {
        s_v[warp][k] = v[k];
        s_e[warp][k] = e[k];
      }
    }
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < kKeep; ++k) {
        v[k] = lane < kWarps ? s_v[lane][k] : -__int_as_float(0x7f800000);
        e[k] = lane < kWarps ? s_e[lane][k] : empty_index<kLast>();
      }
      merge_warp<kKeep, kLast>(v, e);
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kKeep; ++k) {
          if (done + k >= k_cell) break;
          const int slot = cell * k_cell + done + k;
          const float px = static_cast<float>(gx * gw + e[k] % gw);
          const float py = static_cast<float>(gy * gh + e[k] / gw);
          if (P.cand != nullptr) {
            float* o = P.cand + ((static_cast<long long>(lvl) * P.C + c) * n_cand + slot) * 3;
            o[0] = v[k];
            o[1] = px;
            o[2] = py;
          } else {
            const long long o = out0 + slot;
            P.uv[2 * o] = px;
            P.uv[2 * o + 1] = py;
            P.resp[o] = v[k];
            P.valid[o] = v[k] > 0.f;
          }
        }
        pick_v = v[kKeep - 1];
        pick_e = e[kKeep - 1];
      }
    }
    __syncthreads();
    pv = pick_v;
    pe = pick_e;
  }
  // the padding slots past the cells' candidates
  if (P.cand == nullptr && cell == 0) {
    for (int k = n_cand + threadIdx.x; k < P.k_total; k += kThreads) {
      const long long o = out0 + k;
      P.uv[2 * o] = 0.f;
      P.uv[2 * o + 1] = 0.f;
      P.resp[o] = 0.f;
      P.valid[o] = false;
    }
  }
}

__global__ void __launch_bounds__(kThreads) grid_global(const __grid_constant__ Levels P) {
  const int c = blockIdx.x, lvl = blockIdx.y;
  const int n_cand = P.grid * P.grid * P.k_cell, k_total = P.k_total;
  const float* cc = P.cand + (static_cast<long long>(lvl) * P.C + c) * n_cand * 3;
  const long long out0 = static_cast<long long>(lvl * P.C + c) * k_total;
  for (int i = threadIdx.x; i < n_cand; i += kThreads) {
    const float vi = cc[3 * i];
    const float ki = vi > 0.f ? vi : -1.f;
    int rank = 0;
    for (int j = 0; j < n_cand; ++j) {
      const float vj = cc[3 * j];
      const float kj = vj > 0.f ? vj : -1.f;
      rank += (kj > ki || (kj == ki && j < i)) ? 1 : 0;
    }
    if (rank < k_total) {
      const long long o = out0 + rank;
      P.uv[2 * o] = cc[3 * i + 1];
      P.uv[2 * o + 1] = cc[3 * i + 2];
      P.resp[o] = ki;
      P.valid[o] = ki > 0.f;
    }
  }
}

template <int kKeep, bool kLast>
cudaError_t launch_cells(const Levels& P, cudaStream_t s) {
  grid_cells<kKeep, kLast><<<dim3(P.grid * P.grid, P.C, P.n_levels), kThreads, 0, s>>>(P);
  return cudaGetLastError();
}

}  // namespace

// levels: a host table of n_levels rows (score pointer, H, W) as 64-bit
// integers, each score (C, H, W) float32 with k_cell <= (H / grid)·(W /
// grid).  uv (levels, C, k_total, 2), resp and valid (levels, C, k_total),
// every slot written; cand (levels, C, grid²·k_cell, 3) scratch when
// grid²·k_cell > k_total (a second launch ranks the candidates), else null.
extern "C" int uz_grid_topk(const void* levels, int n_levels, int C, int grid, int k_cell,
                            int k_total, float* cand, float* uv, float* resp, bool* valid,
                            void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || grid < 1 || k_cell < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (C <= 0 || k_total <= 0) return 0;
  const long long* t = static_cast<const long long*>(levels);
  Levels P = {};
  for (int l = 0; l < n_levels; ++l) {
    P.lv[l].score = reinterpret_cast<const float*>(t[3 * l]);
    P.lv[l].H = static_cast<int>(t[3 * l + 1]);
    P.lv[l].W = static_cast<int>(t[3 * l + 2]);
    if (static_cast<long long>(P.lv[l].H / grid) * (P.lv[l].W / grid) < k_cell)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  P.n_levels = n_levels;
  P.C = C;
  P.grid = grid;
  P.k_cell = k_cell;
  P.k_total = k_total;
  P.uv = uv;
  P.resp = resp;
  P.valid = valid;
  P.cand = cand;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (k_cell == 1) err = launch_cells<1, true>(P, s);
  else if (k_cell == 2) err = launch_cells<2, false>(P, s);
  else if (k_cell <= 4) err = launch_cells<4, false>(P, s);
  else err = launch_cells<8, false>(P, s);
  if (err != cudaSuccess || cand == nullptr) return static_cast<int>(err);
  grid_global<<<dim3(C, n_levels), kThreads, 0, s>>>(P);
  return static_cast<int>(cudaGetLastError());
}
