// K13 grid_topk: the grid-adapted top-K of a batch of score maps.
//
// Replaces uzliti_slam_tpu/ops/features.py:select_topk_grid (:114-156).  The
// reference crops the (H, W) scores to a multiple of the grid, takes
// approx_max_k (the TPU's PartialReduce) of each of the grid² cells, and
// then keeps the global top k_total of the cells' candidates with top_k when
// they are more than k_total, or pads with invalid slots when fewer.  On the
// CPU both of XLA's calls are exact; their ties go to the lower row-major
// index in the cell (top_k, and approx_max_k with k >= 2), except that
// approx_max_k with k = 1 is a max reduction whose ties keep the last index.
// Here the selection is exact and follows those tie rules:
//   - cell_topk: one CTA per (cell, camera) selects its k_cell best in
//     k_cell rounds; a round is a strided scan of the cell (each thread
//     keeps its best element that comes after the previous round's pick in
//     the order "score descending, then index ascending" — descending for
//     k_cell = 1) and a warp-shuffle + shared-memory argmax;
//   - global_topk (only when grid²·k_cell > k_total): one CTA per camera;
//     each candidate's rank under "key descending, then candidate index
//     ascending", key = score where > 0 else -1, is counted against every
//     other candidate, and ranks below k_total write their slot.
// The outputs come zero-filled from the wrapper, which is the padding.
//
// What bounds it on the card: the bytes — each score read once, 1.2 MB per
// camera at VGA level 0 (0.37 us at 3.35 TB/s); the kernel reads each cell
// k_cell times (from L2 after the first round) with only grid² CTAs per
// camera in flight, so it is latency-bound far above that.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// a before b in the selection order
__device__ __forceinline__ bool before(float va, int ea, float vb, int eb, bool last_on_tie) {
  return va > vb || (va == vb && (last_on_tie ? ea > eb : ea < eb));
}

__global__ void __launch_bounds__(kThreads)
cell_topk(const float* __restrict__ score, int H, int W, int grid, int gh, int gw, int k_cell,
          int last_on_tie, int k_total, float* __restrict__ cand, float* __restrict__ uv,
          float* __restrict__ resp, bool* __restrict__ valid) {
  __shared__ float s_v[kWarps];
  __shared__ int s_e[kWarps];
  __shared__ float pick_v;
  __shared__ int pick_e;
  const int cell = blockIdx.x, c = blockIdx.y;
  const int gy = cell / grid, gx = cell % grid;
  const float* base = score + static_cast<long long>(c) * H * W
                      + static_cast<long long>(gy * gh) * W + gx * gw;
  const int n = gh * gw, n_cand = grid * grid * k_cell;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool last = last_on_tie != 0;
  float pv = 0.f;
  int pe = -1;   // the previous round's pick (none before round 0)
  for (int r = 0; r < k_cell; ++r) {
    float bv = 0.f;
    int be = -1;
    for (int e = threadIdx.x; e < n; e += kThreads) {
      const float v = base[(e / gw) * W + e % gw];
      if (pe >= 0 && !before(pv, pe, v, e, last)) continue;
      if (be < 0 || before(v, e, bv, be, last)) {
        bv = v;
        be = e;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(kFull, bv, off);
      const int oe = __shfl_down_sync(kFull, be, off);
      if (oe >= 0 && (be < 0 || before(ov, oe, bv, be, last))) {
        bv = ov;
        be = oe;
      }
    }
    if (lane == 0) {
      s_v[warp] = bv;
      s_e[warp] = be;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      bv = s_v[0];
      be = s_e[0];
      for (int w = 1; w < kWarps; ++w)
        if (s_e[w] >= 0 && (be < 0 || before(s_v[w], s_e[w], bv, be, last))) {
          bv = s_v[w];
          be = s_e[w];
        }
      pick_v = bv;
      pick_e = be;
      const int slot = cell * k_cell + r;
      const float x = static_cast<float>(gx * gw + be % gw);
      const float y = static_cast<float>(gy * gh + be / gw);
      if (cand != nullptr) {
        float* o = cand + (static_cast<long long>(c) * n_cand + slot) * 3;
        o[0] = bv;
        o[1] = x;
        o[2] = y;
      } else {
        const long long o = static_cast<long long>(c) * k_total + slot;
        uv[2 * o] = x;
        uv[2 * o + 1] = y;
        resp[o] = bv;
        valid[o] = bv > 0.f;
      }
    }
    __syncthreads();
    pv = pick_v;
    pe = pick_e;
  }
}

__global__ void __launch_bounds__(kThreads)
global_topk(const float* __restrict__ cand, int n_cand, int k_total, float* __restrict__ uv,
            float* __restrict__ resp, bool* __restrict__ valid) {
  const int c = blockIdx.x;
  const float* cc = cand + static_cast<long long>(c) * n_cand * 3;
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
      const long long o = static_cast<long long>(c) * k_total + rank;
      uv[2 * o] = cc[3 * i + 1];
      uv[2 * o + 1] = cc[3 * i + 2];
      resp[o] = ki;
      valid[o] = ki > 0.f;
    }
  }
}

}  // namespace

// uv (C, k_total, 2), resp (C, k_total), valid (C, k_total), zero-filled by
// the caller, from score (C, H, W); cand (C, grid²·k_cell, 3) scratch when
// grid²·k_cell > k_total, else null.
extern "C" int uz_grid_topk(const float* score, int C, int H, int W, int grid, int k_cell,
                            int k_total, float* cand, float* uv, float* resp, bool* valid,
                            void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gh = H / grid, gw = W / grid, n_cand = grid * grid * k_cell;
  if (C > 0 && gh > 0 && gw > 0) {
    cell_topk<<<dim3(grid * grid, C), kThreads, 0, s>>>(score, H, W, grid, gh, gw, k_cell,
                                                        k_cell == 1 ? 1 : 0, k_total, cand, uv,
                                                        resp, valid);
    if (cand != nullptr) {
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
      global_topk<<<C, kThreads, 0, s>>>(cand, n_cand, k_total, uv, resp, valid);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
