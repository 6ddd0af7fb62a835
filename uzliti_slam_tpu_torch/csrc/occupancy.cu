// K11 project_rays: scan evidence of a set of nodes, as log-odds on a grid.
//
// Replaces uzliti_slam_tpu/mapping/occupancy.py:_project_rays (:70-188) and,
// in the same pass, _mark_node_cells (:191-202).  The reference pins every
// node at the grid centre, where static tables give each cell's distance D,
// bearing bin bin0 and ray weight Wray, and moves the node's evidence plane
// to its true cell with one-hot shift matmuls (the TPU's matrix unit).  Here
// each output cell (r, c) gathers instead: for every active node, the
// centre-table cell (r - cy + c0, c - cx + c0) — outside [0, size)² it
// contributes nothing, exactly as the one-hot shifts drop it — reads the
// node's range at bin (bin0 - kbin) mod B (+inf and NaN read as 1e9, no
// return), and classifies itself as the reference does:
//   has  = rng < 5e8,   reach = min(rng, max_range)
//   free = has && D < reach - res
//   occ  = has && rng <= max_range && |D - rng| < 0.71·res
//   e    = Wray·(free·miss + occ·hit)
// The node terms are summed in double (each term is the float32 product the
// reference forms, so the sum differs from any float32 order only by that
// order's rounding), then the cell is clip(base + sum) to ±clamp; with
// `mark`, the node footprint marks (2·miss per active node whose own cell
// this is) are added and clipped again.
//
// Layout: one thread per cell, a CTA per 256 cells (one grid row at the
// default size).  The active nodes come as a compacted index list with a
// device-side count, so an incremental projection of 8 new nodes costs 8
// nodes and not N; their per-node scalars (slot, cx, cy, kbin) are staged
// in shared memory 256 at a time.  Threads of a CTA share the row, so the
// row test is uniform across a warp; neighbouring threads read neighbouring
// table entries, and the scans (N x B floats) are read through L1/L2.
//
// What bounds it on the card: the (cell, node) pairs — ~20 operations and
// four gathers each, 32.8M pairs for a 500-node rebuild of a 256² grid —
// not the bytes (the grid, tables and active scans are about 1.7 MB then).
#include <cuda_runtime.h>

namespace {

constexpr int kCells = 256;     // threads per CTA = nodes staged per round
constexpr float kBig = 1e9f;    // the reference's inf sentinel

__global__ void __launch_bounds__(kCells)
project_cells(const float* __restrict__ base, const float* __restrict__ Dt,
              const int* __restrict__ bin0, const float* __restrict__ Wray,
              const float* __restrict__ scans, int bins, const int* __restrict__ cx,
              const int* __restrict__ cy, const int* __restrict__ kbin,
              const int* __restrict__ idx, const int* __restrict__ count, int size, float res,
              float band, float max_range, float hit, float miss, float clampv, int mark,
              float mark_value, float* __restrict__ out) {
  __shared__ int s_node[kCells], s_cx[kCells], s_cy[kCells], s_k[kCells];
  const int cells = size * size;
  const int cell = blockIdx.x * kCells + threadIdx.x;
  const int r = cell / size, c = cell % size, c0 = size / 2;
  const int n = *count;
  double acc = 0.0;
  float marks = 0.f;
  bool marked = false;
  for (int j0 = 0; j0 < n; j0 += kCells) {
    __syncthreads();
    if (j0 + threadIdx.x < n) {
      const int node = idx[j0 + threadIdx.x];
      s_node[threadIdx.x] = node;
      s_cx[threadIdx.x] = cx[node];
      s_cy[threadIdx.x] = cy[node];
      s_k[threadIdx.x] = kbin[node];
    }
    __syncthreads();
    if (cell >= cells) continue;
    const int m = min(kCells, n - j0);
    for (int k = 0; k < m; ++k) {
      const int pr = r - s_cy[k] + c0, pc = c - s_cx[k] + c0;
      if (pr >= 0 && pr < size && pc >= 0 && pc < size) {
        const int q = pr * size + pc;
        const float d = Dt[q];
        int b = (bin0[q] - s_k[k]) % bins;
        if (b < 0) b += bins;
        float rng = scans[static_cast<long long>(s_node[k]) * bins + b];
        if (!isfinite(rng)) rng = kBig;
        const bool has = rng < kBig * 0.5f;
        const float reach = fminf(rng, max_range);
        const bool fr = has && (d < reach - res);
        const bool oc = has && (rng <= max_range) && (fabsf(d - rng) < band);
        const float e = __fmul_rn(Wray[q], (fr ? miss : 0.f) + (oc ? hit : 0.f));
        acc += static_cast<double>(e);
      }
      if (mark && s_cy[k] == r && s_cx[k] == c) {
        marks += mark_value;
        marked = true;
      }
    }
  }
  if (cell >= cells) return;
  float v = fminf(fmaxf(base[cell] + static_cast<float>(acc), -clampv), clampv);
  if (mark && marked) v = fminf(fmaxf(v + marks, -clampv), clampv);
  out[cell] = v;
}

}  // namespace

// out (size, size) = the projection of the `*count` nodes idx[0..count) on
// top of base; cx, cy, kbin indexed by node slot, scans (slots, bins).
extern "C" int uz_project_rays(const float* base, const float* D, const int* bin0, const float* Wray,
                               const float* scans, int bins, const int* cx, const int* cy,
                               const int* kbin, const int* idx, const int* count, int size,
                               float res, float band, float max_range, float hit, float miss,
                               float clampv, int mark, float mark_value, float* out,
                               void* stream) {
  const int cells = size * size;
  if (cells > 0)
    project_cells<<<(cells + kCells - 1) / kCells, kCells, 0, static_cast<cudaStream_t>(stream)>>>(
        base, D, bin0, Wray, scans, bins, cx, cy, kbin, idx, count, size, res, band, max_range, hit,
        miss, clampv, mark, mark_value, out);
  return static_cast<int>(cudaGetLastError());
}
