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
// A term is nonzero only where D < max_range + 0.71·res (free needs D <
// reach - res, occ |D - rng| < band with rng <= max_range), so a node
// reaches only the cells within R = ⌈(max_range + 0.71·res)/res⌉ + 1 of its
// own cell along either axis, and everything outside that box is exactly 0.
//
// Layout: a CTA per 16 x 16 tile of cells, G groups of 64 threads; a
// thread holds four cells of the tile (one column, rows 4 apart) with an
// accumulator each, and group g takes the tile's nodes g, g + G, ...; the G
// groups' sums are combined in a fixed order in shared memory.  G = 8 on a
// grid of fewer than 4 tiles an SM (the 256² default: 256 CTAs), so that an
// SM holds 32 warps, else 4 (measured, scripts/k8_k11_variants.py, device
// ms with 2 / 4 / 8 groups: 500-node rebuild 0.197 / 0.088 / 0.069, 10k
// nodes 3.14 / 1.48 / 1.24; on the 1024² covering grid 4 groups 0.555
// against 8 groups' 0.621: there each CTA stages all nodes, and more
// threads only add to that).  The active nodes (a compacted list with a
// device-side count) are staged one per thread a round: each thread tests
// its node's reach box against the tile and the survivors are compacted in
// list order (ballots and the warps' counts), so a tile pays only for the
// nodes that reach it and the incremental pass (8 new nodes) touches only
// the tiles near them; a node's own cell, where it falls in the tile,
// counts a mark.  The centre tables are one 16-byte entry a cell (D, bin0,
// Wray; kernels/ops.pack_center_tables), one 128-bit load a pair; kbin
// comes normalised to [0, B), so the bin is a subtraction and one
// conditional add; a node whose window lies inside the table skips the
// bounds tests (a warp-uniform branch).  (Measured: D and Wray from a
// quarter table by |dr|, |dc| in L1 and bin0 as int16, 2 bytes a pair from
// L2 in place of 16, was 15-20 % slower: the pairs' chains of latencies
// bound the kernel, not L2's bytes.)
//
// What bounds it on the card: the (cell, node) pairs within a node's reach
// — ~20 operations, a 16-byte table load and a scan gather each, ~21M for
// a 500-node rebuild of a 256² grid — not the bytes (the grid, tables and
// active scans, ~2 MB then).
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kTile = 16;              // cells a tile side
constexpr int kGroupThreads = 64;      // a group's threads: the tile's 256 cells, 4 a thread
constexpr int kGroupsFew = 8;          // node groups a CTA on a grid of few tiles
constexpr int kGroupsMany = 4;         // ... and on one of kTilesPerSm tiles an SM or more
constexpr int kTilesPerSm = 4;
constexpr int kNodeUnroll = 1;         // nodes a group takes at once
constexpr int kRowStride = kGroupThreads / kTile;   // 4: a thread's rows lie 4 apart
constexpr int kRowsPerThread = kTile / kRowStride;  // 4
constexpr int kMaxDevices = 16;
constexpr float kBig = 1e9f;           // the reference's inf sentinel

struct Params {
  const float* base;
  const float4* table;   // (size²) D, bin0 (int bits), Wray, 0
  const float* scans;    // (slots, bins)
  int bins;
  const int* cx;
  const int* cy;
  const int* kbin;       // in [0, bins)
  const int* idx;
  const int* count;
  int size, reach;
  float res, band, max_range, hit, miss, clampv, mark_value;
  int mark;
  float* out;
};

// one (cell, node) term: t the cell's table entry, k the node's kbin in [0, bins)
__device__ __forceinline__ float term(const Params& p, float4 t, const float* srow, int k) {
  int b = __float_as_int(t.y) - k;
  b += b < 0 ? p.bins : 0;
  float rng = srow[b];
  if (!isfinite(rng)) rng = kBig;
  const bool has = rng < kBig * 0.5f;
  const float reach = fminf(rng, p.max_range);
  const bool fr = has && (t.x < reach - p.res);
  const bool oc = has && (rng <= p.max_range) && (fabsf(t.x - rng) < p.band);
  return __fmul_rn(t.z, (fr ? p.miss : 0.f) + (oc ? p.hit : 0.f));
}

template <int kGroups>
__global__ void __launch_bounds__(kGroups * kGroupThreads) project_tiles(Params p) {
  constexpr int kThreads = kGroups * kGroupThreads;   // = nodes staged a round
  __shared__ int s_slot[kThreads], s_ox[kThreads], s_oy[kThreads], s_k[kThreads];
  __shared__ int s_marks[kTile * kTile];
  __shared__ int s_wcount[kThreads / 32];
  __shared__ double s_acc[kGroups][kTile * kTile];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles_x = (p.size + kTile - 1) / kTile;
  const int tr0 = (blockIdx.x / tiles_x) * kTile, tc0 = (blockIdx.x % tiles_x) * kTile;
  const int c0 = p.size / 2;
  const int g = tid / kGroupThreads, u = tid % kGroupThreads;
  const int col = u % kTile, row0 = u / kTile;
  const int n = *p.count;
  for (int c = tid; c < kTile * kTile; c += kThreads) s_marks[c] = 0;
  double acc[kRowsPerThread];
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j) acc[j] = 0.0;
  for (int j0 = 0; j0 < n; j0 += kThreads) {
    __syncthreads();
    // stage: this thread's node, if its reach box meets the tile
    bool keep = false;
    int slot = 0, x = 0, y = 0, k = 0;
    if (j0 + tid < n) {
      slot = p.idx[j0 + tid];
      x = p.cx[slot];
      y = p.cy[slot];
      k = p.kbin[slot];
      keep = x + p.reach >= tc0 && x - p.reach < tc0 + kTile && y + p.reach >= tr0 &&
             y - p.reach < tr0 + kTile;
      if (p.mark && x >= tc0 && x < tc0 + kTile && y >= tr0 && y < tr0 + kTile)
        atomicAdd(s_marks + (y - tr0) * kTile + (x - tc0), 1);
    }
    const unsigned ball = __ballot_sync(0xffffffffu, keep);
    if (lane == 0) s_wcount[warp] = __popc(ball);
    __syncthreads();
    int pos = __popc(ball & ((1u << lane) - 1u)), m = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
      pos += w < warp ? s_wcount[w] : 0;
      m += s_wcount[w];
    }
    if (keep) {
      s_slot[pos] = slot;
      s_ox[pos] = c0 - x + tc0;   // the table column of tile column 0
      s_oy[pos] = c0 - y + tr0;   // the table row of tile row 0
      s_k[pos] = k;
    }
    __syncthreads();
    for (int k0 = g; k0 < m; k0 += kGroups * kNodeUnroll) {
#pragma unroll
      for (int v = 0; v < kNodeUnroll; ++v) {
        const int kk = k0 + v * kGroups;
        if (kk >= m) break;
        const int ox = s_ox[kk], oy = s_oy[kk], kb = s_k[kk];
        const float* srow = p.scans + static_cast<long long>(s_slot[kk]) * p.bins;
        const int pc = ox + col;
        const long long q0 = static_cast<long long>(oy + row0) * p.size + pc;
        const bool inside = ox >= 0 && ox + kTile <= p.size && oy >= 0 && oy + kTile <= p.size;
        if (inside) {
          float4 t[kRowsPerThread];
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j)
            t[j] = p.table[q0 + static_cast<long long>(kRowStride * j) * p.size];
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j)
            acc[j] += static_cast<double>(term(p, t[j], srow, kb));
        } else {
#pragma unroll
          for (int j = 0; j < kRowsPerThread; ++j) {
            const int pr = oy + row0 + kRowStride * j;
            if (static_cast<unsigned>(pr) < static_cast<unsigned>(p.size) &&
                static_cast<unsigned>(pc) < static_cast<unsigned>(p.size))
              acc[j] += static_cast<double>(term(
                  p, p.table[q0 + static_cast<long long>(kRowStride * j) * p.size], srow, kb));
          }
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRowsPerThread; ++j)
    s_acc[g][(row0 + kRowStride * j) * kTile + col] = acc[j];
  __syncthreads();
  // the groups' sums of a cell in a fixed order, the clip, the marks
  for (int t = tid; t < kTile * kTile; t += kThreads) {
    const int r = tr0 + t / kTile, c = tc0 + t % kTile;
    if (r >= p.size || c >= p.size) continue;
    double sum = s_acc[0][t];
#pragma unroll
    for (int h = 1; h < kGroups; ++h) sum += s_acc[h][t];
    const long long cell = static_cast<long long>(r) * p.size + c;
    float v = fminf(fmaxf(p.base[cell] + static_cast<float>(sum), -p.clampv), p.clampv);
    const int marks = s_marks[t];
    if (marks > 0) {
      float add = 0.f;
      for (int i = 0; i < marks; ++i) add += p.mark_value;
      v = fminf(fmaxf(v + add, -p.clampv), p.clampv);
    }
    p.out[cell] = v;
  }
}

}  // namespace

// out (size, size) = the projection of the `*count` nodes idx[0..count) on
// top of base; cx, cy, kbin (in [0, bins)) indexed by node slot, scans
// (slots, bins); table (size²) float4 rows (D, bin0 bits, Wray, 0).
extern "C" int uz_project_rays(const float* base, const void* table, const float* scans, int bins,
                               const int* cx, const int* cy, const int* kbin, const int* idx,
                               const int* count, int size, float res, float band,
                               float max_range, float hit, float miss, float clampv, int mark,
                               float mark_value, float* out, void* stream) {
  if (size <= 0) return 0;
  if (bins <= 0 || res <= 0.f) return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.base = base;
  p.table = static_cast<const float4*>(table);
  p.scans = scans;
  p.bins = bins;
  p.cx = cx;
  p.cy = cy;
  p.kbin = kbin;
  p.idx = idx;
  p.count = count;
  p.size = size;
  // the reach box's half-width in cells, with a cell to spare for the
  // float32 tables' rounding
  const double cells = static_cast<double>(max_range + band) / res;
  p.reach = cells < 2.0 * size ? static_cast<int>(std::ceil(cells)) + 1 : 2 * size;
  p.res = res;
  p.band = band;
  p.max_range = max_range;
  p.hit = hit;
  p.miss = miss;
  p.clampv = clampv;
  p.mark = mark;
  p.mark_value = mark_value;
  p.out = out;
  const int tiles = (size + kTile - 1) / kTile;
  // few tiles (the 256² default: 256 CTAs) leave SMs short of warps, so
  // each CTA takes more node groups; many tiles (a covering grid) fill the
  // card as they are, and each CTA's staging of every node stays cheap
  static int sms[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0 &&
      cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tiles * tiles < kTilesPerSm * sms[dev])
    project_tiles<kGroupsFew><<<tiles * tiles, kGroupsFew * kGroupThreads, 0, s>>>(p);
  else
    project_tiles<kGroupsMany><<<tiles * tiles, kGroupsMany * kGroupThreads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
