// K12 fast_nms: FAST-9/16 corner scores with the 3x3 non-maximum suppression
// fused, for every pyramid level of every camera in one launch.
//
// Replaces uzliti_slam_tpu/ops/features.py:fast_score (:54-102) and nms
// (:105-111), which detect_and_describe calls once per pyramid level.  The
// reference builds 16 zero-padded shifted copies of the image, tests "9
// contiguous" with AND-doubling over the ring axis, sums the brighter and
// darker differences, masks a border of 21 px and suppresses with a 3x3
// reduce_window max.  Here:
//   - the 16 ring tests of a pixel become two 16-bit masks (brighter,
//     darker); a run of 9 with wrap-around is the same AND-doubling done on
//     the mask doubled onto itself (bits i..i+8 of m | m << 16);
//   - score = max(Σ (d - t) over brighter, Σ (-d - t) over darker), with
//     d = ring - centre, summed in ring order 0..15 (the plain version sums
//     in the same order, so the two agree bit for bit at every level; the
//     reference's order may differ off level 0, where scores of a uint8
//     image are exact integers);
//   - an exact early rejection: any 9 contiguous ring positions hold two of
//     the compass positions {0, 4, 8, 12}, so a pixel with fewer than two
//     compass pixels brighter than centre + t and fewer than two darker than
//     centre - t is no corner, and its 16-tap sums are skipped (the same
//     float compares, so the bits do not change);
//   - a pixel is 0 unless it is a corner inside [21, H-21) x [21, W-21) of
//     its own level;
//   - the scores of the tile plus a ring of 1 are kept in shared memory and
//     a pixel survives where it equals the 3x3 maximum and is > 0, so every
//     pixel of a plateau survives, as the reference's `score == pooled`.
// The ring sample of pixel (y, x) at offset (dy, dx) is img[y - dy, x - dx],
// the reference's shift direction (the score does not depend on it).
//
// What bounds it on the card: the bytes at VGA (1.2 MB in, 1.2 MB out per
// camera at level 0, 6.2 MB over four levels: 1.8 us at 3.35 TB/s) against
// ~100 operations a pixel that runs the full ring.
//
// Design: the levels (image and output pointers, H, W, their first tile in
// the flat grid) come by value in the kernel's parameter struct
// (__grid_constant__) from a host table, so one launch covers every level
// and camera and the smallest level does not run alone in a sub-wave grid.
// A CTA of 256 threads takes a 32 x 32 output tile: it loads the 40 x 40
// image tile once (1.56 loads a pixel; 128-bit loads where the level's
// width and pointer allow), scores the 34 x 34 ring of the tile, and each
// thread suppresses four consecutive rows of one column from a 3 x 6 window
// of scores held in registers.  __launch_bounds__ asks for 6 CTAs an SM (40
// registers, no spill): at the 56 registers the compiler takes unasked, 4
// fit, and a one-camera keyframe's 783 tiles need two waves.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32, kTileY = 32;            // output tile
constexpr int kThreadsX = 32, kThreadsY = 8;
constexpr int kThreads = kThreadsX * kThreadsY;
constexpr int kRowsPerThread = kTileY / kThreadsY; // the NMS: consecutive rows a thread
constexpr int kRing = 3, kHalo = kRing + 1;
constexpr int kSw = kTileX + 2 * kHalo, kSh = kTileY + 2 * kHalo;   // image tile 40 x 40
constexpr int kCw = kTileX + 2, kCh = kTileY + 2;                   // score tile 34 x 34
constexpr int kMinBlocks = 6;                      // CTAs an SM: at most 40 registers
constexpr int kBorder = 21;
constexpr int kMaxLevels = 8;
constexpr bool kEarlyReject = true;

struct Level {
  const float* img;   // (C, H, W)
  float* out;         // (C, H, W)
  int H, W;
  int tiles_x, tiles_y;
  int first;          // the level's first CTA in the flat grid
  int vec;            // 128-bit loads: W % 4 == 0 and img 16-byte aligned
};

struct Levels {
  Level lv[kMaxLevels];
  int n_levels;
  float t;
};

// the reference's _FAST_OFFSETS, (dy, dx), clockwise
__constant__ int kDy[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kDx[16] = {3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1, 0, 1, 2, 3};

__device__ __forceinline__ bool run_of_9(unsigned m) {
  const unsigned d = m | (m << 16);
  unsigned a = d & (d >> 1);     // runs of 2
  a &= a >> 2;                   // runs of 4
  a &= a >> 4;                   // runs of 8
  a &= d >> 8;                   // runs of 9
  return (a & 0xFFFFu) != 0u;
}

// score of the pixel at image-tile coordinates (ty, tx)
__device__ __forceinline__ float fast_one(const float (*tile)[kSw], int ty, int tx, float t) {
  const float v = tile[ty][tx];
  if (kEarlyReject) {
    // ring positions 0, 4, 8, 12: offsets (0, 3), (3, 0), (0, -3), (-3, 0)
    const float c0 = __fsub_rn(tile[ty][tx - 3], v), c4 = __fsub_rn(tile[ty - 3][tx], v);
    const float c8 = __fsub_rn(tile[ty][tx + 3], v), c12 = __fsub_rn(tile[ty + 3][tx], v);
    const int nb = (c0 > t) + (c4 > t) + (c8 > t) + (c12 > t);
    const int nd = (c0 < -t) + (c4 < -t) + (c8 < -t) + (c12 < -t);
    if (nb < 2 && nd < 2) return 0.f;
  }
  unsigned bm = 0u, dm = 0u;
  float sb = 0.f, sd = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float d = __fsub_rn(tile[ty - kDy[i]][tx - kDx[i]], v);
    if (d > t) {
      bm |= 1u << i;
      sb = __fadd_rn(sb, __fsub_rn(d, t));
    }
    if (d < -t) {
      dm |= 1u << i;
      sd = __fadd_rn(sd, __fsub_rn(-d, t));
    }
  }
  return (run_of_9(bm) || run_of_9(dm)) ? fmaxf(sb, sd) : 0.f;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
fast_nms_levels(const __grid_constant__ Levels P) {
  __shared__ __align__(16) float tile[kSh][kSw];
  __shared__ float score[kCh][kCw];
  int lvl = 0;
  while (lvl + 1 < P.n_levels && static_cast<int>(blockIdx.x) >= P.lv[lvl + 1].first) ++lvl;
  const Level& L = P.lv[lvl];
  const int H = L.H, W = L.W;
  int b = static_cast<int>(blockIdx.x) - L.first;
  const int per_cam = L.tiles_x * L.tiles_y;
  const int cam = b / per_cam;
  b -= cam * per_cam;
  const int by = b / L.tiles_x, bx = b - by * L.tiles_x;
  const int x0 = bx * kTileX, y0 = by * kTileY;
  const long long plane = static_cast<long long>(H) * W;
  const float* im = L.img + cam * plane;
  const int tid = threadIdx.y * kThreadsX + threadIdx.x;
  if (L.vec) {
    // x0 - kHalo and W are multiples of 4: a float4 lies wholly in or out
    constexpr int kQ = kSw / 4;
    for (int k = tid; k < kSh * kQ; k += kThreads) {
      const int ly = k / kQ, lq = k - ly * kQ;
      const int gy = y0 - kHalo + ly, gx = x0 - kHalo + 4 * lq;
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        q = *reinterpret_cast<const float4*>(im + static_cast<long long>(gy) * W + gx);
      *reinterpret_cast<float4*>(&tile[ly][4 * lq]) = q;
    }
  } else {
    for (int k = tid; k < kSh * kSw; k += kThreads) {
      const int ly = k / kSw, lx = k - ly * kSw;
      const int gy = y0 - kHalo + ly, gx = x0 - kHalo + lx;
      tile[ly][lx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                         ? im[static_cast<long long>(gy) * W + gx] : 0.f;
    }
  }
  __syncthreads();
  for (int k = tid; k < kCh * kCw; k += kThreads) {
    const int ly = k / kCw, lx = k - ly * kCw;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    const bool interior = gy >= kBorder && gy < H - kBorder && gx >= kBorder && gx < W - kBorder;
    score[ly][lx] = interior ? fast_one(tile, ly + kRing, lx + kRing, P.t) : 0.f;
  }
  __syncthreads();
  // rows r0 .. r0 + 3 of column x: the 3 x 6 window of scores around them
  const int x = threadIdx.x, r0 = threadIdx.y * kRowsPerThread;
  const int gx = x0 + x;
  if (gx >= W) return;
  float col[kRowsPerThread + 2];
#pragma unroll
  for (int r = 0; r < kRowsPerThread + 2; ++r)
    col[r] = fmaxf(fmaxf(score[r0 + r][x], score[r0 + r][x + 1]), score[r0 + r][x + 2]);
  float* out = L.out + cam * plane;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int gy = y0 + r0 + r;
    if (gy >= H) break;
    const float s = score[r0 + r + 1][x + 1];
    const float m = fmaxf(fmaxf(col[r], col[r + 1]), col[r + 2]);
    out[static_cast<long long>(gy) * W + gx] = (s == m && s > 0.f) ? s : 0.f;
  }
}

}  // namespace

// levels: a host table of n_levels rows (img pointer, out pointer, H, W) as
// 64-bit integers, each img and out (C, H, W) float32: out = nms(fast_score(
// img, t)) of every level in one launch.
extern "C" int uz_fast_nms_levels(const void* levels, int n_levels, int C, float t,
                                  void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || C < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* tb = static_cast<const long long*>(levels);
  Levels P = {};
  long long ctas = 0;
  for (int l = 0; l < n_levels; ++l) {
    Level& L = P.lv[l];
    L.img = reinterpret_cast<const float*>(tb[4 * l]);
    L.out = reinterpret_cast<float*>(tb[4 * l + 1]);
    L.H = static_cast<int>(tb[4 * l + 2]);
    L.W = static_cast<int>(tb[4 * l + 3]);
    if (L.H < 0 || L.W < 0) return static_cast<int>(cudaErrorInvalidValue);
    L.tiles_x = (L.W + kTileX - 1) / kTileX;
    L.tiles_y = (L.H + kTileY - 1) / kTileY;
    L.first = static_cast<int>(ctas);
    L.vec = (L.W % 4 == 0 && tb[4 * l] % 16 == 0) ? 1 : 0;
    ctas += static_cast<long long>(C) * L.tiles_x * L.tiles_y;
    if (ctas > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  }
  // a level without tiles (no camera or no pixel) is never found: the
  // search for a CTA's level skips a level whose first tile is the next's
  P.n_levels = n_levels;
  P.t = t;
  if (ctas == 0) return 0;
  fast_nms_levels<<<static_cast<unsigned>(ctas), dim3(kThreadsX, kThreadsY), 0,
                    static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
