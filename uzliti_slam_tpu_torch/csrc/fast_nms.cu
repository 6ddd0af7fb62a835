// K12 fast_nms: FAST-9/16 corner scores with the 3x3 non-maximum suppression
// fused, for a batch of images (one pyramid level of every camera).
//
// Replaces uzliti_slam_tpu/ops/features.py:fast_score (:54-102) and nms
// (:105-111).  The reference builds 16 zero-padded shifted copies of the
// image, tests "9 contiguous" with AND-doubling over the ring axis, sums the
// brighter and darker differences, masks a border of 21 px and suppresses
// with a 3x3 reduce_window max.  Here one thread per pixel works on a
// shared-memory tile with a halo of 4 (3 for the ring, 1 for the NMS):
//   - the 16 ring tests of a pixel become two 16-bit masks (brighter,
//     darker); a run of 9 with wrap-around is the same AND-doubling done on
//     the mask doubled onto itself (bits i..i+8 of m | m << 16);
//   - score = max(Σ (d - t) over brighter, Σ (-d - t) over darker), with
//     d = ring - centre, summed in ring order 0..15 (the plain version sums
//     in the same order, so the two agree bit for bit at every level; the
//     reference's order may differ off level 0, where scores of a uint8
//     image are exact integers);
//   - a pixel is 0 unless it is a corner inside [21, H-21) x [21, W-21);
//   - the scores of the tile plus a ring of 1 are kept in shared memory and
//     a pixel survives where it equals the 3x3 maximum and is > 0, so every
//     pixel of a plateau survives, as the reference's `score == pooled`.
// The ring sample of pixel (y, x) at offset (dy, dx) is img[y - dy, x - dx],
// the reference's shift direction (the score does not depend on it).
//
// What bounds it on the card: the bytes at VGA (1.2 MB in, 1.2 MB out per
// camera at level 0: 0.7 us at 3.35 TB/s) against ~150 operations a pixel
// (46 MFLOP: 0.7 us at 67 TFLOP/s) — the two are even; the tile is read
// from device memory once (2.5 loads per pixel with the halo) and the
// scores never leave shared memory before the NMS.
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32, kTy = 8;                   // output tile, one thread a pixel
constexpr int kRing = 3, kHalo = kRing + 1;
constexpr int kSw = kTx + 2 * kHalo, kSh = kTy + 2 * kHalo;   // image tile 40 x 16
constexpr int kCw = kTx + 2, kCh = kTy + 2;                   // score tile 34 x 10
constexpr int kBorder = 21;

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

// score of the pixel at tile coordinates (ty, tx)
__device__ __forceinline__ float fast_one(const float (*tile)[kSw], int ty, int tx, float t) {
  const float v = tile[ty][tx];
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

__global__ void __launch_bounds__(kTx * kTy)
fast_nms_tile(const float* __restrict__ img, int H, int W, float t, float* __restrict__ out) {
  __shared__ float tile[kSh][kSw];
  __shared__ float score[kCh][kCw];
  const long long plane = static_cast<long long>(H) * W;
  const float* im = img + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  const int tid = threadIdx.y * kTx + threadIdx.x;
  for (int k = tid; k < kSh * kSw; k += kTx * kTy) {
    const int gy = y0 - kHalo + k / kSw, gx = x0 - kHalo + k % kSw;
    tile[k / kSw][k % kSw] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? im[gy * W + gx] : 0.f;
  }
  __syncthreads();
  for (int k = tid; k < kCh * kCw; k += kTx * kTy) {
    const int ly = k / kCw, lx = k % kCw;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    const bool interior = gy >= kBorder && gy < H - kBorder && gx >= kBorder && gx < W - kBorder;
    score[ly][lx] = interior ? fast_one(tile, ly + kRing, lx + kRing, t) : 0.f;
  }
  __syncthreads();
  const int gx = x0 + threadIdx.x, gy = y0 + threadIdx.y;
  if (gx >= W || gy >= H) return;
  const float s = score[threadIdx.y + 1][threadIdx.x + 1];
  float m = s;
#pragma unroll
  for (int dy = 0; dy < 3; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) m = fmaxf(m, score[threadIdx.y + dy][threadIdx.x + dx]);
  out[blockIdx.z * plane + gy * W + gx] = (s == m && s > 0.f) ? s : 0.f;
}

}  // namespace

// out (C, H, W) = nms(fast_score(img, t)) of img (C, H, W), float32.
extern "C" int uz_fast_nms(const float* img, int C, int H, int W, float t, float* out,
                           void* stream) {
  if (C > 0 && H > 0 && W > 0) {
    const dim3 grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy, C);
    fast_nms_tile<<<grid, dim3(kTx, kTy), 0, static_cast<cudaStream_t>(stream)>>>(img, H, W, t,
                                                                                 out);
  }
  return static_cast<int>(cudaGetLastError());
}
