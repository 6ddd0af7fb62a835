// Pieces of the keypoint describers: the separable box blur K29
// sift_describe samples, and the intensity-centroid orientation of a
// keypoint, which K14 orb_describe and K29 share.
//
// box_blur<R>: a separable (2R+1)² box sum of each image with zero padding,
// the row sum then the column sum, each added left to right as the
// reference's reduce_window adds, then × fl(1/(2R+1)²)
// (uzliti_slam_tpu/ops/features.py:_sep_blur); one launch over (tiles,
// camera).  K29 blurs with R = 1; K14 takes its 5x5 sums on each
// keypoint's window instead (csrc/orb_describe.cu), in the same order.
//
// centroid_angle: called by the 32 lanes of one warp for one keypoint.  The
// moments m01 = Σ dy·I and m10 = Σ dx·I over the 15x15 patch of the
// UNBLURRED image whose origin is the keypoint's pixel less 7, clipped into
// the image, masked to the disc of radius 7 about the patch centre (exact
// integers at level 0 of a uint8 image), each lane a fixed strided share,
// then a fixed xor-shuffle tree, and atan2 — every lane returns the same
// angle (features.py:intensity_centroid_angles).
#pragma once

#include <cuda_runtime.h>

namespace uz_describe {
namespace {   // internal linkage: each source that includes this gets its own copy

constexpr int kTx = 32, kTy = 8;                          // blur tile
constexpr int kPatchR = 7, kPatch = 2 * kPatchR + 1;      // 15x15 moments patch
constexpr unsigned kFull = 0xFFFFFFFFu;

template <int R>
__global__ void __launch_bounds__(kTx * kTy)
box_blur(const float* __restrict__ img, int H, int W, float* __restrict__ out) {
  constexpr int kSw = kTx + 2 * R, kSh = kTy + 2 * R;
  constexpr float kScale = 1.f / static_cast<float>((2 * R + 1) * (2 * R + 1));
  __shared__ float tile[kSh][kSw];
  __shared__ float rows[kSh][kTx];
  const long long plane = static_cast<long long>(H) * W;
  const float* im = img + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  const int tid = threadIdx.y * kTx + threadIdx.x;
  for (int k = tid; k < kSh * kSw; k += kTx * kTy) {
    const int gy = y0 - R + k / kSw, gx = x0 - R + k % kSw;
    tile[k / kSw][k % kSw] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? im[gy * W + gx] : 0.f;
  }
  __syncthreads();
  // row sums of the tile's rows (rows outside the image stay 0: zero padding
  // of the row-summed image, as the reference's second reduce_window pads)
  for (int k = tid; k < kSh * kTx; k += kTx * kTy) {
    const int ly = k / kTx, lx = k % kTx;
    float s = tile[ly][lx];
#pragma unroll
    for (int i = 1; i < 2 * R + 1; ++i) s = __fadd_rn(s, tile[ly][lx + i]);
    rows[ly][lx] = s;
  }
  __syncthreads();
  const int gx = x0 + threadIdx.x, gy = y0 + threadIdx.y;
  if (gx >= W || gy >= H) return;
  float s = rows[threadIdx.y][threadIdx.x];
#pragma unroll
  for (int i = 1; i < 2 * R + 1; ++i) s = __fadd_rn(s, rows[threadIdx.y + i][threadIdx.x]);
  out[blockIdx.z * plane + gy * W + gx] = __fmul_rn(s, kScale);
}

template <int R>
cudaError_t launch_box_blur(const float* img, int C, int H, int W, float* out, cudaStream_t s) {
  box_blur<R><<<dim3((W + kTx - 1) / kTx, (H + kTy - 1) / kTy, C), dim3(kTx, kTy), 0, s>>>(
      img, H, W, out);
  return cudaGetLastError();
}

// The intensity-centroid angle of the keypoint (u, v) on the image im (H, W),
// by all 32 lanes of a warp.
__device__ __forceinline__ float centroid_angle(const float* __restrict__ im, int H, int W,
                                                float u, float v, int lane) {
  const int y0 = min(max(__float2int_rz(v) - kPatchR, 0), H - kPatch);
  const int x0 = min(max(__float2int_rz(u) - kPatchR, 0), W - kPatch);
  float m01 = 0.f, m10 = 0.f;
  for (int e = lane; e < kPatch * kPatch; e += 32) {
    const int i = e / kPatch, j = e % kPatch;
    const int dy = i - kPatchR, dx = j - kPatchR;
    if (dx * dx + dy * dy <= kPatchR * kPatchR) {
      const float p = im[(y0 + i) * W + x0 + j];
      m01 = __fadd_rn(m01, __fmul_rn(static_cast<float>(dy), p));
      m10 = __fadd_rn(m10, __fmul_rn(static_cast<float>(dx), p));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m01 = __fadd_rn(m01, __shfl_xor_sync(kFull, m01, off));
    m10 = __fadd_rn(m10, __shfl_xor_sync(kFull, m10, off));
  }
  return atan2f(m01, m10);
}

}  // namespace
}  // namespace uz_describe
