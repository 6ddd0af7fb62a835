// K29 sift_describe: intensity-centroid orientation and 128-float SIFT-family
// descriptors of a batch of keypoints.
//
// Replaces uzliti_slam_tpu/ops/features.py:sift_descriptors (:413-481) with
// the orientation the reference computes before it,
// intensity_centroid_angles (:171-194, called at :367), and the radius-1
// _sep_blur (:159-168, called at :435).  The reference gathers every
// keypoint's rotated 18x18 grid in one take, takes central differences,
// bins them by one-hot einsums into a (K, 16, 16, 8) tensor and sums 4x4
// blocks of it.  Here:
//   - box_blur<1> (describe.cuh): the separable 3x3 box sum, × fl(1/9);
//     one launch over (tiles, camera);
//   - sift_keypoints: one warp per keypoint.  The warp takes the
//     intensity-centroid angle on the UNBLURRED image (describe.cuh, the
//     code K14 runs, so the angle is K14's), then gathers the rotated
//     18x18 grid dx, dy ∈ {-8.5, ..., 8.5} into shared memory: the sample
//     at u + (c·dx - s·dy), v + (s·dx + c·dy), clipped into the image and
//     rounded half to even (rintf), read from the blurred image.  The
//     rotation is written with __fmul_rn/__fadd_rn/__fsub_rn: the compiled
//     reference does not contract it into a multiply-add, and a sample on a
//     .5 edge must round as its separately rounded products do.
//     Lane l owns half of spatial cell c = l / 2: sample rows 4·cy + 2·(l%2)
//     and + 1, columns 4·cx .. 4·cx + 3 (8 samples).  Per sample: central
//     differences g = (0.5·(P[i+1][j+2] - P[i+1][j]), 0.5·(P[i+2][j+1] -
//     P[i][j+1])), magnitude sqrt(gx² + gy² + 1e-12) times the Gaussian
//     window (built on the host by the reference's formula, :458-460, and
//     passed in), orientation atan2(gy, gx), t = (θ + π)·(8 / 2π), and the
//     soft vote (1 - frac)·m to bin ⌊t⌋ mod 8 and frac·m to the next.  The
//     8 bins sit in registers (selected by unrolled compares, no local
//     memory), summed over the lane's samples in order, then with the
//     other lane of the cell (one xor shuffle: both lanes get the same
//     sum).  Lane l writes descriptor entries 4l .. 4l + 3 (cell l / 2, bins
//     4·(l%2) ..), the reference's (cy, cx, bin) order.  Then unit L2,
//     a clip at 0.2 and unit L2 again, each norm a fixed xor-shuffle tree.
//   No atomics: the same inputs give the same bits.
//
// What bounds it on the card: the blur's bytes at level 0 (1.2 MB in and
// out per camera: 0.37 us at 3.35 TB/s); the keypoints' work is 75 per level
// and camera, 256 gradient samples each with an atan2 and a sqrt — one warp
// per keypoint, so the describe launch is latency-bound at these counts.
#include <cuda_runtime.h>

#include "describe.cuh"

namespace {

using uz_describe::kFull;
constexpr int kR = 1;                     // blur radius (features.py:435)
constexpr int kG = 16;                    // sample grid
constexpr int kS = kG + 2;                // with its one-sample halo
constexpr int kBins = 8;
constexpr int kWarpsPerBlock = 4;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
sift_keypoints(const float* __restrict__ img, const float* __restrict__ blurred, int C, int H,
               int W, const float* __restrict__ uv, int K, const float* __restrict__ window,
               float* __restrict__ angles, float* __restrict__ desc) {
  __shared__ float patch[kWarpsPerBlock][kS * kS];
  __shared__ float win[kG * kG];
  for (int e = threadIdx.x; e < kG * kG; e += blockDim.x) win[e] = window[e];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long kp = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp;
  if (kp >= static_cast<long long>(C) * K) return;
  const long long c = kp / K;
  const long long plane = static_cast<long long>(H) * W;
  const float u = uv[2 * kp], v = uv[2 * kp + 1];
  const float ang = uz_describe::centroid_angle(img + c * plane, H, W, u, v, lane);
  if (lane == 0) angles[kp] = ang;
  const float ca = cosf(ang), sa = sinf(ang);
  const float* sm = blurred + c * plane;
  float* P = patch[warp];
  const float wmax = static_cast<float>(W - 1), hmax = static_cast<float>(H - 1);
  for (int e = lane; e < kS * kS; e += 32) {
    const float dy = static_cast<float>(e / kS) - 8.5f, dx = static_cast<float>(e % kS) - 8.5f;
    const float rx = __fsub_rn(__fmul_rn(ca, dx), __fmul_rn(sa, dy));
    const float ry = __fadd_rn(__fmul_rn(sa, dx), __fmul_rn(ca, dy));
    const float sx = fminf(fmaxf(__fadd_rn(u, rx), 0.f), wmax);
    const float sy = fminf(fmaxf(__fadd_rn(v, ry), 0.f), hmax);
    P[e] = sm[static_cast<int>(rintf(sy)) * W + static_cast<int>(rintf(sx))];
  }
  __syncwarp();

  const int cell = lane >> 1, half = lane & 1;
  const int cy = cell >> 2, cx = cell & 3;
  const float kPi = 3.14159265358979323846f;
  const float kBinScale = static_cast<float>(kBins / (2.0 * 3.14159265358979323846));
  float hist[kBins];
#pragma unroll
  for (int b = 0; b < kBins; ++b) hist[b] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = 4 * cy + 2 * half + r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = 4 * cx + q;
      const float gx = __fmul_rn(0.5f, __fsub_rn(P[(i + 1) * kS + j + 2], P[(i + 1) * kS + j]));
      const float gy = __fmul_rn(0.5f, __fsub_rn(P[(i + 2) * kS + j + 1], P[i * kS + j + 1]));
      const float mag = sqrtf(__fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)), 1e-12f));
      const float m = __fmul_rn(mag, win[i * kG + j]);
      const float t = __fmul_rn(__fadd_rn(atan2f(gy, gx), kPi), kBinScale);
      const float ft = floorf(t);
      const float frac = __fsub_rn(t, ft);
      const int b0 = static_cast<int>(ft) & (kBins - 1);   // t ∈ [0, 8]: ⌊t⌋ mod 8
      const int b1 = (b0 + 1) & (kBins - 1);
      const float w0 = __fmul_rn(__fsub_rn(1.f, frac), m), w1 = __fmul_rn(frac, m);
#pragma unroll
      for (int b = 0; b < kBins; ++b) {
        if (b == b0) hist[b] = __fadd_rn(hist[b], w0);
        if (b == b1) hist[b] = __fadd_rn(hist[b], w1);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < kBins; ++b) hist[b] = __fadd_rn(hist[b], __shfl_xor_sync(kFull, hist[b], 1));
  float d[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) d[k] = half ? hist[4 + k] : hist[k];
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) ss = __fadd_rn(ss, __fmul_rn(d[k], d[k]));
  const float n1 = __fadd_rn(sqrtf(warp_sum(ss)), 1e-8f);
  ss = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    d[k] = fminf(__fdiv_rn(d[k], n1), 0.2f);
    ss = __fadd_rn(ss, __fmul_rn(d[k], d[k]));
  }
  const float n2 = __fadd_rn(sqrtf(warp_sum(ss)), 1e-8f);
  float4 o;
  o.x = __fdiv_rn(d[0], n2);
  o.y = __fdiv_rn(d[1], n2);
  o.z = __fdiv_rn(d[2], n2);
  o.w = __fdiv_rn(d[3], n2);
  reinterpret_cast<float4*>(desc + kp * 128)[lane] = o;
}

}  // namespace

// img (C, H, W) float32; uv (C, K, 2); window (16, 16) float32; blurred
// (C, H, W) scratch.  Out: angles (C, K), desc (C, K, 128) float32.
extern "C" int uz_sift_describe(const float* img, const float* uv, const float* window, int C,
                                int H, int W, int K, float* blurred, float* angles, float* desc,
                                void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || H <= 0 || W <= 0) return 0;
  const cudaError_t err = uz_describe::launch_box_blur<kR>(img, C, H, W, blurred, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long kps = static_cast<long long>(C) * K;
  if (kps > 0)
    sift_keypoints<<<static_cast<unsigned>((kps + kWarpsPerBlock - 1) / kWarpsPerBlock),
                     32 * kWarpsPerBlock, 0, s>>>(img, blurred, C, H, W, uv, K, window, angles,
                                                  desc);
  return static_cast<int>(cudaGetLastError());
}
