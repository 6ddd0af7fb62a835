// K14 orb_describe: box blur, intensity-centroid orientation and steered
// 256-test binary descriptors of a batch of keypoints.
//
// Replaces uzliti_slam_tpu/ops/features.py:_sep_blur (:159-168),
// intensity_centroid_angles (:171-194) and brief_descriptors (:285-324),
// which the reference also runs for the whole-image GIST (binary_gist,
// :484-493: one keypoint at the centre of a 63x63 resize, the radius-25
// pattern, the roll as the angle).  The reference gathers every patch and
// every sample with linearised takes, then packs the (K, 256) bits.  Here:
//   - box_blur<2> (describe.cuh): a separable 5x5 box sum of each image with
//     zero padding, the row sum then the column sum, each added left to
//     right as the reference's reduce_window adds, then × fl(1/25); one
//     launch over (tiles, camera);
//   - describe: one warp per keypoint.  Without given angles the warp takes
//     the intensity-centroid angle (describe.cuh: the moments over the 15x15
//     disc of the UNBLURRED image, exact integers at level 0 of a uint8
//     image, and atan2; K29 takes the same angle from the same code).  Then
//     each lane makes tests j = lane + 32·w (w = 0..7): both points of the
//     pattern rotated by the angle, (c·px - s·py, s·px + c·py), added to the
//     keypoint, rounded half to even and clipped, sampled on the blurred
//     image; bit = a < b.  __ballot_sync packs word w, so word w's byte q
//     bit i is test 32w + 8q + i: the LSB-first layout of matching.pack_bits.
//     The rotation is written with __fmul_rn/__fadd_rn/__fsub_rn, so no
//     multiply-add is contracted and a sample on a .5 edge rounds as the
//     plain version's separately rounded products do.
//
// What bounds it on the card: at VGA level 0 the blur's bytes (1.2 MB in
// and out per camera: 0.73 us) — the keypoints' work is small (64 per level
// and camera, 512 samples each); the describe launch is one warp per
// keypoint, so it is latency-bound.
#include <cuda_runtime.h>

#include "describe.cuh"

namespace {

using uz_describe::kFull;
constexpr int kR = 2;                                    // blur radius
constexpr int kWarpsPerBlock = 4;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
describe(const float* __restrict__ img, const float* __restrict__ blurred, int C, int H, int W,
         const float* __restrict__ uv, int K, const float* __restrict__ pattern, int given,
         float* __restrict__ angles, unsigned* __restrict__ desc) {
  const int lane = threadIdx.x & 31;
  const long long kp = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (kp >= static_cast<long long>(C) * K) return;
  const long long c = kp / K;
  const long long plane = static_cast<long long>(H) * W;
  const float u = uv[2 * kp], v = uv[2 * kp + 1];
  float ang;
  if (given) {
    ang = angles[kp];
  } else {
    ang = uz_describe::centroid_angle(img + c * plane, H, W, u, v, lane);
    if (lane == 0) angles[kp] = ang;
  }
  const float ca = cosf(ang), sa = sinf(ang);
  const float* sm = blurred + c * plane;
  unsigned* out = desc + kp * 8;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const float* p = pattern + 4 * (32 * w + lane);   // (ax, ay, bx, by)
    float val[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float px = p[2 * q], py = p[2 * q + 1];
      const float rx = __fsub_rn(__fmul_rn(ca, px), __fmul_rn(sa, py));
      const float ry = __fadd_rn(__fmul_rn(sa, px), __fmul_rn(ca, py));
      const float sx = rintf(__fadd_rn(u, rx)), sy = rintf(__fadd_rn(v, ry));
      const int xi = static_cast<int>(fminf(fmaxf(sx, 0.f), static_cast<float>(W - 1)));
      const int yi = static_cast<int>(fminf(fmaxf(sy, 0.f), static_cast<float>(H - 1)));
      val[q] = sm[yi * W + xi];
    }
    const unsigned word = __ballot_sync(kFull, val[0] < val[1]);
    if (lane == w) out[w] = word;
  }
}

}  // namespace

// blurred (C, H, W) scratch; desc (C, K, 32) uint8 as (C, K, 8) words.
// given = 1: angles (C, K) are read; given = 0: they are written.
extern "C" int uz_orb_describe(const float* img, const float* uv, const float* pattern, int C,
                               int H, int W, int K, int given, float* blurred, float* angles,
                               unsigned* desc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C > 0 && H > 0 && W > 0) {
    const cudaError_t err = uz_describe::launch_box_blur<kR>(img, C, H, W, blurred, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long kps = static_cast<long long>(C) * K;
    if (kps > 0)
      describe<<<static_cast<unsigned>((kps + kWarpsPerBlock - 1) / kWarpsPerBlock),
                 32 * kWarpsPerBlock, 0, s>>>(img, blurred, C, H, W, uv, K, pattern, given,
                                              angles, desc);
  }
  return static_cast<int>(cudaGetLastError());
}
