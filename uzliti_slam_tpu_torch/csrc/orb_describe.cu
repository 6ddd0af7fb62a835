// K14 orb_describe: box blur, intensity-centroid orientation and steered
// 256-test binary descriptors of a batch of keypoints.
//
// Replaces uzliti_slam_tpu/ops/features.py:_sep_blur (:159-168),
// intensity_centroid_angles (:171-194) and brief_descriptors (:285-324),
// which the reference also runs for the whole-image GIST (binary_gist,
// :484-493: one keypoint at the centre of a 63x63 resize, the radius-25
// pattern, the roll as the angle).  The reference gathers every patch and
// every sample with linearised takes, then packs the (K, 256) bits.  Here:
//   - box_blur: a separable 5x5 box sum of each image with zero padding,
//     the row sum then the column sum, each added left to right as the
//     reference's reduce_window adds, then × fl(1/25); one launch over
//     (tiles, camera);
//   - describe: one warp per keypoint.  Without given angles the warp sums
//     the moments m01 = Σ dy·I and m10 = Σ dx·I over the 15x15 patch of the
//     UNBLURRED image whose origin is the keypoint's pixel less 7, clipped
//     into the image, masked to the disc of radius 7 about the patch centre
//     (exact integers at level 0 of a uint8 image), and takes atan2.  Then
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

namespace {

constexpr int kTx = 32, kTy = 8, kR = 2;                 // blur tile and radius
constexpr int kWarpsPerBlock = 4;
constexpr int kPatchR = 7, kPatch = 2 * kPatchR + 1;     // 15x15 moments patch
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kTx * kTy)
box_blur(const float* __restrict__ img, int H, int W, float* __restrict__ out) {
  __shared__ float tile[kTy + 2 * kR][kTx + 2 * kR];
  __shared__ float rows[kTy + 2 * kR][kTx];
  const long long plane = static_cast<long long>(H) * W;
  const float* im = img + blockIdx.z * plane;
  const int x0 = blockIdx.x * kTx, y0 = blockIdx.y * kTy;
  const int tid = threadIdx.y * kTx + threadIdx.x;
  constexpr int kSw = kTx + 2 * kR, kSh = kTy + 2 * kR;
  for (int k = tid; k < kSh * kSw; k += kTx * kTy) {
    const int gy = y0 - kR + k / kSw, gx = x0 - kR + k % kSw;
    tile[k / kSw][k % kSw] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? im[gy * W + gx] : 0.f;
  }
  __syncthreads();
  // row sums of the tile's rows (rows outside the image stay 0: zero padding
  // of the row-summed image, as the reference's second reduce_window pads)
  for (int k = tid; k < kSh * kTx; k += kTx * kTy) {
    const int ly = k / kTx, lx = k % kTx;
    float s = tile[ly][lx];
#pragma unroll
    for (int i = 1; i < 2 * kR + 1; ++i) s = __fadd_rn(s, tile[ly][lx + i]);
    rows[ly][lx] = s;
  }
  __syncthreads();
  const int gx = x0 + threadIdx.x, gy = y0 + threadIdx.y;
  if (gx >= W || gy >= H) return;
  float s = rows[threadIdx.y][threadIdx.x];
#pragma unroll
  for (int i = 1; i < 2 * kR + 1; ++i) s = __fadd_rn(s, rows[threadIdx.y + i][threadIdx.x]);
  out[blockIdx.z * plane + gy * W + gx] = __fmul_rn(s, 1.f / 25.f);
}

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
    const float* im = img + c * plane;
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
    ang = atan2f(m01, m10);
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
    box_blur<<<dim3((W + kTx - 1) / kTx, (H + kTy - 1) / kTy, C), dim3(kTx, kTy), 0, s>>>(
        img, H, W, blurred);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long kps = static_cast<long long>(C) * K;
    if (kps > 0)
      describe<<<static_cast<unsigned>((kps + kWarpsPerBlock - 1) / kWarpsPerBlock),
                 32 * kWarpsPerBlock, 0, s>>>(img, blurred, C, H, W, uv, K, pattern, given,
                                              angles, desc);
  }
  return static_cast<int>(cudaGetLastError());
}
