// K14 orb_describe: the binary descriptors of a whole keyframe — every
// pyramid level's keypoints (all cameras) and the whole-image GIST — in one
// launch: intensity-centroid orientation and steered 256-test descriptors,
// the 5x5 box blur taken on each keypoint's window.
//
// Replaces uzliti_slam_tpu/ops/features.py:_sep_blur (:159-168),
// intensity_centroid_angles (:171-194) and brief_descriptors (:285-324),
// which the reference runs once per pyramid level and once more for the
// whole-image GIST (binary_gist, :484-493: one keypoint at the centre of a
// 63x63 resize, the radius-25 pattern, the roll as the angle).  The
// reference blurs each whole image, gathers every patch and every sample
// with linearised takes, then packs the (K, 256) bits.
//
// What bounds it on the card: launch latency.  The work is small — 64
// keypoints a level and camera and one GIST, 512 samples each — and the
// bytes that the keypoints' windows need are a few hundred KB; blurring the
// whole level first (1.2 MB in and out per camera at VGA level 0) served
// only those samples.
//
// Design:
//   - Rows: a host table of up to kMaxRows rows (an image (C, H, W), its
//     keypoints (C, K, 2), a (256, 2, 2) pattern, its given angles or none,
//     and where its angles and descriptors go: camera c's keypoint k at
//     c·stride + k, so rows written side by side form the (C, ΣK) layout of
//     a torch.cat of the rows' outputs, with no copy) passed by value in the
//     kernel's parameter struct (__grid_constant__, read in place, as K13's
//     levels): one launch for every row.  One CTA of 256 threads per
//     keypoint of all rows; the CTA finds its row by the rows' first
//     keypoint index.
//   - The reach: thread j holds test j (ax, ay, bx, by), and the CTA takes
//     the pattern's largest point norm.  A rotation keeps the norm (not the
//     per-axis bound: BRIEF's points lie within ±13 per axis and reach
//     16.4 from the centre), so every rotated sample rounds to within
//     ceil(norm) + 1 pixels of floor(u), and once clipped within as much
//     of floor(u) clamped into the image; its 5x5 sum reads 2 further.
//   - The window: that square of the UNBLURRED image about the keypoint's
//     pixel clamped into the image (samples are clipped into the image, so
//     a keypoint off the image samples within reach of its clamped pixel),
//     clipped to [-2, W+1] x [-2, H+1] with zeros outside the image, as the
//     blur pads, in shared memory; 128-bit loads when the row's width is a
//     multiple of 4 and its image 16-byte aligned (the window's left edge
//     aligned down to 4; a vector then lies wholly in the image or wholly
//     outside it), one float a thread otherwise.  The wrapper checks that
//     each row's window fits kWinH rows x kWinP floats (every shipped
//     pattern does, the GIST's on its 63x63 image), so every sample's 5x5
//     lies in the window.
//   - The angle: warp 0 runs describe.cuh:centroid_angle (the moments over
//     the 15x15 disc of the unblurred image in device memory, the same
//     arithmetic as K29's) while the other warps load the window.
//   - The tests: warp w makes tests 32w + lane: both points rotated by the
//     angle, (c·px - s·py, s·px + c·py), added to the keypoint, rounded half
//     to even and clipped; the 5x5 box sum at each — five row sums each
//     added left to right, then the column top to bottom, then × fl(1/25):
//     the reference's _sep_blur order, so each value is bit-equal to the
//     blurred image's — and bit = a < b.  __ballot_sync packs word w, so
//     word w's byte q bit i is test 32w + 8q + i (matching.pack_bits's
//     LSB-first layout).  The rotation is written with
//     __fmul_rn/__fadd_rn/__fsub_rn, so no multiply-add is contracted and a
//     sample on a .5 edge rounds as the plain version's products do.
#include <cstdint>
#include <cuda_runtime.h>

#include "describe.cuh"

namespace {

using uz_describe::kFull;
constexpr int kThreads = 256;             // 8 warps: warp w makes word w
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;
constexpr int kB = 2;                     // blur radius: 5x5 box sums
constexpr int kWinH = 72, kWinP = 76;     // the window's rows and row pitch (floats)
constexpr float kScale = 1.f / 25.f;
constexpr int kRowFields = 11;            // int64 fields a host table row

struct Row {
  const float* img;       // (C, H, W)
  const float* uv;        // (C, K, 2)
  const float* pattern;   // (256, 2, 2)
  const float* given;     // (C, K) given angles, or null: the centroid's
  float* angles;          // camera c's keypoint k at c·stride + k
  unsigned* desc;         // the same, 32 bytes (8 words) a keypoint
  long long start;        // the row's first keypoint in the launch
  int C, H, W, K, stride;
};

struct Rows {
  Row r[kMaxRows];
  int n;
};

__device__ __forceinline__ float pixel(const float* __restrict__ im, int H, int W, int x, int y) {
  return (x >= 0 && x < W && y >= 0 && y < H) ? __ldg(im + static_cast<long long>(y) * W + x)
                                              : 0.f;
}

// five values added left to right
__device__ __forceinline__ float sum5(const float* p) {
  float s = p[0];
#pragma unroll
  for (int i = 1; i < 2 * kB + 1; ++i) s = __fadd_rn(s, p[i]);
  return s;
}

// The 5x5 box sum at the clipped sample (xi, yi), × fl(1/25), from the
// window whose top-left pixel is (lx0, ly0).
__device__ __forceinline__ float box5(const float* win, int lx0, int ly0, int xi, int yi) {
  const float* p = win + (yi - ly0 - kB) * kWinP + (xi - lx0 - kB);
  float t = sum5(p);
#pragma unroll
  for (int r = 1; r < 2 * kB + 1; ++r) t = __fadd_rn(t, sum5(p + r * kWinP));
  return __fmul_rn(t, kScale);
}

__global__ void __launch_bounds__(kThreads) orb_describe_rows(const __grid_constant__ Rows P) {
  __shared__ __align__(16) float win[kWinH * kWinP];
  __shared__ float s_reach[kWarps];
  __shared__ float s_ang;
  const long long g = blockIdx.x;
  int ri = 0;
  while (ri + 1 < P.n && g >= P.r[ri + 1].start) ++ri;
  const Row& R = P.r[ri];
  const long long kp = g - R.start;                     // c·K + k
  const long long c = kp / R.K;
  const long long out = c * R.stride + (kp - c * R.K);  // c·stride + k
  const int H = R.H, W = R.W;
  const float* im = R.img + c * static_cast<long long>(H) * W;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // test tid of the pattern, and the pattern's largest point norm
  const float4 t = __ldg(reinterpret_cast<const float4*>(R.pattern) + tid);
  float n2 = fmaxf(__fadd_rn(__fmul_rn(t.x, t.x), __fmul_rn(t.y, t.y)),
                   __fadd_rn(__fmul_rn(t.z, t.z), __fmul_rn(t.w, t.w)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n2 = fmaxf(n2, __shfl_xor_sync(kFull, n2, off));
  if (lane == 0) s_reach[warp] = n2;
  const float u = R.uv[2 * kp], v = R.uv[2 * kp + 1];
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n2 = fmaxf(n2, s_reach[w]);
  const int reach = static_cast<int>(ceilf(sqrtf(n2))) + 1 + kB;

  // the window of the unblurred image, zero outside it
  const int u0 = static_cast<int>(fminf(fmaxf(floorf(u), 0.f), static_cast<float>(W - 1)));
  const int v0 = static_cast<int>(fminf(fmaxf(floorf(v), 0.f), static_cast<float>(H - 1)));
  const int x0 = max(u0 - reach, -kB), x1 = min(u0 + reach, W - 1 + kB);
  const int y0 = max(v0 - reach, -kB), y1 = min(v0 + reach, H - 1 + kB);
  const bool vec = (W & 3) == 0 && (reinterpret_cast<uintptr_t>(R.img) & 15) == 0;
  const int lx0 = vec ? (x0 & ~3) : x0;                 // two's complement: floor to 4
  int wid = x1 - lx0 + 1;
  const int hgt = y1 - y0 + 1;
  if (vec) wid = (wid + 3) & ~3;
  if (vec) {
    const int q = wid >> 2;
    for (int e = tid; e < hgt * q; e += kThreads) {
      const int yy = e / q, j = e - yy * q;
      const int gy = y0 + yy, gx = lx0 + 4 * j;
      float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        val = __ldg(reinterpret_cast<const float4*>(im + static_cast<long long>(gy) * W + gx));
      *reinterpret_cast<float4*>(win + yy * kWinP + 4 * j) = val;
    }
  } else {
    for (int e = tid; e < hgt * wid; e += kThreads) {
      const int yy = e / wid, xx = e - yy * wid;
      win[yy * kWinP + xx] = pixel(im, H, W, lx0 + xx, y0 + yy);
    }
  }
  if (warp == 0) {
    const float a = R.given ? R.given[kp] : uz_describe::centroid_angle(im, H, W, u, v, lane);
    if (lane == 0) {
      s_ang = a;
      R.angles[out] = a;
    }
  }
  __syncthreads();

  const float ca = cosf(s_ang), sa = sinf(s_ang);
  const float px[2] = {t.x, t.z}, py[2] = {t.y, t.w};
  float val[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float rx = __fsub_rn(__fmul_rn(ca, px[q]), __fmul_rn(sa, py[q]));
    const float ry = __fadd_rn(__fmul_rn(sa, px[q]), __fmul_rn(ca, py[q]));
    const float sx = rintf(__fadd_rn(u, rx)), sy = rintf(__fadd_rn(v, ry));
    const int xi = static_cast<int>(fminf(fmaxf(sx, 0.f), static_cast<float>(W - 1)));
    const int yi = static_cast<int>(fminf(fmaxf(sy, 0.f), static_cast<float>(H - 1)));
    val[q] = box5(win, lx0, y0, xi, yi);
  }
  const unsigned word = __ballot_sync(kFull, val[0] < val[1]);
  if (lane == 0) R.desc[out * 8 + warp] = word;
}

}  // namespace

// rows: a host table of n_rows rows of kRowFields 64-bit integers each —
// (img, uv, pattern, given, angles, desc) pointers, then C, H, W, K, stride
// — each img (C, H, W) float32 with H, W >= 1, uv (C, K, 2) float32,
// pattern (256, 2, 2) float32 16-byte aligned, given (C, K) float32 angles or null (the
// intensity-centroid angles), angles and desc float32 and 32-byte uint8
// (4-byte aligned) outputs with camera c's keypoint k at c·stride + k,
// stride >= K, and each row's window (the pattern's reach about a pixel,
// clipped to the image and its 2-pixel border) within kWinH x kWinP.  One
// launch; a row with no keypoint takes no CTA.
extern "C" int uz_orb_describe_rows(const void* rows, int n_rows, void* stream) {
  if (n_rows < 1 || n_rows > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  const long long* t = static_cast<const long long*>(rows);
  Rows P = {};
  long long total = 0;
  for (int i = 0; i < n_rows; ++i) {
    const long long* f = t + kRowFields * i;
    Row& R = P.r[i];
    R.img = reinterpret_cast<const float*>(f[0]);
    R.uv = reinterpret_cast<const float*>(f[1]);
    R.pattern = reinterpret_cast<const float*>(f[2]);
    R.given = reinterpret_cast<const float*>(f[3]);
    R.angles = reinterpret_cast<float*>(f[4]);
    R.desc = reinterpret_cast<unsigned*>(f[5]);
    R.C = static_cast<int>(f[6]);
    R.H = static_cast<int>(f[7]);
    R.W = static_cast<int>(f[8]);
    R.K = static_cast<int>(f[9]);
    R.stride = static_cast<int>(f[10]);
    if (R.C < 0 || R.K < 0 || R.H < 1 || R.W < 1 || R.stride < R.K)
      return static_cast<int>(cudaErrorInvalidValue);
    R.start = total;
    total += static_cast<long long>(R.C) * R.K;
  }
  P.n = n_rows;
  if (total == 0) return 0;
  if (total > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  orb_describe_rows<<<static_cast<unsigned>(total), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
