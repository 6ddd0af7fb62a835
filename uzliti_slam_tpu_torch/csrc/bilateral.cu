// K17 bilateral: the joint bilateral depth filter of the keyframe front-end,
// for a batch of cameras.
//
// Replaces uzliti_slam_tpu/ops/depth.py:joint_bilateral_filter (:29-53).
// The reference stacks (2r+1)^2 = 25 zero-filled shifted copies of the depth,
// its validity and the guide image, and sums per pixel
//   w   = ws[dy, dx] * exp(-(g' - g)^2 / (2 sc^2)) * valid'
//   num = num + w * d',  den = den + w
//   out = den > 1e-6 ? num / max(den, 1e-9) : 0
// with d' = valid' ? depth' : 0 (valid = depth > 0 and finite).  Here one
// thread per pixel works on a shared-memory tile with a halo of 2 holding the
// masked depth, the validity and the guide; cameras ride on the grid's z.
//
// The arithmetic is the reference's compiled form (XLA on the CPU): the 25
// spatial weights are the compiled float32 constants, passed in as a table;
// the colour exponent is (t * t) * -fl(1 / (2 sc^2)) (XLA turns the division
// by a constant into a multiplication by its reciprocal); w = (wd * ws) *
// valid'; the taps are summed in the reference's dy-major order with num
// contracted into a fused multiply-add (LLVM contracts num + w * d') and den
// a plain add.  A tap outside the image carries w = 0 in the reference (its
// validity is zero-filled) and is skipped here, which is exact.  expf is the
// IEEE-accurate one (no --use_fast_math); it differs from XLA's exp and
// torch's by an ulp or two, which the stated tolerance covers.
//
// What bounds it on the card: at VGA 25 taps of ~10 operations a pixel
// (77 MFLOP a camera: 1.1 us at 67 TFLOP/s) against 3.7 MB read and written
// (1.1 us at 3.35 TB/s) — the two are even; each input is read from device
// memory once per tile (1.7 loads a pixel with the halo).
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32, kTy = 8;                 // output tile, one thread a pixel
constexpr int kR = 2;                            // the reference's radius
constexpr int kTaps = (2 * kR + 1) * (2 * kR + 1);
constexpr int kSw = kTx + 2 * kR, kSh = kTy + 2 * kR;

struct SpatialWeights {
  float w[kTaps];                                // dy-major, dy, dx in -2..2
};

__global__ void bilateral_tile(const float* __restrict__ depth, const float* __restrict__ guide,
                               int H, int W, SpatialWeights ws, float neg_inv_2sc2,
                               float* __restrict__ out) {
  __shared__ float sd[kSh][kSw];                 // masked depth (0 where invalid)
  __shared__ float sv[kSh][kSw];                 // validity 0/1
  __shared__ float sg[kSh][kSw];                 // guide
  const int cam = blockIdx.z;
  const size_t base = static_cast<size_t>(cam) * H * W;
  const int x0 = blockIdx.x * kTx - kR, y0 = blockIdx.y * kTy - kR;
  for (int i = threadIdx.y * kTx + threadIdx.x; i < kSh * kSw; i += kTx * kTy) {
    const int ty = i / kSw, tx = i % kSw;
    const int y = y0 + ty, x = x0 + tx;
    float d = 0.f, v = 0.f, g = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float raw = depth[base + static_cast<size_t>(y) * W + x];
      const bool ok = raw > 0.f && isfinite(raw);
      d = ok ? raw : 0.f;
      v = ok ? 1.f : 0.f;
      g = guide[base + static_cast<size_t>(y) * W + x];
    }
    sd[ty][tx] = d;
    sv[ty][tx] = v;
    sg[ty][tx] = g;
  }
  __syncthreads();
  const int x = blockIdx.x * kTx + threadIdx.x, y = blockIdx.y * kTy + threadIdx.y;
  if (x >= W || y >= H) return;
  const int cy = threadIdx.y + kR, cx = threadIdx.x + kR;
  const float gc = sg[cy][cx];
  float num = 0.f, den = 0.f;
  int k = 0;
#pragma unroll
  for (int dy = -kR; dy <= kR; ++dy) {
#pragma unroll
    for (int dx = -kR; dx <= kR; ++dx, ++k) {
      // tap (dy, dx) reads pixel (y - dy, x - dx): the reference's
      // _shift2d(img, -dy, -dx), whose order of taps is the order of sums
      const int yy = y - dy, xx = x - dx;
      if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;   // zero-filled: w = 0
      const float t = __fsub_rn(sg[cy - dy][cx - dx], gc);
      const float wd = expf(__fmul_rn(__fmul_rn(t, t), neg_inv_2sc2));
      const float w = __fmul_rn(__fmul_rn(wd, ws.w[k]), sv[cy - dy][cx - dx]);
      num = __fmaf_rn(w, sd[cy - dy][cx - dx], num);
      den = __fadd_rn(den, w);
    }
  }
  out[base + static_cast<size_t>(y) * W + x] =
      den > 1e-6f ? __fdiv_rn(num, den < 1e-9f ? 1e-9f : den) : 0.f;
}

}  // namespace

// depth, guide: (C, H, W) float32 metres and intensities; spatial: host
// pointer to the 25 float32 spatial weights, dy-major; neg_inv_2sc2 =
// -fl(1 / (2 sc^2)); out: (C, H, W) float32.
extern "C" int uz_bilateral(const float* depth, const float* guide, int C, int H, int W,
                            const float* spatial, float neg_inv_2sc2, float* out,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || H <= 0 || W <= 0) return 0;
  SpatialWeights ws;
  for (int i = 0; i < kTaps; ++i) ws.w[i] = spatial[i];
  const dim3 block(kTx, kTy), grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy, C);
  bilateral_tile<<<grid, block, 0, s>>>(depth, guide, H, W, ws, neg_inv_2sc2, out);
  return static_cast<int>(cudaGetLastError());
}
