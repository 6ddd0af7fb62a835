// K17 bilateral: the joint bilateral depth filter of the keyframe front-end,
// for a batch of cameras.
//
// Replaces uzliti_slam_tpu/ops/depth.py:joint_bilateral_filter (:29-53).
// The reference stacks (2r+1)^2 = 25 zero-filled shifted copies of the depth,
// its validity and the guide image, and sums per pixel
//   w   = ws[dy, dx] * exp(-(g' - g)^2 / (2 sc^2)) * valid'
//   num = num + w * d',  den = den + w
//   out = den > 1e-6 ? num / max(den, 1e-9) : 0
// with d' = valid' ? depth' : 0 (valid = depth > 0 and finite).
//
// The arithmetic is the reference's compiled form (XLA on the CPU): the 25
// spatial weights are the compiled float32 constants, passed in as a table;
// the colour exponent is (t * t) * -fl(1 / (2 sc^2)) (XLA turns the division
// by a constant into a multiplication by its reciprocal); w = (wd * ws) *
// valid'; the taps are summed in the reference's dy-major order with num
// contracted into a fused multiply-add (LLVM contracts num + w * d') and den
// a plain add.  expf is the IEEE-accurate one (no --use_fast_math); it
// differs from XLA's exp by an ulp or two, which the tests' tolerance
// against the reference covers; against the plain version on the card
// (torch's exp there is the same expf) the filter is bit-equal.
//
// What bounds it on the card: at VGA 25 taps of ~18 operations a pixel,
// the exponential included (138 MFLOP a camera: 2.1 us at 67 TFLOP/s),
// against 3.7 MB read and written (1.1 us at 3.35 TB/s).
//
// Design: a CTA of 256 threads takes a 32 x 16 output tile, two rows a
// thread, over shared tiles of the masked depth and the guide with a halo
// of 2 (1.41 loads a pixel).
//   - Validity is the masked depth: a tap is valid exactly where it is > 0
//     (an invalid or out-of-image tap holds +0).  An invalid tap adds
//     fma(w·0 = 0, 0, num) = num and den + 0 = den in the reference, so it
//     is skipped with its exponential; the one exception is a NaN colour
//     difference, whose weight NaN·0 turns num and den to NaN and the pixel
//     to 0, so the exponential path keeps that case.
//   - The colour table: where every guide value of the CTA's tile (halo
//     included) is an integer in [0, 255] — the uint8 image of the default
//     configuration — g' - g takes the integer values -255..255, so the
//     colour weight is one of 256 floats by |g' - g|.  The CTA builds them
//     in shared memory, one a thread, with the very expression the per-tap
//     path evaluates (the same float), and one __syncthreads_and decides
//     the path.  A tile with a NaN, an infinite, a fractional or an
//     out-of-range guide (the rectified image) evaluates expf at each tap.
#include <cuda_runtime.h>

namespace {

constexpr int kTx = 32, kTy = 16;                // output tile
constexpr int kThreadsY = 8, kThreads = kTx * kThreadsY;
constexpr int kRows = kTy / kThreadsY;           // rows a thread
constexpr int kR = 2;                            // the reference's radius
constexpr int kTaps = (2 * kR + 1) * (2 * kR + 1);
constexpr int kSw = kTx + 2 * kR, kSh = kTy + 2 * kR;
constexpr int kLevels = 256;                     // |g' - g| of an integer guide in [0, 255]
constexpr bool kColourTable = true;
constexpr int kMinBlocks = 1;                    // __launch_bounds__' CTAs an SM
static_assert(kThreads == kLevels, "one table entry a thread");

struct SpatialWeights {
  float w[kTaps];                                // dy-major, dy, dx in -2..2
};

__device__ __forceinline__ float colour_weight(float t, float neg_inv_2sc2) {
  return expf(__fmul_rn(__fmul_rn(t, t), neg_inv_2sc2));
}

// the filtered depth of the pixel at tile coordinates (cy, cx); kTable: the
// colour weights from the CTA's table by |g' - g| (every guide of the tile
// an integer in [0, 255]), else expf at each tap
template <bool kTable>
__device__ __forceinline__ float filter_pixel(const float (*sd)[kSw], const float (*sg)[kSw],
                                              const float* wc, const SpatialWeights& ws,
                                              float neg_inv_2sc2, int cy, int cx) {
  const float gc = sg[cy][cx];
  float num = 0.f, den = 0.f;
  bool nan_weight = false;
  int k = 0;
  // tap (dy, dx) reads pixel (y - dy, x - dx): the reference's
  // _shift2d(img, -dy, -dx), whose order of taps is the order of sums
#pragma unroll
  for (int dy = -kR; dy <= kR; ++dy) {
#pragma unroll
    for (int dx = -kR; dx <= kR; ++dx, ++k) {
      const float dv = sd[cy - dy][cx - dx];
      const float t = __fsub_rn(sg[cy - dy][cx - dx], gc);
      if (dv > 0.f) {
        const float wd = kTable ? wc[__float2int_rn(fabsf(t))] : colour_weight(t, neg_inv_2sc2);
        const float w = __fmul_rn(wd, ws.w[k]);
        num = __fmaf_rn(w, dv, num);
        den = __fadd_rn(den, w);
      } else if (!kTable) {
        nan_weight = nan_weight || isnan(t);
      }
    }
  }
  if (nan_weight) return 0.f;
  return den > 1e-6f ? __fdiv_rn(num, den < 1e-9f ? 1e-9f : den) : 0.f;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
bilateral_tile(const float* __restrict__ depth, const float* __restrict__ guide, int H, int W,
               SpatialWeights ws, float neg_inv_2sc2, float* __restrict__ out,
               int* __restrict__ paths) {
  __shared__ float sd[kSh][kSw];                 // masked depth (+0 where invalid or outside)
  __shared__ float sg[kSh][kSw];                 // guide (0 outside)
  __shared__ float wc[kLevels];                  // colour weight by |g' - g|
  const int cam = blockIdx.z;
  const size_t base = static_cast<size_t>(cam) * H * W;
  const int tid = threadIdx.y * kTx + threadIdx.x;
  const int x0 = blockIdx.x * kTx - kR, y0 = blockIdx.y * kTy - kR;
  bool ints = true;
  for (int i = tid; i < kSh * kSw; i += kThreads) {
    const int ty = i / kSw, tx = i - ty * kSw;
    const int y = y0 + ty, x = x0 + tx;
    float d = 0.f, g = 0.f;
    if (y >= 0 && y < H && x >= 0 && x < W) {
      const float raw = depth[base + static_cast<size_t>(y) * W + x];
      d = raw > 0.f && isfinite(raw) ? raw : 0.f;
      g = guide[base + static_cast<size_t>(y) * W + x];
    }
    ints = ints && g >= 0.f && g <= 255.f && g == truncf(g);
    sd[ty][tx] = d;
    sg[ty][tx] = g;
  }
  wc[tid] = colour_weight(static_cast<float>(tid), neg_inv_2sc2);
  const bool table = kColourTable && __syncthreads_and(ints);
  if (!kColourTable) __syncthreads();
  if (paths != nullptr && tid == 0)
    paths[(static_cast<size_t>(cam) * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x] =
        table ? 1 : 0;
  const int x = blockIdx.x * kTx + threadIdx.x;
  if (x >= W) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ly = threadIdx.y + r * kThreadsY;
    const int y = blockIdx.y * kTy + ly;
    if (y >= H) break;
    const int cy = ly + kR, cx = threadIdx.x + kR;
    out[base + static_cast<size_t>(y) * W + x] =
        table ? filter_pixel<true>(sd, sg, wc, ws, neg_inv_2sc2, cy, cx)
              : filter_pixel<false>(sd, sg, wc, ws, neg_inv_2sc2, cy, cx);
  }
}

}  // namespace

// depth, guide: (C, H, W) float32 metres and intensities; spatial: host
// pointer to the 25 float32 spatial weights, dy-major; neg_inv_2sc2 =
// -fl(1 / (2 sc^2)); out: (C, H, W) float32; paths: null, or (C,
// ceil(H / 16), ceil(W / 32)) int32 written 1 where the tile took the colour
// table and 0 where it evaluated expf at each tap.
extern "C" int uz_bilateral(const float* depth, const float* guide, int C, int H, int W,
                            const float* spatial, float neg_inv_2sc2, float* out, int* paths,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || H <= 0 || W <= 0) return 0;
  SpatialWeights ws;
  for (int i = 0; i < kTaps; ++i) ws.w[i] = spatial[i];
  const dim3 block(kTx, kThreadsY), grid((W + kTx - 1) / kTx, (H + kTy - 1) / kTy, C);
  bilateral_tile<<<grid, block, 0, s>>>(depth, guide, H, W, ws, neg_inv_2sc2, out, paths);
  return static_cast<int>(cudaGetLastError());
}
