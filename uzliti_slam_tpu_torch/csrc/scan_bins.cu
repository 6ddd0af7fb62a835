// K15 scan_bins: virtual laser scans (per-bearing near and far range) of a
// batch of depth images, and of a batch of point sets; one launch a call.
//
// Replaces uzliti_slam_tpu/ops/scan.py:depth_to_scan's per-pixel part
// (:128-154) and _bin_min_max (:38-68), and (second entry point) the
// re-binning of points_to_scan (:166-196) and cloud_to_scan (:72-100).  The
// reference computes planes of the backprojection, the extrinsic, the band
// and bearing tests and the bin, then finds each bin's min and max range with
// ONE sort of packed (bin << 21 | q) keys and a searchsorted: the TPU's
// answer to a scatter.  Here each passing entry's 21-bit quantised range
// q = int(clip(range · scale, 0, 2^21 - 1)) goes to per-bin atomicMin /
// atomicMax in shared memory (n_bins <= 1023: 8 KB).  Integer min/max are
// exact and order-free, so the result does not depend on the atomics' order;
// reducing the reference's quantised q, not the float range, gives its scans
// bit for bit.  A bin with a range writes q · fl(1/scale), an empty one +inf
// (near and far: _scan's far finished here).
//
//   - uz_scan_bins, scan_grid: a grid over every camera's pixels (a CTA of
//     256 threads takes 1024 pixels, 4 a thread; a warp's 32 lanes lie 8
//     pixels apart, so they fall into different bearing bins: neighbouring
//     pixels of one row share a bin, and 32 neighbours serialised their
//     shared atomics on a few addresses).  A pixel leaves at its first
//     failed test (depth, band, range, bearing), before the atan2.  Each CTA
//     folds its touched bins into its camera's table in device memory with
//     atomicMin / atomicMax, then counts itself in; the camera's last CTA to
//     arrive reads each bin and puts it back to (INT_MAX, -1) with
//     atomicExch, writes the scan and sets the counter to 0.  The table is
//     the wrapper's, made once per device and left as it was found by every
//     call (a call runs on its device's current stream, one at a time): no
//     init or finalize launch and no table a call.
//   - uz_bin_min_max, bin_points: one CTA a scan of P points (x, y) or (x,
//     y, z) with their valid flags: scan._hypot in its compiled form
//     (a·sqrt(fma(t, t, 1)), t = b/a, a correctly rounded square root, +inf
//     where either input is), atan2f, scan._planar_ok, the height band where
//     z is given, scan.bin_index, then the same shared reduction and
//     write-back.
// Arithmetic follows the reference's compiled form, as XLA on the CPU emits
// it: each row of the extrinsic product is fma(r2, z, fma(r0, x, r1·y)) + t,
// the squared range fma(x, x, y·y), the bin (bearing - angle_min) · factor
// with factor = fl(fl(1/span) · n_bins), the write-back a multiplication by
// the float32 reciprocal of the scale; every other operation is written with
// __f*_rn so nvcc contracts nothing else.
//
// What bounds it on the card: the bytes — each depth pixel read once
// (1.2 MB per camera at VGA: 0.37 us at 3.35 TB/s) against ~60 operations a
// pixel (18 MFLOP: 0.27 us at 67 TFLOP/s, atan2 and the square root counted
// as a few each).  A thread-block cluster a camera (scripts/k15_cluster.cu)
// merges without device memory, but holds only 16 SMs a camera, and was the
// slower of the two on the card.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPixelsPerThread = 4;
constexpr int kPixelsPerCta = kThreads * kPixelsPerThread;
constexpr int kMaxBins = 1024;                      // a scratch row: near, far, counter
constexpr int kScratchRow = 2 * kMaxBins + 1;
constexpr int kPointThreads = 256;

struct Params {
  int H, W, n_bins;
  float fx, fy, cx, cy;
  float angle_min, angle_max, bin_factor;
  float band_lo, band_hi, min_range, max_range;
  float scale, inv_scale;
};

__device__ __forceinline__ void bin_range(int* s_table, int n_bins, float rng, float bearing,
                                          float angle_min, float bin_factor, float scale) {
  const int bin = min(max(__float2int_rz(__fmul_rn(__fsub_rn(bearing, angle_min), bin_factor)),
                          0), n_bins - 1);
  const int q = __float2int_rz(fminf(fmaxf(__fmul_rn(rng, scale), 0.f), 2097151.f));
  atomicMin(&s_table[bin], q);
  atomicMax(&s_table[n_bins + bin], q);
}

__global__ void __launch_bounds__(kThreads)
scan_grid(const float* __restrict__ depth, const float* __restrict__ xf, Params p,
          int* __restrict__ scratch, float* __restrict__ out, int C) {
  extern __shared__ int s_table[];   // [0, n): min q; [n, 2n): max q
  __shared__ bool s_last;
  const int c = blockIdx.y, tid = threadIdx.x;
  for (int b = tid; b < p.n_bins; b += kThreads) {
    s_table[b] = INT_MAX;
    s_table[p.n_bins + b] = -1;
  }
  __syncthreads();
  const float* m = xf + 12 * c;
  const float m0 = m[0], m1 = m[1], m2 = m[2], m3 = m[3], m4 = m[4], m5 = m[5];
  const float m6 = m[6], m7 = m[7], m8 = m[8], t0 = m[9], t1 = m[10], t2 = m[11];
  const int n = p.H * p.W;
  const float* img = depth + static_cast<long long>(c) * n;
  // pixel base + j·kThreads + lane·kWarps + warp: a warp's lanes kWarps
  // apart; the thread's depths loaded first (0 past the image: no range)
  const int first = blockIdx.x * kPixelsPerCta + (tid & 31) * kWarps + (tid >> 5);
  float dv[kPixelsPerThread];
#pragma unroll
  for (int j = 0; j < kPixelsPerThread; ++j) {
    const int pix = first + j * kThreads;
    dv[j] = pix < n ? img[pix] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kPixelsPerThread; ++j) {
    const int pix = first + j * kThreads;
    const float d = dv[j];
    if (!(d > 0.01f) || !isfinite(d)) continue;
    const float u = static_cast<float>(pix % p.W), v = static_cast<float>(pix / p.W);
    const float xc = __fmul_rn(__fdiv_rn(__fsub_rn(u, p.cx), p.fx), d);
    const float yc = __fmul_rn(__fdiv_rn(__fsub_rn(v, p.cy), p.fy), d);
    const float zc = d;
    const float zb = __fadd_rn(__fmaf_rn(m8, zc, __fmaf_rn(m6, xc, __fmul_rn(m7, yc))), t2);
    if (!(zb >= p.band_lo && zb <= p.band_hi)) continue;
    const float xb = __fadd_rn(__fmaf_rn(m2, zc, __fmaf_rn(m0, xc, __fmul_rn(m1, yc))), t0);
    const float yb = __fadd_rn(__fmaf_rn(m5, zc, __fmaf_rn(m3, xc, __fmul_rn(m4, yc))), t1);
    const float rng = __fsqrt_rn(__fmaf_rn(xb, xb, __fmul_rn(yb, yb)));
    if (!(rng >= p.min_range && rng <= p.max_range)) continue;
    const float bearing = atan2f(yb, xb);
    if (!(bearing >= p.angle_min && bearing < p.angle_max)) continue;
    bin_range(s_table, p.n_bins, rng, bearing, p.angle_min, p.bin_factor, p.scale);
  }
  __syncthreads();
  int* table = scratch + static_cast<long long>(c) * kScratchRow;   // near, far, counter
  for (int b = tid; b < p.n_bins; b += kThreads) {
    if (s_table[p.n_bins + b] >= 0) {
      atomicMin(&table[b], s_table[b]);
      atomicMax(&table[kMaxBins + b], s_table[p.n_bins + b]);
    }
  }
  __threadfence();
  __syncthreads();
  unsigned* arrived = reinterpret_cast<unsigned*>(table + 2 * kMaxBins);
  if (tid == 0) s_last = atomicAdd(arrived, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int b = tid; b < p.n_bins; b += kThreads) {
    const int lo = atomicExch(&table[b], INT_MAX);
    const int hi = atomicExch(&table[kMaxBins + b], -1);
    const bool has = hi >= 0;
    const long long o = static_cast<long long>(c) * p.n_bins + b;
    out[o] = has ? __fmul_rn(static_cast<float>(lo), p.inv_scale) : __int_as_float(0x7f800000);
    out[static_cast<long long>(C) * p.n_bins + o] =
        has ? __fmul_rn(static_cast<float>(hi), p.inv_scale) : __int_as_float(0x7f800000);
  }
  if (tid == 0) *arrived = 0u;
}

__global__ void __launch_bounds__(kPointThreads)
bin_points(const float* __restrict__ pts, const bool* __restrict__ valid, int P, int D, Params p,
           float* __restrict__ out, int B) {
  extern __shared__ int s_table[];   // [0, n_bins): min q; [n_bins, 2·n_bins): max q
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < p.n_bins; k += kPointThreads) {
    s_table[k] = INT_MAX;
    s_table[p.n_bins + k] = -1;
  }
  __syncthreads();
  const long long row = static_cast<long long>(b) * P;
  for (int i = threadIdx.x; i < P; i += kPointThreads) {
    if (!valid[row + i]) continue;
    const float* pt = pts + (row + i) * D;
    const float x = pt[0], y = pt[1];
    // scan._hypot, compiled: a NaN input leaves through the bearing test
    const float ax = fabsf(x), ay = fabsf(y);
    const float a = fmaxf(ax, ay), bb = fminf(ax, ay);
    const float t = __fdiv_rn(bb, a == 0.f ? 1.f : a);
    const float root = __fsqrt_rn(__fmaf_rn(t, t, 1.f));
    float rng = a == 0.f ? a : __fmul_rn(a, root);
    if (isinf(ax) || isinf(ay)) rng = __int_as_float(0x7f800000);
    if (!(rng >= p.min_range && rng <= p.max_range)) continue;
    const float bearing = atan2f(y, x);
    if (!(bearing >= p.angle_min && bearing < p.angle_max)) continue;
    if (D == 3 && !(pt[2] >= p.band_lo && pt[2] <= p.band_hi)) continue;
    bin_range(s_table, p.n_bins, rng, bearing, p.angle_min, p.bin_factor, p.scale);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < p.n_bins; k += kPointThreads) {
    const int hi = s_table[p.n_bins + k];
    const bool has = hi >= 0;
    const long long o = static_cast<long long>(b) * p.n_bins + k;
    out[o] = has ? __fmul_rn(static_cast<float>(s_table[k]), p.inv_scale)
                 : __int_as_float(0x7f800000);
    out[static_cast<long long>(B) * p.n_bins + o] =
        has ? __fmul_rn(static_cast<float>(hi), p.inv_scale) : __int_as_float(0x7f800000);
  }
}

}  // namespace

// out (2, B, n_bins): near then far ranges (+inf where a bin is empty) of B
// scans of P points pts (B, P, D) float32, D = 2 (x, y) or 3 (x, y, z; z
// within [band_lo, band_hi]), with flags valid (B, P).
extern "C" int uz_bin_min_max(const float* pts, const bool* valid, int B, int P, int D,
                              int n_bins, float angle_min, float angle_max, float bin_factor,
                              float min_range, float max_range, float band_lo, float band_hi,
                              float scale, float inv_scale, float* out, void* stream) {
  if (B <= 0) return 0;
  if (n_bins <= 0 || n_bins > 1023 || (D != 2 && D != 3) || P < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{0, 0, n_bins, 0.f, 0.f, 0.f, 0.f, angle_min, angle_max, bin_factor,
           band_lo, band_hi, min_range, max_range, scale, inv_scale};
  bin_points<<<B, kPointThreads, 2 * n_bins * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      pts, valid, P, D, p, out, B);
  return static_cast<int>(cudaGetLastError());
}

// out (2, C, n_bins): near then far ranges (+inf where a bin is empty) of
// depth (C, H, W) metres with camera-to-base transforms xf (C, 12) = [R row
// major, t]; scratch (C, 2 kMaxBins + 1) int32, each row (INT_MAX x
// kMaxBins, -1 x kMaxBins, 0) and left so by the call.
extern "C" int uz_scan_bins(const float* depth, const float* xf, int C, int H, int W, float fx,
                            float fy, float cx, float cy, int n_bins, float angle_min,
                            float angle_max, float bin_factor, float band_lo, float band_hi,
                            float min_range, float max_range, float scale, float inv_scale,
                            int* scratch, float* out, void* stream) {
  if (C <= 0) return 0;
  if (n_bins <= 0 || n_bins > kMaxBins - 1 || H < 0 || W < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params p{H, W, n_bins, fx, fy, cx, cy, angle_min, angle_max, bin_factor,
                 band_lo, band_hi, min_range, max_range, scale, inv_scale};
  const long long n = static_cast<long long>(H) * W;
  const int ctas = static_cast<int>(n > 0 ? (n + kPixelsPerCta - 1) / kPixelsPerCta : 1);
  scan_grid<<<dim3(ctas, C), kThreads, 2 * n_bins * sizeof(int),
              static_cast<cudaStream_t>(stream)>>>(depth, xf, p, scratch, out, C);
  return static_cast<int>(cudaGetLastError());
}
