// K15 scan_bins: virtual laser scans (per-bearing near and far range) of a
// batch of depth images.
//
// Replaces uzliti_slam_tpu/ops/scan.py:depth_to_scan's per-pixel part
// (:128-154) and _bin_min_max (:38-68).  The reference computes (H, W)
// planes of the backprojection, the extrinsic, the band and bearing tests
// and the bin, then finds each bin's min and max range with ONE sort of
// packed (bin << 21 | q) keys and a searchsorted — the TPU's answer to a
// scatter.  Here:
//   - scan_pixels: one thread per pixel computes the same quantities and,
//     where the pixel passes, the 21-bit quantised range
//     q = int(clip(range · scale, 0, 2^21 - 1)); per-bin atomicMin /
//     atomicMax of q go to shared memory (n_bins <= 1023: 8 KB), and each
//     CTA then folds its touched bins into the (C, 2, B) table in device
//     memory with global atomics.  Integer min/max are exact and order-free,
//     so the result does not depend on the atomics' order;
//   - init_table / finalize: the table starts at (INT_MAX, -1); a bin with a
//     range writes q · fl(1/scale), an empty one +inf (near and far).
// Reducing the reference's quantised q, not the float range, gives its scans
// bit for bit (those scans are what the map and the laser edges read).
// Arithmetic follows the reference's compiled form, as XLA on the CPU emits
// it: each row of the extrinsic product is fma(r2, z, fma(r0, x, r1·y)) + t,
// the squared range fma(x, x, y·y), the bin (bearing - angle_min) · factor
// with factor = fl(fl(1/span) · n_bins), the write-back a multiplication by
// the float32 reciprocal of the scale; every other operation is written with
// __f*_rn so nvcc contracts nothing else.
//
// Second entry point, uz_bin_min_max (points_to_scan and cloud_to_scan,
// the re-binning of node merging's scan unions): the ranges, flags and
// bins are computed by the caller; one CTA per scan runs the same
// shared-memory atomicMin / atomicMax of q over its entries and writes
// q · fl(1/scale), +inf (near) or -inf (far) where a bin is empty, which is
// _bin_min_max's output.  A batch of scans is one launch.
//
// What bounds it on the card: the bytes — each depth pixel read once
// (1.2 MB per camera at VGA: 0.37 us at 3.35 TB/s) against ~60 operations a
// pixel (18 MFLOP: 0.27 us at 67 TFLOP/s, atan2 and the square root counted
// as a few each).
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  int H, W, n_bins;
  float fx, fy, cx, cy;
  float angle_min, angle_max, bin_factor;
  float band_lo, band_hi, min_range, max_range;
  float scale, inv_scale;
};

__global__ void init_table(int* __restrict__ table, int C, int n_bins) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= C * 2 * n_bins) return;
  table[i] = ((i / n_bins) % 2 == 0) ? INT_MAX : -1;
}

__global__ void __launch_bounds__(kThreads)
scan_pixels(const float* __restrict__ depth, const float* __restrict__ xf, Params p,
            int* __restrict__ table) {
  extern __shared__ int s_table[];   // [0, n_bins): min q; [n_bins, 2·n_bins): max q
  const int c = blockIdx.y;
  for (int b = threadIdx.x; b < p.n_bins; b += kThreads) {
    s_table[b] = INT_MAX;
    s_table[p.n_bins + b] = -1;
  }
  __syncthreads();
  const int pix = blockIdx.x * kThreads + threadIdx.x;
  if (pix < p.H * p.W) {
    const float* m = xf + 12 * c;
    const float d = depth[static_cast<long long>(c) * p.H * p.W + pix];
    const float u = static_cast<float>(pix % p.W), v = static_cast<float>(pix / p.W);
    const float xc = __fmul_rn(__fdiv_rn(__fsub_rn(u, p.cx), p.fx), d);
    const float yc = __fmul_rn(__fdiv_rn(__fsub_rn(v, p.cy), p.fy), d);
    const float zc = d;
    const float xb = __fadd_rn(__fmaf_rn(m[2], zc, __fmaf_rn(m[0], xc, __fmul_rn(m[1], yc))), m[9]);
    const float yb = __fadd_rn(__fmaf_rn(m[5], zc, __fmaf_rn(m[3], xc, __fmul_rn(m[4], yc))), m[10]);
    const float zb = __fadd_rn(__fmaf_rn(m[8], zc, __fmaf_rn(m[6], xc, __fmul_rn(m[7], yc))), m[11]);
    const float rng = __fsqrt_rn(__fmaf_rn(xb, xb, __fmul_rn(yb, yb)));
    const float bearing = atan2f(yb, xb);
    const bool ok = d > 0.01f && isfinite(d) && zb >= p.band_lo && zb <= p.band_hi &&
                    rng >= p.min_range && rng <= p.max_range && bearing >= p.angle_min &&
                    bearing < p.angle_max;
    if (ok) {
      const int bin = min(max(__float2int_rz(__fmul_rn(__fsub_rn(bearing, p.angle_min),
                                                       p.bin_factor)), 0), p.n_bins - 1);
      const int q = __float2int_rz(fminf(fmaxf(__fmul_rn(rng, p.scale), 0.f), 2097151.f));
      atomicMin(&s_table[bin], q);
      atomicMax(&s_table[p.n_bins + bin], q);
    }
  }
  __syncthreads();
  int* t = table + static_cast<long long>(c) * 2 * p.n_bins;
  for (int b = threadIdx.x; b < p.n_bins; b += kThreads) {
    if (s_table[p.n_bins + b] >= 0) {
      atomicMin(&t[b], s_table[b]);
      atomicMax(&t[p.n_bins + b], s_table[p.n_bins + b]);
    }
  }
}

__global__ void finalize(const int* __restrict__ table, int C, int n_bins, float inv_scale,
                         float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;   // (camera, bin)
  if (i >= C * n_bins) return;
  const int c = i / n_bins, b = i % n_bins;
  const int* t = table + static_cast<long long>(c) * 2 * n_bins;
  const int hi = t[n_bins + b];
  const bool has = hi >= 0;
  out[i] = has ? __fmul_rn(static_cast<float>(t[b]), inv_scale) : __int_as_float(0x7f800000);
  out[C * n_bins + i] = has ? __fmul_rn(static_cast<float>(hi), inv_scale)
                            : __int_as_float(0x7f800000);
}

__global__ void __launch_bounds__(kThreads)
bin_rows(const float* __restrict__ rng, const bool* __restrict__ ok, const int* __restrict__ bins,
         int P, int n_bins, float scale, float inv_scale, float* __restrict__ out, int B) {
  extern __shared__ int s_table[];   // [0, n_bins): min q; [n_bins, 2·n_bins): max q
  const int b = blockIdx.x;
  for (int k = threadIdx.x; k < n_bins; k += kThreads) {
    s_table[k] = INT_MAX;
    s_table[n_bins + k] = -1;
  }
  __syncthreads();
  const long long row = static_cast<long long>(b) * P;
  for (int i = threadIdx.x; i < P; i += kThreads) {
    if (!ok[row + i]) continue;
    const int bin = min(max(bins[row + i], 0), n_bins - 1);
    const int q = __float2int_rz(fminf(fmaxf(__fmul_rn(rng[row + i], scale), 0.f), 2097151.f));
    atomicMin(&s_table[bin], q);
    atomicMax(&s_table[n_bins + bin], q);
  }
  __syncthreads();
  for (int k = threadIdx.x; k < n_bins; k += kThreads) {
    const int hi = s_table[n_bins + k];
    const bool has = hi >= 0;
    const long long o = static_cast<long long>(b) * n_bins + k;
    out[o] = has ? __fmul_rn(static_cast<float>(s_table[k]), inv_scale)
                 : __int_as_float(0x7f800000);
    out[static_cast<long long>(B) * n_bins + o] =
        has ? __fmul_rn(static_cast<float>(hi), inv_scale) : __int_as_float(0xff800000);
  }
}

}  // namespace

// out (2, B, n_bins): near then far ranges of B scans of P entries each
// (ranges rng, flags ok, bins), +inf / -inf where a bin is empty.
extern "C" int uz_bin_min_max(const float* rng, const bool* ok, const int* bins, int B, int P,
                              int n_bins, float scale, float inv_scale, float* out,
                              void* stream) {
  if (B <= 0 || n_bins <= 0) return static_cast<int>(cudaGetLastError());
  bin_rows<<<B, kThreads, 2 * n_bins * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      rng, ok, bins, P, n_bins, scale, inv_scale, out, B);
  return static_cast<int>(cudaGetLastError());
}

// out (2, C, n_bins): near then far ranges (+inf where a bin is empty) of
// depth (C, H, W) metres with camera-to-base transforms xf (C, 12) = [R row
// major, t]; table (C, 2, n_bins) int32 scratch.
extern "C" int uz_scan_bins(const float* depth, const float* xf, int C, int H, int W, float fx,
                            float fy, float cx, float cy, int n_bins, float angle_min,
                            float angle_max, float bin_factor, float band_lo, float band_hi,
                            float min_range, float max_range, float scale, float inv_scale,
                            int* table, float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C <= 0 || n_bins <= 0) return static_cast<int>(cudaGetLastError());
  const Params p{H, W, n_bins, fx, fy, cx, cy, angle_min, angle_max, bin_factor,
                 band_lo, band_hi, min_range, max_range, scale, inv_scale};
  const int entries = C * 2 * n_bins;
  init_table<<<(entries + kThreads - 1) / kThreads, kThreads, 0, s>>>(table, C, n_bins);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (H > 0 && W > 0) {
    scan_pixels<<<dim3((H * W + kThreads - 1) / kThreads, C), kThreads,
                   2 * n_bins * sizeof(int), s>>>(depth, xf, p, table);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  finalize<<<(C * n_bins + kThreads - 1) / kThreads, kThreads, 0, s>>>(table, C, n_bins,
                                                                     inv_scale, out);
  return static_cast<int>(cudaGetLastError());
}
