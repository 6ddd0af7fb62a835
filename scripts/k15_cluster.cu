// K15's scan_bins in the form of one thread-block cluster a camera: the
// A/B reference of the shipped grid form (uzliti_slam_tpu_torch/csrc/
// scan_bins.cu), built and timed beside it by scripts/k7_k15_variants.py
// alone.  The same per-pixel arithmetic; 16 CTAs of 1024 threads a camera
// deal the image's rows among their warps (a lane takes a run of
// ceil(W/32) columns), each CTA reduces into its shared table, and the
// cluster's tables are folded through distributed shared memory: one
// launch and no device scratch, but only 16 SMs a camera (its times on
// the card are in PERF.md).
#include <climits>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kClusterCtas = 16;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxWidth = 16384;
constexpr int kMaxDevices = 64;

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
scan_cluster(const float* __restrict__ depth, const float* __restrict__ xf, Params p,
             float* __restrict__ out, int C) {
  extern __shared__ int s_table[];   // [0, n): min q; [n, 2n): max q; then W floats (u - cx)/fx
  float* s_xs = reinterpret_cast<float*>(s_table + 2 * p.n_bins);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int c = blockIdx.x / kClusterCtas;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int b = tid; b < p.n_bins; b += kThreads) {
    s_table[b] = INT_MAX;
    s_table[p.n_bins + b] = -1;
  }
  for (int u = tid; u < p.W; u += kThreads)
    s_xs[u] = __fdiv_rn(__fsub_rn(static_cast<float>(u), p.cx), p.fx);
  __syncthreads();
  const float* m = xf + 12 * c;
  const float m0 = m[0], m1 = m[1], m2 = m[2], m3 = m[3], m4 = m[4], m5 = m[5];
  const float m6 = m[6], m7 = m[7], m8 = m[8], t0 = m[9], t1 = m[10], t2 = m[11];
  const int run = (p.W + 31) / 32;
  const int u0 = lane * run, u1 = min(u0 + run, p.W);
  for (int v = rank + kClusterCtas * warp; v < p.H; v += kClusterCtas * kWarps) {
    const float* row = depth + (static_cast<long long>(c) * p.H + v) * p.W;
    const float ys = __fdiv_rn(__fsub_rn(static_cast<float>(v), p.cy), p.fy);
    for (int u = u0; u < u1; ++u) {
      const float d = row[u];
      if (!(d > 0.01f) || !isfinite(d)) continue;
      const float xc = __fmul_rn(s_xs[u], d);
      const float yc = __fmul_rn(ys, d);
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
  }
  cluster.sync();
  // bin i is folded by the cluster's thread i: rank i % 16, thread i / 16
  for (int i = tid * kClusterCtas + rank; i < p.n_bins; i += kThreads * kClusterCtas) {
    int lo = INT_MAX, hi = -1;
#pragma unroll
    for (int q = 0; q < kClusterCtas; ++q) {
      const int* t = cluster.map_shared_rank(s_table, q);
      lo = min(lo, t[i]);
      hi = max(hi, t[p.n_bins + i]);
    }
    const bool has = hi >= 0;
    const long long o = static_cast<long long>(c) * p.n_bins + i;
    out[o] = has ? __fmul_rn(static_cast<float>(lo), p.inv_scale) : __int_as_float(0x7f800000);
    out[static_cast<long long>(C) * p.n_bins + o] =
        has ? __fmul_rn(static_cast<float>(hi), p.inv_scale) : __int_as_float(0x7f800000);
  }
  // no CTA leaves while another may still read its table
  cluster.sync();
}

void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, int C, size_t smem) {
  cfg = {};
  cfg.gridDim = dim3(C * kClusterCtas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// Once per device: the kernel may take a cluster above the portable size,
// and such a cluster, with the widest image's shared memory, must fit.
int prepare() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && ready[dev]) return 0;
  const size_t smem_max = 2 * 1023 * sizeof(int) + kMaxWidth * sizeof(float);
  err = cudaFuncSetAttribute(scan_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_max));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(scan_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cfg, attr, 1, smem_max);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, scan_cluster, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  if (dev < kMaxDevices) ready[dev] = true;
  return 0;
}

}  // namespace

// out (2, C, n_bins): near then far ranges (+inf where a bin is empty) of
// depth (C, H, W) metres with camera-to-base transforms xf (C, 12) = [R row
// major, t].  One cluster of 16 CTAs of 1024 threads a camera; 701 =
// cudaErrorLaunchOutOfResources if such a cluster does not fit the card.
extern "C" int uz_scan_bins_cluster(const float* depth, const float* xf, int C, int H, int W, float fx,
                            float fy, float cx, float cy, int n_bins, float angle_min,
                            float angle_max, float bin_factor, float band_lo, float band_hi,
                            float min_range, float max_range, float scale, float inv_scale,
                            float* out, void* stream) {
  if (C <= 0) return 0;
  if (n_bins <= 0 || n_bins > 1023 || H < 0 || W < 0 || W > kMaxWidth)
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = prepare();
  if (err != 0) return err;
  const Params p{H, W, n_bins, fx, fy, cx, cy, angle_min, angle_max, bin_factor,
                 band_lo, band_hi, min_range, max_range, scale, inv_scale};
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(cfg, attr, C, 2 * n_bins * sizeof(int) + static_cast<size_t>(W) * sizeof(float));
  cfg.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, scan_cluster, depth, xf, p, out, C));
}
