// K18 icp: planar point-to-line ICP, every iteration, the final audit, the
// Censi covariance and the gates of a batch of scan-matching problems in one
// launch.
//
// Replaces uzliti_slam_tpu/ops/icp.py:_correspondences (:40-61) inside
// icp_point_to_line (:64-120).  Per iteration the reference forms the
// (M, N) squared distances of the moved source points to the target points
// (+inf at invalid targets), takes the two nearest targets of each source
// point with top_k, builds the point-to-line residual r, its Jacobian
// J = [n_x, n_y, n . d(moved)/d(theta)] and the weight w (valid source, both
// neighbours finite, nearest within max_corr), then solves
// (sum w J J^T + 1e-9 I) delta = -(sum w J r) and adds delta to the pose, for
// a fixed number of iterations; then it recounts the correspondences at the
// final pose (valid fraction, mse) and takes cov = sigma^2 (sum w J J^T +
// 1e-6 I)^-1.  Gates: valid fraction >= min, |correction| < (1.5 m, 0.8
// rad), finite pose.
//
// What bounds it on the card: iterations x M x N distance tests, 21 x 360 x
// 360 x ~8 = 22 M operations a problem (0.3 us at 67 T/s).  Each iteration
// depends on the last one's pose, so a problem is a chain of 21 short
// parallel phases, each ended by a reduction and a 3x3 solve: latency, not
// arithmetic or bytes, bounds it.
//
// Design: one thread-block cluster per problem (kClusterCtas CTAs of
// kThreads: 16 of 256, a cluster above the portable 8, measured fastest
// among 1-16 CTAs of 256-1024 threads, scripts/k18_variants.py), the
// problem batch on the grid.
//   - Every CTA holds the whole target scan in shared memory (21 bytes a
//     point: the points, their flags, and the valid points compacted in
//     ascending index order with their indices), so the searches read only
//     shared memory and skip invalid targets.
//   - The source points are dealt to the cluster's warps; each point's
//     nearest-two search is split over a group of kLanes = 8 lanes (a warp
//     searches 4 points a pass) and merged by butterfly shuffles within the
//     group.  A candidate is the 64-bit key (distance bits, target index):
//     the squared distance is >= +0, so unsigned order is (distance, then
//     index), the reference's top_k order with ties to the lower index.
//   - A point with fewer than two finite distances among the valid targets
//     (fewer than two valid targets, or distances overflowed) searches all
//     N targets again with +inf at the invalid ones: the reference's top_k
//     over +inf, the lowest indices first.
//   - Each lane sums its points' 11 terms (H upper, J r, w, r^2 w) in its
//     order; a warp tree, the CTA's warps in order, then the cluster's CTAs
//     in rank order through distributed shared memory: a fixed order with
//     no atomics, so two runs give the same bits.  The CTA partials are
//     double-buffered by iteration parity, so one cluster barrier an
//     iteration suffices; every thread then solves the same 3x3 system from
//     the same sums and so holds the same pose bits, with no barrier to hand
//     the pose out.
//   - The 3x3 solve and inverse are LU with partial pivoting (the first
//     largest pivot, as LAPACK's isamax), unrolled into registers.  No
//     multiply-add is contracted (__f*_rn), so the kernel does the plain
//     version's arithmetic; the reference's compiled form contracts some,
//     and its LAPACK LU scales by a reciprocal pivot: the pose agrees with it
//     within the stated tolerance.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSums = 11;   // H (6 upper entries), J r (3), w, r^2 w
constexpr int kMaxPoints = 8192;
constexpr int kBytesPerPoint = 2 * sizeof(float2) + sizeof(int) + 1;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr uint64_t kNone = ~0ull;   // an empty candidate, after every real one
constexpr unsigned kInfBits = 0x7f800000u;
constexpr int kMaxDevices = 16;

// the launch shape (CTAs a cluster, threads a CTA) and the lanes that split
// one point's search: the measured choice (PERF.md)
constexpr int kClusterCtas = 16, kThreads = 256;
constexpr int kLanes = 8, kPerPass = 32 / kLanes;
constexpr int kWarps = kThreads / 32;
static_assert(kLanes == 8 || kLanes == 16 || kLanes == 32, "kLanes: 8, 16 or 32");

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Doolittle LU of a 3x3 matrix with partial pivoting (the first largest
// pivot), in place and in registers: every index is a constant once
// unrolled, the row swap a predicated exchange; perm[i] is the original row
// at position i.
__device__ __forceinline__ void lu3(float (&a)[3][3], int (&perm)[3]) {
  perm[0] = 0; perm[1] = 1; perm[2] = 2;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int p = k;
    float m = fabsf(a[k][k]);
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      if (fabsf(a[i][k]) > m) { m = fabsf(a[i][k]); p = i; }
    }
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      if (p == i) {
#pragma unroll
        for (int j = 0; j < 3; ++j) { const float t = a[k][j]; a[k][j] = a[i][j]; a[i][j] = t; }
        const int t = perm[k]; perm[k] = perm[i]; perm[i] = t;
      }
    }
#pragma unroll
    for (int i = k + 1; i < 3; ++i) {
      const float l = __fdiv_rn(a[i][k], a[k][k]);
      a[i][k] = l;
#pragma unroll
      for (int j = k + 1; j < 3; ++j) a[i][j] = __fsub_rn(a[i][j], __fmul_rn(l, a[k][j]));
    }
  }
}

__device__ __forceinline__ void lu3_solve(const float (&lu)[3][3], const int (&perm)[3],
                                          const float (&b)[3], float (&x)[3]) {
  float y[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float s = perm[i] == 0 ? b[0] : perm[i] == 1 ? b[1] : b[2];
#pragma unroll
    for (int j = 0; j < i; ++j) s = __fsub_rn(s, __fmul_rn(lu[i][j], y[j]));
    y[i] = s;
  }
#pragma unroll
  for (int i = 2; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int j = i + 1; j < 3; ++j) s = __fsub_rn(s, __fmul_rn(lu[i][j], x[j]));
    x[i] = __fdiv_rn(s, lu[i][i]);
  }
}

__device__ __forceinline__ void unpack_h(const float* tot, float diag, float (&H)[3][3]) {
  H[0][0] = __fadd_rn(tot[0], diag); H[0][1] = tot[1]; H[0][2] = tot[2];
  H[1][1] = __fadd_rn(tot[3], diag); H[1][2] = tot[4]; H[2][2] = __fadd_rn(tot[5], diag);
  H[1][0] = H[0][1]; H[2][0] = H[0][2]; H[2][1] = H[1][2];
}

// (distance bits, index): unsigned order is distance, then index
__device__ __forceinline__ uint64_t key_of(float d, int j) {
  return (static_cast<uint64_t>(__float_as_uint(d)) << 32) | static_cast<unsigned>(j);
}

// selects, not branches: the lanes of a warp never diverge here
__device__ __forceinline__ void insert2(uint64_t k, uint64_t& k1, uint64_t& k2) {
  const bool lt1 = k < k1, lt2 = k < k2;
  k2 = lt1 ? k1 : (lt2 ? k : k2);
  k1 = lt1 ? k : k1;
}

__device__ __forceinline__ void merge2(uint64_t o1, uint64_t o2, uint64_t& k1, uint64_t& k2) {
  const bool lt1 = o1 < k1, lt2 = o1 < k2;
  const uint64_t second = k1 < o2 ? k1 : o2;
  k2 = lt1 ? second : (lt2 ? o1 : k2);
  k1 = lt1 ? o1 : k1;
}

__device__ __forceinline__ bool finite2(uint64_t k2) {
  return static_cast<unsigned>(k2 >> 32) < kInfBits;
}

__device__ __forceinline__ float dist2(float mx, float my, float2 t) {
  const float ex = __fsub_rn(mx, t.x), ey = __fsub_rn(my, t.y);
  return __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
}

// The scan in shared memory: all N targets, their flags, and the nv valid
// ones compacted in ascending index order with their indices.
struct Scan {
  const float2* tgt;
  const unsigned char* tvalid;
  const float2* cpts;
  const int* cids;
  int nv, N;
};

// A lane's part of the two nearest targets to (mx, my) over its segment
// of a list (every kLanes-th entry from sl), then the merge over the
// kLanes lanes of its point: every lane of the segment group ends with the
// group's two least keys.
__device__ __forceinline__ void merge_group(uint64_t& k1, uint64_t& k2) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    merge2(__shfl_xor_sync(kFull, k1, off), __shfl_xor_sync(kFull, k2, off), k1, k2);
}

// The two nearest targets of (mx, my) as keys, in every lane of the point's
// group of kLanes lanes: the lanes split the compacted valid targets; a
// group whose point has fewer than two finite distances there searches all
// N targets again with +inf at the invalid ones (the reference's top_k
// over +inf).  Every lane of the warp calls it (the shuffles span the warp).
__device__ __forceinline__ void nearest2(float mx, float my, const Scan& sc, int sl,
                                         uint64_t& k1, uint64_t& k2) {
  k1 = k2 = kNone;
#pragma unroll 4
  for (int j = sl; j < sc.nv; j += kLanes) {
    insert2(key_of(dist2(mx, my, sc.cpts[j]), sc.cids[j]), k1, k2);
  }
  merge_group(k1, k2);
  const bool redo = !finite2(k2);
  if (!__any_sync(kFull, redo)) return;
  uint64_t a1 = kNone, a2 = kNone;
  for (int j = sl; j < sc.N; j += kLanes)
    insert2(key_of(sc.tvalid[j] ? dist2(mx, my, sc.tgt[j]) : inf_f(), j), a1, a2);
  merge_group(a1, a2);
  if (redo) { k1 = a1; k2 = a2; }
}

__global__ void __launch_bounds__(kThreads, 1)
icp_cluster(const float* __restrict__ src, const unsigned char* __restrict__ src_valid,
            const float* __restrict__ dst, const unsigned char* __restrict__ dst_valid,
            const float* __restrict__ init, int M, int N, int iterations, float max_corr2,
            float min_fraction, float max_t, float max_r, float sigma2,
            float* __restrict__ pose_out, float* __restrict__ fraction_out,
            float* __restrict__ mse_out, float* __restrict__ cov_out,
            unsigned char* __restrict__ ok_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  float2* tgt = reinterpret_cast<float2*>(smem);                     // N points
  float2* cpts = tgt + N;                                            // the valid ones, compacted
  int* cids = reinterpret_cast<int*>(cpts + N);                      // their indices
  unsigned char* tvalid = reinterpret_cast<unsigned char*>(cids + N);  // N flags
  __shared__ float wpart[kWarps][kSums];
  __shared__ float part[2][kSums];      // this CTA's sums, read by the cluster
  __shared__ float tot[kSums];
  __shared__ int wcnt[kWarps];
  __shared__ int n_src;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / kClusterCtas, rank = static_cast<int>(cluster.block_rank());
  const float* bsrc = src + static_cast<size_t>(b) * M * 2;
  const unsigned char* bsv = src_valid + static_cast<size_t>(b) * M;

  // the target scan into shared memory, the valid points compacted in
  // ascending index order (a ballot and the warps' counts a chunk)
  if (tid == 0) n_src = 0;
  int nv = 0;
  for (int base = 0; base < N; base += kThreads) {
    const int j = base + tid;
    bool f = false;
    if (j < N) {
      const size_t o = static_cast<size_t>(b) * N + j;
      tgt[j] = make_float2(dst[2 * o], dst[2 * o + 1]);
      f = dst_valid[o] != 0;
      tvalid[j] = f;
    }
    const unsigned bal = __ballot_sync(kFull, f);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int off = nv, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcnt[w];
      off += w < warp ? c : 0;
      total += c;
    }
    if (f) {
      const int pos = off + __popc(bal & ((1u << lane) - 1u));
      cpts[pos] = tgt[j];
      cids[pos] = j;
    }
    nv += total;
    __syncthreads();
  }
  int mine = 0;
  for (int i = tid; i < M; i += kThreads) mine += bsv[i] != 0;
  if (mine) atomicAdd(&n_src, mine);   // an integer count: any order gives the same
  __syncthreads();
  const Scan sc{tgt, tvalid, cpts, cids, nv, N};

  // every thread carries the pose: each solves the same system from the same
  // sums, so all hold the same bits with no barrier to hand it out
  float p0 = init[3 * b], p1 = init[3 * b + 1], th = init[3 * b + 2];
  const int gwarp = rank * kWarps + warp;
  constexpr int kAllWarps = kClusterCtas * kWarps;
  for (int it = 0; it <= iterations; ++it) {
    const float c = cosf(th), s = sinf(th);
    float acc[kSums];
#pragma unroll
    for (int q = 0; q < kSums; ++q) acc[q] = 0.f;
    // groups of up to 32 points a warp: point base + k·kAllWarps is lane k's
    for (int base = gwarp; base < M; base += 32 * kAllWarps) {
      const int i = base + lane * kAllWarps;
      const bool have = i < M;
      float px = 0.f, py = 0.f;
      bool sv = false;
      if (have) {
        px = bsrc[2 * i];
        py = bsrc[2 * i + 1];
        sv = bsv[i] != 0;
      }
      const float mx = __fadd_rn(__fsub_rn(__fmul_rn(c, px), __fmul_rn(s, py)), p0);
      const float my = __fadd_rn(__fadd_rn(__fmul_rn(s, px), __fmul_rn(c, py)), p1);
      const int n_here = min(32, (M - base + kAllWarps - 1) / kAllWarps);
      // a pass searches kPerPass points, kLanes lanes each; the point's own
      // lane then takes the group's result
      uint64_t m1 = kNone, m2 = kNone;
      const int sub = lane / kLanes, sl = lane % kLanes;
      for (int k = 0; k < n_here; k += kPerPass) {
        const int from = min(k + sub, n_here - 1);   // past the group: a repeat, not kept
        uint64_t k1, k2;
        nearest2(__shfl_sync(kFull, mx, from), __shfl_sync(kFull, my, from), sc, sl, k1, k2);
        const int owner = lane - k;                     // this lane's point's group
        const int src_lane = (owner >= 0 && owner < kPerPass ? owner : 0) * kLanes;
        const uint64_t r1 = __shfl_sync(kFull, k1, src_lane), r2 = __shfl_sync(kFull, k2, src_lane);
        if (owner >= 0 && owner < kPerPass) { m1 = r1; m2 = r2; }
      }
      if (!have) continue;
      const float d1 = __uint_as_float(static_cast<unsigned>(m1 >> 32));
      const float d2 = __uint_as_float(static_cast<unsigned>(m2 >> 32));
      const float2 a = tgt[static_cast<unsigned>(m1)], bb = tgt[static_cast<unsigned>(m2)];
      const float sx = __fsub_rn(bb.x, a.x), sy = __fsub_rn(bb.y, a.y);
      float len = sqrtf(__fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sy, sy)));
      len = len < 1e-9f ? 1e-9f : len;
      const float nx = __fdiv_rn(-sy, len), ny = __fdiv_rn(sx, len);
      const float r =
          __fadd_rn(__fmul_rn(__fsub_rn(mx, a.x), nx), __fmul_rn(__fsub_rn(my, a.y), ny));
      const float w = (sv && d1 < max_corr2 && isfinite(d1) && isfinite(d2)) ? 1.f : 0.f;
      const float t0 = __fadd_rn(-my, p1), t1 = __fsub_rn(mx, p0);
      const float J[3] = {nx, ny, __fadd_rn(__fmul_rn(nx, t0), __fmul_rn(ny, t1))};
      int q = 0;
#pragma unroll
      for (int u = 0; u < 3; ++u) {
#pragma unroll
        for (int v = u; v < 3; ++v) {
          acc[q] = __fadd_rn(acc[q], __fmul_rn(__fmul_rn(J[u], J[v]), w));
          ++q;
        }
      }
#pragma unroll
      for (int u = 0; u < 3; ++u)
        acc[6 + u] = __fadd_rn(acc[6 + u], __fmul_rn(__fmul_rn(J[u], r), w));
      acc[9] = __fadd_rn(acc[9], w);
      acc[10] = __fadd_rn(acc[10], __fmul_rn(__fmul_rn(r, r), w));
    }
    // the sums: a warp tree, the CTA's warps in order, the cluster's CTAs in
    // rank order
#pragma unroll
    for (int q = 0; q < kSums; ++q)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[q] = __fadd_rn(acc[q], __shfl_down_sync(kFull, acc[q], off));
    if (lane == 0)
#pragma unroll
      for (int q = 0; q < kSums; ++q) wpart[warp][q] = acc[q];
    __syncthreads();
    const int par = it & 1;
    if (tid < kSums) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t = __fadd_rn(t, wpart[w][tid]);
      part[par][tid] = t;
    }
    cluster.sync();
    if (tid < kSums) {
      float v[kClusterCtas];
#pragma unroll
      for (int q = 0; q < kClusterCtas; ++q) v[q] = *cluster.map_shared_rank(&part[par][tid], q);
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < kClusterCtas; ++q) t = __fadd_rn(t, v[q]);
      tot[tid] = t;
    }
    __syncthreads();
    if (it < iterations) {
      float H[3][3];
      int perm[3];
      unpack_h(tot, 1e-9f, H);
      lu3(H, perm);
      const float rhs[3] = {tot[6], tot[7], tot[8]};
      float x[3];
      lu3_solve(H, perm, rhs, x);
      p0 = __fadd_rn(p0, -x[0]);
      p1 = __fadd_rn(p1, -x[1]);
      th = __fadd_rn(th, -x[2]);
      continue;
    }
    // the final audit at the last pose
    if (rank == 0 && tid == 0) {
      const float n_good = tot[9];
      const int ns = n_src > 1 ? n_src : 1;
      const float fraction = __fdiv_rn(n_good, static_cast<float>(ns));
      const float mse = __fdiv_rn(tot[10], n_good > 1.f ? n_good : 1.f);
      float H[3][3];
      int perm[3];
      unpack_h(tot, 1e-6f, H);
      lu3(H, perm);
      float cov[3][3];
#pragma unroll
      for (int col = 0; col < 3; ++col) {
        const float e[3] = {col == 0 ? 1.f : 0.f, col == 1 ? 1.f : 0.f, col == 2 ? 1.f : 0.f};
        float x[3];
        lu3_solve(H, perm, e, x);
#pragma unroll
        for (int row = 0; row < 3; ++row) cov[row][col] = __fmul_rn(sigma2, x[row]);
      }
      const float* ini = init + 3 * b;
      const float c0 = __fsub_rn(p0, ini[0]), c1 = __fsub_rn(p1, ini[1]);
      const float c2 = __fsub_rn(th, ini[2]);
      const bool corr_ok = fabsf(c0) < max_t && fabsf(c1) < max_t && fabsf(c2) < max_r;
      const bool finite = isfinite(p0) && isfinite(p1) && isfinite(th);
      pose_out[3 * b] = p0;
      pose_out[3 * b + 1] = p1;
      pose_out[3 * b + 2] = th;
      fraction_out[b] = fraction;
      mse_out[b] = mse;
#pragma unroll
      for (int q = 0; q < 9; ++q) cov_out[9 * b + q] = cov[q / 3][q % 3];
      ok_out[b] = fraction >= min_fraction && corr_ok && finite;
    }
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();
}

// Once per device: the kernel may take kMaxPoints targets' shared memory and
// a cluster above the portable size, and such a cluster must fit the card.
int prepare() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && ready[dev]) return 0;
  err = cudaFuncSetAttribute(icp_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxPoints * kBytesPerPoint);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(icp_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterCtas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kMaxPoints * kBytesPerPoint;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, icp_cluster, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  if (dev < kMaxDevices) ready[dev] = true;
  return 0;
}

}  // namespace

// src: (B, M, 2) float32, src_valid: (B, M) bool; dst: (B, N, 2) float32,
// dst_valid: (B, N) bool; init: (B, 3).  Out: pose (B, 3), fraction (B,),
// mse (B,), cov (B, 3, 3), ok (B,) bool.  2 <= N <= 8192.  One cluster of
// 16 CTAs of 256 threads a problem; 701 = cudaErrorLaunchOutOfResources if
// such a cluster does not fit the card.
extern "C" int uz_icp(const float* src, const unsigned char* src_valid, const float* dst,
                      const unsigned char* dst_valid, const float* init, int B, int M, int N,
                      int iterations, float max_corr2, float min_fraction, float max_t,
                      float max_r, float sigma2, float* pose, float* fraction, float* mse,
                      float* cov, unsigned char* ok, void* stream) {
  if (B <= 0) return 0;
  if (N < 2 || N > kMaxPoints || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int err = prepare();
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kClusterCtas, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(N) * kBytesPerPoint;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, icp_cluster, src, src_valid, dst, dst_valid,
                                             init, M, N, iterations, max_corr2, min_fraction,
                                             max_t, max_r, sigma2, pose, fraction, mse, cov, ok));
}
