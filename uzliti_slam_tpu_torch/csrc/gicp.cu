// K26 knn_normals and K27 gicp: the gicp estimator's normals and 6-D ICP.
//
// K26 replaces uzliti_slam_tpu/ops/gicp.py:estimate_normals (:89-102): per
// point of a voxel cloud the M x M squared distances (XLA compiles the sum of
// squares as fma(z, z, fma(y, y, x * x))), +inf at invalid points, the 8
// nearest (lax.top_k of -d2: ties to the lower index), their mean and
// covariance + 1e-9 I, and eigh's smallest eigenvector.
// Design: one thread per point, the problem's cloud in shared memory (16 B a
// point), a running top-8 in registers ordered by (distance, index), the
// sums in neighbour order, and the eigenvector by cyclic Jacobi on the 3x3
// (a fixed number of sweeps; a closed trigonometric form loses the small
// eigenvalue's vector when two eigenvalues nearly coincide).  The keyframe
// step launches it once for all candidates' target clouds (grid.y).
//
// K27 replaces gicp_6d (:105-172): 20 iterations, each a first argmin over
// the valid targets of d_xyz + w * d_Lab (compiled as fma(w, d_Lab, d_xyz)),
// a point-to-plane row per source point weighted by its validity and the
// correspondence radius, (sum J J^T + 1e-6 I) dx = -(sum J r), and the LEFT
// update pose <- exp(dx) o pose (not the solver's retraction); then the
// nearest-target audit (fraction, mse) and the gates fraction > 0.3,
// |dt| <= 1 m, |dtheta| <= pi/6, finite.
// Design, K18's (icp.cu): one thread-block cluster per target cloud (the
// keyframe step's candidates), kClusterCtas CTAs of kCtaThreads (8 of 512,
// 16 lanes a point: the fastest of 4-16 CTAs of 256-512 threads and 8-16
// lanes at the step's and the large shapes, scripts/k27_k28_variants.py).
//   - Every CTA holds the whole target cloud in shared memory as three
//     16-byte vectors a point (position and validity flag, Lab, normal), so
//     a search step is two LDS.128 and the normal is read only at the match.
//   - The source points are dealt to the cluster's warps; each point's
//     search is split over a group of kLanes lanes (each scans every
//     kLanes-th target) and merged by butterfly shuffles within the group.
//     A lane keeps its first minimum (ascending targets, strict <, a NaN
//     kept once taken); the merge is an unsigned minimum of 64-bit keys (0
//     for a NaN, else the distance in total order + 1; then the index),
//     which is order-free and gives argmin's first NaN or first minimum.
//     The audit's nearest distance is a NaN-propagating minimum (amin's).
//   - Each lane sums its points' 27 terms in its order; a warp tree (a
//     reduce-scatter butterfly, uz::warp_sum_scatter: 31 shuffles for the
//     27 sums), the CTA's warps in order, then the cluster's CTAs in rank order through
//     distributed shared memory, the CTA partials double-buffered by
//     iteration parity: one cluster barrier an iteration, no atomics, the
//     same bits run to run.
//   - Warp 0 solves the 6x6 system (LU with partial pivoting in registers,
//     lu_solve6) and makes the left update (se3_exp_rcp, pose_compose_rcp),
//     then hands the pose out through shared memory (one CTA barrier).  The
//     solve's chain is latency: IEEE divisions cost most of it (3.9 us an
//     iteration with 35 of them, 1.7 us with six in the LU; the stamps of
//     scripts/k27_k28_variants.py), so the LU divides once a pivot and the
//     exp multiplies by reciprocals.
//   - A lane's source point of the warp's first group stays in registers
//     across the iterations.
// No cuSOLVER call: its solve checks an info flag on the host, and the
// step reads nothing back.
//
// What bounds them on the card: K26 does M^2 distance tests (8 flops each):
// 10 x 256^2 at the keyframe step, 5 Mflop, under a microsecond at 67
// TFLOP/s; K27 does 21 x M x N 6-D distances (17 flops each), 10 x 21 x
// 256^2 x 17 = 234 Mflop, 3.5 us.  Each of K27's iterations depends on the
// last one's pose, so a problem is a chain of 21 short parallel phases, each
// ended by a reduction and a 6x6 solve: latency bounds it, which the
// cluster shortens by spreading each phase over kClusterCtas SMs.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "linalg.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kK = 8;             // KNN_K in kernels/ops.py
constexpr int kEighSweeps = 8;    // JACOBI_SWEEPS
constexpr int kNormalThreads = 256;
constexpr int kSums = 27;         // H upper triangle (21), J^T r (6)
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxTargets = 2048;                      // GICP_MAX_POINTS
constexpr int kTargetBytes = 3 * sizeof(float4);       // position + flag, Lab, normal
constexpr int kMaxDevices = 16;

// K27's launch shape (CTAs a cluster, threads a CTA) and the lanes that
// split one point's search: the measured choice (PERF.md,
// scripts/k27_k28_variants.py)
constexpr int kClusterCtas = 8, kCtaThreads = 512;
constexpr int kLanes = 16, kPerPass = 32 / kLanes;
constexpr int kWarps = kCtaThreads / 32, kAllWarps = kClusterCtas * kWarps;
static_assert(kLanes == 4 || kLanes == 8 || kLanes == 16 || kLanes == 32, "kLanes");

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float sum_sq3(float x, float y, float z) {
  return fmaf(z, z, fmaf(y, y, x * x));
}

// Cyclic Jacobi on a symmetric 3x3 (a00, a01, a02, a11, a12, a22), pairs
// (0,1), (0,2), (1,2), as kernels/ops.py:jacobi_eigh3_plain; V's columns
// are the eigenvectors.
__device__ void jacobi_eigh3(float A[3][3], float V[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) V[i][j] = i == j ? 1.f : 0.f;
  const int P[3] = {0, 0, 1}, Q[3] = {1, 2, 2};
  for (int sweep = 0; sweep < kEighSweeps; ++sweep) {
#pragma unroll
    for (int pq = 0; pq < 3; ++pq) {
      const int p = P[pq], q = Q[pq], r = 3 - p - q;
      const float apq = A[p][q];
      if (apq == 0.f) continue;
      const float theta = (A[q][q] - A[p][p]) / (2.f * apq);
      const float t = (theta >= 0.f ? 1.f : -1.f) / (fabsf(theta) + sqrtf(theta * theta + 1.f));
      const float c = 1.f / sqrtf(t * t + 1.f), s = t * c;
      const float app = A[p][p], aqq = A[q][q], arp = A[r][p], arq = A[r][q];
      A[p][p] = app - t * apq;
      A[q][q] = aqq + t * apq;
      A[p][q] = A[q][p] = 0.f;
      A[r][p] = A[p][r] = c * arp - s * arq;
      A[r][q] = A[q][r] = s * arp + c * arq;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float vp = V[i][p], vq = V[i][q];
        V[i][p] = c * vp - s * vq;
        V[i][q] = s * vp + c * vq;
      }
    }
  }
}

__global__ void __launch_bounds__(kNormalThreads)
knn_normals_kernel(const float* __restrict__ pts, const unsigned char* __restrict__ valid, int M,
                   float* __restrict__ normals) {
  extern __shared__ float4 sp[];
  const int b = blockIdx.y;
  const float* bp = pts + static_cast<size_t>(b) * M * 3;
  const unsigned char* bv = valid + static_cast<size_t>(b) * M;
  for (int j = threadIdx.x; j < M; j += blockDim.x)
    sp[j] = make_float4(bp[3 * j], bp[3 * j + 1], bp[3 * j + 2], bv[j] ? 1.f : 0.f);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const float4 p = sp[i];
  float bd[kK];
  int bi[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    bd[k] = inf_f();
    bi[k] = 0x7fffffff;
  }
  for (int j = 0; j < M; ++j) {
    const float4 q = sp[j];
    float d = inf_f();
    if (q.w != 0.f) d = sum_sq3(p.x - q.x, p.y - q.y, p.z - q.z);
    if (!(d < bd[kK - 1] || (d == bd[kK - 1] && j < bi[kK - 1]))) continue;
    float cd = d;
    int ci = j;
#pragma unroll
    for (int k = 0; k < kK; ++k) {   // insertion ordered by (distance, index)
      if (cd < bd[k] || (cd == bd[k] && ci < bi[k])) {
        const float td = bd[k];
        const int ti = bi[k];
        bd[k] = cd;
        bi[k] = ci;
        cd = td;
        ci = ti;
      }
    }
  }
  float nb[kK][3], wn[kK];
  float s[3] = {0.f, 0.f, 0.f}, n = 0.f;
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float4 q = sp[bi[k]];
    nb[k][0] = q.x;
    nb[k][1] = q.y;
    nb[k][2] = q.z;
    wn[k] = isfinite(bd[k]) ? 1.f : 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) s[a] = s[a] + nb[k][a] * wn[k];
    n = n + wn[k];
  }
  const float den = n < 1.f ? 1.f : n;
  const float mu[3] = {s[0] / den, s[1] / den, s[2] / den};
  float C[3][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
  for (int k = 0; k < kK; ++k) {
    const float c[3] = {(nb[k][0] - mu[0]) * wn[k], (nb[k][1] - mu[1]) * wn[k],
                        (nb[k][2] - mu[2]) * wn[k]};
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int e = 0; e < 3; ++e) C[a][e] = C[a][e] + c[a] * c[e];
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) C[a][a] = C[a][a] + 1e-9f;
  float V[3][3];
  jacobi_eigh3(C, V);
  int lo = 0;
  if (C[1][1] < C[lo][lo]) lo = 1;
  if (C[2][2] < C[lo][lo]) lo = 2;
  float* out = normals + (static_cast<size_t>(b) * M + i) * 3;
#pragma unroll
  for (int a = 0; a < 3; ++a) out[a] = V[a][lo];
}

// The first minimum's key of a distance (the reference's argmin over the
// valid targets): 0 for a NaN (argmin's minimum), else the distance in
// unsigned total order (-0 as +0) plus 1, then the target index; an unsigned
// minimum over such keys is order-free and picks the first NaN, else the
// first smallest distance (kernels/ops.py:argmin_key_plain).
__device__ __forceinline__ uint64_t argmin_key(float d, int j) {
  unsigned u = __float_as_uint(d == 0.f ? 0.f : d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  const unsigned hi = isnan(d) ? 0u : u + 1u;
  return (static_cast<uint64_t>(hi) << 32) | static_cast<unsigned>(j);
}

// a NaN-propagating minimum (torch.amin's): order-free
__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fc00000) : fminf(a, b);
}

// One source point's search, split over the kLanes lanes of its group (lane
// sl scans targets sl, sl + kLanes, ...): the key of its first minimum of
// fma(cw, d_Lab, d_xyz) over the valid targets (+inf at the others), or,
// in the audit, the NaN-propagating minimum of d_xyz over the valid ones
// (returned in key's low word as float bits).  Every lane of the warp calls
// it (the merge's shuffles span the warp); every lane of the group ends
// with the group's result.
template <bool kAudit>
__device__ __forceinline__ uint64_t search(const float m[3], const float l[3], const float4* tp,
                                           const float4* tl, int N, float cw, int sl) {
  float best = inf_f();
  int bj = sl;
#pragma unroll 4
  for (int j = sl; j < N; j += kLanes) {
    const float4 p = tp[j];
    const float dg = sum_sq3(m[0] - p.x, m[1] - p.y, m[2] - p.z);
    if (kAudit) {
      best = p.w != 0.f ? nan_min(best, dg) : best;
      continue;
    }
    const float4 c = tl[j];
    const float dc = sum_sq3(l[0] - c.x, l[1] - c.y, l[2] - c.z);
    const float d = p.w != 0.f ? fmaf(cw, dc, dg) : inf_f();
    // the lane's targets come in ascending order: strict < keeps the first
    // minimum, and a NaN, once taken, stays
    const bool take = d < best || (isnan(d) && !isnan(best));
    best = take ? d : best;
    bj = take ? j : bj;
  }
  if (kAudit) {
#pragma unroll
    for (int off = kLanes / 2; off > 0; off >>= 1)
      best = nan_min(best, __shfl_xor_sync(kFull, best, off));
    return __float_as_uint(best);
  }
  uint64_t key = sl < N ? argmin_key(best, bj) : ~0ull;
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    const uint64_t o = __shfl_xor_sync(kFull, key, off);
    key = o < key ? o : key;
  }
  return key;
}

__global__ void __launch_bounds__(kCtaThreads, 1)
gicp_cluster(const float* __restrict__ src, const float* __restrict__ src_lab,
             const unsigned char* __restrict__ src_valid, const float* __restrict__ dst,
             const float* __restrict__ dst_lab, const unsigned char* __restrict__ dst_valid,
             const float* __restrict__ normals, const float* __restrict__ init, int M, int N,
             int iterations, float max_corr2, float cw, float min_fraction, float max_t,
             float max_r, float* __restrict__ pose_out, float* __restrict__ fraction_out,
             float* __restrict__ mse_out, unsigned char* __restrict__ ok_out,
             int* __restrict__ matches) {
  extern __shared__ __align__(16) float4 st[];
  float4* tp = st;           // N x (position, valid flag)
  float4* tl = tp + N;       // N x (Lab, 0)
  float4* tn = tl + N;       // N x (normal, 0)
  __shared__ float wpart[kWarps][kSums];
  __shared__ float part[2][kSums];   // this CTA's sums, read by the cluster
  __shared__ float tot[kSums];
  __shared__ float spose[7];   // the pose warp 0 solved for
  __shared__ int n_src;

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / kClusterCtas, rank = static_cast<int>(cluster.block_rank());
  if (tid == 0) n_src = 0;
  const size_t off = static_cast<size_t>(b) * N;
  for (int j = tid; j < N; j += kCtaThreads) {
    const size_t o = 3 * (off + j);
    tp[j] = make_float4(dst[o], dst[o + 1], dst[o + 2], dst_valid[off + j] ? 1.f : 0.f);
    tl[j] = make_float4(dst_lab[o], dst_lab[o + 1], dst_lab[o + 2], 0.f);
    tn[j] = make_float4(normals[o], normals[o + 1], normals[o + 2], 0.f);
  }
  __syncthreads();
  int mine = 0;
  for (int i = tid; i < M; i += kCtaThreads) mine += src_valid[i] != 0;
  if (mine) atomicAdd(&n_src, mine);   // an integer count: any order gives the same
  __syncthreads();

  // every thread carries the pose: warp 0 solves each iteration's system and
  // hands the new pose out through shared memory
  float pose[7];
#pragma unroll
  for (int k = 0; k < 7; ++k) pose[k] = init[7 * b + k];
  const int gwarp = rank * kWarps + warp;
  const int sub = lane / kLanes, sl = lane % kLanes;
  // the lane's point of the warp's first group, kept across the iterations
  // (every point, for M <= 32 x the cluster's warps)
  float p0[3] = {0.f, 0.f, 0.f}, lab0[3] = {0.f, 0.f, 0.f};
  bool ok0 = false;
  {
    const int i = gwarp + lane * kAllWarps;
    if (i < M) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        p0[a] = src[3 * i + a];
        lab0[a] = src_lab[3 * i + a];
      }
      ok0 = src_valid[i] != 0;
    }
  }
  for (int it = 0; it <= iterations; ++it) {
    const bool audit = it == iterations;
    float acc[kSums];
#pragma unroll
    for (int q = 0; q < kSums; ++q) acc[q] = 0.f;
    // groups of up to 32 points a warp: point base + k·kAllWarps is lane k's
    for (int base = gwarp; base < M; base += 32 * kAllWarps) {
      const int i = base + lane * kAllWarps;
      const bool have = i < M;
      float mv[3] = {0.f, 0.f, 0.f}, lab[3] = {lab0[0], lab0[1], lab0[2]};
      float p[3] = {p0[0], p0[1], p0[2]};
      bool ok_i = ok0;
      if (have && base != gwarp) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          p[a] = src[3 * i + a];
          lab[a] = src_lab[3 * i + a];
        }
        ok_i = src_valid[i] != 0;
      }
      if (have) {
        uz::quat_rotate(pose + 3, p, mv);
#pragma unroll
        for (int a = 0; a < 3; ++a) mv[a] = mv[a] + pose[a];
      }
      const int n_here = min(32, (M - base + kAllWarps - 1) / kAllWarps);
      // a pass searches kPerPass points, kLanes lanes each; the point's own
      // lane then takes its group's result
      uint64_t res = 0;
      for (int k = 0; k < n_here; k += kPerPass) {
        const int from = min(k + sub, n_here - 1);   // past the group: a repeat, not kept
        float m[3], l[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          m[a] = __shfl_sync(kFull, mv[a], from);
          l[a] = audit ? 0.f : __shfl_sync(kFull, lab[a], from);
        }
        const uint64_t r = audit ? search<true>(m, l, tp, tl, N, cw, sl)
                                 : search<false>(m, l, tp, tl, N, cw, sl);
        const int owner = lane - k;   // this lane's point's group
        const uint64_t got = __shfl_sync(kFull, r, (owner >= 0 && owner < kPerPass ? owner : 0) * kLanes);
        if (owner >= 0 && owner < kPerPass) res = got;
      }
      if (!have) continue;
      if (audit) {
        const float nn = __uint_as_float(static_cast<unsigned>(res));
        const bool good = ok_i && nn < max_corr2;
        acc[0] += good ? 1.f : 0.f;
        acc[1] += good ? nn : 0.f;
        continue;
      }
      const int bj = static_cast<int>(static_cast<unsigned>(res));
      if (matches && it == 0) matches[static_cast<size_t>(b) * M + i] = bj;
      const float4 tq = tp[bj], tnr = tn[bj];
      const float e[3] = {mv[0] - tq.x, mv[1] - tq.y, mv[2] - tq.z};
      const float nr[3] = {tnr.x, tnr.y, tnr.z};
      const float geo = sum_sq3(e[0], e[1], e[2]);
      const float w = (ok_i && geo < max_corr2) ? 1.f : 0.f;
      const float r = e[0] * nr[0] + e[1] * nr[1] + e[2] * nr[2];
      float J[6] = {nr[0], nr[1], nr[2], 0.f, 0.f, 0.f};
      uz::cross3(mv, nr, J + 3);
      int q = 0;
#pragma unroll
      for (int u = 0; u < 6; ++u)
#pragma unroll
        for (int v = u; v < 6; ++v) acc[q++] += J[u] * J[v] * w;
#pragma unroll
      for (int u = 0; u < 6; ++u) acc[21 + u] += J[u] * (r * w);
    }
    // the sums: a warp tree (lane q ends with the warp's sum q), the CTA's
    // warps in order, the cluster's CTAs in rank order (the CTA partials
    // double-buffered by iteration parity)
    const float mine_q = uz::warp_sum_scatter(acc, lane);
    if (lane < kSums) wpart[warp][lane] = mine_q;
    __syncthreads();
    const int par = it & 1;
    if (tid < kSums) {
      float t = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t = t + wpart[w][tid];
      part[par][tid] = t;
    }
    cluster.sync();
    if (tid < kSums) {
      float v[kClusterCtas];
#pragma unroll
      for (int q = 0; q < kClusterCtas; ++q) v[q] = *cluster.map_shared_rank(&part[par][tid], q);
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < kClusterCtas; ++q) t = t + v[q];
      tot[tid] = t;
    }
    if (!audit) {
      // warp 0 solves; the pose goes out through shared memory
      if (warp == 0) {
        __syncwarp();
        float H[6][6], g[6], x[6];
        int q = 0;
#pragma unroll
        for (int u = 0; u < 6; ++u)
#pragma unroll
          for (int v = u; v < 6; ++v) {
            H[u][v] = H[v][u] = tot[q++];
          }
#pragma unroll
        for (int u = 0; u < 6; ++u) {
          H[u][u] = H[u][u] + 1e-6f;
          g[u] = tot[21 + u];
        }
        uz::lu_solve6(H, g, x);
        float dx[6], ex[7], np[7];
#pragma unroll
        for (int u = 0; u < 6; ++u) dx[u] = -x[u];
        uz::se3_exp_rcp(dx, ex);
        uz::pose_compose_rcp(ex, pose, np);
        if (lane < 7) spose[lane] = np[lane];
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < 7; ++k) pose[k] = spose[k];
      continue;
    }
    __syncthreads();
    if (rank == 0 && tid == 0) {
      const float n_good = tot[0];
      const int ns = n_src > 1 ? n_src : 1;
      const float fraction = n_good / static_cast<float>(ns);
      const float mse = tot[1] / (n_good > 1.f ? n_good : 1.f);
      float inv[7], corr[7], phi[3];
      uz::pose_inverse(init + 7 * b, inv);
      uz::pose_compose(inv, pose, corr);
      const float dt = sqrtf(corr[0] * corr[0] + corr[1] * corr[1] + corr[2] * corr[2]);
      uz::quat_to_axis_angle(corr + 3, phi);
      const float dr = uz::safe_norm3(phi);
      bool finite = true;
      for (int k = 0; k < 7; ++k) {
        finite = finite && isfinite(pose[k]);
        pose_out[7 * b + k] = pose[k];
      }
      fraction_out[b] = fraction;
      mse_out[b] = mse;
      ok_out[b] = fraction > min_fraction && dt <= max_t && dr <= max_r && finite;
    }
  }
  // no CTA leaves while another may still read its partials
  cluster.sync();
}

// Once per device: the kernel may take kMaxTargets targets' shared memory
// and a cluster above the portable size, and such a cluster must fit.
int prepare_gicp() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && ready[dev]) return 0;
  err = cudaFuncSetAttribute(gicp_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxTargets * kTargetBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kClusterCtas > 8) {
    err = cudaFuncSetAttribute(gicp_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterCtas, 1, 1);
  cfg.blockDim = dim3(kCtaThreads, 1, 1);
  cfg.dynamicSmemBytes = kMaxTargets * kTargetBytes;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, gicp_cluster, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  if (dev < kMaxDevices) ready[dev] = true;
  return 0;
}

}  // namespace

// points: (B, M, 3) float32, valid: (B, M) bool.  Out: normals (B, M, 3).
extern "C" int uz_knn_normals(const float* points, const unsigned char* valid, int B, int M,
                              float* normals, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || M <= 0) return 0;
  const size_t smem = static_cast<size_t>(M) * sizeof(float4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_normals_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((M + kNormalThreads - 1) / kNormalThreads, B);
  knn_normals_kernel<<<grid, kNormalThreads, smem, s>>>(points, valid, M, normals);
  return static_cast<int>(cudaGetLastError());
}

// src: (M, 3), src_lab (M, 3) float32, src_valid (M,) bool: the shared
// source cloud; dst, dst_lab, normals: (B, N, 3) float32, dst_valid (B, N)
// bool; init (B, 7).  Out: pose (B, 7), fraction (B,), mse (B,), ok (B,);
// matches null, or (B, M) int32: each source point's target in the first
// iteration (the argmin a check holds to the plain version's).
// 1 <= N <= kMaxTargets.  One cluster of kClusterCtas CTAs of kCtaThreads a
// problem; 701 = cudaErrorLaunchOutOfResources if it does not fit the card.
extern "C" int uz_gicp(const float* src, const float* src_lab, const unsigned char* src_valid,
                       const float* dst, const float* dst_lab, const unsigned char* dst_valid,
                       const float* normals, const float* init, int B, int M, int N,
                       int iterations, float max_corr2, float color_weight, float min_fraction,
                       float max_t, float max_r, float* pose, float* fraction, float* mse,
                       unsigned char* ok, int* matches, void* stream) {
  if (B <= 0) return 0;
  if (N < 1 || N > kMaxTargets || M < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int err = prepare_gicp();
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kClusterCtas, 1, 1);
  cfg.blockDim = dim3(kCtaThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(N) * kTargetBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, gicp_cluster, src, src_lab, src_valid, dst,
                                             dst_lab, dst_valid, normals, init, M, N, iterations,
                                             max_corr2, color_weight, min_fraction, max_t, max_r,
                                             pose, fraction, mse, ok, matches));
}
