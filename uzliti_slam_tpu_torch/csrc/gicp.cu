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
// Design: one CTA per target cloud (the keyframe step's candidates), the
// target's points, Lab and normals in shared memory, one thread per source
// point; the 27 terms of H and b reduced in a fixed tree order (no atomics:
// the same result run to run); the 6x6 solve by LU with partial pivoting in
// one thread; the SE(3) algebra of lie.cuh.  No cuSOLVER call: its solve
// checks an info flag on the host, and the step reads nothing back.
//
// What bounds them on the card: K26 does M^2 distance tests (8 flops each):
// 10 x 256^2 at the keyframe step, 5 Mflop, under a microsecond at 67
// TFLOP/s; K27 does 21 x M x N 6-D distances (17 flops each), 10 x 21 x
// 256^2 x 17 = 234 Mflop, 3.5 us.  Both are latency-bound at these sizes:
// 10 CTAs on 132 SMs, iterations in sequence.
#include <cuda_runtime.h>

#include "linalg.cuh"

namespace {

constexpr int kK = 8;             // KNN_K in kernels/ops.py
constexpr int kEighSweeps = 8;    // JACOBI_SWEEPS
constexpr int kNormalThreads = 256;
constexpr int kGicpThreads = 256;
constexpr int kGicpSums = 27;     // H upper triangle (21), J^T r (6)

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

__global__ void __launch_bounds__(kGicpThreads)
gicp_problems(const float* __restrict__ src, const float* __restrict__ src_lab,
              const unsigned char* __restrict__ src_valid, const float* __restrict__ dst,
              const float* __restrict__ dst_lab, const unsigned char* __restrict__ dst_valid,
              const float* __restrict__ normals, const float* __restrict__ init, int M, int N,
              int iterations, float max_corr2, float cw, float min_fraction, float max_t,
              float max_r, float* __restrict__ pose_out, float* __restrict__ fraction_out,
              float* __restrict__ mse_out, unsigned char* __restrict__ ok_out) {
  extern __shared__ float sg[];
  float* sd = sg;            // N x 3 points
  float* sl = sd + 3 * N;    // N x 3 Lab
  float* sn = sl + 3 * N;    // N x 3 normals
  unsigned char* sv = reinterpret_cast<unsigned char*>(sn + 3 * N);
  __shared__ float red[kGicpSums][kGicpThreads];
  __shared__ float spose[7];
  __shared__ int scnt[kGicpThreads];
  const int b = blockIdx.x;
  const size_t off = static_cast<size_t>(b) * N * 3;
  for (int j = threadIdx.x; j < 3 * N; j += blockDim.x) {
    sd[j] = dst[off + j];
    sl[j] = dst_lab[off + j];
    sn[j] = normals[off + j];
  }
  for (int j = threadIdx.x; j < N; j += blockDim.x) sv[j] = dst_valid[static_cast<size_t>(b) * N + j];
  if (threadIdx.x < 7) spose[threadIdx.x] = init[7 * b + threadIdx.x];
  __syncthreads();
  for (int it = 0; it <= iterations; ++it) {
    float pose[7];
#pragma unroll
    for (int k = 0; k < 7; ++k) pose[k] = spose[k];
    const bool audit = it == iterations;
    float acc[kGicpSums];
#pragma unroll
    for (int q = 0; q < kGicpSums; ++q) acc[q] = 0.f;
    int n_src = 0;
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      const bool ok_i = src_valid[i] != 0;
      n_src += ok_i;
      const float p[3] = {src[3 * i], src[3 * i + 1], src[3 * i + 2]};
      float moved[3];
      uz::quat_rotate(pose + 3, p, moved);
#pragma unroll
      for (int a = 0; a < 3; ++a) moved[a] = moved[a] + pose[a];
      if (audit) {
        float nn = inf_f();
        for (int j = 0; j < N; ++j) {
          if (!sv[j]) continue;
          const float d = sum_sq3(moved[0] - sd[3 * j], moved[1] - sd[3 * j + 1],
                                  moved[2] - sd[3 * j + 2]);
          nn = fminf(nn, d);
        }
        const bool good = ok_i && nn < max_corr2;
        acc[0] += good ? 1.f : 0.f;
        acc[1] += good ? nn : 0.f;
        continue;
      }
      const float l[3] = {src_lab[3 * i], src_lab[3 * i + 1], src_lab[3 * i + 2]};
      float best = inf_f();
      int bj = 0;
      for (int j = 0; j < N; ++j) {
        float d = inf_f();
        if (sv[j]) {
          const float dg = sum_sq3(moved[0] - sd[3 * j], moved[1] - sd[3 * j + 1],
                                   moved[2] - sd[3 * j + 2]);
          const float dc = sum_sq3(l[0] - sl[3 * j], l[1] - sl[3 * j + 1], l[2] - sl[3 * j + 2]);
          d = fmaf(cw, dc, dg);
        }
        // the first minimum, as argmin (a NaN is the minimum)
        if (j == 0 || d < best || (isnan(d) && !isnan(best))) {
          best = d;
          bj = j;
        }
      }
      const float e[3] = {moved[0] - sd[3 * bj], moved[1] - sd[3 * bj + 1], moved[2] - sd[3 * bj + 2]};
      const float nr[3] = {sn[3 * bj], sn[3 * bj + 1], sn[3 * bj + 2]};
      const float geo = sum_sq3(e[0], e[1], e[2]);
      const float w = (ok_i && geo < max_corr2) ? 1.f : 0.f;
      const float r = e[0] * nr[0] + e[1] * nr[1] + e[2] * nr[2];
      float J[6] = {nr[0], nr[1], nr[2], 0.f, 0.f, 0.f};
      uz::cross3(moved, nr, J + 3);
      int q = 0;
#pragma unroll
      for (int u = 0; u < 6; ++u)
#pragma unroll
        for (int v = u; v < 6; ++v) acc[q++] += J[u] * J[v] * w;
#pragma unroll
      for (int u = 0; u < 6; ++u) acc[21 + u] += J[u] * (r * w);
    }
    uz::block_tree_sum(acc, red);
    if (!audit) {
      if (threadIdx.x == 0) {
        float H[6][6], g[6], x[6];
        int q = 0;
        for (int u = 0; u < 6; ++u)
          for (int v = u; v < 6; ++v) {
            H[u][v] = H[v][u] = red[q++][0];
          }
        for (int u = 0; u < 6; ++u) {
          H[u][u] = H[u][u] + 1e-6f;
          g[u] = red[21 + u][0];
        }
        uz::lu_solve6(H, g, x);
        float dx[6], ex[7], np[7];
        for (int u = 0; u < 6; ++u) dx[u] = -x[u];
        uz::se3_exp(dx, ex);
        uz::pose_compose(ex, pose, np);
        for (int k = 0; k < 7; ++k) spose[k] = np[k];
      }
      __syncthreads();
      continue;
    }
    scnt[threadIdx.x] = n_src;
    __syncthreads();
    for (int stride = kGicpThreads / 2; stride > 0; stride >>= 1) {
      if (threadIdx.x < stride) scnt[threadIdx.x] += scnt[threadIdx.x + stride];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const float n_good = red[0][0];
      const int ns = scnt[0] > 1 ? scnt[0] : 1;
      const float fraction = n_good / static_cast<float>(ns);
      const float mse = red[1][0] / (n_good > 1.f ? n_good : 1.f);
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
// bool; init (B, 7).  Out: pose (B, 7), fraction (B,), mse (B,), ok (B,).
extern "C" int uz_gicp(const float* src, const float* src_lab, const unsigned char* src_valid,
                       const float* dst, const float* dst_lab, const unsigned char* dst_valid,
                       const float* normals, const float* init, int B, int M, int N,
                       int iterations, float max_corr2, float color_weight, float min_fraction,
                       float max_t, float max_r, float* pose, float* fraction, float* mse,
                       unsigned char* ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  const size_t smem = static_cast<size_t>(N) * (9 * sizeof(float) + 1);
  const cudaError_t err = cudaFuncSetAttribute(
      gicp_problems, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  gicp_problems<<<B, kGicpThreads, smem, s>>>(src, src_lab, src_valid, dst, dst_lab, dst_valid,
                                              normals, init, M, N, iterations, max_corr2,
                                              color_weight, min_fraction, max_t, max_r, pose,
                                              fraction, mse, ok);
  return static_cast<int>(cudaGetLastError());
}
