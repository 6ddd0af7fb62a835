// K7 ransac_rigid: batched RANSAC rigid fits of the loop-closure filter.
//
// Replaces uzliti_slam_tpu/ops/ransac.py:ransac_rigid (:123-201) with its
// hypothesis fit kabsch_quat (:54-93) and refit kabsch (:32-52), as
// graph/filter.py:157-165 vmaps them over cluster roots.  Per root r, with
// the K sampled triplets given (sampling stays outside, so that a test can
// hand both sides the same draws):
//   1. K Horn fits of 3 weighted correspondences, exactly as the reference
//      does them: Frobenius shift ||N|| + 1e-6, q0 = (1/2)(1,1,1,1), 30
//      power steps each normalised by max(||q||, 1e-12);
//   2. K x M inlier counts (err2 < thresh^2 and valid), set to -1 where the
//      sample repeats an index or holds an invalid one;
//   3. the first argmax of the counts, as jnp.argmax;
//   4. the weighted refit on that hypothesis's inliers: weighted means, the
//      3x3 cross-covariance, its SVD by one-sided (Hestenes) cyclic Jacobi in
//      registers, R = U diag(1, 1, d) V^T, t = mu_d - R mu_s, and the
//      quaternion by the Shepperd branches of lie.matrix_to_quat (both in
//      linalg.cuh, shared with K28);
//   5. consensus, mse, the information model and ok under the refit.
// For the rotation, U and V are completed from the two largest singular
// pairs by cross products (u3 = u1 x u2, v3 = v1 x v2): that gives exactly
// U diag(1, 1, sign(det U det V)) V^T, whatever the sign of the third
// singular pair, so a planar point set (rank 2, the 2-D trajectory's case)
// needs no special branch.  No cuSOLVER call: a library SVD may check its
// info flag and synchronise, and the reference's SVD is what is ported here.
//
// Design: one CTA per root, one thread per hypothesis; the root's points sit
// in shared memory.  Sums over points (weighted means, covariance, mse) are
// per-thread partials in double, added by one thread in a fixed order: the
// result is the same from run to run, and at 40 m coordinates a float32
// sequential sum of 128 partials would drift ~1e-4 m from the reference's
// tree-ordered float32 sums, where the double sum rounds once.
//
// What bounds it on the card: the K x M consensus (about 40 flops each) and
// the serial refit; at the epoch's 51 roots x 128 x 256 it is a few
// microseconds of work on 51 of the 132 SMs, i.e. latency.
#include <cuda_runtime.h>

#include "linalg.cuh"

namespace {

constexpr int kPowerIters = 30;
constexpr int kSums = 9;

__device__ __forceinline__ float err2_of(const float pose[7], const float* s, const float* d) {
  float p[3];
  uz::quat_rotate(pose + 3, s, p);
  float e = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float r = (p[a] + pose[a]) - d[a];
    e += r * r;
  }
  return e;
}

// ransac.kabsch_quat on three correspondences
__device__ void horn_fit3(const float s[3][3], const float d[3][3], const float w_in[3],
                          float pose[7]) {
  float w[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = uz::floor_at(w_in[i], 0.f);
  const float wsum = uz::floor_at(w[0] + w[1] + w[2], 1e-9f);
  float mu_s[3], mu_d[3], cs[3][3], cd[3][3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mu_s[a] = (s[0][a] * w[0] + s[1][a] * w[1] + s[2][a] * w[2]) / wsum;
    mu_d[a] = (d[0][a] * w[0] + d[1][a] * w[1] + d[2][a] * w[2]) / wsum;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      cs[i][a] = s[i][a] - mu_s[a];
      cd[i][a] = d[i][a] - mu_d[a];
    }
  float S[3][3];   // S_ab = sum_i w_i cs_ia cd_ib / wsum
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b)
      S[a][b] = ((cs[0][a] * w[0]) * cd[0][b] + (cs[1][a] * w[1]) * cd[1][b]
                 + (cs[2][a] * w[2]) * cd[2][b]) / wsum;
  const float N[4][4] = {
      {S[0][0] + S[1][1] + S[2][2], S[1][2] - S[2][1], S[2][0] - S[0][2], S[0][1] - S[1][0]},
      {S[1][2] - S[2][1], S[0][0] - S[1][1] - S[2][2], S[0][1] + S[1][0], S[2][0] + S[0][2]},
      {S[2][0] - S[0][2], S[0][1] + S[1][0], -S[0][0] + S[1][1] - S[2][2], S[1][2] + S[2][1]},
      {S[0][1] - S[1][0], S[2][0] + S[0][2], S[1][2] + S[2][1], -S[0][0] - S[1][1] + S[2][2]},
  };
  float fro = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) fro += N[i][j] * N[i][j];
  const float c = sqrtf(fro) + 1e-6f;   // Frobenius shift makes the largest eigenvalue dominant
  float q[4] = {0.5f, 0.5f, 0.5f, 0.5f};
  for (int it = 0; it < kPowerIters; ++it) {
    float qn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qn[i] = (N[i][0] + (i == 0 ? c : 0.f)) * q[0] + (N[i][1] + (i == 1 ? c : 0.f)) * q[1]
            + (N[i][2] + (i == 2 ? c : 0.f)) * q[2] + (N[i][3] + (i == 3 ? c : 0.f)) * q[3];
    const float nrm = uz::floor_at(
        sqrtf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3]), 1e-12f);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = qn[i] / nrm;
  }
  float R[3][3], Rm[3];
  uz::quat_to_matrix(q, R);
  uz::mv3(R, mu_s, Rm);
#pragma unroll
  for (int a = 0; a < 3; ++a) pose[a] = mu_d[a] - Rm[a];
#pragma unroll
  for (int i = 0; i < 4; ++i) pose[3 + i] = q[i];
  uz::quat_normalize(pose + 3);
}

// Per-thread partials s_red[p * blockDim + tid], p < n, added by thread 0 in
// thread order into out[p].
__device__ void block_sums(double* s_red, int n, double* out) {
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int p = 0; p < n; ++p) {
      double acc = 0.0;
      for (int t = 0; t < blockDim.x; ++t) acc += s_red[p * blockDim.x + t];
      out[p] = acc;
    }
  }
  __syncthreads();
}

__global__ void ransac_roots(const float* __restrict__ src, long long src_stride,
                             const float* __restrict__ dst, long long dst_stride,
                             const unsigned char* __restrict__ valid, const int* __restrict__ tri,
                             int m, int k_hyp, float thresh_sq, int min_consensus,
                             float min_sigma_sq, float* __restrict__ pose_out,
                             int* __restrict__ consensus_out, float* __restrict__ mse_out,
                             float* __restrict__ info_out, unsigned char* __restrict__ ok_out,
                             int* __restrict__ best_out, int* __restrict__ counts_out) {
  extern __shared__ double smd[];
  double* s_red = smd;                    // kSums x blockDim
  float* s_src = reinterpret_cast<float*>(s_red + kSums * blockDim.x);   // m x 3
  float* s_dst = s_src + 3 * m;           // m x 3
  float* s_w = s_dst + 3 * m;             // m: valid as 0/1
  float* s_wr = s_w + m;                  // m: refit weights
  float* s_hyp = s_wr + m;                // k_hyp x 7
  int* s_cnt = reinterpret_cast<int*>(s_hyp + 7 * k_hyp);   // k_hyp
  __shared__ double s_tot[kSums];
  __shared__ float s_fit[7];
  __shared__ int s_best;

  const long long r = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* g_src = src + r * src_stride;
  const float* g_dst = dst + r * dst_stride;
  const unsigned char* g_valid = valid + r * m;
  for (int j = tid; j < 3 * m; j += nt) {
    s_src[j] = g_src[j];
    s_dst[j] = g_dst[j];
  }
  for (int j = tid; j < m; j += nt) s_w[j] = g_valid[j] ? 1.f : 0.f;
  __syncthreads();

  // 1-2: one hypothesis per thread
  if (tid < k_hyp) {
    const int* tk = tri + (r * k_hyp + tid) * 3;
    int idx[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) idx[c] = min(max(tk[c], 0), m - 1);
    float s[3][3], d[3][3], w[3], hp[7];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        s[c][a] = s_src[idx[c] * 3 + a];
        d[c][a] = s_dst[idx[c] * 3 + a];
      }
      w[c] = s_w[idx[c]];
    }
    horn_fit3(s, d, w, hp);
#pragma unroll
    for (int i = 0; i < 7; ++i) s_hyp[tid * 7 + i] = hp[i];
    int count = 0;
    for (int j = 0; j < m; ++j)
      if (s_w[j] > 0.f && err2_of(hp, s_src + 3 * j, s_dst + 3 * j) < thresh_sq) ++count;
    const bool distinct = idx[0] != idx[1] && idx[1] != idx[2] && idx[0] != idx[2];
    const bool sample_valid = w[0] > 0.f && w[1] > 0.f && w[2] > 0.f && distinct;
    s_cnt[tid] = sample_valid ? count : -1;
    counts_out[r * k_hyp + tid] = s_cnt[tid];
  }
  __syncthreads();

  // 3: the first argmax
  if (tid == 0) {
    int b = 0;
    for (int k = 1; k < k_hyp; ++k)
      if (s_cnt[k] > s_cnt[b]) b = k;
    s_best = b;
    best_out[r] = b;
  }
  __syncthreads();
  const float* bp = s_hyp + s_best * 7;

  // 4: weighted means over the best hypothesis's inliers
  double acc[kSums] = {0.0};
  for (int j = tid; j < m; j += nt) {
    const float wj = (s_w[j] > 0.f && err2_of(bp, s_src + 3 * j, s_dst + 3 * j) < thresh_sq)
                         ? s_w[j] : 0.f;
    s_wr[j] = wj;
    acc[0] += wj;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      acc[1 + a] += static_cast<double>(s_src[3 * j + a] * wj);
      acc[4 + a] += static_cast<double>(s_dst[3 * j + a] * wj);
    }
  }
  for (int p = 0; p < 7; ++p) s_red[p * nt + tid] = acc[p];
  block_sums(s_red, 7, s_tot);
  const double wsum = s_tot[0] < 1e-9 ? 1e-9 : s_tot[0];
  float mu_s[3], mu_d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    mu_s[a] = static_cast<float>(s_tot[1 + a] / wsum);
    mu_d[a] = static_cast<float>(s_tot[4 + a] / wsum);
  }
  // cov_ab = sum_j (cd_ja w_j) cs_jb / wsum
  double cov[kSums] = {0.0};
  for (int j = tid; j < m; j += nt) {
    const float wj = s_wr[j];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float cdw = (s_dst[3 * j + a] - mu_d[a]) * wj;
#pragma unroll
      for (int b = 0; b < 3; ++b)
        cov[3 * a + b] += static_cast<double>(cdw) * static_cast<double>(s_src[3 * j + b] - mu_s[b]);
    }
  }
  for (int p = 0; p < kSums; ++p) s_red[p * nt + tid] = cov[p];
  block_sums(s_red, kSums, s_tot);
  if (tid == 0) {
    float C[3][3], R[3][3], Rm[3], q[4];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) C[a][b] = static_cast<float>(s_tot[3 * a + b] / wsum);
    uz::proper_rotation(C, R);
    uz::mv3(R, mu_s, Rm);
    uz::matrix_to_quat(R, q);
#pragma unroll
    for (int a = 0; a < 3; ++a) s_fit[a] = mu_d[a] - Rm[a];
#pragma unroll
    for (int i = 0; i < 4; ++i) s_fit[3 + i] = q[i];
    uz::quat_normalize(s_fit + 3);   // lie.make_pose
#pragma unroll
    for (int i = 0; i < 7; ++i) pose_out[r * 7 + i] = s_fit[i];
  }
  __syncthreads();

  // 5: consensus and mse under the refit
  double cnt = 0.0, esum = 0.0;
  for (int j = tid; j < m; j += nt) {
    const float e = err2_of(s_fit, s_src + 3 * j, s_dst + 3 * j);
    if (s_w[j] > 0.f && e < thresh_sq) {
      cnt += 1.0;
      esum += e;
    }
  }
  s_red[tid] = cnt;
  s_red[nt + tid] = esum;
  block_sums(s_red, 2, s_tot);
  if (tid == 0) {
    const int consensus = static_cast<int>(s_tot[0]);
    const float mse = static_cast<float>(s_tot[1] / (consensus > 1 ? consensus : 1));
    const float base = 0.1f * static_cast<float>(consensus) / uz::floor_at(mse, min_sigma_sq);
    float* info = info_out + r * 36;
    for (int i = 0; i < 36; ++i) info[i] = 0.f;
    for (int i = 0; i < 6; ++i) info[i * 7] = i < 3 ? base : base * 100.f;
    consensus_out[r] = consensus;
    mse_out[r] = mse;
    ok_out[r] = consensus >= min_consensus && s_cnt[s_best] > 0;
  }
}

}  // namespace

// src, dst: root r's (m, 3) points at src + r*src_stride (stride 0: shared by
// every root); valid: (n_roots, m) bool; tri: (n_roots, k_hyp, 3) int32.
// Outputs per root: pose (7), consensus, mse, information (6x6), ok, the best
// hypothesis, and the k_hyp counts.  k_hyp <= 1024.
extern "C" int uz_ransac_rigid(const float* src, long long src_stride, const float* dst,
                               long long dst_stride, const unsigned char* valid, const int* tri,
                               int n_roots, int m, int k_hyp, float thresh_sq, int min_consensus,
                               float min_sigma_sq, float* pose, int* consensus, float* mse,
                               float* information, unsigned char* ok, int* best, int* counts,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_roots <= 0) return 0;
  if (m <= 0 || k_hyp <= 0 || k_hyp > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = ((k_hyp + 31) / 32) * 32;
  const size_t smem = 1ull * kSums * threads * sizeof(double)
                    + (8ull * m + 7ull * k_hyp) * sizeof(float) + 1ull * k_hyp * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ransac_roots, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ransac_roots<<<n_roots, threads, smem, s>>>(src, src_stride, dst, dst_stride, valid, tri, m,
                                              k_hyp, thresh_sq, min_consensus, min_sigma_sq,
                                              pose, consensus, mse, information, ok, best,
                                              counts);
  return static_cast<int>(cudaGetLastError());
}
