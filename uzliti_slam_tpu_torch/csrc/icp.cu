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
// Design: one CTA per problem, the problem batch on the grid.  The target
// scan (N <= 8192 points) and its validity sit in shared memory; each thread
// takes the source points i = tid, tid + blockDim, ... and keeps the two
// nearest targets of each in registers (ascending target index, strict '<':
// ties keep the lower index, as XLA's top_k, also among the +inf of invalid
// targets).  The per-thread sums of J J^T, J r (and, in the audit, w, r^2 w
// and the valid source count) are reduced across the block in a fixed tree
// order, with no atomics, so a problem gives the same result run to run.
// The 3x3 solve and inverse are LU with partial pivoting (the first largest
// pivot, as LAPACK's isamax), done by one thread in registers; the new pose
// goes back through shared memory.  No multiply-add is contracted
// (__f*_rn), so the kernel does the plain version's arithmetic; the
// reference's compiled form contracts some, and its LAPACK LU scales by a
// reciprocal pivot: the pose agrees with it within the stated tolerance.
//
// What bounds it on the card: iterations x M x N distance tests, 21 x 360 x
// 360 x ~8 = 22 M operations a problem (0.3 us at 67 T/s); one CTA runs
// them at a few hundred GFLOP/s, so a single problem is latency-bound on
// one SM — the batch on the grid is what fills the card.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSums = 11;   // H (6 upper entries), J r (3), w, r^2 w

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Doolittle LU of a 3x3 matrix with partial pivoting, in place; perm[i] is
// the original row at position i.
__device__ void lu3(float a[3][3], int perm[3]) {
  perm[0] = 0; perm[1] = 1; perm[2] = 2;
  for (int k = 0; k < 3; ++k) {
    int p = k;
    float m = fabsf(a[k][k]);
    for (int i = k + 1; i < 3; ++i) {
      if (fabsf(a[i][k]) > m) { m = fabsf(a[i][k]); p = i; }
    }
    if (p != k) {
      for (int j = 0; j < 3; ++j) { const float t = a[k][j]; a[k][j] = a[p][j]; a[p][j] = t; }
      const int t = perm[k]; perm[k] = perm[p]; perm[p] = t;
    }
    for (int i = k + 1; i < 3; ++i) {
      const float l = __fdiv_rn(a[i][k], a[k][k]);
      a[i][k] = l;
      for (int j = k + 1; j < 3; ++j) a[i][j] = __fsub_rn(a[i][j], __fmul_rn(l, a[k][j]));
    }
  }
}

__device__ void lu3_solve(const float lu[3][3], const int perm[3], const float b[3], float x[3]) {
  float y[3];
  for (int i = 0; i < 3; ++i) {
    float s = b[perm[i]];
    for (int j = 0; j < i; ++j) s = __fsub_rn(s, __fmul_rn(lu[i][j], y[j]));
    y[i] = s;
  }
  for (int i = 2; i >= 0; --i) {
    float s = y[i];
    for (int j = i + 1; j < 3; ++j) s = __fsub_rn(s, __fmul_rn(lu[i][j], x[j]));
    x[i] = __fdiv_rn(s, lu[i][i]);
  }
}

// One source point against the shared target scan under pose (c, s, p0, p1):
// adds its terms to acc (H upper, J r, w, r^2 w).
__device__ __forceinline__ void correspond(float px, float py, bool sv, float c, float s,
                                           float p0, float p1, const float2* sdst,
                                           const unsigned char* sdv, int N, float max_corr2,
                                           float acc[kSums]) {
  const float mx = __fadd_rn(__fsub_rn(__fmul_rn(c, px), __fmul_rn(s, py)), p0);
  const float my = __fadd_rn(__fadd_rn(__fmul_rn(s, px), __fmul_rn(c, py)), p1);
  float d1 = inf_f(), d2 = inf_f();
  int i1 = 0, i2 = 0;
  bool have1 = false, have2 = false;
  for (int j = 0; j < N; ++j) {
    float d = inf_f();
    if (sdv[j]) {
      const float ex = __fsub_rn(mx, sdst[j].x), ey = __fsub_rn(my, sdst[j].y);
      d = __fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey));
    }
    // strict '<' in ascending j; the first two entries seed the pair so
    // that +inf ties keep the lowest indices
    if (!have1 || d < d1) {
      if (have1) { d2 = d1; i2 = i1; have2 = true; }
      d1 = d; i1 = j; have1 = true;
    } else if (!have2 || d < d2) {
      d2 = d; i2 = j; have2 = true;
    }
  }
  const float2 a = sdst[i1], b = sdst[i2];
  const float sx = __fsub_rn(b.x, a.x), sy = __fsub_rn(b.y, a.y);
  float len = sqrtf(__fadd_rn(__fmul_rn(sx, sx), __fmul_rn(sy, sy)));
  len = len < 1e-9f ? 1e-9f : len;
  const float nx = __fdiv_rn(-sy, len), ny = __fdiv_rn(sx, len);
  const float r = __fadd_rn(__fmul_rn(__fsub_rn(mx, a.x), nx), __fmul_rn(__fsub_rn(my, a.y), ny));
  const float w = (sv && d1 < max_corr2 && isfinite(d1) && isfinite(d2)) ? 1.f : 0.f;
  const float t0 = __fadd_rn(-my, p1), t1 = __fsub_rn(mx, p0);
  const float J[3] = {nx, ny, __fadd_rn(__fmul_rn(nx, t0), __fmul_rn(ny, t1))};
  int q = 0;
  for (int u = 0; u < 3; ++u)
    for (int v = u; v < 3; ++v) acc[q++] += __fmul_rn(__fmul_rn(J[u], J[v]), w);
  for (int u = 0; u < 3; ++u) acc[6 + u] += __fmul_rn(__fmul_rn(J[u], r), w);
  acc[9] += w;
  acc[10] += __fmul_rn(__fmul_rn(r, r), w);
}

// sums acc over the block into red[q][0], fixed tree order
__device__ void block_sum(float acc[kSums], float (*red)[kThreads]) {
  for (int q = 0; q < kSums; ++q) red[q][threadIdx.x] = acc[q];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      for (int q = 0; q < kSums; ++q)
        red[q][threadIdx.x] = __fadd_rn(red[q][threadIdx.x], red[q][threadIdx.x + stride]);
    }
    __syncthreads();
  }
}

__device__ void unpack_h(float (*red)[kThreads], float diag, float H[3][3]) {
  H[0][0] = __fadd_rn(red[0][0], diag); H[0][1] = red[1][0]; H[0][2] = red[2][0];
  H[1][1] = __fadd_rn(red[3][0], diag); H[1][2] = red[4][0]; H[2][2] = __fadd_rn(red[5][0], diag);
  H[1][0] = H[0][1]; H[2][0] = H[0][2]; H[2][1] = H[1][2];
}

__global__ void icp_problems(const float* __restrict__ src, const unsigned char* __restrict__ src_valid,
                             const float* __restrict__ dst, const unsigned char* __restrict__ dst_valid,
                             const float* __restrict__ init, int M, int N, int iterations,
                             float max_corr2, float min_fraction, float max_t, float max_r,
                             float sigma2, float* __restrict__ pose_out,
                             float* __restrict__ fraction_out, float* __restrict__ mse_out,
                             float* __restrict__ cov_out, unsigned char* __restrict__ ok_out) {
  extern __shared__ float2 sdst[];                               // N points, then N flags
  unsigned char* sdv = reinterpret_cast<unsigned char*>(sdst + N);
  __shared__ float red[kSums][kThreads];
  __shared__ float spose[3];
  const int b = blockIdx.x;
  const float* bsrc = src + static_cast<size_t>(b) * M * 2;
  const unsigned char* bsv = src_valid + static_cast<size_t>(b) * M;
  for (int j = threadIdx.x; j < N; j += blockDim.x) {
    const size_t o = static_cast<size_t>(b) * N + j;
    sdst[j] = make_float2(dst[2 * o], dst[2 * o + 1]);
    sdv[j] = dst_valid[o];
  }
  if (threadIdx.x < 3) spose[threadIdx.x] = init[3 * b + threadIdx.x];
  __syncthreads();
  for (int it = 0; it <= iterations; ++it) {
    const float p0 = spose[0], p1 = spose[1], th = spose[2];
    const float c = cosf(th), s = sinf(th);
    float acc[kSums];
    for (int q = 0; q < kSums; ++q) acc[q] = 0.f;
    int n_src = 0;
    for (int i = threadIdx.x; i < M; i += blockDim.x) {
      const bool sv = bsv[i] != 0;
      n_src += sv;
      correspond(bsrc[2 * i], bsrc[2 * i + 1], sv, c, s, p0, p1, sdst, sdv, N, max_corr2, acc);
    }
    block_sum(acc, red);
    if (it < iterations) {
      if (threadIdx.x == 0) {
        float H[3][3];
        int perm[3];
        unpack_h(red, 1e-9f, H);
        lu3(H, perm);
        const float rhs[3] = {red[6][0], red[7][0], red[8][0]};
        float x[3];
        lu3_solve(H, perm, rhs, x);
        spose[0] = __fadd_rn(p0, -x[0]);
        spose[1] = __fadd_rn(p1, -x[1]);
        spose[2] = __fadd_rn(th, -x[2]);
      }
      __syncthreads();
      continue;
    }
    // the final audit at the last pose: the valid source count reduces too
    __shared__ int cnt[kThreads];
    cnt[threadIdx.x] = n_src;
    __syncthreads();
    for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
      if (threadIdx.x < stride) cnt[threadIdx.x] += cnt[threadIdx.x + stride];
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      const float n_good = red[9][0];
      const int ns = cnt[0] > 1 ? cnt[0] : 1;
      const float fraction = __fdiv_rn(n_good, static_cast<float>(ns));
      const float mse = __fdiv_rn(red[10][0], n_good > 1.f ? n_good : 1.f);
      float H[3][3];
      int perm[3];
      unpack_h(red, 1e-6f, H);
      lu3(H, perm);
      float cov[3][3];
      for (int col = 0; col < 3; ++col) {
        const float e[3] = {col == 0 ? 1.f : 0.f, col == 1 ? 1.f : 0.f, col == 2 ? 1.f : 0.f};
        float x[3];
        lu3_solve(H, perm, e, x);
        for (int row = 0; row < 3; ++row) cov[row][col] = __fmul_rn(sigma2, x[row]);
      }
      const float* ini = init + 3 * b;
      const float c0 = __fsub_rn(p0, ini[0]), c1 = __fsub_rn(p1, ini[1]), c2 = __fsub_rn(th, ini[2]);
      const bool corr_ok = fabsf(c0) < max_t && fabsf(c1) < max_t && fabsf(c2) < max_r;
      const bool finite = isfinite(p0) && isfinite(p1) && isfinite(th);
      pose_out[3 * b] = p0;
      pose_out[3 * b + 1] = p1;
      pose_out[3 * b + 2] = th;
      fraction_out[b] = fraction;
      mse_out[b] = mse;
      for (int q = 0; q < 9; ++q) cov_out[9 * b + q] = cov[q / 3][q % 3];
      ok_out[b] = fraction >= min_fraction && corr_ok && finite;
    }
  }
}

}  // namespace

// src: (B, M, 2) float32, src_valid: (B, M) bool; dst: (B, N, 2) float32,
// dst_valid: (B, N) bool; init: (B, 3).  Out: pose (B, 3), fraction (B,),
// mse (B,), cov (B, 3, 3), ok (B,) bool.  N * 9 bytes fit a CTA's shared
// memory with the reductions (the wrapper keeps N <= 8192).
extern "C" int uz_icp(const float* src, const unsigned char* src_valid, const float* dst,
                      const unsigned char* dst_valid, const float* init, int B, int M, int N,
                      int iterations, float max_corr2, float min_fraction, float max_t,
                      float max_r, float sigma2, float* pose, float* fraction, float* mse,
                      float* cov, unsigned char* ok, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  const size_t smem = static_cast<size_t>(N) * (sizeof(float2) + 1);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        icp_problems, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  icp_problems<<<B, kThreads, smem, s>>>(src, src_valid, dst, dst_valid, init, M, N, iterations,
                                         max_corr2, min_fraction, max_t, max_r, sigma2, pose,
                                         fraction, mse, cov, ok);
  return static_cast<int>(cudaGetLastError());
}
