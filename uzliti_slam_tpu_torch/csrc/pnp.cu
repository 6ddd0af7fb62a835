// K28 pnp: the PnP RANSAC of the "pnp" estimator, two entry points.
//
// Replaces uzliti_slam_tpu/ops/pnp.py:pnp_ransac (:107-242) with its fits
// _dlt_pose (:29-55), _homography_pose (:58-98) and ransac.kabsch, as the
// keyframe step vmaps it over its candidates (pipeline.py:417-457).
//
// uz_pnp_hypotheses: one warp per (candidate, draw).  The draw is the 6
// largest uniform keys over the valid correspondences (-1e9 elsewhere; ties
// to the lower index, as lax.top_k): each lane keeps its own top 6, then six
// rounds of a warp-wide (value, index) maximum.  Then three hypotheses:
//   - the DLT: the (12, 12) system with one row on each of 12 lanes, its null
//     vector by one-sided (Hestenes) cyclic Jacobi on the system itself (an
//     eigen-solve of A^T A would square its condition number in float32),
//     the det(M3) sign folded into M, R the proper polar factor of M3 and
//     t = M4 / (sum sigma / 3);
//   - the homography: the sample's plane by one-sided Jacobi of its (6, 3)
//     weighted spread, the (12, 9) system's null vector the same way, and
//     the decomposition (sigma = sgn(H22), Gram-Schmidt, the rotation
//     completed through the plane normal);
//   - with depth, Kabsch of the 6 points against their back-projected
//     observations.
// The sign folds make each pose independent of the singular vectors' signs,
// and the plane frame's in-plane rotation cancels in the rotation, so the
// poses agree with LAPACK's to rounding wherever the null space is one
// dimension.  (A coplanar sample's DLT null space is not: its pose is
// arbitrary on both sides.)  Column sums are warp butterflies, which give
// every lane the same bits, so all lanes take the same rotations.
//
// uz_pnp_refine: one CTA per candidate.  The K x M consensus (reprojection
// error compiled as fma(v, v, u * u) below the threshold, in front, within
// the depth tolerance where measured) a warp per hypothesis, -1 where the
// draw holds an invalid correspondence; the first argmax; 8 Gauss-Newton
// steps p <- p o exp(dx) on the best inliers' reprojection and depth rows,
// their Jacobian at dx = 0 in forward-mode dual numbers with 6 tangents
// (jacfwd's derivative through _project_norm's |z| < 1e-6 clamp), J^T J +
// 1e-8 I and J^T r reduced in a fixed tree order, a pivoted 6x6 solve by one
// thread; then the final inliers, consensus, mse in px^2 and ok.  No
// cuSOLVER call (its solves check an info flag on the host).
//
// What bounds it on the card: the K x M consensus, 192 x 256 x ~40 flops a
// candidate (20 Mflop for the step's 10), and the Jacobi sweeps, ~12 x 66 x
// 20 warp operations a draw; both are microseconds of work, so a launch is
// latency: 640 warps and 10 CTAs on 132 SMs.
#include <cuda_runtime.h>

#include "linalg.cuh"

namespace {

constexpr int kSample = 6;            // PNP_SAMPLE in kernels/ops.py
constexpr int kSvdSweeps = 12;        // SVD_SWEEPS
constexpr float kSvdTol = 1e-7f;      // SVD_TOL
constexpr int kHypWarps = 4;
constexpr int kRefineThreads = 256;
constexpr int kRefineWarps = kRefineThreads / 32;
constexpr int kRefineSums = 27;       // J^T J upper triangle (21), J^T r (6)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One-sided cyclic Jacobi on an (m <= 32, N) matrix held one row per lane
// (a: this lane's row; v: this lane's row of V, the identity's where lane <
// N, else zeros), pairs (p, q) in row-major order, as
// kernels/ops.py:jacobi_svd_plain; a sweep without a rotation ends it.
template <int N>
__device__ void jacobi_rows(float a[N], float v[N]) {
  for (int sweep = 0; sweep < kSvdSweeps; ++sweep) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < N - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < N; ++q) {
        const float alpha = warp_sum(a[p] * a[p]);
        const float beta = warp_sum(a[q] * a[q]);
        const float gamma = warp_sum(a[p] * a[q]);
        if (!(fabsf(gamma) > kSvdTol * sqrtf(alpha * beta))) continue;
        rotated = true;
        const float zeta = (beta - alpha) / (2.f * gamma);
        const float t = (zeta >= 0.f ? 1.f : -1.f) / (fabsf(zeta) + sqrtf(1.f + zeta * zeta));
        const float c = 1.f / sqrtf(1.f + t * t), s = c * t;
        const float ap = a[p], aq = a[q], vp = v[p], vq = v[q];
        a[p] = c * ap - s * aq;
        a[q] = s * ap + c * aq;
        v[p] = c * vp - s * vq;
        v[q] = s * vp + c * vq;
      }
    }
    if (!rotated) break;
  }
}

// The column of V with the smallest singular value (the first on a tie),
// broadcast to every lane: out[k] = V[k][j].
template <int N>
__device__ void null_vector(const float a[N], const float v[N], float out[N]) {
  int jmin = 0;
  float smin = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const float s = sqrtf(warp_sum(a[j] * a[j]));
    if (j == 0 || s < smin) {
      smin = s;
      jmin = j;
    }
  }
  float vj = 0.f;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j == jmin) vj = v[j];
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = __shfl_sync(kFull, vj, k);
}

__device__ __forceinline__ float norm3(const float v[3]) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

__device__ __forceinline__ void write_pose(const float R[3][3], const float t[3], float* out) {
  float q[4];
  uz::matrix_to_quat(R, q);
  for (int k = 0; k < 3; ++k) out[k] = t[k];
  for (int k = 0; k < 4; ++k) out[3 + k] = q[k];
}

__global__ void __launch_bounds__(kHypWarps * 32)
pnp_hypotheses_kernel(const float* __restrict__ X, const float* __restrict__ xn,
                      const unsigned char* __restrict__ valid, const float* __restrict__ depth,
                      const float* __restrict__ keys, int B, int M, int H,
                      int* __restrict__ samples, float* __restrict__ poses) {
  const int lane = threadIdx.x & 31;
  const int task = blockIdx.x * kHypWarps + (threadIdx.x >> 5);
  if (task >= B * H) return;   // the whole warp
  const int b = task / H, h = task % H;
  const float* key = keys + static_cast<size_t>(task) * M;
  const unsigned char* vb = valid + static_cast<size_t>(b) * M;
  // the draw: the 6 largest (score, -index) over the warp
  float lv[kSample];
  int li[kSample];
#pragma unroll
  for (int k = 0; k < kSample; ++k) {
    lv[k] = -__int_as_float(0x7f800000);
    li[k] = 0x7fffffff;
  }
  for (int m = lane; m < M; m += 32) {
    float cv = vb[m] ? key[m] : -1e9f;
    int ci = m;
#pragma unroll
    for (int k = 0; k < kSample; ++k) {
      if (cv > lv[k] || (cv == lv[k] && ci < li[k])) {
        const float tv = lv[k];
        const int ti = li[k];
        lv[k] = cv;
        li[k] = ci;
        cv = tv;
        ci = ti;
      }
    }
  }
  int smp[kSample];
#pragma unroll
  for (int r = 0; r < kSample; ++r) {
    float v = lv[0];
    int ix = li[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(kFull, v, o);
      const int oi = __shfl_xor_sync(kFull, ix, o);
      if (ov > v || (ov == v && oi < ix)) {
        v = ov;
        ix = oi;
      }
    }
    smp[r] = ix;
    if (li[0] == ix) {
#pragma unroll
      for (int k = 0; k < kSample - 1; ++k) {
        lv[k] = lv[k + 1];
        li[k] = li[k + 1];
      }
      lv[kSample - 1] = -__int_as_float(0x7f800000);
      li[kSample - 1] = 0x7fffffff;
    }
  }
  if (lane < kSample) {
    int s = 0;
#pragma unroll
    for (int r = 0; r < kSample; ++r)
      if (r == lane) s = smp[r];
    samples[static_cast<size_t>(task) * kSample + lane] = s;
  }
  // lane r < 12 holds sample point r % 6 (rows r and r + 6 of the systems)
  const bool row = lane < 2 * kSample;
  const int pr = lane % kSample;
  int idx = 0;
#pragma unroll
  for (int r = 0; r < kSample; ++r)
    if (r == pr) idx = smp[r];
  const size_t gi = static_cast<size_t>(b) * M + idx;
  const float P[3] = {X[3 * gi], X[3 * gi + 1], X[3 * gi + 2]};
  const float x = xn[2 * gi], y = xn[2 * gi + 1];
  const float w = vb[idx] ? 1.f : 0.f;
  const bool first = lane < kSample;
  const int F = depth ? 3 : 2;
  float* out = poses + (static_cast<size_t>(b) * F * H + h) * 7;

  // --- the DLT: rows [Xh, 0, -x Xh] and [0, Xh, -y Xh], weighted
  {
    const float Xh[4] = {P[0], P[1], P[2], 1.f};
    float a[12], v[12], m[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) {
      a[j] = 0.f;
      v[j] = (row && j == lane) ? 1.f : 0.f;
    }
    if (row) {   // constant register indices on both branches
      const float c = first ? -x : -y;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (first) a[j] = Xh[j] * w; else a[4 + j] = Xh[j] * w;
        a[8 + j] = (c * Xh[j]) * w;
      }
    }
    jacobi_rows<12>(a, v);
    null_vector<12>(a, v, m);
    if (lane == 0) {
      const float det = m[0] * (m[5] * m[10] - m[6] * m[9]) - m[1] * (m[4] * m[10] - m[6] * m[8])
                        + m[2] * (m[4] * m[9] - m[5] * m[8]);
      const float sg = det < 0.f ? -1.f : 1.f;
      float M3[3][3], R[3][3], t[3];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) M3[i][j] = m[4 * i + j] * sg;
      const float ssum = uz::proper_rotation(M3, R);
      const float scale = fmaxf(ssum / 3.f, 1e-12f);
      for (int i = 0; i < 3; ++i) t[i] = (m[4 * i + 3] * sg) / scale;
      write_pose(R, t, out);
    }
  }

  // --- the homography: the sample's plane, then the (12, 9) system
  {
    const float wp = first ? w : 0.f;
    const float wsum = fmaxf(warp_sum(wp), 1e-6f);
    float c0[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) c0[k] = warp_sum(first ? P[k] * w : 0.f) / wsum;
    const float d[3] = {P[0] - c0[0], P[1] - c0[1], P[2] - c0[2]};
    float a3[3], v3[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a3[k] = first ? d[k] * w : 0.f;
      v3[k] = (lane == k) ? 1.f : 0.f;
    }
    jacobi_rows<3>(a3, v3);
    float sig[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) sig[k] = sqrtf(warp_sum(a3[k] * a3[k]));
    int i1 = 0;
    for (int k = 1; k < 3; ++k)
      if (sig[k] > sig[i1]) i1 = k;
    int i2 = i1 == 0 ? 1 : 0;
    for (int k = 0; k < 3; ++k)
      if (k != i1 && sig[k] > sig[i2]) i2 = k;
    float c1 = 0.f, c2 = 0.f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (k == i1) c1 = v3[k];
      if (k == i2) c2 = v3[k];
    }
    float e1[3], e2[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      e1[k] = __shfl_sync(kFull, c1, k);
      e2[k] = __shfl_sync(kFull, c2, k);
    }
    const float px = d[0] * e1[0] + d[1] * e1[1] + d[2] * e1[2];
    const float py = d[0] * e2[0] + d[1] * e2[1] + d[2] * e2[2];
    float a[9], v[9], hv[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      a[j] = 0.f;
      v[j] = (row && j == lane) ? 1.f : 0.f;
    }
    if (row) {
      const float c = first ? -x : -y;
      if (first) {
        a[0] = px * w;
        a[1] = py * w;
        a[2] = w;
      } else {
        a[3] = px * w;
        a[4] = py * w;
        a[5] = w;
      }
      a[6] = (c * px) * w;
      a[7] = (c * py) * w;
      a[8] = c * w;
    }
    jacobi_rows<9>(a, v);
    null_vector<9>(a, v, hv);
    if (lane == 0) {
      float Hm[3][3];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) Hm[i][j] = hv[3 * i + j];
      const float col0[3] = {Hm[0][0], Hm[1][0], Hm[2][0]};
      const float col1[3] = {Hm[0][1], Hm[1][1], Hm[2][1]};
      const float s = sqrtf(norm3(col0) * norm3(col1)) + 1e-12f;
      const float sigma = Hm[2][2] > 0.f ? 1.f : -1.f;
      float Hs[3][3];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) Hs[i][j] = (sigma * Hm[i][j]) / s;
      const float h0[3] = {Hs[0][0], Hs[1][0], Hs[2][0]};
      const float h1[3] = {Hs[0][1], Hs[1][1], Hs[2][1]};
      const float n0 = norm3(h0) + 1e-12f;
      float r1c[3], r2o[3], r2c[3], r3c[3], npl[3];
      for (int i = 0; i < 3; ++i) r1c[i] = h0[i] / n0;
      const float dd = r1c[0] * h1[0] + r1c[1] * h1[1] + r1c[2] * h1[2];
      for (int i = 0; i < 3; ++i) r2o[i] = h1[i] - r1c[i] * dd;
      const float n2 = norm3(r2o) + 1e-12f;
      for (int i = 0; i < 3; ++i) r2c[i] = r2o[i] / n2;
      uz::cross3(r1c, r2c, r3c);
      uz::cross3(e1, e2, npl);
      float Rc[3][3], tc[3];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) Rc[i][j] = r1c[i] * e1[j] + r2c[i] * e2[j] + r3c[i] * npl[j];
      for (int i = 0; i < 3; ++i)
        tc[i] = Hs[i][2] - (Rc[i][0] * c0[0] + Rc[i][1] * c0[1] + Rc[i][2] * c0[2]);
      write_pose(Rc, tc, out + static_cast<size_t>(H) * 7);
    }
  }

  // --- Kabsch against the back-projected observations (measured depth)
  if (depth) {
    const float dep = depth[gi];
    const float wk = (first && vb[idx] && dep > 0.05f) ? 1.f : 0.f;
    const float Q[3] = {x * dep, y * dep, dep};
    const float wsum = fmaxf(warp_sum(wk), 1e-9f);
    float mu_s[3], mu_d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      mu_s[k] = warp_sum(P[k] * wk) / wsum;
      mu_d[k] = warp_sum(Q[k] * wk) / wsum;
    }
    const float cs[3] = {P[0] - mu_s[0], P[1] - mu_s[1], P[2] - mu_s[2]};
    const float cd[3] = {Q[0] - mu_d[0], Q[1] - mu_d[1], Q[2] - mu_d[2]};
    float C[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) C[i][j] = warp_sum((cd[i] * wk) * cs[j]) / wsum;
    if (lane == 0) {
      float R[3][3], t[3];
      uz::proper_rotation(C, R);
      for (int i = 0; i < 3; ++i) t[i] = mu_d[i] - (R[i][0] * mu_s[0] + R[i][1] * mu_s[1] + R[i][2] * mu_s[2]);
      write_pose(R, t, out + 2 * static_cast<size_t>(H) * 7);
    }
  }
}

// ------------------------------------------------------------ dual numbers

struct D6 {
  float v;
  float d[6];
};

__device__ __forceinline__ D6 dconst(float x) {
  D6 r;
  r.v = x;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = 0.f;
  return r;
}
__device__ __forceinline__ D6 operator+(const D6& a, const D6& b) {
  D6 r;
  r.v = a.v + b.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] + b.d[k];
  return r;
}
__device__ __forceinline__ D6 operator-(const D6& a, const D6& b) {
  D6 r;
  r.v = a.v - b.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] - b.d[k];
  return r;
}
__device__ __forceinline__ D6 operator*(const D6& a, const D6& b) {
  D6 r;
  r.v = a.v * b.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = a.d[k] * b.v + a.v * b.d[k];
  return r;
}
__device__ __forceinline__ D6 operator*(float s, const D6& a) {
  D6 r;
  r.v = s * a.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = s * a.d[k];
  return r;
}
__device__ __forceinline__ D6 operator/(const D6& a, const D6& b) {
  D6 r;
  r.v = a.v / b.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) / b.v;
  return r;
}

__device__ __forceinline__ void dcross(const D6* a, const D6* b, D6* o) {
  o[0] = a[1] * b[2] - a[2] * b[1];
  o[1] = a[2] * b[0] - a[0] * b[2];
  o[2] = a[0] * b[1] - a[1] * b[0];
}

// v' = v + 2*qw*(qv x v) + 2*qv x (qv x v)
__device__ __forceinline__ void dquat_rotate(const D6* q, const D6* v, D6* o) {
  D6 uv[3], uuv[3];
  dcross(q + 1, v, uv);
  dcross(q + 1, uv, uuv);
#pragma unroll
  for (int i = 0; i < 3; ++i) o[i] = v[i] + 2.f * (q[0] * uv[i] + uuv[i]);
}

// the refined pose p o exp(dx) at dx = 0 with the 6 tangents of dx.  exp at
// 0 takes the small-angle branch (theta = sqrt(1e-30) < 1e-6, the floor's
// derivative 0): t = v, q = (1, phi / 2) before a normalisation whose
// derivative vanishes there.
__device__ void retract_at_zero(const float p[7], D6 t[3], D6 q[4]) {
  D6 te[3], qp[4], qe[4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    te[i] = dconst(0.f);
    te[i].d[i] = 1.f;
  }
  qe[0] = dconst(1.f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    qe[1 + i] = dconst(0.f);
    qe[1 + i].d[3 + i] = 0.5f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) qp[i] = dconst(p[3 + i]);
  D6 rt[3];
  dquat_rotate(qp, te, rt);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = dconst(p[i]) + rt[i];
  // quat_mul(qp, qe), then quat_normalize
  D6 m[4];
  m[0] = qp[0] * qe[0] - qp[1] * qe[1] - qp[2] * qe[2] - qp[3] * qe[3];
  m[1] = qp[0] * qe[1] + qp[1] * qe[0] + qp[2] * qe[3] - qp[3] * qe[2];
  m[2] = qp[0] * qe[2] - qp[1] * qe[3] + qp[2] * qe[0] + qp[3] * qe[1];
  m[3] = qp[0] * qe[3] + qp[1] * qe[2] - qp[2] * qe[1] + qp[3] * qe[0];
  D6 n2 = m[0] * m[0] + m[1] * m[1] + m[2] * m[2] + m[3] * m[3];
  if (n2.v < 1e-30f) n2 = dconst(1e-30f);
  D6 n;
  n.v = sqrtf(n2.v);
#pragma unroll
  for (int k = 0; k < 6; ++k) n.d[k] = n2.d[k] * (0.5f / n.v);
  const float sg = (m[0] / n).v < 0.f ? -1.f : 1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = sg * (m[i] / n);
}

__device__ __forceinline__ bool inlier(const float pose[7], const float* P, const float* obs,
                                       float dep, bool val, bool has_depth, float thresh2,
                                       float depth_tol, float* err2) {
  float pc[3];
  uz::quat_rotate(pose + 3, P, pc);
#pragma unroll
  for (int a = 0; a < 3; ++a) pc[a] = pc[a] + pose[a];
  const float z = fabsf(pc[2]) < 1e-6f ? 1e-6f : pc[2];
  const float ex = pc[0] / z - obs[0], ey = pc[1] / z - obs[1];
  *err2 = fmaf(ey, ey, ex * ex);
  bool ok = *err2 < thresh2 && val && pc[2] > 0.05f;
  if (has_depth && dep > 0.05f) ok = ok && fabsf(pc[2] - dep) < depth_tol * fmaxf(dep, 1.f);
  return ok;
}

__device__ __forceinline__ void add_row(const D6& r, float acc[kRefineSums]) {
  int q = 0;
#pragma unroll
  for (int u = 0; u < 6; ++u)
#pragma unroll
    for (int v = u; v < 6; ++v) acc[q++] += r.d[u] * r.d[v];
#pragma unroll
  for (int u = 0; u < 6; ++u) acc[21 + u] += r.d[u] * r.v;
}

__global__ void __launch_bounds__(kRefineThreads)
pnp_refine_kernel(const float* __restrict__ X, const float* __restrict__ xn,
                  const unsigned char* __restrict__ valid, const float* __restrict__ depth,
                  const int* __restrict__ samples, const float* __restrict__ poses, int M, int H,
                  int K, float thresh2, float depth_tol, float min_consensus, int iterations,
                  float f_mean2, float* __restrict__ pose_out, int* __restrict__ consensus_out,
                  float* __restrict__ mse_out, unsigned char* __restrict__ ok_out,
                  int* __restrict__ best_out, int* __restrict__ counts_out) {
  extern __shared__ float sr[];
  float* sX = sr;                    // M x 3
  float* sxn = sX + 3 * M;           // M x 2
  float* sdep = sxn + 2 * M;         // M
  int* scount = reinterpret_cast<int*>(sdep + M);                      // K
  unsigned char* sval = reinterpret_cast<unsigned char*>(scount + K);  // M
  unsigned char* sinl = sval + M;                                       // M
  __shared__ float red[kRefineSums][kRefineThreads];
  __shared__ float spose[7];
  const int b = blockIdx.x;
  const bool has_depth = depth != nullptr;
  const size_t pm = static_cast<size_t>(b) * M;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    for (int a = 0; a < 3; ++a) sX[3 * m + a] = X[3 * (pm + m) + a];
    sxn[2 * m] = xn[2 * (pm + m)];
    sxn[2 * m + 1] = xn[2 * (pm + m) + 1];
    sdep[m] = has_depth ? depth[pm + m] : 0.f;
    sval[m] = valid[pm + m];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = warp; k < K; k += kRefineWarps) {
    float pk[7];
    for (int a = 0; a < 7; ++a) pk[a] = poses[(static_cast<size_t>(b) * K + k) * 7 + a];
    int cnt = 0;
    for (int m = lane; m < M; m += 32) {
      float e2;
      cnt += inlier(pk, sX + 3 * m, sxn + 2 * m, sdep[m], sval[m] != 0, has_depth, thresh2,
                    depth_tol, &e2);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
    if (lane == 0) {
      const int* smp = samples + (static_cast<size_t>(b) * H + k % H) * kSample;
      bool sample_ok = true;
      for (int r = 0; r < kSample; ++r) sample_ok = sample_ok && sval[smp[r]];
      const int c = sample_ok ? cnt : -1;
      scount[k] = c;
      counts_out[static_cast<size_t>(b) * K + k] = c;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int best = 0;
    for (int k = 1; k < K; ++k)
      if (scount[k] > scount[best]) best = k;
    best_out[b] = best;
    for (int a = 0; a < 7; ++a) spose[a] = poses[(static_cast<size_t>(b) * K + best) * 7 + a];
  }
  __syncthreads();
  {
    float p0[7];
    for (int a = 0; a < 7; ++a) p0[a] = spose[a];
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      float e2;
      sinl[m] = inlier(p0, sX + 3 * m, sxn + 2 * m, sdep[m], sval[m] != 0, has_depth, thresh2,
                       depth_tol, &e2);
    }
  }
  __syncthreads();
  for (int it = 0; it < iterations; ++it) {
    float p[7];
    for (int a = 0; a < 7; ++a) p[a] = spose[a];
    D6 t[3], q[4];
    retract_at_zero(p, t, q);
    float acc[kRefineSums];
#pragma unroll
    for (int j = 0; j < kRefineSums; ++j) acc[j] = 0.f;
    for (int m = threadIdx.x; m < M; m += blockDim.x) {
      if (!sinl[m]) continue;   // a zero row: r = 0 and J = 0
      const D6 Pd[3] = {dconst(sX[3 * m]), dconst(sX[3 * m + 1]), dconst(sX[3 * m + 2])};
      D6 pc[3];
      dquat_rotate(q, Pd, pc);
#pragma unroll
      for (int a = 0; a < 3; ++a) pc[a] = pc[a] + t[a];
      const D6 z = fabsf(pc[2].v) < 1e-6f ? dconst(1e-6f) : pc[2];
      add_row((pc[0] / z) - dconst(sxn[2 * m]), acc);
      add_row((pc[1] / z) - dconst(sxn[2 * m + 1]), acc);
      const float dep = sdep[m];
      if (has_depth && dep > 0.05f) add_row((pc[2] - dconst(dep)) / dconst(fmaxf(dep, 1.f)), acc);
    }
    uz::block_tree_sum(acc, red);
    if (threadIdx.x == 0) {
      float Hm[6][6], g[6], x[6];
      int k = 0;
      for (int u = 0; u < 6; ++u)
        for (int v = u; v < 6; ++v) {
          Hm[u][v] = Hm[v][u] = red[k++][0];
        }
      for (int u = 0; u < 6; ++u) {
        Hm[u][u] = Hm[u][u] + 1e-8f;
        g[u] = red[21 + u][0];
      }
      uz::lu_solve6(Hm, g, x);
      float dx[6], ex[7], np[7];
      for (int u = 0; u < 6; ++u) dx[u] = -x[u];
      uz::se3_exp(dx, ex);
      uz::pose_compose(p, ex, np);
      for (int a = 0; a < 7; ++a) spose[a] = np[a];
    }
    __syncthreads();
  }
  float pf[7];
  for (int a = 0; a < 7; ++a) pf[a] = spose[a];
  float acc[kRefineSums];
#pragma unroll
  for (int j = 0; j < kRefineSums; ++j) acc[j] = 0.f;
  for (int m = threadIdx.x; m < M; m += blockDim.x) {
    float e2;
    if (inlier(pf, sX + 3 * m, sxn + 2 * m, sdep[m], sval[m] != 0, has_depth, thresh2,
               depth_tol, &e2)) {
      acc[0] += 1.f;
      acc[1] += e2;
    }
  }
  uz::block_tree_sum(acc, red);
  if (threadIdx.x == 0) {
    const int cons = static_cast<int>(red[0][0]);
    const float mse = (red[1][0] / static_cast<float>(cons > 1 ? cons : 1)) * f_mean2;
    bool finite = true;
    for (int a = 0; a < 7; ++a) {
      finite = finite && isfinite(pf[a]);
      pose_out[7 * b + a] = pf[a];
    }
    consensus_out[b] = cons;
    mse_out[b] = mse;
    ok_out[b] = static_cast<float>(cons) >= min_consensus && finite;
  }
}

}  // namespace

// X: (B, M, 3), xn: (B, M, 2) float32; valid: (B, M) bool; depth: (B, M)
// float32 or null; keys: (B, H, M) float32.  Out: samples (B, H, 6) int32,
// poses (B, F * H, 7), family-major (DLT, homography, Kabsch with depth).
extern "C" int uz_pnp_hypotheses(const float* X, const float* xn, const unsigned char* valid,
                                 const float* depth, const float* keys, int B, int M, int H,
                                 int* samples, float* poses, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tasks = B * H;
  if (tasks <= 0) return 0;
  pnp_hypotheses_kernel<<<(tasks + kHypWarps - 1) / kHypWarps, kHypWarps * 32, 0, s>>>(
      X, xn, valid, depth, keys, B, M, H, samples, poses);
  return static_cast<int>(cudaGetLastError());
}

// The inputs as above, samples (B, H, 6), poses (B, K, 7).  Out: pose (B, 7),
// consensus (B,) int32, mse (B,), ok (B,) bool, best (B,) int32, counts
// (B, K) int32.
extern "C" int uz_pnp_refine(const float* X, const float* xn, const unsigned char* valid,
                             const float* depth, const int* samples, const float* poses, int B,
                             int M, int H, int K, float thresh2, float depth_tol,
                             float min_consensus, int iterations, float f_mean2, float* pose,
                             int* consensus, float* mse, unsigned char* ok, int* best,
                             int* counts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0) return 0;
  const size_t smem = static_cast<size_t>(M) * (6 * sizeof(float) + 2) + K * sizeof(int);
  const cudaError_t err = cudaFuncSetAttribute(
      pnp_refine_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pnp_refine_kernel<<<B, kRefineThreads, smem, s>>>(X, xn, valid, depth, samples, poses, M, H, K,
                                                    thresh2, depth_tol, min_consensus,
                                                    iterations, f_mean2, pose, consensus, mse,
                                                    ok, best, counts);
  return static_cast<int>(cudaGetLastError());
}
