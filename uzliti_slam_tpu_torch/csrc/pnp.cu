// K28 pnp: the PnP RANSAC of the "pnp" estimator in one launch.
//
// Replaces uzliti_slam_tpu/ops/pnp.py:pnp_ransac (:107-242) with its fits
// _dlt_pose (:29-55), _homography_pose (:58-98) and ransac.kabsch, as the
// keyframe step vmaps it over its candidates (pipeline.py:417-457).
//
// Per candidate and draw the 6 largest uniform keys over the valid
// correspondences (-1e9 elsewhere; ties to the lower index, as lax.top_k),
// then three hypotheses:
//   - the DLT: the (12, 12) system's null vector by one-sided (Hestenes)
//     Jacobi on the system itself (an eigen-solve of A^T A would square its
//     condition number in float32), the det(M3) sign folded into M, R the
//     proper polar factor of M3 and t = M4 / (sum sigma / 3);
//   - the homography: the sample's plane by one-sided cyclic Jacobi of its
//     (6, 3) weighted spread, the (12, 9) system's null vector by one-sided
//     Jacobi, and the decomposition (sigma = sgn(H22), Gram-Schmidt, the
//     rotation completed through the plane normal);
//   - with depth, Kabsch of the 6 points against their back-projected
//     observations.
// Then the K x M consensus (reprojection error compiled as fma(v, v, u * u)
// below the threshold, in front, within the depth tolerance where
// measured), -1 where the draw holds an invalid correspondence; the first
// argmax; 8 Gauss-Newton steps p <- p o exp(dx) on the best inliers'
// reprojection and depth rows, their Jacobian at dx = 0 in forward-mode dual
// numbers with 6 tangents (jacfwd's derivative through _project_norm's
// |z| < 1e-6 clamp), J^T J + 1e-8 I; then the final inliers, consensus, mse
// in px^2 and ok.
//
// Design: one thread-block cluster per candidate, kClusterCtas CTAs of
// kDraws / 2 x 3 warps (8 CTAs taking 8 draws a pass: the step's 64 draws in
// one pass; scripts/k27_k28_variants.py).  Every CTA stages the candidate's
// M correspondences in shared memory (two 16-byte vectors each).  The CTAs
// share the draws; a warp per (two draws, family), a 16-lane group a draw,
// so that the three fits of a draw run side by side and a warp's latency
// serves two draws:
//   - each family group makes its draw (the same bits in all three: each
//     lane keeps its own top 6, then six rounds of a (value, index) maximum
//     over the group) and reads the 6 correspondences from shared memory;
//   - the (12, 12) and (12, 9) systems hold one COLUMN a lane of the group,
//     and the one-sided Jacobi rotates disjoint column pairs in parallel
//     rounds (the round-robin order of kernels/ops.py:round_robin_pairs: 11
//     rounds of 6 pairs a sweep for n = 12, 9 rounds of 4 for n = 9): a lane
//     fetches its partner's column by shuffles, both lanes of a pair form the
//     same alpha, beta, gamma from the same operands and so take the same
//     rotation, in place of 66 or 36 pairs one after another, each with three
//     warp butterflies; a sweep without a rotation ends it.  The plane's
//     (6, 3) and the 3x3 polar factors stay cyclic, in every lane's
//     registers.  Every rotation takes its (c, s) from the hardware's
//     reciprocal and reciprocal square root (uz::jacobi_rotation<true>): an
//     IEEE division or square root is a slow-path check and a convergence
//     barrier on the rounds' chain (the fits took 94 us at the step with
//     them, 49 without);
//   - the warp that fitted a hypothesis scores it over the staged
//     correspondences and votes (count + 1, K - 1 - k) into its CTA's
//     largest vote (a 32-bit atomicMax in shared memory); after one cluster
//     barrier every CTA takes the largest of the CTAs' votes through
//     distributed shared memory: order-free, argmax's lowest index among
//     ties;
//   - the polish spreads the best inliers over kPolishCtas CTAs (1: the
//     leader alone measured faster than the cluster at both shapes, its sums
//     needing no cluster barrier; the other CTAs leave after the vote); the
//     27 sums go each thread's points in order, a warp tree (a
//     reduce-scatter butterfly, uz::warp_sum_scatter), the CTA's warps in
//     order, the CTAs in rank order (double-buffered by step parity: one
//     cluster barrier a step); warp 0 of each CTA solves the 6x6
//     (lu_solve6) and hands the pose out through shared memory; a
//     dual-number quotient divides once (its value's) and scales its
//     tangents by the reciprocal.
// The sign folds make each pose independent of the singular vectors' signs,
// and the plane frame's in-plane rotation cancels in the rotation, so the
// poses agree with LAPACK's to rounding wherever the null space is one
// dimension.  (A coplanar sample's DLT null space is not: its pose is
// arbitrary on both sides.)  No cuSOLVER call (its solves check an info
// flag on the host).
//
// What bounds it on the card: the K x M consensus, 192 x 256 x ~40 flops a
// candidate (20 Mflop for the step's 10), and the Jacobi sweeps, ~12 x 66 x
// ~60 operations a system; both are microseconds of work, so the launch is
// latency: 132 dependent rotation rounds a system, then 8 dependent solves.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "linalg.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kSample = 6;            // PNP_SAMPLE in kernels/ops.py
constexpr int kSvdSweeps = 12;        // SVD_SWEEPS
constexpr float kSvdTol = 1e-7f;      // SVD_TOL
constexpr int kSums = 27;             // J^T J upper triangle (21), J^T r (6)
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxPoints = 2048;      // PNP_MAX_POINTS
constexpr int kPointBytes = 2 * sizeof(float4) + 1;
constexpr int kMaxDevices = 16;
constexpr int kFamilies = 3;
constexpr int kVoteBits = 20;         // a vote: (count + 1) << kVoteBits | (K - 1 - k)
static_assert(kMaxPoints + 1 < (1 << (32 - kVoteBits)), "a count in a vote's high bits");

// the launch shape: CTAs a candidate, draws a CTA a pass, and the CTAs the
// polish spreads over (1 or kClusterCtas): the measured choice (PERF.md,
// scripts/k27_k28_variants.py)
constexpr int kClusterCtas = 8, kDraws = 8, kPolishCtas = 1;
constexpr int kPairs = kDraws / 2, kWarps = kPairs * kFamilies, kCtaThreads = kWarps * 32;
static_assert(kDraws % 2 == 0, "kDraws: two draws a warp");
static_assert(kPolishCtas == 1 || kPolishCtas == kClusterCtas, "kPolishCtas");

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ float norm3(const float v[3]) {
  return sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
}

// Partner of column slot j in round r of the round-robin order over P
// (even) slots: slot P - 1 meets r; else j meets (2r - j) mod (P - 1), or
// P - 1 where that is j itself.  Lanes at or past P meet themselves.
__device__ __forceinline__ int rr_partner(int j, int r, int P) {
  const int m = P - 1;
  if (j >= P) return j;
  if (j == m) return r;
  const int k = (2 * r - j + 2 * m) % m;
  return k == j ? m : k;
}

// One-sided Jacobi on an (R, N) matrix held one column a lane of a 16-lane
// group (lane base + j, j < N: a = column j of A, v = column j of V, the
// identity's at the start; the group's other lanes zeros), the two groups
// of a warp on two matrices in step.  Each round rotates the disjoint pairs
// of rr_partner at once; a pair (p < q) is rotated where |gamma| > kSvdTol
// sqrt(alpha beta).  Both lanes of a pair form alpha = |a_p|^2, beta =
// |a_q|^2 and gamma = a_p . a_q by the same operations on the same operands
// (a lane's |a|^2 is handed to its partner; a product's operand order does
// not change its bits), so both take the same rotation.  A sweep that
// rotates no pair of either matrix ends it (a matrix without one is left as
// it is; kernels/ops.py:jacobi_svd_plain, order="parallel").
template <int R, int N>
__device__ __forceinline__ void jacobi_columns(float (&a)[R], float (&v)[N], int j, int base) {
  constexpr int P = N + (N & 1);
  for (int sweep = 0; sweep < kSvdSweeps; ++sweep) {
    bool rotated = false;
    for (int r = 0; r < P - 1; ++r) {
      const int pj = rr_partner(j, r, P), partner = base + pj;
      float pa[R], pv[N];
#pragma unroll
      for (int i = 0; i < R; ++i) pa[i] = __shfl_sync(kFull, a[i], partner);
#pragma unroll
      for (int i = 0; i < N; ++i) pv[i] = __shfl_sync(kFull, v[i], partner);
      float own2 = 0.f, gamma = 0.f;
#pragma unroll
      for (int i = 0; i < R; ++i) {
        own2 = fmaf(a[i], a[i], own2);
        gamma = fmaf(a[i], pa[i], gamma);
      }
      const float par2 = __shfl_sync(kFull, own2, partner);
      const bool lo = j < pj;
      const float alpha = lo ? own2 : par2, beta = lo ? par2 : own2;
      // |gamma| > kSvdTol sqrt(alpha beta), squared: no square root
      const bool rot = j < N && pj < N && pj != j &&
                       gamma * gamma > (kSvdTol * kSvdTol) * (alpha * beta);
      if (rot) {
        // the rotation from the hardware's reciprocal (square root) in place
        // of IEEE divisions and square roots, each a slow-path check and a
        // convergence barrier on the rounds' critical path (the poses are
        // scale-free in the null vector; uz::jacobi_rotation); both lanes
        // of a pair take the same (c, s)
        float c, s;
        uz::jacobi_rotation<true>(alpha, beta, gamma, c, s);
        // lane p: c a_p - s a_q; lane q: s a_p + c a_q
#pragma unroll
        for (int i = 0; i < R; ++i) a[i] = lo ? c * a[i] - s * pa[i] : s * pa[i] + c * a[i];
#pragma unroll
        for (int i = 0; i < N; ++i) v[i] = lo ? c * v[i] - s * pv[i] : s * pv[i] + c * v[i];
      }
      rotated = rotated || rot;
    }
    if (!__any_sync(kFull, rotated)) break;
  }
}

// V's column of the smallest singular value (the first on a tie; column
// norms of A V), in every lane of the 16-lane group: out[k] = V[k][j].
template <int R, int N>
__device__ __forceinline__ void null_vector(const float (&a)[R], const float (&v)[N], int j,
                                            int base, float (&out)[N]) {
  float s2 = 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) s2 = fmaf(a[i], a[i], s2);
  const float sig = j < N ? sqrtf(s2) : inf_f();
  uint64_t key = (static_cast<uint64_t>(__float_as_uint(sig)) << 32) | static_cast<unsigned>(j);
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    const uint64_t k = __shfl_xor_sync(kFull, key, o);
    key = k < key ? k : key;
  }
  const int jmin = static_cast<int>(static_cast<unsigned>(key));
#pragma unroll
  for (int k = 0; k < N; ++k) out[k] = __shfl_sync(kFull, v[k], base + jmin);
}

// One one-sided Jacobi rotation of columns p < q of a (6, 3) matrix (V
// alongside), sums over the rows in order; false where the two are already
// orthogonal (kSvdTol).
template <int p, int q>
__device__ __forceinline__ bool plane_pair(float (&A)[kSample][3], float (&V)[3][3]) {
  float alpha = 0.f, beta = 0.f, gamma = 0.f;
#pragma unroll
  for (int i = 0; i < kSample; ++i) {
    alpha = fmaf(A[i][p], A[i][p], alpha);
    beta = fmaf(A[i][q], A[i][q], beta);
    gamma = fmaf(A[i][p], A[i][q], gamma);
  }
  if (!(gamma * gamma > (kSvdTol * kSvdTol) * (alpha * beta))) return false;
  float c, s;
  uz::jacobi_rotation<true>(alpha, beta, gamma, c, s);
#pragma unroll
  for (int i = 0; i < kSample; ++i) {
    const float ap = A[i][p], aq = A[i][q];
    A[i][p] = c * ap - s * aq;
    A[i][q] = s * ap + c * aq;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float vp = V[i][p], vq = V[i][q];
    V[i][p] = c * vp - s * vq;
    V[i][q] = s * vp + c * vq;
  }
  return true;
}

__device__ __forceinline__ void write_pose(const float R[3][3], const float t[3], float out[7]) {
  float q[4];
  uz::matrix_to_quat(R, q);
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k] = t[k];
#pragma unroll
  for (int k = 0; k < 4; ++k) out[3 + k] = q[k];
}

// A draw's 6 correspondences, in every lane of its warp
struct Draw {
  float X[kSample][3], x[kSample], y[kSample], dep[kSample], w[kSample];
};

// The DLT's pose from the (12, 12) system [X~ w, 0, (-x X~) w; 0, X~ w,
// (-y X~) w], column j on lane base + j.
__device__ __forceinline__ void dlt_fit(const Draw& dr, int j, int base, float (&pose)[7]) {
  float a[12], v[12], m[12];
  const int blk = j >> 2, comp = j & 3;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int k = i % kSample;
    const bool first = i < kSample;
    const float g = comp == 3 ? 1.f : (comp == 0 ? dr.X[k][0] : (comp == 1 ? dr.X[k][1] : dr.X[k][2]));
    const float c = first ? -dr.x[k] : -dr.y[k];
    float e = 0.f;
    if (blk == 0 && first) e = g * dr.w[k];
    if (blk == 1 && !first) e = g * dr.w[k];
    if (blk == 2) e = (c * g) * dr.w[k];
    a[i] = j < 12 ? e : 0.f;
  }
#pragma unroll
  for (int k = 0; k < 12; ++k) v[k] = (j < 12 && k == j) ? 1.f : 0.f;
  jacobi_columns<12, 12>(a, v, j, base);
  null_vector<12, 12>(a, v, j, base, m);
  const float det = m[0] * (m[5] * m[10] - m[6] * m[9]) - m[1] * (m[4] * m[10] - m[6] * m[8])
                    + m[2] * (m[4] * m[9] - m[5] * m[8]);
  const float sg = det < 0.f ? -1.f : 1.f;
  float M3[3][3], R[3][3], t[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) M3[i][j] = m[4 * i + j] * sg;
  const float ssum = uz::proper_rotation<true>(M3, R);
  const float scale = fmaxf(ssum / 3.f, 1e-12f);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = (m[4 * i + 3] * sg) / scale;
  write_pose(R, t, pose);
}

// The homography's pose: the sample's plane (cyclic Jacobi of the (6, 3)
// weighted spread in registers), then the (12, 9) system [px w, py w, w, 0,
// 0, 0, (-x px) w, (-x py) w, -x w; 0, 0, 0, px w, py w, w, (-y px) w, ...]
// column j on lane base + j, its null vector H and the decomposition.
__device__ __forceinline__ void homography_fit(const Draw& dr, int j, int base,
                                               float (&pose)[7]) {
  float wsum = 0.f;
#pragma unroll
  for (int k = 0; k < kSample; ++k) wsum = wsum + dr.w[k];
  wsum = fmaxf(wsum, 1e-6f);
  float c0[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kSample; ++k) s = s + dr.X[k][a] * dr.w[k];
    c0[a] = s / wsum;
  }
  float A[kSample][3], V[3][3], d[kSample][3];
#pragma unroll
  for (int k = 0; k < kSample; ++k)
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      d[k][a] = dr.X[k][a] - c0[a];
      A[k][a] = d[k][a] * dr.w[k];
    }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) V[i][j] = i == j ? 1.f : 0.f;
  for (int sweep = 0; sweep < kSvdSweeps; ++sweep) {
    const bool r01 = plane_pair<0, 1>(A, V);
    const bool r02 = plane_pair<0, 2>(A, V);
    const bool r12 = plane_pair<1, 2>(A, V);
    if (!(r01 || r02 || r12)) break;
  }
  float sig[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kSample; ++i) s = fmaf(A[i][k], A[i][k], s);
    sig[k] = sqrtf(s);
  }
  int i1 = 0;
#pragma unroll
  for (int k = 1; k < 3; ++k)
    if (sig[k] > uz::pick3(sig, i1)) i1 = k;
  int i2 = i1 == 0 ? 1 : 0;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    if (k != i1 && sig[k] > uz::pick3(sig, i2)) i2 = k;
  float e1[3], e2[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    e1[k] = uz::pick3(V[k], i1);
    e2[k] = uz::pick3(V[k], i2);
  }
  float a[12], v[9], hv[9];
  const int blk = j < 9 ? j / 3 : 3, comp = j % 3;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    const int k = i % kSample;
    const bool first = i < kSample;
    const float px = d[k][0] * e1[0] + d[k][1] * e1[1] + d[k][2] * e1[2];
    const float py = d[k][0] * e2[0] + d[k][1] * e2[1] + d[k][2] * e2[2];
    const float g = comp == 0 ? px : (comp == 1 ? py : 1.f);
    const float c = first ? -dr.x[k] : -dr.y[k];
    float e = 0.f;
    if (blk == 0 && first) e = g * dr.w[k];
    if (blk == 1 && !first) e = g * dr.w[k];
    if (blk == 2) e = (c * g) * dr.w[k];
    a[i] = e;
  }
#pragma unroll
  for (int k = 0; k < 9; ++k) v[k] = (j < 9 && k == j) ? 1.f : 0.f;
  jacobi_columns<12, 9>(a, v, j, base);
  null_vector<12, 9>(a, v, j, base, hv);
  float Hm[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Hm[i][j] = hv[3 * i + j];
  const float col0[3] = {Hm[0][0], Hm[1][0], Hm[2][0]};
  const float col1[3] = {Hm[0][1], Hm[1][1], Hm[2][1]};
  const float s = sqrtf(norm3(col0) * norm3(col1)) + 1e-12f;
  const float sigma = Hm[2][2] > 0.f ? 1.f : -1.f;
  float Hs[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Hs[i][j] = (sigma * Hm[i][j]) / s;
  const float h0[3] = {Hs[0][0], Hs[1][0], Hs[2][0]};
  const float h1[3] = {Hs[0][1], Hs[1][1], Hs[2][1]};
  const float n0 = norm3(h0) + 1e-12f;
  float r1c[3], r2o[3], r2c[3], r3c[3], npl[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) r1c[i] = h0[i] / n0;
  const float dd = r1c[0] * h1[0] + r1c[1] * h1[1] + r1c[2] * h1[2];
#pragma unroll
  for (int i = 0; i < 3; ++i) r2o[i] = h1[i] - r1c[i] * dd;
  const float n2 = norm3(r2o) + 1e-12f;
#pragma unroll
  for (int i = 0; i < 3; ++i) r2c[i] = r2o[i] / n2;
  uz::cross3(r1c, r2c, r3c);
  uz::cross3(e1, e2, npl);
  float Rc[3][3], tc[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Rc[i][j] = r1c[i] * e1[j] + r2c[i] * e2[j] + r3c[i] * npl[j];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    tc[i] = Hs[i][2] - (Rc[i][0] * c0[0] + Rc[i][1] * c0[1] + Rc[i][2] * c0[2]);
  write_pose(Rc, tc, pose);
}

// Kabsch of the 6 points against their back-projected observations, the
// points with a measured depth (> 0.05) weighted 1.
__device__ __forceinline__ void kabsch_fit(const Draw& dr, float (&pose)[7]) {
  float wk[kSample], Q[kSample][3];
  float wsum = 0.f;
#pragma unroll
  for (int k = 0; k < kSample; ++k) {
    wk[k] = (dr.w[k] != 0.f && dr.dep[k] > 0.05f) ? 1.f : 0.f;
    Q[k][0] = dr.x[k] * dr.dep[k];
    Q[k][1] = dr.y[k] * dr.dep[k];
    Q[k][2] = dr.dep[k];
    wsum = wsum + wk[k];
  }
  wsum = fmaxf(wsum, 1e-9f);
  float mu_s[3], mu_d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float ss = 0.f, sd = 0.f;
#pragma unroll
    for (int k = 0; k < kSample; ++k) {
      ss = ss + dr.X[k][a] * wk[k];
      sd = sd + Q[k][a] * wk[k];
    }
    mu_s[a] = ss / wsum;
    mu_d[a] = sd / wsum;
  }
  float C[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float c = 0.f;
#pragma unroll
      for (int k = 0; k < kSample; ++k)
        c = c + ((Q[k][i] - mu_d[i]) * wk[k]) * (dr.X[k][j] - mu_s[j]);
      C[i][j] = c / wsum;
    }
  float R[3][3], t[3];
  uz::proper_rotation<true>(C, R);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    t[i] = mu_d[i] - (R[i][0] * mu_s[0] + R[i][1] * mu_s[1] + R[i][2] * mu_s[2]);
  write_pose(R, t, pose);
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
// a / b with its tangents: one division (the value's), then b's reciprocal
// (the same to a rounding as dividing each tangent: seven divisions would
// lie on the polish's path for each row)
__device__ __forceinline__ D6 operator/(const D6& a, const D6& b) {
  D6 r;
  r.v = a.v / b.v;
  const float inv = 1.f / b.v;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.d[k] = (a.d[k] - r.v * b.d[k]) * inv;
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

// One correspondence under a pose: an inlier of the consensus (and its
// squared reprojection error in normalised units)
__device__ __forceinline__ bool inlier(const float pose[7], float4 ca, float4 cb, bool has_depth,
                                       float thresh2, float depth_tol, float* err2) {
  const float P[3] = {ca.x, ca.y, ca.z};
  float pc[3];
  uz::quat_rotate(pose + 3, P, pc);
#pragma unroll
  for (int a = 0; a < 3; ++a) pc[a] = pc[a] + pose[a];
  const float z = fabsf(pc[2]) < 1e-6f ? 1e-6f : pc[2];
  const float ex = pc[0] / z - cb.x, ey = pc[1] / z - cb.y;
  *err2 = fmaf(ey, ey, ex * ex);
  bool ok = *err2 < thresh2 && cb.z != 0.f && pc[2] > 0.05f;
  const float dep = ca.w;
  if (has_depth && dep > 0.05f) ok = ok && fabsf(pc[2] - dep) < depth_tol * fmaxf(dep, 1.f);
  return ok;
}

__device__ __forceinline__ void add_row(const D6& r, float (&acc)[kSums]) {
  int q = 0;
#pragma unroll
  for (int u = 0; u < 6; ++u)
#pragma unroll
    for (int v = u; v < 6; ++v) acc[q++] += r.d[u] * r.d[v];
#pragma unroll
  for (int u = 0; u < 6; ++u) acc[21 + u] += r.d[u] * r.v;
}

// A draw: the 6 largest (key, -index) over the valid correspondences, in
// every lane of a 16-lane group (lane j scans entries j, j + 16, ...; ties to
// the lower index)
__device__ __forceinline__ void make_draw(const float* __restrict__ key, const float4* cb, int M,
                                          int j, int (&smp)[kSample]) {
  float lv[kSample];
  int li[kSample];
#pragma unroll
  for (int k = 0; k < kSample; ++k) {
    lv[k] = -inf_f();
    li[k] = 0x7fffffff;
  }
  for (int m = j; m < M; m += 16) {
    float cv = cb[m].z != 0.f ? key[m] : -1e9f;
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
#pragma unroll
  for (int r = 0; r < kSample; ++r) {
    float v = lv[0];
    int ix = li[0];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
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
      lv[kSample - 1] = -inf_f();
      li[kSample - 1] = 0x7fffffff;
    }
  }
}

// The CTA's 27 partial sums of this step (each thread's in its order, a
// warp tree, the warps in order) into part, then the polish CTAs' totals in
// rank order into tot, written by threads 0-26 (warp 0: it reads them after
// a __syncwarp).
__device__ __forceinline__ void polish_sums(float (&acc)[kSums], float (*wpart)[kSums],
                                            float* part, float* tot, cg::cluster_group& cluster,
                                            int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  const float mine_q = uz::warp_sum_scatter(acc, lane);   // lane q: the warp's sum q
  if (lane < kSums) wpart[warp][lane] = mine_q;
  __syncthreads();
  if (tid < kSums) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t = t + wpart[w][tid];
    part[tid] = t;
  }
  if (kPolishCtas > 1) {
    cluster.sync();
    if (tid < kSums) {
      float v[kPolishCtas];
#pragma unroll
      for (int q = 0; q < kPolishCtas; ++q) v[q] = *cluster.map_shared_rank(&part[tid], q);
      float t = 0.f;
#pragma unroll
      for (int q = 0; q < kPolishCtas; ++q) t = t + v[q];
      tot[tid] = t;
    }
  } else if (tid < kSums) {
    tot[tid] = part[tid];
  }
}

__global__ void __launch_bounds__(kCtaThreads, 1)
pnp_cluster(const float* __restrict__ X, const float* __restrict__ xn,
            const unsigned char* __restrict__ valid, const float* __restrict__ depth,
            const float* __restrict__ keys, int M, int H, float thresh2,
            float depth_tol, float min_consensus, int iterations, float f_mean2,
            int* __restrict__ samples, float* poses, float* __restrict__ pose_out,
            int* __restrict__ consensus_out, float* __restrict__ mse_out,
            unsigned char* __restrict__ ok_out, int* __restrict__ best_out,
            int* __restrict__ counts_out, unsigned long long* __restrict__ stamps) {
  extern __shared__ __align__(16) float4 sc[];
  float4* ca = sc;            // M x (X, depth or 0)
  float4* cb = ca + M;        // M x (xn, valid flag, 0)
  unsigned char* sinl = reinterpret_cast<unsigned char*>(cb + M);   // M: the best's inliers
  __shared__ float wpart[kWarps][kSums];
  __shared__ float part[2][kSums];
  __shared__ float tot[kSums];
  __shared__ float spose[7];   // the pose warp 0 solved for
  __shared__ unsigned sbest;   // this CTA's largest vote

  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / kClusterCtas, rank = static_cast<int>(cluster.block_rank());
  const bool has_depth = depth != nullptr;
  const int F = has_depth ? 3 : 2, K = F * H;
  unsigned long long* stamp = stamps ? stamps + 4 * b : nullptr;
  if (stamp && tid == 0) atomicMin(stamp, now_ns());
  const size_t pm = static_cast<size_t>(b) * M;
  for (int m = tid; m < M; m += kCtaThreads) {
    const size_t g = pm + m;
    ca[m] = make_float4(X[3 * g], X[3 * g + 1], X[3 * g + 2], has_depth ? depth[g] : 0.f);
    cb[m] = make_float4(xn[2 * g], xn[2 * g + 1], valid[g] ? 1.f : 0.f, 0.f);
  }
  if (tid == 0) sbest = 0u;
  cluster.sync();

  // --- the draws, fits and consensus: a warp per (two draws, family), a
  // 16-lane group a draw; a group past the last draw repeats its partner's
  // and writes nothing
  const int f = warp / kPairs, pr = warp % kPairs;
  const int j = lane & 15, base = lane & 16;
  for (int h0 = rank * kDraws + 2 * pr; h0 < H && f < F; h0 += kClusterCtas * kDraws) {
    const bool live = h0 + (base >> 4) < H;
    const int h = live ? h0 + (base >> 4) : h0;
    const int k = f * H + h;
    float pose[7];
    int smp[kSample];
    make_draw(keys + (static_cast<size_t>(b) * H + h) * M, cb, M, j, smp);
    if (f == 0 && live && j < kSample) {
      int s = 0;
#pragma unroll
      for (int r = 0; r < kSample; ++r)
        if (r == j) s = smp[r];
      samples[(static_cast<size_t>(b) * H + h) * kSample + j] = s;
    }
    Draw dr;
#pragma unroll
    for (int r = 0; r < kSample; ++r) {
      const float4 a = ca[smp[r]], c = cb[smp[r]];
      dr.X[r][0] = a.x;
      dr.X[r][1] = a.y;
      dr.X[r][2] = a.z;
      dr.dep[r] = a.w;
      dr.x[r] = c.x;
      dr.y[r] = c.y;
      dr.w[r] = c.z;
    }
    if (f == 0) dlt_fit(dr, j, base, pose);
    else if (f == 1) homography_fit(dr, j, base, pose);
    else kabsch_fit(dr, pose);
    if (live && j == 0) {
#pragma unroll
      for (int a = 0; a < 7; ++a) poses[(static_cast<size_t>(b) * K + k) * 7 + a] = pose[a];
      __threadfence();   // read by the polish CTAs after the cluster barrier
      if (stamp) atomicMax(stamp + 1, now_ns());
    }
    int cnt = 0;
    for (int m = j; m < M; m += 16) {
      float e2;
      cnt += inlier(pose, ca[m], cb[m], has_depth, thresh2, depth_tol, &e2);
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) cnt += __shfl_xor_sync(kFull, cnt, o);
    bool sample_ok = true;
#pragma unroll
    for (int r = 0; r < kSample; ++r) sample_ok = sample_ok && cb[smp[r]].z != 0.f;
    const int c = sample_ok ? cnt : -1;
    if (live && j == 0) {
      counts_out[static_cast<size_t>(b) * K + k] = c;
      // argmax's first maximum: the largest (count + 1, K - 1 - k), count +
      // 1 <= kMaxPoints + 1 in the high 12 bits, K <= 2^20
      atomicMax(&sbest, (static_cast<unsigned>(c + 1) << kVoteBits) |
                            static_cast<unsigned>(K - 1 - k));
      if (stamp) atomicMax(stamp + 2, now_ns());
    }
  }
  cluster.sync();   // every vote is in, every fitted pose written
  // the candidate's largest vote over the CTAs' (order-free)
  unsigned top = 0u;
#pragma unroll
  for (int q = 0; q < kClusterCtas; ++q) top = max(top, *cluster.map_shared_rank(&sbest, q));
  const int best = K - 1 - static_cast<int>(top & ((1u << kVoteBits) - 1u));
  if (kPolishCtas < kClusterCtas) {
    cluster.sync();   // every CTA has read the votes: the others may leave
    if (rank >= kPolishCtas) return;
  }

  // --- the polish: the best hypothesis' inliers, the Gauss-Newton steps
  float p[7];
#pragma unroll
  for (int a = 0; a < 7; ++a) p[a] = __ldcg(poses + (static_cast<size_t>(b) * K + best) * 7 + a);
  const int stride = kPolishCtas * kCtaThreads;
  for (int m = rank + kPolishCtas * tid; m < M; m += stride) {
    float e2;
    sinl[m] = inlier(p, ca[m], cb[m], has_depth, thresh2, depth_tol, &e2);
  }
  // sinl: only this thread reads its points' flags
  for (int it = 0; it < iterations; ++it) {
    D6 t[3], q[4];
    retract_at_zero(p, t, q);
    float acc[kSums];
#pragma unroll
    for (int j = 0; j < kSums; ++j) acc[j] = 0.f;
    for (int m = rank + kPolishCtas * tid; m < M; m += stride) {
      if (!sinl[m]) continue;   // a zero row: r = 0 and J = 0
      const float4 a = ca[m], c = cb[m];
      const D6 Pd[3] = {dconst(a.x), dconst(a.y), dconst(a.z)};
      D6 pc[3];
      dquat_rotate(q, Pd, pc);
#pragma unroll
      for (int u = 0; u < 3; ++u) pc[u] = pc[u] + t[u];
      const D6 z = fabsf(pc[2].v) < 1e-6f ? dconst(1e-6f) : pc[2];
      add_row((pc[0] / z) - dconst(c.x), acc);
      add_row((pc[1] / z) - dconst(c.y), acc);
      const float dep = a.w;
      if (has_depth && dep > 0.05f) add_row((pc[2] - dconst(dep)) / dconst(fmaxf(dep, 1.f)), acc);
    }
    polish_sums(acc, wpart, part[it & 1], tot, cluster, tid);
    // warp 0 solves; the pose goes out through shared memory
    if (warp == 0) {
      __syncwarp();
      float Hm[6][6], g[6], x[6];
      int n = 0;
#pragma unroll
      for (int u = 0; u < 6; ++u)
#pragma unroll
        for (int v = u; v < 6; ++v) {
          Hm[u][v] = Hm[v][u] = tot[n++];
        }
#pragma unroll
      for (int u = 0; u < 6; ++u) {
        Hm[u][u] = Hm[u][u] + 1e-8f;
        g[u] = tot[21 + u];
      }
      uz::lu_solve6(Hm, g, x);
      float dx[6], ex[7], np[7];
#pragma unroll
      for (int u = 0; u < 6; ++u) dx[u] = -x[u];
      uz::se3_exp_rcp(dx, ex);
      uz::pose_compose_rcp(p, ex, np);
      if (lane < 7) spose[lane] = np[lane];
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < 7; ++a) p[a] = spose[a];
  }
  // --- the final audit at the refined pose
  float acc[kSums];
#pragma unroll
  for (int j = 0; j < kSums; ++j) acc[j] = 0.f;
  for (int m = rank + kPolishCtas * tid; m < M; m += stride) {
    float e2;
    if (inlier(p, ca[m], cb[m], has_depth, thresh2, depth_tol, &e2)) {
      acc[0] += 1.f;
      acc[1] += e2;
    }
  }
  polish_sums(acc, wpart, part[iterations & 1], tot, cluster, tid);
  __syncwarp();
  if (rank == 0 && tid == 0) {
    const int cons = static_cast<int>(tot[0]);
    const float mse = (tot[1] / static_cast<float>(cons > 1 ? cons : 1)) * f_mean2;
    bool finite = true;
    for (int a = 0; a < 7; ++a) {
      finite = finite && isfinite(p[a]);
      pose_out[7 * b + a] = p[a];
    }
    consensus_out[b] = cons;
    mse_out[b] = mse;
    ok_out[b] = static_cast<float>(cons) >= min_consensus && finite;
    best_out[b] = best;
    if (stamp) stamp[3] = now_ns();
  }
  // no CTA leaves while another may still read its partials
  if (kPolishCtas > 1) cluster.sync();
}

// Once per device: the kernel may take kMaxPoints correspondences' shared
// memory and a cluster above the portable size, and such a cluster must fit.
int prepare() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && ready[dev]) return 0;
  err = cudaFuncSetAttribute(pnp_cluster, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxPoints * kPointBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (kClusterCtas > 8) {
    err = cudaFuncSetAttribute(pnp_cluster, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterCtas, 1, 1);
  cfg.blockDim = dim3(kCtaThreads, 1, 1);
  cfg.dynamicSmemBytes = kMaxPoints * kPointBytes;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, pnp_cluster, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  if (dev < kMaxDevices) ready[dev] = true;
  return 0;
}

}  // namespace

// X: (B, M, 3), xn: (B, M, 2) float32; valid: (B, M) bool; depth: (B, M)
// float32 or null; keys: (B, H, M) float32.  Out: samples (B, H, 6) int32,
// poses (B, F * H, 7), family-major (DLT, homography, Kabsch with depth);
// pose (B, 7), consensus (B,) int32, mse (B,), ok (B,) bool, best (B,)
// int32, counts (B, F * H) int32; stamps null, or (B, 4) uint64 of
// %globaltimer ns set to (~0, 0, 0, 0) by the caller: the first CTA's
// start, the last fit's end, the last consensus' end, the polish's end.
// 6 <= M <= 2048.  One cluster of kClusterCtas CTAs a candidate; 701 =
// cudaErrorLaunchOutOfResources if it does not fit the card.
extern "C" int uz_pnp_ransac(const float* X, const float* xn, const unsigned char* valid,
                             const float* depth, const float* keys, int B, int M, int H,
                             float thresh2, float depth_tol, float min_consensus, int iterations,
                             float f_mean2, int* samples, float* poses, float* pose,
                             int* consensus, float* mse, unsigned char* ok, int* best,
                             int* counts, unsigned long long* stamps, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (M < kSample || M > kMaxPoints || (depth ? 3 : 2) * H > (1 << kVoteBits))
    return static_cast<int>(cudaErrorInvalidValue);
  const int err = prepare();
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * kClusterCtas, 1, 1);
  cfg.blockDim = dim3(kCtaThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(M) * kPointBytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterCtas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, pnp_cluster, X, xn, valid, depth, keys, M, H,
                                             thresh2, depth_tol, min_consensus, iterations,
                                             f_mean2, samples, poses, pose, consensus, mse, ok,
                                             best, counts, stamps));
}
