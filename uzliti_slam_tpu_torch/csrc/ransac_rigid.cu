// K7 ransac_rigid: batched RANSAC rigid fits, soft-PROSAC draws included,
// of the keyframe step, the exchange round's absorbed slots and the
// loop-closure filter, one launch a call.
//
// Replaces uzliti_slam_tpu/ops/ransac.py:ransac_rigid (:123-201) with its
// draw _valid_sample (:96-120), its hypothesis fit kabsch_quat (:54-93) and
// its refit kabsch (:32-52), vmapped over roots (graph/filter.py:157-165,
// the keyframe step, recognize_absorbed).  Per root r:
//   0. the draw (unless the caller hands the triplets in): each entry's
//      weight, exp(beta (q - q_min) / span - beta) over the valid entries
//      with span = max(q_max - q_min, 1e-6) (soft PROSAC), or valid as 0/1
//      without a quality; the row's running sum; each uniform u mapped to
//      the first entry whose running sum exceeds min(u total,
//      nextafter(total, 0)), index 0 in a row with no weight.  That is
//      ops/ransac.py:triplets_from_uniforms, the port's plain draw (the
//      uniforms come from one torch.rand on the caller's generator; JAX's
//      jax.random streams do not exist in PyTorch);
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
//      linalg.cuh, shared with K27 and K28);
//   5. consensus, mse, the information model and ok under the refit.
// For the rotation, U and V are completed from the two largest singular
// pairs by cross products (u3 = u1 x u2, v3 = v1 x v2): that gives exactly
// U diag(1, 1, sign(det U det V)) V^T, whatever the sign of the third
// singular pair, so a planar point set (rank 2, the 2-D trajectory's case)
// needs no special branch.  No cuSOLVER call: a library SVD may check its
// info flag and synchronise.
//
// Weights (ransac.py:131, 146): an optional (R, M) weight multiplies
// `valid` in the hypothesis fits and the refit, as the reference's
// w = weights * valid; the draw, the inlier tests, the sample-validity gate
// and the consensus read `valid` alone.
//
// Design: a thread-block cluster per root of G CTAs of kRootThreads = 1024
// (G = kMaxCluster = 4, halved while R·G exceeds the card's 132 SMs), the K
// hypotheses split into G runs; each CTA holds the root's points (two float4
// rows a point: xyz and its flag, xyz and its fit weight), its quality and
// running sums in shared memory.
//   - Every CTA of the cluster makes the same draw (the same operations on
//     the same inputs); the first writes the triplets out.  Each fits and
//     tests its run of hypotheses and puts its best key and pose in the
//     first CTA's shared memory (one split cluster barrier: the others
//     arrive and leave); the first CTA refits.
//   - The draw's running sum is a block scan in double: each thread sums a
//     run of entries, then a shuffle scan of the runs.  A weight is a float
//     in [e^-4, 1] (a multiple of 2^-30) or 0/1, so every partial sum of up
//     to 2^22 entries is exact in double whatever its order, and each
//     running sum rounded to float is the exact one rounded: what the plain
//     draw's torch.cumsum gives on the CPU (a sequential double sum).  One
//     thread per uniform then bisects the running sums.
//   - Four lanes per hypothesis fit it (horn_fit3): the power iteration is
//     a chain of 30 dependent steps, and its four divisions a step run on
//     four lanes side by side.
//   - The consensus: `lanes` lanes a hypothesis (1024 / K' for the K' a CTA
//     tests, at most 32, a power of two: 32 at the step's K = 128 over 4
//     CTAs), each over a strided share of the points, the counts added by a
//     shuffle butterfly within the lane group (exact integers).
//   - The argmax: keys (count + 1) << 32 | (2^31 - 1 - k), a warp butterfly
//     of maxima, then the warps', then the cluster's CTAs': ties go to the
//     lower k.
//   - Sums over points (weighted means, covariance, consensus and mse) in
//     double, a fixed order: every thread tests its points, then warp 0
//     sums, each lane over its points in order, then a butterfly
//     (uz::warp_tree_sum).  The SVD (registers only: uz::proper_rotation
//     rotates compile-time column pairs), rotation and quaternion run on
//     lane 0.
// What bounds it on the card: the K x M consensus (about 40 flops each: 1.3
// MFLOP a step root, 0.02 us at 67 TFLOP/s) and, below that, latency: the
// 30 dependent power steps and the refit's serial 3x3 SVD.  The cluster
// spreads the consensus and the fits over G SMs a root.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "linalg.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kRootThreads = 1024;
constexpr int kRootWarps = kRootThreads / 32;
constexpr int kLanes = 0;     // lanes a hypothesis; 0: 1024 / K', a power of two, at most 32
constexpr int kUniformsPerThread = 3;   // 3K <= 3 kRootThreads uniforms a root
constexpr int kMaxCluster = 4;   // CTAs a root at most (a thread-block cluster)
constexpr int kPowerIters = 30;
constexpr int kSums = 9;   // the covariance's entries

struct Params {
  const float* src;
  long long src_stride;
  const float* dst;
  long long dst_stride;
  const unsigned char* valid;
  const float* weights;    // (R, M) or nullptr
  const float* quality;    // (R, M) or nullptr: the soft-PROSAC draw's quality
  const float* uniforms;   // (R, 3K) or nullptr: the triplets are given
  const int* tri_in;       // (R, K, 3) when the uniforms are nullptr
  int m, k_hyp, lanes;
  int k_per_cta;           // hypotheses a CTA of the root's cluster fits and tests
  float thresh_sq, min_sigma_sq, beta;
  int min_consensus;
  float* pose;             // (R, 7)
  int* consensus;          // (R,)
  float* mse;              // (R,)
  float* info;             // (R, 36)
  unsigned char* ok;       // (R,)
  int* best;               // (R,)
  int* counts;             // (R, K)
  int* tri_out;            // (R, K, 3) or nullptr
};

// |pose · s - d|² of one correspondence (s, d: the xyz of a point row)
__device__ __forceinline__ float err2_of(const float pose[7], const float4& s, const float4& d) {
  const float sv[3] = {s.x, s.y, s.z}, dv[3] = {d.x, d.y, d.z};
  float p[3];
  uz::quat_rotate(pose + 3, sv, p);
  float e = 0.f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float r = (p[a] + pose[a]) - dv[a];
    e += r * r;
  }
  return e;
}

// ransac.kabsch_quat on three correspondences, by the 4 lanes of a group
// (lane % 4 = c): every lane forms N and each power step's (N + cI) q and
// norm alike, lane c divides component c by the norm, and the four
// quotients are gathered by shuffles.  The same operations in the same order
// as one thread's fit, so every lane holds the same bits; the step's four
// divisions, which one thread runs one after another, run side by side.
// All 32 lanes of the warp take part.
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
  const int lane = threadIdx.x & 31, c4 = lane & 3, base = lane & ~3;
  float q[4] = {0.5f, 0.5f, 0.5f, 0.5f};
  for (int it = 0; it < kPowerIters; ++it) {
    float qn[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qn[i] = (N[i][0] + (i == 0 ? c : 0.f)) * q[0] + (N[i][1] + (i == 1 ? c : 0.f)) * q[1]
            + (N[i][2] + (i == 2 ? c : 0.f)) * q[2] + (N[i][3] + (i == 3 ? c : 0.f)) * q[3];
    const float nrm = uz::floor_at(
        sqrtf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3]), 1e-12f);
    const float mine = (c4 == 0 ? qn[0] : c4 == 1 ? qn[1] : c4 == 2 ? qn[2] : qn[3]) / nrm;
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = __shfl_sync(0xffffffffu, mine, base + i);
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

// a[i] for a run-time i, by selects (registers, not local memory)
template <int N>
__device__ __forceinline__ double pick(const double (&a)[N], int i) {
  double v = a[0];
#pragma unroll
  for (int k = 1; k < N; ++k) v = i == k ? a[k] : v;
  return v;
}

// Block max / min of a float over the CTA (order-free), every thread gets it.
template <bool kMax>
__device__ float block_extreme(float v, float* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : fminf(v, o);
  }
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  v = s_warp[lane];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = kMax ? fmaxf(v, o) : fminf(v, o);
  }
  __syncthreads();
  return v;
}

// The draw (step 0): s_cum gets the running sums of the weights; the 3K
// triplet entries (uniform i of thread i % kRootThreads in u[i / kRootThreads],
// loaded at the kernel's start) go to s_tri.
__device__ void draw_triplets(const Params& p, const float4* s_pt, const float* q_row,
                              const float (&u)[kUniformsPerThread], float* s_cum, int* s_tri,
                              double* s_scan, float* s_warpf) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m = p.m;
  float qmin = 0.f, span = 1.f;
  if (q_row != nullptr) {
    float hi = __int_as_float(0xff800000), lo = __int_as_float(0x7f800000);   // -inf, +inf
    for (int j = tid; j < m; j += kRootThreads)
      if (s_pt[j].w > 0.f) {
        hi = fmaxf(hi, q_row[j]);
        lo = fminf(lo, q_row[j]);
      }
    hi = block_extreme<true>(hi, s_warpf);
    qmin = block_extreme<false>(lo, s_warpf);
    span = fmaxf(__fsub_rn(hi, qmin), 1e-6f);
  }
  // each thread's run of entries [j0, j1), summed in double
  const int run = (m + kRootThreads - 1) / kRootThreads;
  const int j0 = min(tid * run, m), j1 = min(j0 + run, m);
  double sum = 0.0;
  for (int j = j0; j < j1; ++j) {
    float w = s_pt[j].w;
    if (q_row != nullptr && w > 0.f) {
      const float logit = __fdiv_rn(__fmul_rn(p.beta, __fsub_rn(q_row[j], qmin)), span);
      w = expf(__fsub_rn(logit, p.beta));
    }
    s_cum[j] = w;
    sum += static_cast<double>(w);
  }
  // exclusive scan of the runs: within the warp, then across the warps
  double incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double o = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) s_scan[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    double t = s_scan[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double o = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += o;
    }
    s_scan[lane] = t;   // inclusive over the warps
  }
  __syncthreads();
  const double before = __shfl_up_sync(0xffffffffu, incl, 1);
  double acc = (warp > 0 ? s_scan[warp - 1] : 0.0) + (lane > 0 ? before : 0.0);
  for (int j = j0; j < j1; ++j) {
    acc += static_cast<double>(s_cum[j]);
    s_cum[j] = static_cast<float>(acc);
  }
  __syncthreads();
  const float total = s_cum[m - 1];
  const float top = nextafterf(total, 0.f);
#pragma unroll
  for (int k = 0; k < kUniformsPerThread; ++k) {
    const int i = tid + k * kRootThreads;
    if (i >= 3 * p.k_hyp) break;
    const float target = fminf(__fmul_rn(u[k], total), top);
    int lo = 0, hi = m;   // the first j with s_cum[j] > target (searchsorted, right)
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_cum[mid] > target) hi = mid; else lo = mid + 1;
    }
    const int idx = (lo < m && total > 0.f) ? lo : 0;
    s_tri[i] = idx;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kRootThreads, 1) ransac_draw_fit(const Params p) {
  extern __shared__ float4 smv[];
  const int m = p.m, K = p.k_hyp, Kc = p.k_per_cta;
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int k_begin = rank * Kc, k_count = max(min(K - k_begin, Kc), 0);
  float4* s_pt = smv;                     // m: source xyz, valid as 0/1
  float4* s_dp = s_pt + m;                // m: destination xyz, fit weight (weights * valid)
  float* s_wr = reinterpret_cast<float*>(s_dp + m);   // m: the running sums, then refit terms
  float* s_q = s_wr + m;                  // m: the draw's quality, where given
  float* s_hyp = s_q + m;                 // Kc x 7: this CTA's hypotheses
  int* s_tri = reinterpret_cast<int*>(s_hyp + 7 * Kc);   // K x 3
  int* s_cnt = s_tri + 3 * K;             // Kc
  __shared__ double s_scan[kRootWarps];
  __shared__ float s_warpf[kRootWarps];
  __shared__ unsigned long long s_key[kRootWarps];
  __shared__ unsigned long long s_slot_key[kMaxCluster];   // the first CTA's: each CTA's best
  __shared__ float s_slot_pose[kMaxCluster][7];
  __shared__ float s_fit[7];

  const long long r = blockIdx.x / G;
  // arrive now, wait before the first access to another CTA's shared memory:
  // every CTA of the cluster has started by then
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* g_src = p.src + r * p.src_stride;
  const float* g_dst = p.dst + r * p.dst_stride;
  const unsigned char* g_valid = p.valid + r * m;
  // the draw's uniforms, loaded beside the points
  float u[kUniformsPerThread];
  if (p.uniforms != nullptr) {
#pragma unroll
    for (int k = 0; k < kUniformsPerThread; ++k) {
      const int i = tid + k * kRootThreads;
      u[k] = i < 3 * K ? p.uniforms[r * 3 * K + i] : 0.f;
    }
  }
  for (int j = tid; j < m; j += kRootThreads) {
    const float v = g_valid[j] ? 1.f : 0.f;
    const float fw = p.weights == nullptr ? v : p.weights[r * m + j] * v;
    s_pt[j] = make_float4(g_src[3 * j], g_src[3 * j + 1], g_src[3 * j + 2], v);
    s_dp[j] = make_float4(g_dst[3 * j], g_dst[3 * j + 1], g_dst[3 * j + 2], fw);
    if (p.quality != nullptr) s_q[j] = p.quality[r * m + j];
  }
  if (p.uniforms == nullptr) {
    for (int i = tid; i < 3 * K; i += kRootThreads) s_tri[i] = p.tri_in[r * 3 * K + i];
  }
  __syncthreads();
  if (p.uniforms != nullptr)
    draw_triplets(p, s_pt, p.quality == nullptr ? nullptr : s_q, u, s_wr, s_tri, s_scan,
                  s_warpf);

  // 1: one Horn fit per hypothesis, four lanes each (a warp's 8 fits; a
  // warp with none left skips, whole)
  for (int k0 = 0; k0 < k_count; k0 += kRootThreads / 4) {
    if (k0 + 8 * warp >= k_count) continue;
    const int k = k0 + tid / 4, kk = k_begin + min(k, k_count - 1);
    int idx[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) idx[c] = min(max(s_tri[3 * kk + c], 0), m - 1);
    float s[3][3], d[3][3], fw[3], hp[7];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float4 a = s_pt[idx[c]], b = s_dp[idx[c]];
      s[c][0] = a.x;
      s[c][1] = a.y;
      s[c][2] = a.z;
      d[c][0] = b.x;
      d[c][1] = b.y;
      d[c][2] = b.z;
      fw[c] = b.w;
    }
    horn_fit3(s, d, fw, hp);
    if (k < k_count && (tid & 3) == 0) {
#pragma unroll
      for (int i = 0; i < 7; ++i) s_hyp[k * 7 + i] = hp[i];
    }
  }
  __syncthreads();

  // 2: the consensus, `lanes` lanes a hypothesis
  const int L = p.lanes, g = tid / L, l = tid % L, groups = kRootThreads / L;
  for (int k0 = 0; k0 < k_count; k0 += groups) {
    const int k = k0 + g;   // this CTA's hypothesis k, the root's k_begin + k
    int count = 0;
    if (k < k_count) {
      float hp[7];
#pragma unroll
      for (int i = 0; i < 7; ++i) hp[i] = s_hyp[k * 7 + i];
      for (int j = l; j < m; j += L) {
        const float4 a = s_pt[j];
        if (a.w > 0.f && err2_of(hp, a, s_dp[j]) < p.thresh_sq) ++count;
      }
    }
    for (int off = L >> 1; off > 0; off >>= 1) count += __shfl_xor_sync(0xffffffffu, count, off);
    if (k < k_count && l == 0) {
      int idx[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) idx[c] = min(max(s_tri[3 * (k_begin + k) + c], 0), m - 1);
      const bool distinct = idx[0] != idx[1] && idx[1] != idx[2] && idx[0] != idx[2];
      const bool sample_valid = s_pt[idx[0]].w > 0.f && s_pt[idx[1]].w > 0.f
                                && s_pt[idx[2]].w > 0.f && distinct;
      s_cnt[k] = sample_valid ? count : -1;
    }
  }
  __syncthreads();

  // 3: the first argmax: the CTA's, then the cluster's through distributed
  // shared memory; then every CTA but the first leaves
  unsigned long long key =
      tid < k_count
          ? (static_cast<unsigned long long>(static_cast<unsigned>(s_cnt[tid] + 1)) << 32)
                | static_cast<unsigned>(0x7fffffff - (k_begin + tid))
          : 0ull;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
    key = o > key ? o : key;
  }
  if (lane == 0) s_key[warp] = key;
  __syncthreads();
  key = s_key[lane];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
    key = o > key ? o : key;
  }
  // each CTA puts its best key and that hypothesis's pose in the first
  // CTA's slots, counts itself in (release) and writes its counts; the first
  // waits (acquire) and takes the best slot
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < 7) {
    const int mine = 0x7fffffff - static_cast<int>(key & 0xffffffffu);
    *cluster.map_shared_rank(&s_slot_pose[rank][tid], 0) =
        k_count > 0 ? s_hyp[(mine - k_begin) * 7 + tid] : 0.f;
  }
  if (tid == 7) *cluster.map_shared_rank(&s_slot_key[rank], 0) = key;
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  for (int k = tid; k < k_count; k += kRootThreads) p.counts[r * K + k_begin + k] = s_cnt[k];
  if (rank != 0) return;
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  int owner = 0;
  for (int q = 1; q < G; ++q)
    if (s_slot_key[q] > s_slot_key[owner]) owner = q;
  key = s_slot_key[owner];
  const int best = 0x7fffffff - static_cast<int>(key & 0xffffffffu);
  const int best_count = static_cast<int>(key >> 32) - 1;
  float bp[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) bp[i] = s_slot_pose[owner][i];
  if (tid == 0) p.best[r] = best;
  if (p.tri_out != nullptr)
    for (int i = tid; i < 3 * K; i += kRootThreads) p.tri_out[r * 3 * K + i] = s_tri[i];

  // 4: the refit.  Every thread tests its points under the best hypothesis
  // (the inliers' fit weights to s_wr); warp 0 sums the weighted means and
  // the covariance in double, each lane over the points j = lane, lane + 32,
  // ... in order, then a butterfly (uz::warp_tree_sum); lane 0 takes the SVD.
  for (int j = tid; j < m; j += kRootThreads) {
    const float4 a = s_pt[j], b = s_dp[j];
    s_wr[j] = (a.w > 0.f && err2_of(bp, a, b) < p.thresh_sq) ? b.w : 0.f;
  }
  __syncthreads();
  if (warp == 0) {
    double mean7[7];
#pragma unroll
    for (int q = 0; q < 7; ++q) mean7[q] = 0.0;
    for (int j = lane; j < m; j += 32) {
      const float wj = s_wr[j];
      const float4 a = s_pt[j], b = s_dp[j];
      mean7[0] += wj;
      mean7[1] += static_cast<double>(a.x * wj);
      mean7[2] += static_cast<double>(a.y * wj);
      mean7[3] += static_cast<double>(a.z * wj);
      mean7[4] += static_cast<double>(b.x * wj);
      mean7[5] += static_cast<double>(b.y * wj);
      mean7[6] += static_cast<double>(b.z * wj);
    }
    uz::warp_tree_sum(mean7);
    const double wsum = mean7[0] < 1e-9 ? 1e-9 : mean7[0];
    // the six means' divisions on lanes 0-5 side by side, then gathered
    const float mean = static_cast<float>(pick(mean7, 1 + min(lane, 5)) / wsum);
    float mu_s[3], mu_d[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      mu_s[a] = __shfl_sync(0xffffffffu, mean, a);
      mu_d[a] = __shfl_sync(0xffffffffu, mean, 3 + a);
    }
    // cov_ab = sum_j (cd_ja w_j) cs_jb / wsum
    double cov[kSums];
#pragma unroll
    for (int q = 0; q < kSums; ++q) cov[q] = 0.0;
    for (int j = lane; j < m; j += 32) {
      const float wj = s_wr[j];
      const float4 a = s_pt[j], b = s_dp[j];
      const float sv[3] = {a.x, a.y, a.z}, dv[3] = {b.x, b.y, b.z};
#pragma unroll
      for (int x = 0; x < 3; ++x) {
        const float cdw = (dv[x] - mu_d[x]) * wj;
#pragma unroll
        for (int y = 0; y < 3; ++y)
          cov[3 * x + y] += static_cast<double>(cdw) * static_cast<double>(sv[y] - mu_s[y]);
      }
    }
    uz::warp_tree_sum(cov);
    const float entry = static_cast<float>(pick(cov, min(lane, kSums - 1)) / wsum);
    float C[3][3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) C[a][b] = __shfl_sync(0xffffffffu, entry, 3 * a + b);
    if (lane == 0) {
      float R[3][3], Rm[3], q[4];
      uz::proper_rotation(C, R);
      uz::mv3(R, mu_s, Rm);
      uz::matrix_to_quat(R, q);
#pragma unroll
      for (int a = 0; a < 3; ++a) s_fit[a] = mu_d[a] - Rm[a];
#pragma unroll
      for (int i = 0; i < 4; ++i) s_fit[3 + i] = q[i];
      uz::quat_normalize(s_fit + 3);   // lie.make_pose
#pragma unroll
      for (int i = 0; i < 7; ++i) p.pose[r * 7 + i] = s_fit[i];
    }
  }
  __syncthreads();

  // 5: consensus and mse under the refit: every thread tests its points
  // (an inlier's squared error to s_wr, -1 elsewhere), warp 0 sums
  {
    float fit[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) fit[i] = s_fit[i];
    for (int j = tid; j < m; j += kRootThreads) {
      const float4 a = s_pt[j];
      const float e = err2_of(fit, a, s_dp[j]);
      s_wr[j] = (a.w > 0.f && e < p.thresh_sq) ? e : -1.f;
    }
  }
  __syncthreads();
  if (warp == 0) {
    double ce[2] = {0.0, 0.0};
    for (int j = lane; j < m; j += 32) {
      const float e = s_wr[j];
      if (e >= 0.f) {
        ce[0] += 1.0;
        ce[1] += e;
      }
    }
    uz::warp_tree_sum(ce);
    if (lane == 0) {
      const int consensus = static_cast<int>(ce[0]);
      const float mse = static_cast<float>(ce[1] / (consensus > 1 ? consensus : 1));
      const float base = 0.1f * static_cast<float>(consensus) / uz::floor_at(mse, p.min_sigma_sq);
      float* info = p.info + r * 36;
      for (int i = 0; i < 36; ++i) info[i] = 0.f;
      for (int i = 0; i < 6; ++i) info[i * 7] = i < 3 ? base : base * 100.f;
      p.consensus[r] = consensus;
      p.mse[r] = mse;
      p.ok[r] = consensus >= p.min_consensus && best_count > 0;
    }
  }
}

}  // namespace

// src, dst: root r's (m, 3) points at src + r*src_stride (stride 0: shared by
// every root); valid: (n_roots, m) bool; weights: (n_roots, m) float32 or
// nullptr.  The triplets: with uniforms (n_roots, 3 k_hyp) float32 in [0, 1)
// the kernel draws them (soft PROSAC on quality (n_roots, m) float32 where
// given, else uniform over the valid entries) and writes them to tri_out
// (n_roots, k_hyp, 3) int32; with uniforms nullptr it reads tri_in.
// Outputs per root: pose (7), consensus, mse, information (6x6), ok, the best
// hypothesis, and the k_hyp counts.  1 <= k_hyp <= 1024.
extern "C" int uz_ransac_rigid(const float* src, long long src_stride, const float* dst,
                               long long dst_stride, const unsigned char* valid,
                               const float* weights, const float* quality, const float* uniforms,
                               const int* tri_in, int n_roots, int m, int k_hyp, float thresh_sq,
                               int min_consensus, float min_sigma_sq, float beta, float* pose,
                               int* consensus, float* mse, float* information, unsigned char* ok,
                               int* best, int* counts, int* tri_out, void* stream) {
  if (n_roots <= 0) return 0;
  if (m <= 0 || k_hyp <= 0 || k_hyp > kRootThreads) return static_cast<int>(cudaErrorInvalidValue);
  if ((uniforms == nullptr) == (tri_in == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  // a cluster of G CTAs a root while the grid fits the card's 132 SMs, the
  // hypotheses split among them
  int G = kMaxCluster;
  while (G > 1 && n_roots * G > 132) G /= 2;
  const int k_per_cta = (k_hyp + G - 1) / G;
  int lanes = kLanes > 0 ? kLanes : 1;
  while (kLanes == 0 && lanes < 32 && 2 * lanes * k_per_cta <= kRootThreads) lanes *= 2;
  // two float4 rows and two floats a point; 7 floats and an int a hypothesis
  // of the CTA, 3 ints a hypothesis of the root
  const size_t smem = (10ull * m + 7ull * k_per_cta) * sizeof(float)
                    + (3ull * k_hyp + k_per_cta) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ransac_draw_fit, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Params p{src, src_stride, dst, dst_stride, valid, weights, quality, uniforms, tri_in,
                 m, k_hyp, lanes, k_per_cta, thresh_sq, min_sigma_sq, beta, min_consensus,
                 pose, consensus, mse, information, ok, best, counts, tri_out};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_roots * G, 1, 1);
  cfg.blockDim = dim3(kRootThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = G;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, ransac_draw_fit, p));
}
