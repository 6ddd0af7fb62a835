// K19 merge_pairs: the node-merge pair search.
//
// Replaces uzliti_slam_tpu/graph/lifecycle.py:find_merge_pairs (:77-133).
// The reference builds the full N x N score (dt where the pair is close,
// +inf elsewhere: dt = |t_i - t_j|, dr = degrees(rotation_angle(conj(q_i) ·
// q_j)), both nodes eligible, stamp_i < stamp_j), then takes max_pairs
// rounds of an argmin over all N² entries, masking both chosen nodes' rows
// and columns: max_pairs passes over N² floats, a 400 MB temporary each at
// 10k nodes.  Here:
//   - row_keys: a warp per row i scans the row once.  A close pair (i, j)
//     becomes the 64-bit key (float_bits(dt) << 32) | (i·N + j); for dt >= 0
//     the float bits order like the floats, so the smallest key is argmin's
//     answer with ties to the lower flat index (N <= 65535 keeps i·N + j in
//     32 bits).  The row keeps only its K = 2·max_pairs - 1 smallest keys:
//     when round r picks (i*, j*), every smaller key of row i* has a column
//     among the <= 2r <= K - 1 nodes already used, else it would have won,
//     so the winner is always among its row's K smallest and no pair is
//     lost, whatever the density.  Each lane keeps its own sorted list of K;
//     K rounds of a warp minimum merge the 32 lists into the row's.
//   - greedy_rounds: one CTA runs the max_pairs rounds over the N·K list: a
//     block minimum over the keys whose nodes are both unused (a bitmap in
//     shared memory), then the winner's nodes are marked used.  A round
//     with no key left writes (0, 0, false), as argmin over an all-inf
//     score does.
// No atomics decide anything: the answer does not depend on thread order.
// The gates repeat merge_pair_gates_plain (kernels/ops.py) operation for
// operation, the reference's compiled form on the CPU: the quaternion
// product and the sums of squares as chains of fused multiply-adds,
// evaluated in float64 and rounded once to float32 as the plain version
// does (the products of two floats are exact there), square roots
// correctly rounded, degrees as a multiply by fl(180/pi).
//
// What bounds it on the card: the operations, ~150 per pair (the gates'
// sums, three roots, a division, atan2) over N² pairs of eligible rows:
// 1.5e10 at 10k nodes, 0.22 ms at 67 TFLOP/s; the bytes are the N poses,
// stamps and flags.
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kWarpsPerCta = 8;
constexpr int kMaxK = 63;            // 2·32 - 1: max_pairs <= 32
constexpr int kRoundThreads = 1024;
constexpr unsigned long long kNone = ~0ull;

__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

__device__ __forceinline__ float sqrt64(float x) {
  return __double2float_rn(__dsqrt_rn(static_cast<double>(x)));
}

__device__ __forceinline__ float floor_at(float x, float lo) { return x < lo ? lo : x; }

// dt and dr (degrees) of a pose pair, as merge_pair_gates_plain.
__device__ __forceinline__ void gates(const float* pi, const float* pj, float& dt, float& dr) {
  const float d0 = __fsub_rn(pi[0], pj[0]), d1 = __fsub_rn(pi[1], pj[1]),
              d2 = __fsub_rn(pi[2], pj[2]);
  dt = sqrt64(fma64(d2, d2, fma64(d1, d1, __fmul_rn(d0, d0))));
  const float aw = pi[3], ax = -pi[4], ay = -pi[5], az = -pi[6];
  const float bw = pj[3], bx = pj[4], by = pj[5], bz = pj[6];
  float w = fma64(-az, bz, fma64(-ay, by, fma64(aw, bw, -__fmul_rn(ax, bx))));
  float x = fma64(-az, by, fma64(ay, bz, fma64(aw, bx, __fmul_rn(ax, bw))));
  float y = fma64(az, bx, fma64(ay, bw, fma64(aw, by, -__fmul_rn(ax, bz))));
  float z = fma64(az, bw, fma64(-ay, bx, fma64(aw, bz, __fmul_rn(ax, by))));
  const float n = sqrt64(floor_at(fma64(z, z, fma64(y, y, fma64(x, x, __fmul_rn(w, w)))), 1e-30f));
  w = __fdiv_rn(w, n); x = __fdiv_rn(x, n); y = __fdiv_rn(y, n); z = __fdiv_rn(z, n);
  if (w < 0.f) { w = -w; x = -x; y = -y; z = -z; }
  w = fminf(fmaxf(w, -1.f), 1.f);
  const float vn = sqrt64(floor_at(fma64(z, z, fma64(y, y, __fmul_rn(x, x))), 1e-30f));
  const bool small = vn < 1e-6f;
  const float scale = small ? __fdiv_rn(2.f, fabsf(w) < 1e-12f ? 1.f : w)
                            : __fdiv_rn(__fmul_rn(2.f, atan2f(vn, w)), vn);
  const float px = __fmul_rn(scale, x), py = __fmul_rn(scale, y), pz = __fmul_rn(scale, z);
  const float ang = sqrt64(floor_at(fma64(pz, pz, fma64(py, py, __fmul_rn(px, px))), 1e-30f));
  dr = __fmul_rn(ang, 57.2957802f);   // fl(180/pi)
}

__device__ __forceinline__ unsigned long long warp_min(unsigned long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long u = __shfl_xor_sync(0xffffffffu, v, o);
    v = u < v ? u : v;
  }
  return v;
}

__global__ void __launch_bounds__(32 * kWarpsPerCta)
row_keys(const float* __restrict__ pose, const float* __restrict__ stamp,
         const bool* __restrict__ eligible, int n, float dist_thresh, float angle_thresh,
         int K, unsigned long long* __restrict__ cand) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (i >= n) return;
  unsigned long long* out = cand + static_cast<long long>(i) * K;
  if (!eligible[i]) {
    for (int r = lane; r < K; r += 32) out[r] = kNone;
    return;
  }
  float pi[7];
#pragma unroll
  for (int c = 0; c < 7; ++c) pi[c] = pose[7 * i + c];
  const float si = stamp[i];
  unsigned long long list[kMaxK];   // this lane's K smallest keys, ascending
  int count = 0;
  for (int j = lane; j < n; j += 32) {
    if (!eligible[j] || !(si < stamp[j])) continue;
    float dt, dr;
    gates(pi, pose + 7 * j, dt, dr);
    if (!(dt < dist_thresh) || !(dr < angle_thresh)) continue;
    const unsigned long long key =
        (static_cast<unsigned long long>(__float_as_uint(dt)) << 32) |
        (static_cast<unsigned int>(i) * static_cast<unsigned int>(n) + static_cast<unsigned int>(j));
    if (count == K && key >= list[K - 1]) continue;
    int p = count < K ? count++ : K - 1;   // insertion: drop the largest when full
    while (p > 0 && list[p - 1] > key) {
      list[p] = list[p - 1];
      --p;
    }
    list[p] = key;
  }
  int head = 0;
  for (int r = 0; r < K; ++r) {   // K rounds of a warp minimum merge the lanes' lists
    const unsigned long long mine = head < count ? list[head] : kNone;
    const unsigned long long best = warp_min(mine);
    if (best != kNone && mine == best) ++head;   // keys are unique: one lane advances
    if (lane == 0) out[r] = best;
  }
}

__global__ void __launch_bounds__(kRoundThreads)
greedy_rounds(const unsigned long long* __restrict__ cand, int n, int K, int max_pairs,
              int* __restrict__ keep, int* __restrict__ absorb, bool* __restrict__ ok) {
  extern __shared__ unsigned int used[];   // one bit per node
  __shared__ unsigned long long warp_best[kRoundThreads / 32];
  const int words = (n + 31) / 32;
  for (int w = threadIdx.x; w < words; w += kRoundThreads) used[w] = 0u;
  __syncthreads();
  const long long total = static_cast<long long>(n) * K;
  for (int r = 0; r < max_pairs; ++r) {
    unsigned long long best = kNone;
    for (long long e = threadIdx.x; e < total; e += kRoundThreads) {
      const unsigned long long key = cand[e];
      if (key >= best) continue;   // also skips the empty kNone entries
      const unsigned int flat = static_cast<unsigned int>(key);
      const unsigned int i = flat / static_cast<unsigned int>(n);
      const unsigned int j = flat % static_cast<unsigned int>(n);
      if ((used[i >> 5] >> (i & 31)) & 1u) continue;
      if ((used[j >> 5] >> (j & 31)) & 1u) continue;
      best = key;
    }
    best = warp_min(best);
    if ((threadIdx.x & 31) == 0) warp_best[threadIdx.x >> 5] = best;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long b = kNone;
      for (int w = 0; w < kRoundThreads / 32; ++w) b = warp_best[w] < b ? warp_best[w] : b;
      if (b == kNone) {
        keep[r] = 0;
        absorb[r] = 0;
        ok[r] = false;
      } else {
        const unsigned int flat = static_cast<unsigned int>(b);
        const unsigned int i = flat / static_cast<unsigned int>(n);
        const unsigned int j = flat % static_cast<unsigned int>(n);
        keep[r] = static_cast<int>(i);
        absorb[r] = static_cast<int>(j);
        ok[r] = true;
        used[i >> 5] |= 1u << (i & 31);
        used[j >> 5] |= 1u << (j & 31);
      }
    }
    __syncthreads();
  }
}

}  // namespace

// keep, absorb (max_pairs,) int32 and ok (max_pairs,) bool of the greedy
// merge pairs of n poses (n, 7) with stamps (n,) and eligibility (n,);
// cand (n, 2·max_pairs - 1) uint64 scratch.
extern "C" int uz_merge_pairs(const float* pose, const float* stamp, const bool* eligible, int n,
                              float dist_thresh, float angle_thresh, int max_pairs,
                              unsigned long long* cand, int* keep, int* absorb, bool* ok,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n > 65535 || max_pairs <= 0 || 2 * max_pairs - 1 > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  const int K = 2 * max_pairs - 1;
  row_keys<<<(n + kWarpsPerCta - 1) / kWarpsPerCta, 32 * kWarpsPerCta, 0, s>>>(
      pose, stamp, eligible, n, dist_thresh, angle_thresh, K, cand);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  greedy_rounds<<<1, kRoundThreads, ((n + 31) / 32) * sizeof(unsigned int), s>>>(
      cand, n, K, max_pairs, keep, absorb, ok);
  return static_cast<int>(cudaGetLastError());
}
