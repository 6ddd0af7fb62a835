// K36 lm_step: the tail of one LM iteration in two launches.
//
// Replaces, on the LM loop's path, what follows the PCG solve in
// uzliti_slam_tpu/graph/solver.py: the masked step's retraction and the
// candidate's residuals and robust χ² (lie.pose_retract,
// factors.batched_residuals, _robust_chi2_from_r: :918-924 in the early-exit
// loop, :981-987 in the fixed one, :1163-1169 in the generic one; before
// this kernel, a retraction in eager PyTorch and K4), and the accept rule
// with the λ schedule (:925-946, :988-997, :1170-1181).
//
// uz_lm_candidate, one launch: per instance b of a flattened fleet (a single
// solve is the batch of one) on a (blocks, B) grid, thread i
//   - writes cand[i] = pose[i] ∘ exp(dx[i]·free[i]) if i is a node slot,
//   - and if i is an edge slot computes its two endpoints' candidates
//     itself, then r_cand = log(meas⁻¹·candᵢ⁻¹·candⱼ) and the Huber cost
//     ρ(rᵀΛr)·valid, as K4 does (residual_chi2.cu).
// The endpoint's candidate is the same function of the same inputs as the
// node owner's, and `retract` is one __noinline__ function, so the compiler
// cannot contract its multiply-adds differently at the two call sites: the
// edge sees exactly the bits written to cand.  The alternative, a
// cooperative launch with one grid.sync() between the node and the edge
// pass, would cap the grid at the resident CTAs (the 4096-instance fleet
// has 4096) and buys back only ~2.2 retractions an edge, a few hundred
// flops against a launch.  χ²_new[b] is summed in K4's fixed order: each
// block's tree sum over its 256 edges, then, in the last block of the
// instance to finish (an integer ticket after __threadfence), the strided
// sum over the block partials and a tree: no float atomics, no second
// launch, the same bits as K4 on the same candidate.
//
// uz_lm_accept, one launch on the same grid: every thread computes
// accept[b] = χ²_new < χ²_cur (and still active, in the early exit) from
// values no block of this launch writes — χ²_cur, λ, done, stale and need
// are read from column `it` of per-iteration tensors and written to column
// `it + 1` — selects its rows of poses and r in place, and thread 0 of the
// instance's first block writes χ²_cur, λ (clamped), the history and accept
// flags and, for the early exit, the gain, done, stale and the next
// iteration's refresh flag `need` for K9.  λ / factor is λ·fl(1/factor), as
// PyTorch divides a CUDA tensor by a Python float (the eager loop this
// replaces) and XLA the reference's λ by its constant; the gates are the
// configuration's floats rounded to float32.  At it = 0 the done, stale and
// need columns are not read (nothing is done, stale is 0).
//
// What bounds them: launch latency up to ~1e5 edges; above, the ~300
// bytes an edge reads and writes and the few hundred flops of pose algebra
// of three retractions and a residual.
#include <cuda_runtime.h>

#include "lie.cuh"

namespace {

// pose ∘ exp(dx·fr): the retraction of solver.py:925 with the free mask of
// :924.  __noinline__: every caller gets the bits of one compiled body.
__device__ __noinline__ void retract(const float* __restrict__ pose,
                                     const float* __restrict__ dx, float fr,
                                     float* __restrict__ out) {
  float xi[6], e[7], p[7];
#pragma unroll
  for (int k = 0; k < 6; ++k) xi[k] = dx[k] * fr;
#pragma unroll
  for (int k = 0; k < 7; ++k) p[k] = pose[k];
  uz::se3_exp(xi, e);
  uz::pose_compose(p, e, out);
}

__device__ __forceinline__ float block_sum(float v) {
  __shared__ float buf[kThreads];
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  const float out = buf[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads)
candidate_kernel(const float* __restrict__ poses, const float* __restrict__ dx,
                 const float* __restrict__ free, const int* __restrict__ e_from,
                 const int* __restrict__ e_to, const float* __restrict__ meas,
                 const float* __restrict__ info, const float* __restrict__ valid,
                 float huber_delta, int n_nodes, int n_edges, int edge_blocks,
                 float* __restrict__ cand, float* __restrict__ r_out,
                 float* __restrict__ partials, unsigned int* __restrict__ tickets,
                 float* __restrict__ chi2) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const long long b = blockIdx.y;
  if (i < n_nodes) {
    const long long v = b * n_nodes + i;
    retract(poses + v * 7, dx + v * 6, free[v], cand + v * 7);
  }
  if (static_cast<int>(blockIdx.x) >= edge_blocks) return;   // no edge, no partial
  float rho = 0.f;
  if (i < n_edges) {
    const long long e = b * n_edges + i;
    const int f = e_from[e], t = e_to[e];
    float ci[7], cj[7], m[7], r[6];
    retract(poses + 7LL * f, dx + 6LL * f, free[f], ci);
    retract(poses + 7LL * t, dx + 6LL * t, free[t], cj);
#pragma unroll
    for (int k = 0; k < 7; ++k) m[k] = meas[e * 7 + k];
    uz::edge_residual(ci, cj, m, r);
#pragma unroll
    for (int k = 0; k < 6; ++k) r_out[e * 6 + k] = r[k];
    const float q = uz::quad6(r, info + e * 36);
    const float en = sqrtf(uz::floor_at(q, 1e-12f));
    rho = (en <= huber_delta ? q : 2.f * huber_delta * en - huber_delta * huber_delta) * valid[e];
  }
  const float part = block_sum(rho);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[b * edge_blocks + blockIdx.x] = part;
    __threadfence();
    last = atomicAdd(tickets + b, 1u) == static_cast<unsigned int>(edge_blocks - 1);
  }
  __syncthreads();
  if (!last) return;
  // the instance's last block: K4's second pass over the partials
  __threadfence();
  const volatile float* row = partials + b * edge_blocks;
  float s = 0.f;
  for (int k = threadIdx.x; k < edge_blocks; k += kThreads) s += row[k];
  const float total = block_sum(s);
  if (threadIdx.x == 0) {
    chi2[b] = total;
    tickets[b] = 0u;   // ready for the next launch
  }
}

struct Rules {
  float inv_factor, factor, lam_min, lam_max, lam_init, tol;
  int refresh, early_exit;
};

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);   // NaN passes, as torch.clamp
}

__global__ void __launch_bounds__(kThreads)
accept_kernel(const float* __restrict__ cand, const float* __restrict__ r_cand,
              const float* __restrict__ chi2_new, int n_nodes, int n_edges, int n_batch, int it,
              int iterations, Rules R, float* __restrict__ poses, float* __restrict__ r,
              float* __restrict__ hist, float* __restrict__ lam, unsigned char* __restrict__ acc,
              float* __restrict__ gain, unsigned char* __restrict__ done,
              int* __restrict__ stale, unsigned char* __restrict__ need) {
  const long long b = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const long long h = b * (iterations + 1) + it;      // column it of (B, iterations + 1)
  const long long f = static_cast<long long>(it) * n_batch + b;   // row it of (iterations + 1, B)
  const float cur = hist[h], cn = chi2_new[b];
  const bool active = !(R.early_exit && it > 0 && done[f]);
  const bool accept = (cn < cur) && active;
  if (accept) {
    if (i < n_nodes) {
#pragma unroll
      for (int k = 0; k < 7; ++k) poses[(b * n_nodes + i) * 7 + k] =
            cand[(b * n_nodes + i) * 7 + k];
    }
    if (i < n_edges) {
#pragma unroll
      for (int k = 0; k < 6; ++k)
        r[(b * n_edges + i) * 6 + k] = r_cand[(b * n_edges + i) * 6 + k];
    }
  }
  if (blockIdx.x != 0 || threadIdx.x != 0) return;
  const float l = lam[h];
  const float l_next = clamp_nan(accept ? l * R.inv_factor : l * R.factor, R.lam_min, R.lam_max);
  hist[h + 1] = accept ? cn : cur;
  acc[b * iterations + it] = accept;
  if (!R.early_exit) {
    lam[h + 1] = l_next;
    return;
  }
  const float g = (cur - cn) / (cur < 1e-12f ? 1e-12f : cur);
  const bool finished = (accept && g < R.tol && l <= R.lam_init) || (!accept && l >= R.lam_max);
  const bool was_done = it > 0 && done[f];
  const int st = it > 0 && !need[f] ? stale[f] : 0;   // K9 rebuilt at `it`: stale reset
  const int st_next = accept ? st + 1 : R.refresh;
  const bool done_next = was_done || (active && finished);
  const long long f1 = f + n_batch;
  gain[b * iterations + it] = g;
  lam[h + 1] = active ? l_next : l;
  stale[f1] = st_next;
  done[f1] = done_next;
  need[f1] = st_next >= R.refresh && !done_next;
}

int grid_x(int n_nodes, int n_edges) {
  return blocks_for(n_nodes > n_edges ? n_nodes : n_edges);
}

}  // namespace

// The candidate of n_batch instances of n_nodes nodes and n_edges edges,
// flattened (instance b's edges at b·n_edges, their endpoints into the
// flattened poses): cand (B·N, 7), r (B·E, 6), chi2 (B,).  partials:
// B·blocks_for(n_edges) floats; tickets: B zeroed counters, left zeroed.
extern "C" int uz_lm_candidate(const float* poses, const float* dx, const float* free,
                               const int* e_from, const int* e_to, const float* meas,
                               const float* info, const float* valid, float huber_delta,
                               int n_nodes, int n_edges, int n_batch, float* cand, float* r,
                               float* partials, unsigned int* tickets, float* chi2,
                               void* stream) {
  if (n_batch < 1 || n_batch > 65535 || n_edges < 1 || n_nodes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(grid_x(n_nodes, n_edges), n_batch);
  candidate_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      poses, dx, free, e_from, e_to, meas, info, valid, huber_delta, n_nodes, n_edges,
      blocks_for(n_edges), cand, r, partials, tickets, chi2);
  return static_cast<int>(cudaGetLastError());
}

// The accept rule of LM iteration `it` of `iterations`: poses (B·N, 7) and
// r (B·E, 6) updated in place; hist and lam (B, iterations + 1) read at
// column it, written at it + 1; acc and gain (B, iterations) at it; done,
// stale and need (iterations + 1, B) read at row it (it > 0), written at
// it + 1 (early_exit only).
extern "C" int uz_lm_accept(const float* cand, const float* r_cand, const float* chi2_new,
                            int n_nodes, int n_edges, int n_batch, int it, int iterations,
                            int early_exit, float inv_factor, float factor, float lam_min,
                            float lam_max, float lam_init, float tol, int refresh, float* poses,
                            float* r, float* hist, float* lam, unsigned char* acc, float* gain,
                            unsigned char* done, int* stale, unsigned char* need, void* stream) {
  if (n_batch < 1 || n_batch > 65535 || it < 0 || it >= iterations)
    return static_cast<int>(cudaErrorInvalidValue);
  const Rules R{inv_factor, factor, lam_min, lam_max, lam_init, tol, refresh, early_exit};
  const dim3 grid(grid_x(n_nodes, n_edges), n_batch);
  accept_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      cand, r_cand, chi2_new, n_nodes, n_edges, n_batch, it, iterations, R, poses, r, hist, lam,
      acc, gain, done, stale, need);
  return static_cast<int>(cudaGetLastError());
}
