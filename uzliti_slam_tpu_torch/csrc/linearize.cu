// K1 linearize: the fused per-edge linearization of the LM step.
//
// Replaces uzliti_slam_tpu/graph/solver.py:_make_fused_linearize (with
// factors.jacobians_from_residual and solver._weighted_info).  Per edge, from
// the carried residual twist r:
//   W  = huber(rᵀΛr)·valid·Λ
//   Jⱼ = Jr⁻¹(r),  Jᵢ = -Jⱼ·(Ad(exp(-r))·Ad(meas⁻¹))
// and per node the row [g | Hii + Hjj | Uc]: JᵀWr, JᵢᵀWJᵢ and the spine
// coupling JᵢᵀWJⱼ (edges e_to == e_from + 1 only) of the edges it leaves,
// JⱼᵀWr and JⱼᵀWJⱼ of the edges it enters; the gradient masked to free
// nodes and the spine blocks to consecutive free pairs.
//
// Design: no float atomics, one launch.  The node rows are summed over the
// solve's incidence table (row_ptr, entries: each node's (edge, side) pairs
// of its valid edges, entry 2e + side, in a fixed order), so every run
// gives the same bits.  A block owns kLinNodes consecutive node rows, whose
// table entries are contiguous; it walks them in chunks of kLinThreads, one
// thread per (node, incidence): the thread computes its edge's blocks (each
// edge is computed at both of its endpoints, twice the arithmetic of an edge
// pass) and its 78-float term into shared memory, then the block sums each
// row's terms in table order, adds a row that straddles chunks to its
// partial in device memory (the same thread owns that float in every chunk)
// and writes the row masked once its last term is in.  The thread of an
// edge's 'from' entry writes the edge's Jᵢ, Jⱼ and W, and a tail of the
// grid writes those of the slots the table leaves out (invalid edges, W =
// 0), so every slot is written, as K2's atomic route and the fleet read
// them.
//
// What bounds it on the card: at E ~ 1e3 (the 1k headline) the launch and
// one edge's latency; at E ~ 1e5 the few thousand flops of 6x6 algebra per
// (edge, endpoint) pair.
#include <cuda_runtime.h>

#include "lie.cuh"

namespace {

constexpr int kLinThreads = 128;   // table entries a chunk (threads a block)
constexpr int kLinNodes = 32;      // node rows a block owns
constexpr int kRow = 78;           // a node row: g (6) | H (36) | U (36)
constexpr int kSlot = kRow + 1;    // a term's stride in shared memory (odd: no bank conflicts)

__device__ __forceinline__ void mm6(const float A[6][6], const float B[6][6], float C[6][6]) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < 6; ++j) s += A[i][j] * B[j][k];
      C[i][k] = s;
    }
}

// Edge e's residual, robust information and Jacobians (columns kept by
// col_keep), in the arithmetic of the atomic edge pass it replaces.
__device__ __forceinline__ void edge_blocks(const float* __restrict__ r,
                                            const float* __restrict__ adj_meas_inv,
                                            const float* __restrict__ info,
                                            const float* __restrict__ valid, float huber_delta,
                                            int col_keep, int e, float re[6], float W[6][6],
                                            float Ji[6][6], float Jj[6][6]) {
  float nr[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    re[i] = r[e * 6 + i];
    nr[i] = -re[i];
  }
  const float* L = info + e * 36;
  const float w = uz::huber_weight(uz::quad6(re, L), huber_delta) * valid[e];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) W[i][j] = L[i * 6 + j] * w;

  // Jⱼ = Jr⁻¹(r) = Jl⁻¹(-r);  Jᵢ = -(Jⱼ · (Ad(exp(-r)) · Ad(meas⁻¹)))
  float T[6][6];
  uz::se3_left_jacobian_inv(nr, Jj);
  {
    float p[7], A[6][6], M[6][6];
    uz::se3_exp(nr, p);
    uz::se3_adjoint(p, A);
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = 0; j < 6; ++j) M[i][j] = adj_meas_inv[e * 36 + i * 6 + j];
    mm6(A, M, T);
  }
  mm6(Jj, T, Ji);
  float keep[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) keep[j] = (col_keep >> j) & 1 ? 1.f : 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      Ji[i][j] = -Ji[i][j] * keep[j];
      Jj[i][j] *= keep[j];
    }
}

__device__ __forceinline__ void write_edge(int e, const float Ji[6][6], const float Jj[6][6],
                                           const float W[6][6], float* __restrict__ Ji_out,
                                           float* __restrict__ Jj_out, float* __restrict__ W_out) {
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      Ji_out[e * 36 + i * 6 + j] = Ji[i][j];
      Jj_out[e * 36 + i * 6 + j] = Jj[i][j];
      W_out[e * 36 + i * 6 + j] = W[i][j];
    }
}

// Float k of node n's row: grad (n, 6), Hb (n, 36), U (n, 36).
__device__ __forceinline__ float* row_at(float* grad, float* Hb, float* U, int n, int k) {
  return k < 6 ? grad + n * 6 + k : (k < 42 ? Hb + n * 36 + (k - 6) : U + n * 36 + (k - 42));
}

__global__ void __launch_bounds__(kLinThreads)
linearize_rows(const float* __restrict__ r, const float* __restrict__ adj_meas_inv,
               const float* __restrict__ info, const float* __restrict__ valid,
               const float* __restrict__ free, const float* __restrict__ both_free,
               const float* __restrict__ is_chain, const int* __restrict__ row_ptr,
               const int* __restrict__ entries, float huber_delta, int n_edges, int n_nodes,
               int col_keep, int node_blocks, float* __restrict__ Ji_out,
               float* __restrict__ Jj_out, float* __restrict__ W_out, float* grad, float* Hb,
               float* U) {
  __shared__ float slot[kLinThreads * kSlot];
  const int tid = threadIdx.x;
  float re[6], W[6][6], Ji[6][6], Jj[6][6];
  if (static_cast<int>(blockIdx.x) >= node_blocks) {
    // the tail: the slots of invalid edges, which no table entry reaches
    const int e = (static_cast<int>(blockIdx.x) - node_blocks) * kLinThreads + tid;
    if (e < n_edges && valid[e] == 0.f) {
      edge_blocks(r, adj_meas_inv, info, valid, huber_delta, col_keep, e, re, W, Ji, Jj);
      write_edge(e, Ji, Jj, W, Ji_out, Jj_out, W_out);
    }
    return;
  }
  const int n0 = blockIdx.x * kLinNodes;
  const int n1 = min(n0 + kLinNodes, n_nodes);
  const int items = (n1 - n0) * kRow;       // (row, float) pairs of the block
  const int a = row_ptr[n0], b = row_ptr[n1];
  // a row with no incident valid edge is zero
  for (int q = tid; q < items; q += kLinThreads) {
    const int n = n0 + q / kRow;
    if (row_ptr[n] == row_ptr[n + 1]) *row_at(grad, Hb, U, n, q % kRow) = 0.f;
  }
  for (int c0 = a; c0 < b; c0 += kLinThreads) {
    const int i = c0 + tid;
    if (i < b) {
      const int entry = entries[i];
      const int e = entry >> 1;
      const bool to_side = entry & 1;
      edge_blocks(r, adj_meas_inv, info, valid, huber_delta, col_keep, e, re, W, Ji, Jj);
      if (!to_side) write_edge(e, Ji, Jj, W, Ji_out, Jj_out, W_out);
      float* s = slot + tid * kSlot;
      // this endpoint's Jacobian: Jᵢ from the 'from' side, Jⱼ from the 'to' side
      auto J = [&](int row, int col) { return to_side ? Jj[row][col] : Ji[row][col]; };
      float Wr[6];
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < 6; ++j) t += W[k][j] * re[j];
        Wr[k] = t;
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        float t = 0.f;
#pragma unroll
        for (int j = 0; j < 6; ++j) t += J(j, k) * Wr[j];
        s[k] = t;
      }
      float T[6][6];
      // H = JᵀWJ of this endpoint
#pragma unroll
      for (int k = 0; k < 6; ++k)
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < 6; ++j) t += W[k][j] * J(j, m);
          T[k][m] = t;
        }
#pragma unroll
      for (int k = 0; k < 6; ++k)
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          float t = 0.f;
#pragma unroll
          for (int j = 0; j < 6; ++j) t += J(j, k) * T[j][m];
          s[6 + k * 6 + m] = t;
        }
      // the spine coupling JᵢᵀWJⱼ, on a chain edge's 'from' row only
      const bool spine = !to_side && is_chain[e] != 0.f;
      if (spine) mm6(W, Jj, T);
#pragma unroll
      for (int k = 0; k < 6; ++k)
#pragma unroll
        for (int m = 0; m < 6; ++m) {
          float t = 0.f;
          if (spine)
#pragma unroll
            for (int j = 0; j < 6; ++j) t += Ji[j][k] * T[j][m];
          s[42 + k * 6 + m] = t;
        }
    }
    __syncthreads();
    // each row's terms of this chunk, in table order
    const int c1 = min(c0 + kLinThreads, b);
    for (int q = tid; q < items; q += kLinThreads) {
      const int n = n0 + q / kRow, k = q % kRow;
      const int lo = row_ptr[n], hi = row_ptr[n + 1];
      if (hi <= c0 || lo >= c1) continue;
      float* out = row_at(grad, Hb, U, n, k);
      float acc = lo >= c0 ? 0.f : *out;       // a partial from an earlier chunk
      for (int m = max(lo, c0); m < min(hi, c1); ++m) acc += slot[(m - c0) * kSlot + k];
      if (hi <= c1) acc *= k < 6 ? free[n] : (k < 42 ? 1.f : both_free[n]);
      *out = acc;
    }
    __syncthreads();
  }
}

}  // namespace

// Every node row and every edge slot is written.  (row_ptr, entries): the
// incidence table of the edges with valid != 0 (kernels/ops.py
// incidence_table); col_keep 63 keeps every Jacobian column.
extern "C" int uz_linearize(const float* r, const float* adj_meas_inv, const float* info,
                            const float* valid, const float* free, const float* both_free,
                            const float* is_chain,
                            const int* row_ptr, const int* entries, float huber_delta, int n_edges,
                            int n_nodes, int col_keep, float* Ji, float* Jj, float* W, float* grad,
                            float* Hb, float* U, void* stream) {
  const int node_blocks = (n_nodes + kLinNodes - 1) / kLinNodes;
  const int tail_blocks = (n_edges + kLinThreads - 1) / kLinThreads;
  if (node_blocks + tail_blocks > 0)
    linearize_rows<<<node_blocks + tail_blocks, kLinThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        r, adj_meas_inv, info, valid, free, both_free, is_chain, row_ptr, entries,
        huber_delta, n_edges, n_nodes, col_keep, node_blocks, Ji, Jj, W, grad, Hb, U);
  return static_cast<int>(cudaGetLastError());
}
