// K37 with K2's Hessian-vector product inside its step: a measurement
// variant of uzliti_slam_tpu_torch/csrc/pcg_grid.cu, not part of the
// package.
//
// The package's K37 (its start and step, unchanged below) plus one entry,
// uz_pcg_grid_solve_step, for a single solve above K34's cap with no reduce
// hook: the step with Hp = H(p·m)·m computed in the same cooperative launch
// (replacing, with the rest, uzliti_slam_tpu/graph/solver.py:_make_hvp
// (:306-322)), in two passes before the pHp barrier: an edge pass over the
// valid edges (the incidence table's side-0 entries, 32 a warp's chunk)
// writes each edge's Jᵢᵀ·W·u and Jⱼᵀ·W·u (u = Jᵢ·vm[from] + Jⱼ·vm[to], vm =
// p·m·free) into scratch, and behind one more grid barrier a thread a row
// sums its entries' terms in table order into Hp with its pᵀHp terms: no
// atomics, each valid edge read once, K35's Hp bits.  Hp, written in the
// launch, is read by forward level 0 with ordinary loads, not through the
// read-only path.  The edge pass has two forms: 6 lanes an edge with the
// edges' Jᵢ, Jⱼ, W through two tiles of 10 a warp (cp.async, the next in
// flight while one is computed; the default), or kHvThreadEdges, a thread
// an edge reading them through L1 (K2's edge kernel writing its two terms
// instead of its atomics).  On an NVIDIA H100 80GB HBM3 at 700.00 W both
// took longer than K2 + K37 (PERF.md §6), as did two earlier forms
// (a warp a chunk of 32 rows summing each row's entries, each edge's u at
// both endpoints, K35's way), so the package keeps K2 + K37.
// scripts/k10_k2_variants.py builds it as the variants "k37:thread=0" and
// "k37:thread=1" and times it beside K2 + K37 (through its own wrapper,
// the package having none).
#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinCtas = 3;        // resident CTAs an SM the register budget is set for
constexpr int kPass = 5;           // odd blocks a warp computes at once (30 lanes)
constexpr int kTile = 2 * kPass;   // odd blocks a warp stages at once
constexpr int kBlock4 = 9;         // float4s of one 6x6 block
constexpr int kTile4 = kTile * kBlock4;
constexpr int kMaxLevels = 24;     // K9's
constexpr int kMaxDevices = 64;

struct Chain {
  const float* lv[kMaxLevels][5];  // each level's Dinv_o, P1m, P2, G1, G2: (half, 6, 6)
  const float* root_inv;           // (6·m_root, 6·m_root)
  const float* cmask;              // 6 column weights, or nullptr
  float* vec[kMaxLevels + 1];      // forward: level l's vector, l = 1..levels (2·half_l rows)
  float* xv[kMaxLevels + 1];       // back: level l's x, l = 1..levels (the same rows)
  int levels, m_root, n;           // n: the valid rows of the level-0 vector
};

struct Vectors {
  const float* in;                 // b at the start, Hp in a step
  float* x;
  float* r;
  float* p;
  float* z;                        // M⁻¹r (a step's scratch)
  float* scal;                     // [rz, b2, ok, rz kept]
  float* part;                     // 2 x gridDim.x partial sums
  float tol;
  int start;
};

// The Hv entry's operator (K2's arguments), the solve's incidence table, the
// edges' terms and the step's Hp.
struct HvOp {
  const float* Ji;       // (E, 6, 6)
  const float* Jj;
  const float* W;
  const int* e_from;     // (E,)
  const int* e_to;
  const float* damp;     // (n, 6)
  const float* free;     // (n,)
  const int* row_ptr;    // (n + 1,)
  const int* entries;    // 2e + side, each node's in table order
  float* ye;             // (E, 12): each valid edge's Jᵢᵀ·W·u, Jⱼᵀ·W·u
  float* hp;             // (n, 6)
};

__device__ __forceinline__ int half_of(const Chain& f, int l) {
  return f.m_root << (f.levels - 1 - l);
}

// Fixed-order sum over the CTA (a shuffle tree, then the warps in order);
// every thread gets the same total.
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

// The total of the grid's per-CTA partials, summed in the same order in
// every CTA.  Called after the barrier that follows every CTA's write.
__device__ float grid_total(const float* part, float* red) {
  float s = 0.f;
  for (int i = threadIdx.x; i < static_cast<int>(gridDim.x); i += kThreads) s += part[i];
  return block_sum(s, red);
}

// Level-0 row `row`, component k, unmasked: b at the start, r - α·Hp in a
// step (rounded as the α update writes it); zero past the valid rows.
// kHv: Hp was written in this launch, so it is not read through the
// read-only path.
template <bool kHv>
__device__ __forceinline__ float level0(const Vectors& v, float alpha, int n, int row, int k) {
  if (row < 0 || row >= n) return 0.f;
  const long long q = 6LL * row + k;
  const float in = kHv ? v.in[q] : __ldg(v.in + q);
  if (v.start) return in;
  return __fsub_rn(v.r[q], __fmul_rn(alpha, in));
}

// Copy kM matrices (a, b[, c]) of the odd blocks [j0, j0 + nb) into this
// warp's tile st, asynchronously (cp.async, 16 bytes a copy): matrix m's
// block jl at floats st + (m·kTile + jl)·36.  Lane `lane` copies float4s
// lane, lane + 32, ... of the tile, so a warp's copies are coalesced.  The
// copies land by stage_wait(); the warp may pass a grid barrier meanwhile.
template <int kM>
__device__ __forceinline__ void stage_async(const float* a, const float* b, const float* c,
                                            int j0, int nb, float4* st) {
  constexpr int kRounds = (kM * kTile4 + 31) / 32;
  const int lane = threadIdx.x % 32;
  __syncwarp();   // the warp's lanes are done with the previous tile
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int q = i * 32 + lane;
    const int m = q / kTile4, idx = q - m * kTile4;
    const float* src = m == 0 ? a : (m == 1 ? b : c);
    if (q < kM * kTile4 && idx < nb * kBlock4)
      __pipeline_memcpy_async(st + q, reinterpret_cast<const float4*>(src) +
                                          kBlock4 * static_cast<long long>(j0) + idx,
                              sizeof(float4));
  }
  __pipeline_commit();
}

__device__ __forceinline__ void stage_wait() {
  __pipeline_wait_prior(0);
  __syncwarp();
}

// Issue the copy of tile t of forward (back = false) or back level l.
__device__ __forceinline__ void issue_tile(const Chain& f, int l, bool back, int t, float4* st) {
  const int j0 = t * kTile, nb = min(kTile, half_of(f, l) - j0);
  if (back)
    stage_async<3>(f.lv[l][0], f.lv[l][3], f.lv[l][4], j0, nb, st);
  else
    stage_async<2>(f.lv[l][1], f.lv[l][2], nullptr, j0, nb, st);
}

// Issue this warp's first tile (w0) of a level's phase ahead of the barrier
// before it: the products do not depend on the vectors.  Whether it did.
__device__ __forceinline__ bool prefetch(const Chain& f, int l, bool back, int w0, float4* st) {
  if (w0 * kTile >= half_of(f, l)) return false;
  issue_tile(f, l, back, w0, st);
  return true;
}

// Column weight k of the planar mask (1 without one).
__device__ __forceinline__ float mask(const Chain& f, int k) {
  return f.cmask != nullptr ? __ldg(f.cmask + k) : 1.f;
}

// Forward level l over its tiles t = w0, w0 + ws, ...: vec[l + 1][j] from
// level l's vector.  A pass takes 5 odd blocks on lanes 0-29, lane 6·g + i
// on block g's output row i: each lane loads only component i of the rows
// it needs (coalesced) and gathers the rest from its block's lanes by warp
// shuffles.  At level 0 also the step's x += α·p and r's even rows (or the
// start's x = 0, r = b and its bᵀb terms, into b2).
template <bool kHv>
__device__ void forward_level(const Chain& f, const Vectors& v, int l, float alpha, int w0,
                              int ws, float4* st, bool staged, float& b2) {
  const int half = half_of(f, l), n = f.n, lane = threadIdx.x % 32;
  const int grp = lane / 6, i = lane - 6 * grp, base = 6 * grp;
  const float w = l == 0 ? mask(f, i) : 1.f;
  const float* bl = f.vec[l];
  float* out = f.vec[l + 1];
  const float* S = reinterpret_cast<const float*>(st);
  const int tiles = (half + kTile - 1) / kTile;
  for (int t = w0; t < tiles; t += ws) {
    const int j0 = t * kTile, nb = min(kTile, half - j0);
    if (t != w0 || !staged) issue_tile(f, l, false, t, st);
    stage_wait();
#pragma unroll 1
    for (int pass = 0; pass < kTile / kPass; ++pass) {
      const int jl = min(kPass * pass + grp, kTile - 1), j = j0 + jl;
      const bool live = grp < kPass && kPass * pass + grp < nb;
      // component i of rows 2j - 1, 2j and 2j + 1 (masked at level 0)
      float vm = 0.f, ve = 0.f, vo = 0.f;
      if (live) {
        if (l == 0) {
          vm = level0<kHv>(v, alpha, n, 2 * j - 1, i);
          ve = level0<kHv>(v, alpha, n, 2 * j, i);
          vo = level0<kHv>(v, alpha, n, 2 * j + 1, i);
        } else {
          vm = j > 0 ? bl[6 * (2 * j - 1) + i] : 0.f;
          ve = bl[12 * j + i];
          vo = bl[6 * (2 * j + 1) + i];
        }
      }
      const float* A = S + jl * 36 + i * 6;
      const float* B = S + (kTile + jl) * 36 + i * 6;
      const float vmw = vm * w, vow = vo * w;
      float a = 0.f, c = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        a += A[k] * __shfl_sync(0xffffffffu, vmw, base + k);
        c += B[k] * __shfl_sync(0xffffffffu, vow, base + k);
      }
      if (!live) continue;
      out[6 * j + i] = ve * w - a - c;
      if (l == 0) {
        // this lane alone reads and writes rows 2j and 2j + 1's component
        // i of x, and row 2j's of r, in this phase
        for (int row = 2 * j; row <= 2 * j + 1 && row < n; ++row) {
          const long long q = 6LL * row + i;
          if (v.start) {
            const float bq = kHv ? v.in[q] : __ldg(v.in + q);
            v.x[q] = 0.f;
            v.r[q] = bq;
            b2 += bq * bq;
          } else {
            v.x[q] = __fadd_rn(v.x[q], __fmul_rn(alpha, v.p[q]));
            if (row == 2 * j) v.r[q] = ve;
          }
        }
      }
    }
  }
}

// The root over rows w0, w0 + ws, ... of root_inv: xv[L] = root_inv·vec[L].
__device__ void root_rows(const Chain& f, int w0, int ws) {
  const int nr = 6 * f.m_root, lane = threadIdx.x % 32;
  const float* b = f.vec[f.levels];
  float* x = f.xv[f.levels];
  for (int row = w0; row < nr; row += ws) {
    const float* ri = f.root_inv + static_cast<long long>(row) * nr;
    float s = 0.f;
    if (nr % 4 == 0) {   // an even root: rows 16-byte aligned, read as float4
      const float4* r4 = reinterpret_cast<const float4*>(ri);
      const float4* b4 = reinterpret_cast<const float4*>(b);
#pragma unroll 4
      for (int k = lane; k < nr / 4; k += 32) {
        const float4 a = __ldg(r4 + k), c = b4[k];
        s += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
      }
    } else {
      for (int k = lane; k < nr; k += 32) s += __ldg(ri + k) * b[k];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) x[row] = s;
  }
}

// Back level l over its tiles: level l's x from level l + 1's, the lanes
// as in forward_level.  Level 0 writes z masked (p = z0 at the start) and
// adds its rᵀz terms to dot; in a step it also writes r's odd rows (each
// lane the component it alone read).
template <bool kHv>
__device__ void back_level(const Chain& f, const Vectors& v, int l, float alpha, int w0, int ws,
                           float4* st, bool staged, float& dot) {
  const int half = half_of(f, l), n = f.n, lane = threadIdx.x % 32;
  const int grp = lane / 6, i = lane - 6 * grp, base = 6 * grp;
  const float w = l == 0 ? mask(f, i) : 1.f;
  const float* bl = f.vec[l];
  const float* xc = f.xv[l + 1];
  float* xo = f.xv[l];
  float* zo = v.start ? v.p : v.z;
  const float* S = reinterpret_cast<const float*>(st);
  const int tiles = (half + kTile - 1) / kTile;
  for (int t = w0; t < tiles; t += ws) {
    const int j0 = t * kTile, nb = min(kTile, half - j0);
    if (t != w0 || !staged) issue_tile(f, l, true, t, st);
    stage_wait();
#pragma unroll 1
    for (int pass = 0; pass < kTile / kPass; ++pass) {
      const int jl = min(kPass * pass + grp, kTile - 1), j = j0 + jl;
      const bool live = grp < kPass && kPass * pass + grp < nb;
      // component i of row 2j + 1 (unmasked) and of x'[j], x'[j + 1]
      float vo = 0.f, xe = 0.f, xn = 0.f;
      if (live) {
        vo = l == 0 ? level0<kHv>(v, alpha, n, 2 * j + 1, i) : bl[6 * (2 * j + 1) + i];
        xe = xc[6 * j + i];
        xn = j + 1 < half ? xc[6 * (j + 1) + i] : 0.f;
      }
      const float* D = S + jl * 36 + i * 6;
      const float* G1 = S + (kTile + jl) * 36 + i * 6;
      const float* G2 = S + (2 * kTile + jl) * 36 + i * 6;
      const float vow = vo * w;
      float a = 0.f, g1 = 0.f, g2 = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        a += D[k] * __shfl_sync(0xffffffffu, vow, base + k);
        g1 += G1[k] * __shfl_sync(0xffffffffu, xe, base + k);
        g2 += G2[k] * __shfl_sync(0xffffffffu, xn, base + k);
      }
      if (!live) continue;
      const float odd = a - g1 - g2;
      if (l > 0) {
        xo[12 * j + i] = xe;
        xo[12 * j + 6 + i] = odd;
        continue;
      }
      const long long qe = 12LL * j + i, qo = qe + 6;
      if (2 * j < n) {
        const float zv = xe * w;
        zo[qe] = zv;
        dot += (v.start ? (kHv ? v.in[qe] : __ldg(v.in + qe)) : v.r[qe]) * zv;
      }
      if (2 * j + 1 < n) {
        const float zv = odd * w;
        zo[qo] = zv;
        dot += vo * zv;
        if (!v.start) v.r[qo] = vo;
      }
    }
  }
}

constexpr unsigned kFull = 0xffffffffu;
constexpr bool kHvThreadEdges = false;   // the edge pass a thread an edge (else 6 lanes an edge)

// Copy the Jᵢ, Jⱼ and W of the nb edges of a tile (edge jl's id on lane
// (j0 + jl) mod 32) into this warp's tile st, matrix m's edge jl at floats
// st + (m·kTile + jl)·36, asynchronously (cp.async, 16 bytes a copy).
__device__ __forceinline__ void stage_edges(const HvOp& h, int e, int j0, int nb, float4* st) {
  constexpr int kRounds = (3 * kTile4 + 31) / 32;
  const int lane = threadIdx.x % 32;
  __syncwarp();   // the warp's lanes are done with this buffer's last tile
#pragma unroll
  for (int i = 0; i < kRounds; ++i) {
    const int q = i * 32 + lane;
    const int m = q / kTile4, idx = q - m * kTile4;
    const int jl = idx / kBlock4, k = idx - jl * kBlock4;
    const long long ej = __shfl_sync(kFull, e, (j0 + jl) & 31);
    if (q < 3 * kTile4 && jl < nb) {
      const float* src = m == 0 ? h.Ji : (m == 1 ? h.Jj : h.W);
      __pipeline_memcpy_async(st + q, reinterpret_cast<const float4*>(src) + kBlock4 * ej + k,
                              sizeof(float4));
    }
  }
  __pipeline_commit();
}

// The Hv's edge pass over the valid edges (the side-0 entries of the
// table, row_ptr[n] entries in all), chunks of 32 entries a warp (chunks
// w0, w0 + ws, ...): lane ℓ < ne takes the chunk's ℓ-th edge, its masked p
// rows loaded at once; the edges' Jᵢ, Jⱼ, W come in tiles of 10 through
// the warp's two tile buffers (the next in flight while one is computed);
// a pass takes 5 edges on lanes 0-29 (lane 6·g + i on component i, the
// other components by warp shuffles) and writes Jᵢᵀ·W·u and Jⱼᵀ·W·u, u =
// Jᵢ·vm[from] + Jⱼ·vm[to], vm = p·m·free, into ye (12 floats an edge).
__device__ void hv_edges(const Chain& f, const HvOp& h, const float* p, int w0, int ws,
                         float4* st) {
  const int lane = threadIdx.x % 32;
  const int grp = lane / 6, i = lane - 6 * grp, base = 6 * grp;
  float cm[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) cm[k] = mask(f, k);
  const int nq = __ldg(h.row_ptr + f.n);
  const int chunks = (nq + 31) / 32;
  for (int c = w0; c < chunks; c += ws) {
    const int q = c * 32 + lane;
    const int code = q < nq ? __ldg(h.entries + q) : 1;
    const unsigned first = __ballot_sync(kFull, (code & 1) == 0);
    const int ne = __popc(first);
    // lane ℓ < ne: the ℓ-th side-0 entry's edge (its lane: the lowest set
    // bit left after dropping ℓ)
    unsigned rest = first;
    for (int k = 0; k < lane && rest != 0u; ++k) rest &= rest - 1u;
    const int at = lane < ne ? __ffs(static_cast<int>(rest)) - 1 : 0;
    const int e = __shfl_sync(kFull, code, at) >> 1;
    float vf[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, vt[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (lane < ne) {
      const int nf = __ldg(h.e_from + e), nt = __ldg(h.e_to + e);
      const float ff = __ldg(h.free + nf), ft = __ldg(h.free + nt);
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        vf[k] = p[6LL * nf + k] * cm[k] * ff;
        vt[k] = p[6LL * nt + k] * cm[k] * ft;
      }
    }
    const int tiles = (ne + kTile - 1) / kTile;
    if (tiles > 0) stage_edges(h, e, 0, min(kTile, ne), st);
    for (int t = 0; t < tiles; ++t) {
      if (t + 1 < tiles) {
        stage_edges(h, e, (t + 1) * kTile, min(kTile, ne - (t + 1) * kTile),
                    st + ((t + 1) & 1) * 3 * kTile4);
        __pipeline_wait_prior(1);
      } else {
        __pipeline_wait_prior(0);
      }
      __syncwarp();
      const float* S = reinterpret_cast<const float*>(st + (t & 1) * 3 * kTile4);
#pragma unroll 1
      for (int pass = 0; pass < kTile / kPass; ++pass) {
        const int jl = min(kPass * pass + grp, kTile - 1), jb = t * kTile + jl;
        const bool live = grp < kPass && jb < ne;
        const int src = jb & 31;
        const float* A = S + jl * 36;                 // Jᵢ, Jⱼ, W of edge jl
        const float* B = S + (kTile + jl) * 36;
        const float* C = S + (2 * kTile + jl) * 36;
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          a += A[6 * i + k] * __shfl_sync(kFull, vf[k], src);
          b += B[6 * i + k] * __shfl_sync(kFull, vt[k], src);
        }
        const float u = a + b;
        float wu = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) wu += C[6 * i + k] * __shfl_sync(kFull, u, base + k);
        float yi = 0.f, yj = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float w = __shfl_sync(kFull, wu, base + k);
          yi += A[6 * k + i] * w;
          yj += B[6 * k + i] * w;
        }
        const long long ej = __shfl_sync(kFull, e, src);
        if (live) {
          h.ye[12 * ej + i] = yi;
          h.ye[12 * ej + 6 + i] = yj;
        }
      }
    }
  }
}

// The edge pass a thread an edge (K2's edge kernel, its atomics replaced by
// the writes into ye): chunks of 32 table entries a warp, lane ℓ < ne on
// the chunk's ℓ-th side-0 entry's edge, its Jᵢ, Jⱼ, W read through L1.
__device__ void hv_edges_threads(const Chain& f, const HvOp& h, const float* p, int w0, int ws) {
  const int lane = threadIdx.x % 32;
  float cm[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) cm[k] = mask(f, k);
  const int nq = __ldg(h.row_ptr + f.n);
  const int chunks = (nq + 31) / 32;
  for (int c = w0; c < chunks; c += ws) {
    const int q = c * 32 + lane;
    const int code = q < nq ? __ldg(h.entries + q) : 1;
    const unsigned first = __ballot_sync(kFull, (code & 1) == 0);
    const int ne = __popc(first);
    unsigned rest = first;
    for (int k = 0; k < lane && rest != 0u; ++k) rest &= rest - 1u;
    const int at = lane < ne ? __ffs(static_cast<int>(rest)) - 1 : 0;
    const long long e = __shfl_sync(kFull, code, at) >> 1;
    if (lane >= ne) continue;
    const int nf = __ldg(h.e_from + e), nt = __ldg(h.e_to + e);
    const float ff = __ldg(h.free + nf), ft = __ldg(h.free + nt);
    const float* A = h.Ji + 36 * e;
    const float* B = h.Jj + 36 * e;
    const float* C = h.W + 36 * e;
    float vf[6], vt[6], u[6], wu[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      vf[k] = p[6LL * nf + k] * cm[k] * ff;
      vt[k] = p[6LL * nt + k] * cm[k] * ft;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        a += __ldg(A + 6 * i + k) * vf[k];
        b += __ldg(B + 6 * i + k) * vt[k];
      }
      u[i] = a + b;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float w = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) w += __ldg(C + 6 * i + k) * u[k];
      wu[i] = w;
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        a += __ldg(A + 6 * k + i) * wu[k];
        b += __ldg(B + 6 * k + i) * wu[k];
      }
      h.ye[12 * e + i] = a;
      h.ye[12 * e + 6 + i] = b;
    }
  }
}

// The Hv's row pass, a thread a row (rows gt, gt + gts, ...): its entries'
// terms from ye summed in table order, Hp = ((Σ + damp·vm)·free)·m written,
// and its pᵀHp terms returned.  ye was written in this launch before the
// caller's grid barrier (ordinary loads); Hp is read after the next one.
__device__ float hv_rows(const Chain& f, const HvOp& h, const float* p, long long gt,
                         long long gts) {
  float cm[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) cm[k] = mask(f, k);
  float dot = 0.f;
  for (long long row = gt; row < f.n; row += gts) {
    const int q1 = __ldg(h.row_ptr + row), q2 = __ldg(h.row_ptr + row + 1);
    float y[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = q1; q < q2; ++q) {
      const int code = __ldg(h.entries + q);
      const float* term = h.ye + 12LL * (code >> 1) + 6 * (code & 1);
#pragma unroll
      for (int k = 0; k < 6; ++k) y[k] += term[k];
    }
    const float fr = __ldg(h.free + row);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      const float pv = p[6 * row + k];
      const float vm = pv * cm[k] * fr;
      const float hv = ((y[k] + __ldg(h.damp + 6 * row + k) * vm) * fr) * cm[k];
      h.hp[6 * row + k] = hv;
      dot += pv * hv;
    }
  }
  return dot;
}

// kHv: the step with its Hessian-vector product (uz_pcg_grid_solve_step);
// v.in is then h.hp.
template <bool kHv>
__global__ void __launch_bounds__(kThreads, kMinCtas)
pcg_grid_kernel(Chain f, Vectors v, HvOp h) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 tiles[];   // kWarps tiles of 3·kTile4 (two each with kHv)
  __shared__ float red[kWarps];
  const int tid = threadIdx.x, warp = tid / 32, G = static_cast<int>(gridDim.x);
  float4* st = tiles + (kHv ? 2 : 1) * 3 * kTile4 * warp;
  const int gw = static_cast<int>(blockIdx.x) * kWarps + warp, gws = G * kWarps;
  const int L = f.levels;
  float* partA = v.part;                       // bᵀb at the start, pHp in a step
  float* partB = v.part + G;                   // rᵀz
  const long long nf = 6LL * f.n;
  const long long gt = static_cast<long long>(blockIdx.x) * kThreads + tid;
  const long long gts = static_cast<long long>(G) * kThreads;

  // forward level 0's first tile is not issued ahead of the pHp pass: there
  // it moved ~4 µs into that pass to save ~5 µs in level 0
  // (scripts/k37_phase_stamps.py, start_prefetch)
  bool staged = false;
  float rz = 0.f, alpha = 0.f;
  bool ok = true;
  if (!v.start) {
    rz = v.scal[0];
    const float b2 = v.scal[1];
    float s = 0.f;
    if constexpr (kHv) {
      if (kHvThreadEdges)
        hv_edges_threads(f, h, v.p, gw, gws);
      else
        hv_edges(f, h, v.p, gw, gws, st);
      grid.sync();
      s = hv_rows(f, h, v.p, gt, gts);
    } else {
#pragma unroll 4
      for (long long i = gt; i < nf; i += gts) s += v.p[i] * __ldg(v.in + i);
    }
    s = block_sum(s, red);
    if (tid == 0) partA[blockIdx.x] = s;
    grid.sync();
    const float pHp = grid_total(partA, red);
    ok = (pHp > 1e-20f) && (rz > v.tol * (b2 + 1e-30f));
    alpha = ok ? rz / (pHp == 0.f ? 1.f : pHp) : 0.f;
    if (blockIdx.x == 0 && tid == 0) v.scal[2] = ok ? 1.f : 0.f;
  }

  // forward
  float b2 = 0.f;
  for (int l = 0; l < L; ++l) {
    forward_level<kHv>(f, v, l, alpha, gw, gws, st, staged, b2);
    // the next phase's first tile: the next level's, or across the root
    // (which does not use the tile) back level L - 1's
    staged = l + 1 < L ? prefetch(f, l + 1, false, gw, st) : prefetch(f, L - 1, true, gw, st);
    if (l == 0 && v.start) {
      b2 = block_sum(b2, red);
      if (tid == 0) partA[blockIdx.x] = b2;
    }
    grid.sync();
  }
  root_rows(f, gw, gws);
  grid.sync();
  // back; level 0 gives z and the rᵀz partials
  float dot = 0.f;
  for (int l = L - 1; l >= 0; --l) {
    back_level<kHv>(f, v, l, alpha, gw, gws, st, staged, dot);
    if (l > 0) {
      staged = prefetch(f, l - 1, true, gw, st);
      grid.sync();
    }
  }
  dot = block_sum(dot, red);
  if (tid == 0) partB[blockIdx.x] = dot;
  grid.sync();

  if (v.start) {
    if (blockIdx.x == 0) {
      const float rz0 = grid_total(partB, red), bb = grid_total(partA, red);
      if (tid == 0) {
        v.scal[0] = rz0;
        v.scal[1] = bb;
        v.scal[2] = 1.f;
        v.scal[3] = rz0;
      }
    }
    return;
  }
  const float rz_new = grid_total(partB, red);
  const float beta = ok ? rz_new / (rz == 0.f ? 1.f : rz) : 0.f;
  if (ok) {
#pragma unroll 4
    for (long long i = gt; i < nf; i += gts) v.p[i] = __fadd_rn(v.z[i], __fmul_rn(beta, v.p[i]));
  }
  if (blockIdx.x == 0 && tid == 0) v.scal[0] = ok ? rz_new : rz;
}

// Dynamic shared memory of a CTA: each warp's tile (two with the Hv, whose
// entries' tiles are double-buffered).
constexpr int kTileBytes = kWarps * 3 * kTile4 * static_cast<int>(sizeof(float4));
template <bool kHv>
constexpr int tile_bytes() { return kHv ? 2 * kTileBytes : kTileBytes; }

// CTAs the card holds at once of either form (cached per device, after
// allowing the kernel its dynamic shared memory); 0 on an error.
template <bool kHv>
int resident_ctas() {
  static int cache[kMaxDevices][2] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (cache[dev][0] == 0) {
    int fit = 0, sms = 0;
    if (cudaFuncSetAttribute(pcg_grid_kernel<kHv>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tile_bytes<kHv>()) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, pcg_grid_kernel<kHv>, kThreads,
                                                      tile_bytes<kHv>()) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    cache[dev][0] = fit;
    cache[dev][1] = sms;
  }
  return cache[dev][0] * cache[dev][1];
}

// Floats of the vector scratch: each level's forward vector and back-sweep
// x, levels 1..L (m_root << (L - l) rows of 6 each).
long long scratch_floats(int levels, int m_root) {
  return 2LL * 6 * m_root * ((1LL << levels) - 1);
}

// The factor from its host table of pointers (5 a level: Dinv_o, P1m, P2,
// G1, G2, then root_inv) and the vectors' scratch.  Refuses shapes the
// kernel cannot take and products that are not 16-byte aligned.
int make_chain(const void* table, int levels, int m_root, int n, const float* cmask,
               float* scratch, Chain* f) {
  if (levels < 1 || levels > kMaxLevels || m_root < 1 || (m_root & (m_root - 1)) != 0 ||
      n < 1 || n > (static_cast<long long>(m_root) << levels) || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const* ptrs = static_cast<const float* const*>(table);
  *f = Chain{};
  for (int l = 0; l < levels; ++l)
    for (int k = 0; k < 5; ++k) {
      f->lv[l][k] = ptrs[5 * l + k];
      if (reinterpret_cast<unsigned long long>(f->lv[l][k]) % 16 != 0)
        return static_cast<int>(cudaErrorMisalignedAddress);
    }
  f->root_inv = ptrs[5 * levels];
  f->cmask = cmask;
  f->levels = levels;
  f->m_root = m_root;
  f->n = n;
  float* at = scratch;
  for (int l = 1; l <= levels; ++l) {
    f->vec[l] = at;
    at += 6LL * (static_cast<long long>(m_root) << (levels - l));
  }
  for (int l = 1; l <= levels; ++l) {
    f->xv[l] = at;
    at += 6LL * (static_cast<long long>(m_root) << (levels - l));
  }
  return 0;
}

template <bool kHv>
int launch(const void* table, int levels, int m_root, int n, const float* cmask, Vectors v,
           HvOp h, float* scratch, long long scratch_size, int max_ctas, void* stream) {
  Chain f;
  int err = make_chain(table, levels, m_root, n, cmask, scratch, &f);
  if (err != 0) return err;
  if (scratch_size < scratch_floats(levels, m_root)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = resident_ctas<kHv>();
  if (grid <= 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (grid > max_ctas) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&f, &v, &h};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pcg_grid_kernel<kHv>), dim3(grid), dim3(kThreads), args,
      tile_bytes<kHv>(), static_cast<cudaStream_t>(stream)));
}

}  // namespace

// A single solve: vectors (n, 6), scal (1, 4); the factor as a host table
// (see make_chain) of a chain of m_root << levels rows, levels >= 1; cmask
// nullptr or 6 floats; scratch (scratch_size floats, at least
// 12·m_root·(2^levels - 1)) and partials (2·max_ctas floats) from the
// wrapper.

// The number of CTAs a launch takes on the current device (0 if it cannot
// run).
extern "C" int uz_pcg_grid_ctas() { return resident_ctas<false>(); }

// x, r, p and scal from b: z0 = M⁻¹b in p.
extern "C" int uz_pcg_grid_start(const void* table, int levels, int m_root, int n,
                                 const float* cmask, const float* b, float* x,
                                 float* r, float* p, float* scal, float* scratch,
                                 long long scratch_size, float* partials, int max_ctas,
                                 void* stream) {
  const Vectors v{b, x, r, p, nullptr, scal, partials, 0.f, 1};
  return launch<false>(table, levels, m_root, n, cmask, v, HvOp{}, scratch, scratch_size,
                       max_ctas, stream);
}

// One step after Hp = H·p: x, r, p and scal in place, z = M⁻¹r (scratch).
extern "C" int uz_pcg_grid_step(const float* Hp, float tol, const void* table, int levels,
                                int m_root, int n, const float* cmask, float* x,
                                float* r, float* p, float* z, float* scal, float* scratch,
                                long long scratch_size, float* partials, int max_ctas,
                                void* stream) {
  const Vectors v{Hp, x, r, p, z, scal, partials, tol, 0};
  return launch<false>(table, levels, m_root, n, cmask, v, HvOp{}, scratch, scratch_size,
                       max_ctas, stream);
}

// One step with its Hp = H(p·m)·m (the operator as K2 takes it: Ji, Jj, W
// (E, 6, 6), 16-byte aligned; e_from, e_to (E,); damp (n, 6); free (n,))
// summed over the solve's incidence table (row_ptr (n + 1,), entries
// (2E,)): x, r, p and scal in place; z, hp (n, 6) and ye (12·E floats)
// scratch.
extern "C" int uz_pcg_grid_solve_step(float tol, const void* table, int levels, int m_root,
                                      int n, const float* cmask, const float* Ji,
                                      const float* Jj, const float* W, const int* e_from,
                                      const int* e_to, const float* damp, const float* free,
                                      const int* row_ptr, const int* entries, int n_edges,
                                      float* x, float* r, float* p, float* z, float* hp,
                                      float* ye, float* scal, float* scratch,
                                      long long scratch_size, float* partials, int max_ctas,
                                      void* stream) {
  if (n_edges < 0) return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<unsigned long long>(Ji) | reinterpret_cast<unsigned long long>(Jj) |
       reinterpret_cast<unsigned long long>(W)) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const Vectors v{hp, x, r, p, z, scal, partials, tol, 0};
  const HvOp h{Ji, Jj, W, e_from, e_to, damp, free, row_ptr, entries, ye, hp};
  return launch<true>(table, levels, m_root, n, cmask, v, h, scratch, scratch_size, max_ctas,
                      stream);
}
