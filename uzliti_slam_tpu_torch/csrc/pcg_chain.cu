// K34 pcg_chain: one PCG step's preconditioner half in one launch; and K35
// pcg_chain_solve: a whole PCG solve, its Hessian-vector products included,
// in one launch (the same device code).
//
// Replaces, for a single solve, the body of uzliti_slam_tpu/graph/solver.py:
// _pcg (:512-540) minus its Hessian-vector product, with the preconditioner
// apply uzliti_slam_tpu/graph/tridiag.py:block_tridiag_apply (:198-248)
// inside it: what K10 (csrc/pcg.cu) and K3 (csrc/chain_apply.cu) did in 11
// launches a step (K10's two, K3's four forward levels, root and four back
// levels at 1k nodes) is one launch here.
//   uz_pcg_chain_start: z0 = M⁻¹b, then x = 0, r = b, p = z0, rz = rᵀz0,
//                       b2 = bᵀb;
//   uz_pcg_chain_step (after K2 has written Hp = H·p):
//       pHp = pᵀHp, ok = pHp > 1e-20 && rz > tol·(b2 + 1e-30),
//       α = ok ? rz / (pHp == 0 ? 1 : pHp) : 0, x += α·p, r -= α·Hp;
//       z = M⁻¹r through every level and the root;
//       rz' = rᵀz, β = ok ? rz' / (rz == 0 ? 1 : rz) : 0,
//       p = ok ? z + β·p : p, rz = ok ? rz' : rz.
// The scalars stay on the card in K10's scal (1, 4) = [rz, b2, ok, rz kept],
// and the axpys are K10's explicitly rounded ones (__fmul_rn, __fadd_rn).
// The apply is K3's arithmetic: per level the forward
//   b'[j] = b[2j] - P1m[j]·b[2j-1] - P2[j]·b[2j+1]   (b[-1] = 0),
// the root x' = root_inv·b' (a warp per row, a fixed shuffle tree), and back
//   x[2j] = x'[j],  x[2j+1] = Dinv_o[j]·b[2j+1] - G1[j]·x'[j] - G2[j]·x'[j+1].
// With a column mask (the generic loop's planar solve) the level-0 vector is
// read through the mask and z is masked, as its wrapped preconditioner
// minv(r) = M⁻¹(r·m)·m does.
//
// What bounds it: at the 1k headline, latency (a step moves 1.3 MB, 0.0004
// ms at the card's memory rate): 2·levels + 4 cluster barriers, each after
// a pass over a level.  The reads of the level products from L2 are not
// what costs: fetching them ahead into shared memory (cp.async into two
// stages, or every phase's products by TMA at entry) gave no gain on an
// H100, and is not done.  K3 and K10 lost their time to host issue (11
// launches a step, each a ctypes call with its checks); this kernel is one
// call a step with its arguments fixed at the start.
//
// Design.  One thread-block cluster of 8 CTAs (the portable size) per solve.
// The chain's block rows are split by root block: CTA c owns root blocks
// [c·rr, (c+1)·rr) and, at every level, the rows that descend from them, so
// a level's rows and their parents live in the same CTA and a sweep reads
// one row of a neighbour only: the forward's b[2j-1] from CTA c-1, the back
// sweep's x'[j+1] from CTA c+1, through distributed shared memory after a
// cluster barrier.  Every level's vector (the odd rows are read again on the
// way back) and the back sweep's x (two buffers, one per level parity) stay
// in shared memory: ~18·n₂/8 floats a CTA, n₂ the rows rounded up to a power
// of two, 149 KB at n₂ = 16,384, the route's cap.  The level products and
// root_inv do not depend on the vector and stay in L2 across the solve's
// steps.  Dots: each CTA sums its rows in a fixed order (strided threads,
// then its warps in order), then every CTA sums the cluster's partials in
// rank order through DSMEM, so every CTA holds the same total and a rerun
// gives the same bits; no atomics.
//
// K35 (uz_pcg_chain_solve) replaces, for a single solve with no reduce hook,
// _pcg's whole loop with uzliti_slam_tpu/graph/solver.py:_make_hvp (:306-322)
// inside it: the start and every step's Hp = H·p (K2's operator) in the same
// cluster, so one launch per LM iteration where K2 + K34 took 1 + 2·12 + 12.
// Each CTA computes Hp for the level-0 rows it owns from the solve's
// incidence table, in table order, without atomics: per entry u =
// Jᵢ·vm[from] + Jⱼ·vm[to] (each edge's u computed at both endpoints) and
// J_sideᵀ·W·u, then per row their sum.  At entry each CTA copies its rows'
// entries' Jᵢ, Jⱼ, W (432 bytes an edge) once into planes in table order
// (the operator does not change in the solve), so a step's loads of them
// are coalesced: read from the (E, 6, 6) tables each step, a thread a row
// (108 scalar loads an entry, 32 cache lines a warp load) they cost 0.137
// ms a step at 10k on an H100's 8 cluster SMs.  The operator stays
// matrix-free: H's blocks JᵀWJ assembled once (36 floats an entry) read
// less but add two near-cancelling large terms in float32, and moved x by
// up to 9.7e-5 of max|x| from the plain version (PERF.md §6).  p's neighbour
// rows, written by other CTAs, are read after the cluster barrier that
// closes the previous phase (its release/acquire orders them), with
// ordinary loads; everything else a step reads was written by its own CTA
// before a block barrier.  The scratch lives in device memory, so the cap
// is K34's.  What bounds it at 1k: the cluster barriers, as K34.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;             // CTAs of the cluster
constexpr int kChainThreads = 512;
constexpr int kWarps = kChainThreads / 32;
constexpr int kMaxLevels = 16;
constexpr int kMaxSmemBytes = 232448;   // shared memory one CTA can use on Hopper
constexpr int kMaxDevices = 64;

struct Chain {
  const float* lv[kMaxLevels][5];   // each level's Dinv_o, P1m, P2, G1, G2: (half, 6, 6)
  const float* root_inv;            // (6·m_root, 6·m_root)
  const float* cmask;               // 6 column weights, or nullptr
  int levels, m_root, n;            // n: the valid rows of the level-0 vector
};

// Root blocks a CTA owns (m_root and kCluster are powers of two; with fewer
// root blocks than CTAs, CTA c < m_root owns block c and the rest none).
__host__ __device__ inline int root_rows(int m_root) {
  return m_root >= kCluster ? m_root / kCluster : 1;
}

// Offset, in floats, of level l's vector (rr << (L - l) rows of 6) in a CTA's
// shared memory; level L + 1's is the end of the levels.
__host__ __device__ inline long long level_offset(int L, int rr, int l) {
  return 6LL * rr * ((1LL << (L + 1)) - (1LL << (L + 1 - l)));
}

// Floats of one back-sweep buffer: level 1's rows, the largest it holds.
__host__ __device__ inline long long x_floats(int L, int rr) {
  return L > 0 ? (6LL * rr) << (L - 1) : 0;
}

// A CTA's shared memory: the levels, two back-sweep buffers, the gathered
// root vector, four partial sums, their totals and the warps' sums.
__host__ __device__ inline long long smem_floats(int L, int m_root) {
  const int rr = root_rows(m_root);
  return level_offset(L, rr, L + 1) + 2 * x_floats(L, rr) + 6LL * m_root + 8 + kWarps;
}

// Fixed-order sum over the CTA (lane 0's shuffle tree, then the warps in
// order); every thread gets the same total.
__device__ float block_sum(float v, float* warp_sums) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (threadIdx.x % 32 == 0) warp_sums[threadIdx.x / 32] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += warp_sums[w];
  __syncthreads();
  return t;
}

// The cluster's total of part[slot], summed in rank order: the same bits in
// every CTA.  Called after a cluster barrier that follows every CTA's write.
__device__ float cluster_total(float* part, float* tot, int slot) {
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x < 32) {
    const float v = threadIdx.x < kCluster
                        ? *cluster.map_shared_rank(part + slot, threadIdx.x) : 0.f;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kCluster; ++q) s += __shfl_sync(0xffffffffu, v, q);
    if (threadIdx.x == 0) tot[slot] = s;
  }
  __syncthreads();
  return tot[slot];
}

// One phase of the solve on the cluster, ending with a cluster barrier.
// kStart: in = b, z unused; otherwise in = Hp and z is scratch for M⁻¹r.
// No __restrict__ on the vectors here: K35 writes Hp and p inside its
// launch, so none may be read through the non-coherent path there.
template <bool kStart>
__device__ __forceinline__ void pcg_phase(const Chain& f, const float* in, float* x, float* r,
                                          float* p, float* z, float* scal, float tol) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int c = static_cast<int>(cluster.block_rank());
  const int L = f.levels, m_root = f.m_root, n = f.n;
  const int rr = root_rows(m_root);
  const int active = m_root < kCluster ? m_root : kCluster;
  const bool own = c < active;
  const int R0 = rr << L;                       // level-0 rows a CTA owns
  float* bk = smem;
  float* xb[2] = {smem + level_offset(L, rr, L + 1),
                  smem + level_offset(L, rr, L + 1) + x_floats(L, rr)};
  float* broot = xb[1] + x_floats(L, rr);
  float* part = broot + 6 * m_root;             // [pHp, rz', b2, rz0] partials
  float* tot = part + 4;
  float* wsum = tot + 4;
  float cm[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) cm[k] = f.cmask != nullptr ? f.cmask[k] : 1.f;

  // this CTA's floats of the caller's vectors: [lo, hi)
  const int lo = own ? 6 * c * R0 : 0;
  int hi = own ? 6 * min((c + 1) * R0, n) : 0;
  hi = hi > lo ? hi : lo;

  float rz = 0.f;
  bool ok = true;
  if (kStart) {
    float s = 0.f;
    for (int i = lo + tid; i < hi; i += kChainThreads) {
      const float v = in[i];
      x[i] = 0.f;
      r[i] = v;
      bk[i - lo] = v;
      s += v * v;
    }
    s = block_sum(s, wsum);
    if (tid == 0) part[2] = s;
  } else {
    rz = scal[0];
    const float b2 = scal[1];
    float s = 0.f;
    for (int i = lo + tid; i < hi; i += kChainThreads) s += p[i] * in[i];
    s = block_sum(s, wsum);
    if (tid == 0) part[0] = s;
    cluster.sync();
    const float pHp = cluster_total(part, tot, 0);
    ok = (pHp > 1e-20f) && (rz > tol * (b2 + 1e-30f));
    const float alpha = ok ? rz / (pHp == 0.f ? 1.f : pHp) : 0.f;
    for (int i = lo + tid; i < hi; i += kChainThreads) {
      x[i] = __fadd_rn(x[i], __fmul_rn(alpha, p[i]));
      const float ri = __fsub_rn(r[i], __fmul_rn(alpha, in[i]));
      r[i] = ri;
      bk[i - lo] = ri;
    }
    if (c == 0 && tid == 0) scal[2] = ok ? 1.f : 0.f;
  }
  // rows past the caller's n read as zero (the pad to a power of two)
  if (own)
    for (int i = hi - lo + tid; i < 6 * R0; i += kChainThreads) bk[i] = 0.f;
  cluster.sync();

  // level-0 output (row, component i): z, or p = z0 at the start, masked,
  // and its term of rᵀz (bᵀz0)
  float dot = 0.f;
  auto emit = [&](int row, int i, float v) {
    if (row < n) {
      const float zv = v * cm[i];
      const int k = 6 * row + i;
      (kStart ? p : z)[k] = zv;
      dot += bk[k - lo] * zv;
    }
  };

  // forward: level l's vector to level l + 1's, the level-0 vector masked
  for (int l = 0; l < L; ++l) {
    const int Rn = rr << (L - l - 1);
    const float* bl = bk + level_offset(L, rr, l);
    float* bn = bk + level_offset(L, rr, l + 1);
    const float* prev =
        own && c > 0 ? cluster.map_shared_rank(bl, c - 1) + 6 * (2 * Rn - 1) : nullptr;
    const float* P1m = f.lv[l][1];
    const float* P2 = f.lv[l][2];
    if (own)
      for (int t = tid; t < 6 * Rn; t += kChainThreads) {
        const int jl = t / 6, i = t % 6;
        const long long q = (static_cast<long long>(c) * Rn + jl) * 36 + i * 6;
        const float* bm = jl > 0 ? bl + 6 * (2 * jl - 1) : prev;
        const float* bo = bl + 6 * (2 * jl + 1);
        float a = 0.f, cc = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          const float w = l == 0 ? cm[k] : 1.f;
          a += P1m[q + k] * (bm != nullptr ? bm[k] * w : 0.f);
          cc += P2[q + k] * (bo[k] * w);
        }
        bn[t] = bl[12 * jl + i] * (l == 0 ? cm[i] : 1.f) - a - cc;
      }
    cluster.sync();
  }

  // the root: gather its vector from the cluster, a warp per row of root_inv
  const int nr = 6 * m_root;
  const float* bL = bk + level_offset(L, rr, L);
  for (int k = tid; k < nr; k += kChainThreads) {
    const int rho = k / 6, q = rho / rr;
    float v = cluster.map_shared_rank(bL, q)[6 * (rho - q * rr) + k % 6];
    if (L == 0) v *= cm[k % 6];
    broot[k] = v;
  }
  __syncthreads();
  {
    float* xL = xb[L & 1];
    const int warp = tid / 32, lane = tid % 32;
    if (own)
      for (int w = warp; w < 6 * rr; w += kWarps) {
        const long long row = 6LL * c * rr + w;
        const float* ri = f.root_inv + row * nr;
        float s = 0.f;
        for (int k = lane; k < nr; k += 32) s += ri[k] * broot[k];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) {
          if (L > 0)
            xL[w] = s;
          else
            emit(static_cast<int>(row / 6), static_cast<int>(row % 6), s);
        }
      }
  }
  if (L > 0) cluster.sync();

  // back: level l + 1's x to level l's; level 0's is the output
  for (int l = L - 1; l >= 0; --l) {
    const int Rn = rr << (L - l - 1);
    const float* xc = xb[(l + 1) & 1];
    const float* next = own && c + 1 < active ? cluster.map_shared_rank(xc, c + 1) : nullptr;
    float* xf = xb[l & 1];
    const float* bl = bk + level_offset(L, rr, l);
    const float* Dinv = f.lv[l][0];
    const float* G1 = f.lv[l][3];
    const float* G2 = f.lv[l][4];
    if (own)
      for (int t = tid; t < 6 * Rn; t += kChainThreads) {
        const int jl = t / 6, i = t % 6;
        const int j = c * Rn + jl;
        const long long q = static_cast<long long>(j) * 36 + i * 6;
        const float* xj = xc + 6 * jl;
        const float* xj1 = jl + 1 < Rn ? xj + 6 : next;
        const float* bo = bl + 6 * (2 * jl + 1);
        float a = 0.f, g1 = 0.f, g2 = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          a += Dinv[q + k] * (bo[k] * (l == 0 ? cm[k] : 1.f));
          g1 += G1[q + k] * xj[k];
          g2 += G2[q + k] * (xj1 != nullptr ? xj1[k] : 0.f);
        }
        const float even = xj[i], odd = a - g1 - g2;
        if (l > 0) {
          xf[12 * jl + i] = even;
          xf[12 * jl + 6 + i] = odd;
        } else {
          emit(2 * j, i, even);
          emit(2 * j + 1, i, odd);
        }
      }
    if (l > 0) cluster.sync();
  }

  dot = block_sum(dot, wsum);
  if (tid == 0) part[kStart ? 3 : 1] = dot;
  cluster.sync();
  if (kStart) {
    const float rz0 = cluster_total(part, tot, 3), b2 = cluster_total(part, tot, 2);
    if (c == 0 && tid == 0) {
      scal[0] = rz0;
      scal[1] = b2;
      scal[2] = 1.f;
      scal[3] = rz0;
    }
  } else {
    const float rz_new = cluster_total(part, tot, 1);
    const float beta = ok ? rz_new / (rz == 0.f ? 1.f : rz) : 0.f;
    if (ok)
      for (int i = lo + tid; i < hi; i += kChainThreads)
        p[i] = __fadd_rn(z[i], __fmul_rn(beta, p[i]));
    if (c == 0 && tid == 0) scal[0] = ok ? rz_new : rz;
  }
  // no CTA leaves (or starts the next phase) while another may still read
  // its partials, and every CTA's p is written before the next Hp reads it
  cluster.sync();
}

// K34: one phase a launch.  Nothing else writes its vectors during the
// launch, so its parameters keep __restrict__ (pcg_phase, inlined, takes
// their no-alias facts with it).
template <bool kStart>
__global__ void __launch_bounds__(kChainThreads)
pcg_chain_kernel(Chain f, const float* __restrict__ in, float* __restrict__ x,
                 float* __restrict__ r, float* __restrict__ p, float* __restrict__ z,
                 float* __restrict__ scal, float tol) {
  pcg_phase<kStart>(f, in, x, r, p, z, scal, tol);
}

// The Gauss-Newton operator of one LM iteration (K2's arguments), the
// solve's incidence table, and K35's scratch in device memory: per table
// entry q (2E of them, each CTA writing only its own rows' entries) its
// edge's endpoints (fq, tq) and its Jᵢ, Jⱼ, W copied into 108 planes of 2E
// floats (jq), and the step's product yq = J_sideᵀ·W·u (6 planes of 2E).
struct Op {
  const float* Ji;       // (E, 6, 6)
  const float* Jj;
  const float* W;
  const int* e_from;     // (E,)
  const int* e_to;
  const float* damp;     // (n, 6)
  const float* free;     // (n,)
  const int* row_ptr;    // (n + 1,)
  const int* entries;    // 2e + side, each node's in table order
  int two_e;             // 2E: the stride of an entry plane
  int* fq;               // (2E,)
  int* tq;               // (2E,)
  float* jq;             // (108, 2E): Jᵢ | Jⱼ | W, row-major 6x6 each
  float* yq;             // (6, 2E)
};

// This CTA's level-0 rows [lo, hi) and their table entries [qa, qb); empty
// on a CTA that owns no root block.
struct Span {
  int lo, hi, qa, qb;
};

__device__ __forceinline__ Span own_span(const Chain& f, const Op& op) {
  const int c = static_cast<int>(cg::this_cluster().block_rank());
  const int rr = root_rows(f.m_root);
  const int active = f.m_root < kCluster ? f.m_root : kCluster;
  Span s{0, 0, 0, 0};
  if (c < active) {
    const int R0 = rr << f.levels;
    s.lo = min(c * R0, f.n);
    s.hi = min((c + 1) * R0, f.n);
    s.qa = op.row_ptr[s.lo];
    s.qb = op.row_ptr[s.hi];
  }
  return s;
}

// Once per launch (the operator does not change in the solve): each of
// this CTA's entries' edge copied from the (E, 6, 6) tables into the
// table-ordered planes, a thread an entry (float4 reads; coalesced writes).
// Only this CTA reads what it writes here.
__device__ __forceinline__ void gather_operator(const Chain& f, const Op& op) {
  const Span s = own_span(f, op);
  const int E2 = op.two_e;
  for (int q = s.qa + static_cast<int>(threadIdx.x); q < s.qb; q += kChainThreads) {
    const int e = op.entries[q] >> 1;
    op.fq[q] = op.e_from[e];
    op.tq[q] = op.e_to[e];
    const float* src[3] = {op.Ji + e * 36, op.Jj + e * 36, op.W + e * 36};
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src[m]) + k);
        float* dst = op.jq + (36 * m + 4 * k) * E2 + q;
        dst[0] = v.x;
        dst[E2] = v.y;
        dst[2 * E2] = v.z;
        dst[3 * E2] = v.w;
      }
  }
  __syncthreads();
}

// Entry q's term of its row: yq = J_sideᵀ·W·u, u = Jᵢ·vm[from] + Jⱼ·vm[to],
// vm = p·m·free.
__device__ __forceinline__ void entry_term(const Op& op, const float* p, const float cm[6],
                                           int q, float y[6]) {
  const int E2 = op.two_e;
  const int nf = op.fq[q], nt = op.tq[q];
  const bool to_side = op.entries[q] & 1;
  const float ff = __ldg(op.free + nf), ft = __ldg(op.free + nt);
  float vf[6], vt[6], u[6], Wu[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    vf[k] = p[nf * 6 + k] * cm[k] * ff;
    vt[k] = p[nt * 6 + k] * cm[k] * ft;
  }
  const float* A = op.jq + q;
  const float* B = A + 36 * E2;
  const float* C = B + 36 * E2;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      a += A[(i * 6 + j) * E2] * vf[j];
      b += B[(i * 6 + j) * E2] * vt[j];
    }
    u[i] = a + b;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float c = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) c += C[(i * 6 + j) * E2] * u[j];
    Wu[i] = c;
  }
  const float* S = to_side ? B : A;      // this row's side of the edge
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float c = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) c += S[(j * 6 + i) * E2] * Wu[j];
    y[i] = c;
  }
}

// y = H(p·m)·m on this CTA's level-0 rows, into hp, as K2's operator: per
// table entry its term (entry_term; a thread an entry, its planes read
// coalesced), then per row y = ((Σ_q yq in table order) +
// damp·vm)·free·m (a thread a row): the product without atomics, each
// edge's u computed at both endpoints.  p is read with ordinary loads,
// after the previous phase's closing cluster barrier.
__device__ __forceinline__ void hvp_rows(const Chain& f, const Op& op, const float* p,
                                         float* hp) {
  const Span s = own_span(f, op);
  const int E2 = op.two_e;
  float cm[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) cm[k] = f.cmask != nullptr ? f.cmask[k] : 1.f;
  for (int q = s.qa + static_cast<int>(threadIdx.x); q < s.qb; q += kChainThreads) {
    float y[6];
    entry_term(op, p, cm, q, y);
#pragma unroll
    for (int i = 0; i < 6; ++i) op.yq[i * E2 + q] = y[i];
  }
  __syncthreads();
  for (int row = s.lo + static_cast<int>(threadIdx.x); row < s.hi; row += kChainThreads) {
    const int q0 = op.row_ptr[row], q1 = op.row_ptr[row + 1];
    const float fr = __ldg(op.free + row);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float y = 0.f;
      for (int q = q0; q < q1; ++q) y += op.yq[i * E2 + q];
      const float vm = p[row * 6 + i] * cm[i] * fr;
      hp[row * 6 + i] = ((y + __ldg(op.damp + row * 6 + i) * vm) * fr) * cm[i];
    }
  }
}

// K35: a whole PCG solve in one launch: the operator gathered into table
// order, the start, then each step's Hp = H·p (hvp_rows) and K34's step.
// The step's dots, axpys and stall logic are K34's own code; Hp and p stay
// in device memory (L2), so a step adds two CTA barriers and no cluster
// barrier to K34's.
__global__ void __launch_bounds__(kChainThreads)
pcg_solve_kernel(Chain f, Op op, const float* b, float* x, float* r, float* p, float* z,
                 float* hp, float* scal, float tol, int steps) {
  gather_operator(f, op);
  pcg_phase<true>(f, b, x, r, p, nullptr, scal, 0.f);
  for (int s = 0; s < steps; ++s) {
    hvp_rows(f, op, p, hp);
    __syncthreads();
    pcg_phase<false>(f, hp, x, r, p, z, scal, tol);
  }
}

cudaLaunchConfig_t cluster_config(size_t smem, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, 1, 1);
  cfg.blockDim = dim3(kChainThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Once per device: the three kernels may take a whole CTA's shared memory,
// and one cluster of 8 such CTAs fits on the card.
int prepare() {
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < kMaxDevices && ready[dev]) return 0;
  const void* kernels[3] = {reinterpret_cast<const void*>(pcg_chain_kernel<true>),
                            reinterpret_cast<const void*>(pcg_chain_kernel<false>),
                            reinterpret_cast<const void*>(pcg_solve_kernel)};
  for (const void* k : kernels) {
    err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(kMaxSmemBytes, nullptr, &attr);
  int clusters = 0;
  for (int k = 1; k < 3; ++k) {
    err = cudaOccupancyMaxActiveClusters(&clusters, kernels[k], &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  }
  if (dev < kMaxDevices) ready[dev] = true;
  return 0;
}

// The factor from its host table of pointers: 5 per level (Dinv_o, P1m,
// P2, G1, G2), then root_inv.  Refuses shapes the kernel cannot take.
int make_chain(const void* table, int levels, int m_root, int n, const float* cmask,
               Chain* f) {
  if (levels < 0 || levels > kMaxLevels || m_root < 1 || (m_root & (m_root - 1)) != 0 ||
      n < 1 || n > (static_cast<long long>(m_root) << levels) ||
      4 * smem_floats(levels, m_root) > kMaxSmemBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const* ptrs = static_cast<const float* const*>(table);
  *f = Chain{};
  for (int l = 0; l < levels; ++l)
    for (int k = 0; k < 5; ++k) f->lv[l][k] = ptrs[5 * l + k];
  f->root_inv = ptrs[5 * levels];
  f->cmask = cmask;
  f->levels = levels;
  f->m_root = m_root;
  f->n = n;
  return 0;
}

template <bool kStart>
int launch(const void* table, int levels, int m_root, int n, const float* cmask,
           const float* in, float* x, float* r, float* p, float* z, float* scal, float tol,
           void* stream) {
  Chain f;
  int err = make_chain(table, levels, m_root, n, cmask, &f);
  if (err == 0) err = prepare();
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(4 * smem_floats(levels, m_root),
                                                static_cast<cudaStream_t>(stream), &attr);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, pcg_chain_kernel<kStart>, f, in, x, r, p, z,
                                             scal, tol));
}

}  // namespace

// A single solve: vectors (n, 6), scal (1, 4); the factor as a host table
// (see make_chain) of a chain of m_root << levels rows, at most 232,448
// bytes of shared memory a CTA (smem_floats); cmask nullptr or 6 floats.

// x, r, p and scal from b: z0 = M⁻¹b in p.
extern "C" int uz_pcg_chain_start(const void* table, int levels, int m_root, int n,
                                  const float* cmask, const float* b, float* x, float* r,
                                  float* p, float* scal, void* stream) {
  return launch<true>(table, levels, m_root, n, cmask, b, x, r, p, nullptr, scal, 0.f, stream);
}

// One step after Hp = H·p: x, r, p and scal in place, z = M⁻¹r (scratch).
extern "C" int uz_pcg_chain_step(const float* Hp, float tol, const void* table, int levels,
                                 int m_root, int n, const float* cmask, float* x, float* r,
                                 float* p, float* z, float* scal, void* stream) {
  return launch<false>(table, levels, m_root, n, cmask, Hp, x, r, p, z, scal, tol, stream);
}

// K35: the start and `steps` steps, each with its Hp = H(p·m)·m from the
// operator (Ji, Jj, W (E, 6, 6); e_from, e_to (E,); damp (n, 6); free (n,))
// summed over the incidence table (row_ptr (n + 1,), entries (2E,)); x, r,
// p, scal as K34 leaves them; z and hp (n, 6), iscratch (2·2E ints) and
// fscratch (114·2E floats) scratch.
extern "C" int uz_pcg_chain_solve(const void* table, int levels, int m_root, int n,
                                  const float* cmask, const float* Ji, const float* Jj,
                                  const float* W, const int* e_from, const int* e_to,
                                  const float* damp, const float* free, const int* row_ptr,
                                  const int* entries, int n_edges, const float* b, int steps,
                                  float tol, float* x, float* r, float* p, float* z, float* hp,
                                  float* scal, int* iscratch, float* fscratch, void* stream) {
  Chain f;
  int err = steps < 0 || n_edges < 0 ? static_cast<int>(cudaErrorInvalidValue)
                                     : make_chain(table, levels, m_root, n, cmask, &f);
  if (err == 0) err = prepare();
  if (err != 0) return err;
  const long long E2 = 2LL * n_edges;
  const Op op{Ji, Jj, W, e_from, e_to, damp, free, row_ptr, entries, static_cast<int>(E2),
              iscratch, iscratch + E2, fscratch, fscratch + 108 * E2};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(4 * smem_floats(levels, m_root),
                                                static_cast<cudaStream_t>(stream), &attr);
  return static_cast<int>(cudaLaunchKernelEx(&cfg, pcg_solve_kernel, f, op, b, x, r, p, z, hp,
                                             scal, tol, steps));
}
