// K9 chain_factor: the cyclic-reduction factor of the chain preconditioner,
// in one cooperative launch.
//
// Replaces uzliti_slam_tpu/graph/tridiag.py:block_tridiag_factor (:145-195)
// with its helpers _inv3/_inv6 (:22-72), _pad_pow2 (:75-85) and
// _dense_root_inverse (:112-142), and the damped diagonal that
// uzliti_slam_tpu/graph/solver.py builds before it (build_pack: free ?
// Hb + diag(damp) : I, plus the planar lift, :867-868).  The input is the
// block-tridiagonal chain matrix, D (n, 6, 6) on the diagonal and
// U[i] = A[i, i+1]; with `damp` given, D is Hb and each block read is
// free ? Hb + diag(damp) : I, then + diag(lift) when a lift is given, all
// in float32 as the solver's eager version computed it.
//
// Reduction level, for every surviving odd block j of m = 2·half blocks,
// with De = D[2j], Do = D[2j+1], Ueo = U[2j], Uoe = U[2j+1], and the
// previous odd pair (Do, Uoe)[j-1] (identity and zero at j = 0, the
// reference's roll-and-zero):
//   Dinv_o = inv6(Do)            (3x3 Schur over adjugates, determinant
//                                 floor 1e-30, as :47-72, :35)
//   P1m = Uoe[j-1]ᵀ·inv6(Do[j-1])   P2 = Ueo·Dinv_o
//   G1  = Dinv_o·Ueoᵀ               G2 = Dinv_o·Uoe
//   newD = De - P1m·Uoe[j-1] - P2·Ueoᵀ     newU = -P2·Uoe (0 at j = half-1)
// The chain's levels take inv6 with the reference's 1e-8·I floor.  The
// pad to a power of two and the zeroed U[n-1] are read, not copied: rows at
// or past n_valid read as D = I, U = 0, and U[n_valid-1] reads as 0.  36
// threads hold one odd block (one per 6x6 entry), eight blocks a CTA, the
// operands in shared memory; inv6(Do) and inv6(Do[j-1]) run side by side,
// 18 threads each, so a level needs no second phase.
//
// The root: the inverse of A = tridiag(Uᵀ, D, U) + 1e-8·I of the m <= 64
// blocks the levels leave, which the reference inverts by pivoted LU.  The
// same cyclic reduction continues inside it, exactly and without the
// floor: 1e-8 is added to its diagonal once, then log2(m) levels leave one
// block.  The root's diagonal blocks carry float32 rounding that makes them
// slightly unsymmetric, so these levels keep the lower blocks L[i] =
// A[i+1, i] (Uᵀ at the start) apart from the upper ones:
//   newD = De - Ueo·Do⁻¹·Leo - L[2j-1]·Do[j-1]⁻¹·U[2j-1]
//   newU = -Ueo·Do⁻¹·Uoe      newL = -Loe·Do⁻¹·Leo
// and store Do⁻¹, A1 = Do⁻¹·Leo, A2 = Do⁻¹·Uoe, B1 = Ueo·Do⁻¹, B2 =
// Loe·Do⁻¹.  The one block left is inverted, and the inverse is rebuilt
// level by level back up, each level's X from the next one's Y = S⁻¹ (S
// the even blocks' Schur complement; A's odd blocks are decoupled):
//   X[2a, 2b]     = Y[a, b]
//   X[2j+1, 2b]   = -(A1[j]·Y[j, b] + A2[j]·Y[j+1, b])          (X_OE)
//   X[2a, 2k+1]   = -(Y[a, k]·B1[k] + Y[a, k+1]·B2[k])
//   X[2j+1, 2k+1] = δjk·Do⁻¹[j] - X_OE[j, k]·B1[k] - X_OE[j, k+1]·B2[k]
// A CTA takes one instance's block rows 2j and 2j+1 of a level: Y's block
// rows j and j+1, the level's B1, B2 and the block's A1, A2, Do⁻¹ staged in
// shared memory, X_OE[j, ·] formed there once, every output from shared
// operands (a row a thread with its ~240 operands read from L2 was bound
// by those loads).  m = 1 is exactly _inv6(D_0).
//
// One launch: a cooperative grid, sized by occupancy and by the largest
// phase, runs the chain's levels, the root's levels, the one-block
// inverse and the root's expansions as phases separated by grid.sync():
// L + 2·log2(m) + 1 phases, each a grid-stride loop over the work of every
// instance, all instances at the same phase (the expansions' buffers are
// laid out by the phase's size).  The phases' shared memory is one static
// union (46,944 bytes); the same union in dynamic shared memory faulted
// with a misaligned address on the card, not understood.
//
// Refresh flag: when `need` is given the kernel reads it first and returns
// at once where no instance is to be built (every CTA reads the same flags,
// so all return together before the first barrier), so a solve can hold
// one factor and rebuild it in place only when its device-side refresh
// decision says so; `builds` (when given) counts the factors built.
//
// Precision: every level and the root are computed in float64, and only the
// factor handed to the apply (K3, K34, K35) is stored in float32.  Each
// level's newD = De - P1m·Uoe - P2·Ueoᵀ cancels, so a float32 reduction
// loses about a bit per level: on the 100k-node solve's first iteration (11
// levels) the float32 factor is 2.6e-4 of its largest entry away from the
// float64 one.  The carried newD, newU, the root's levels and its
// expansions are float64 scratch; the first level (or the root when there is
// no level) reads the caller's float32 blocks.
//
// The fleet (kernels/ops.chain_factor with batch > 1, for
// parallel/sharded.py:optimize_batch): each instance is its own chain with
// its own levels and root; a phase's work items run over all instances
// (odd block jg belongs to instance jg / half), and `need` is a (B,) flag
// array, since each instance refreshes its own factor under the early exit.
//
// What bounds it on the card: the chain of dependent phases — at 1k
// 4.3-6.0 µs a level, 2.3-9.1 µs an expansion (chip_smoke.py's
// factor_split sweep; a 6x6 inverse pair in one CTA and a grid.sync are
// each ~1 µs of it, scripts/k9_phase_bench.cu) — not the bytes (each
// level's 10 blocks of 144 bytes per odd block) nor the float64
// operations.  A fleet of 4096 roots holds only 2 CTAs an SM (96
// registers) in the cooperative grid, where the separate launches it
// replaces kept 6 resident; its levels run ~60 rounds of that latency.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace {

using real = double;               // the factor's arithmetic

constexpr int kEntries = 36;      // threads of one group: one per 6x6 entry
constexpr int kGroups = 8;        // odd blocks per CTA
constexpr int kBlockThreads = kEntries * kGroups;
constexpr int kMaxLevels = 24;    // chain levels (2^24 · 64 blocks)
constexpr int kRootMax = 64;      // blocks of the largest root
constexpr int kMaxSub = 6;        // log2(kRootMax)
constexpr int kMinBlocks = 2;     // resident CTAs an SM (the register budget)

// max(|x|, 1e-30) floor of the reference's 3x3 determinant, sign kept.
__device__ __forceinline__ real det_floor(real det) {
  return fabs(det) < 1e-30 ? 1e-30 : det;
}

// Entry u (0..8) of the closed-form inverse of the 3x3 matrix M (row stride
// ld): adjugate over determinant, as tridiag.py:_inv3.  Every thread forms
// all nine cofactors and selects its own, so the nine threads of a warp
// that call it do not diverge around the division.
__device__ __forceinline__ real inv3_entry(const real* M, int ld, int u) {
  const real a = M[0], b = M[1], c = M[2];
  const real d = M[ld], e = M[ld + 1], f = M[ld + 2];
  const real g = M[2 * ld], h = M[2 * ld + 1], i = M[2 * ld + 2];
  const real A = e * i - f * h;
  const real B = -(d * i - f * g);
  const real C = d * h - e * g;
  const real det = det_floor(a * A + b * B + c * C);
  real v = A;
  v = u == 1 ? -(b * i - c * h) : v;
  v = u == 2 ? b * f - c * e : v;
  v = u == 3 ? B : v;
  v = u == 4 ? a * i - c * g : v;
  v = u == 5 ? -(a * f - c * d) : v;
  v = u == 6 ? C : v;
  v = u == 7 ? -(a * h - b * g) : v;
  v = u == 8 ? a * e - b * d : v;
  return v / det;
}

// (X·Y)[r][c] for 3x3 matrices with row strides lx, ly.
__device__ __forceinline__ real mm3(const real* X, int lx, const real* Y, int ly, int r, int c) {
  return X[r * lx] * Y[c] + X[r * lx + 1] * Y[ly + c] + X[r * lx + 2] * Y[2 * ly + c];
}

// Scratch of one 6x6 inverse: the reference's intermediates.
struct Inv6Scratch {
  real M[36];                           // input + fl·I
  real Ainv[9], AinvB[9], CAinv[9], S[9], Sinv[9], W[9];
};

// out0 = (M0 + fl·I)⁻¹ and out1 = (M1 + fl·I)⁻¹ by the 2x2-block Schur
// complement over 3x3 blocks (tridiag.py:_inv6), side by side: threads
// t = 0..17 of the group invert M0, t = 18..35 invert M1.  Called by all
// threads of the CTA together (the barriers are CTA-wide); threads past
// the group's 36 idle.
__device__ void inv6_pair(const real* M0, const real* M1, real fl, real* out0, real* out1,
                          Inv6Scratch& s0, Inv6Scratch& s1, int t) {
  const bool on = t < kEntries;
  const int u = t % 18;
  const real* M = t < 18 ? M0 : M1;
  real* out = t < 18 ? out0 : out1;
  Inv6Scratch& s = t < 18 ? s0 : s1;
  if (on) {
    s.M[u] = M[u] + ((u / 6 == u % 6) ? fl : 0.0);
    s.M[u + 18] = M[u + 18] + (((u + 18) / 6 == (u + 18) % 6) ? fl : 0.0);
  }
  __syncthreads();
  const int r = (u % 9) / 3, c = u % 3;
  if (on && u < 9) s.Ainv[u] = inv3_entry(s.M, 6, u);                       // A⁻¹
  __syncthreads();
  if (on && u < 9) s.AinvB[u] = mm3(s.Ainv, 3, s.M + 3, 6, r, c);           // A⁻¹B
  else if (on) s.CAinv[u - 9] = mm3(s.M + 18, 6, s.Ainv, 3, r, c);          // CA⁻¹
  __syncthreads();
  if (on && u < 9) s.S[u] = s.M[21 + r * 6 + c] - mm3(s.M + 18, 6, s.AinvB, 3, r, c);
  __syncthreads();
  if (on && u < 9) s.Sinv[u] = inv3_entry(s.S, 3, u);
  __syncthreads();
  if (on && u < 9) s.W[u] = mm3(s.AinvB, 3, s.Sinv, 3, r, c);               // A⁻¹B·S⁻¹
  else if (on) out[(3 + r) * 6 + c] = -mm3(s.Sinv, 3, s.CAinv, 3, r, c);    // BL
  __syncthreads();
  if (on && u < 9) {
    out[r * 6 + c] = s.Ainv[u] + mm3(s.W, 3, s.CAinv, 3, r, c);             // TL
  } else if (on) {
    out[r * 6 + 3 + c] = -s.W[u - 9];                                        // TR
    out[(3 + r) * 6 + 3 + c] = s.Sinv[u - 9];                                // BR
  }
  __syncthreads();
}

// Entry (r, c) of X·Y, Xᵀ·Y and X·Yᵀ for 6x6 row-major blocks.
__device__ __forceinline__ real mm6(const real* X, const real* Y, int r, int c) {
  real s = 0.0;
#pragma unroll
  for (int k = 0; k < 6; ++k) s += X[r * 6 + k] * Y[k * 6 + c];
  return s;
}
__device__ __forceinline__ real mtm6(const real* X, const real* Y, int r, int c) {
  real s = 0.0;
#pragma unroll
  for (int k = 0; k < 6; ++k) s += X[k * 6 + r] * Y[k * 6 + c];
  return s;
}
__device__ __forceinline__ real mmt6(const real* X, const real* Y, int r, int c) {
  real s = 0.0;
#pragma unroll
  for (int k = 0; k < 6; ++k) s += X[r * 6 + k] * Y[c * 6 + k];
  return s;
}

// Where a level reads its blocks: the caller's float32 input (with the
// damped diagonal built on the fly) or the previous level's float64 newD,
// newU.  Instance b's rows start at b·rows; rows at or past n_valid read as
// D = I, U = 0; diag_add is added to every diagonal entry of D (the root's
// 1e-8·I).
struct Src {
  const float* D;
  const float* U;
  const float* damp;     // nullptr: D is the matrix itself
  const float* free;
  const float* lift;     // (6,) diagonal added after the damping, or nullptr
  const real* dD;        // float64 source (then D, U unused)
  const real* dU;
  const real* dL;        // float64 lower blocks (the root's); nullptr: Uᵀ
  int rows, n_valid;
  real diag_add;
};

__device__ __forceinline__ real load_d(const Src& s, long long inst, int row, int t) {
  const int r = t / 6;
  const bool diag = r == t % 6;
  real v;
  if (row >= s.n_valid) {
    v = diag ? 1.0 : 0.0;
  } else if (s.dD != nullptr) {
    v = s.dD[(inst * s.rows + row) * 36 + t];
  } else {
    const long long k = inst * s.rows + row;
    float x = s.D[k * 36 + t];
    if (s.damp != nullptr) {
      x = x + (diag ? s.damp[k * 6 + r] : 0.f);      // Hb + diag_embed(damp)
      if (!(s.free[k] > 0.f)) x = diag ? 1.f : 0.f;   // where(free > 0, ·, I)
      if (s.lift != nullptr) x = x + (diag ? s.lift[r] : 0.f);
    }
    v = static_cast<real>(x);
  }
  return diag ? v + s.diag_add : v;
}

__device__ __forceinline__ real load_u(const Src& s, long long inst, int row, int t) {
  if (row >= s.n_valid - 1) return 0.0;
  const long long k = (inst * s.rows + row) * 36 + t;
  return s.dD != nullptr ? s.dU[k] : static_cast<real>(s.U[k]);
}

// L[row] = A[row+1, row]: the root's own lower blocks, or U[row]ᵀ.
__device__ __forceinline__ real load_l(const Src& s, long long inst, int row, int t) {
  if (s.dL == nullptr) return load_u(s, inst, row, (t % 6) * 6 + t / 6);
  if (row >= s.n_valid - 1) return 0.0;
  return s.dL[(inst * s.rows + row) * 36 + t];
}

struct LevelGroup {
  real De[36], Do[36], Dom[36], Ueo[36], Uoe[36], Uoem[36];
  real Di[36], Dim[36], P1m[36], P2[36];
  Inv6Scratch s0, s1;
};

// A root level's operands: the chain's, the lower blocks, three products.
struct RootGroup {
  real De[36], Do[36], Dom[36], Ueo[36], Uoe[36], Uoem[36], Leo[36], Loe[36], Loem[36];
  real Di[36], Dim[36], B1[36], A1[36], T[36];
  Inv6Scratch s0, s1;
};

// An expansion's staging of the largest root (expand_phase).
constexpr int kExpandDoubles = 180 * (kRootMax / 2) + 108;

union GroupMem {
  LevelGroup level[kGroups];
  RootGroup root[kGroups];
  real expand[kExpandDoubles];
};

// A level's outputs: (Dinv_o, P1m, P2, G1, G2), each (B, half, 6, 6), in
// float32 (the chain's levels) or float64 (the root's), and the next
// level's newD, newU (B, half, 6, 6) in float64.
struct LevelOut {
  void* m[5];
  real* newD;
  real* newU;
  real* newL;     // the root's levels only
};

// Is instance `inst`'s factor to be built?  (need: nullptr = always.)
__device__ __forceinline__ bool wanted(const unsigned char* need, long long inst) {
  return need == nullptr || need[inst] != 0;
}

template <typename OutT>
__device__ __forceinline__ void put(void* base, long long o, real v) {
  static_cast<OutT*>(base)[o] = static_cast<OutT>(v);
}

// One reduction level over all instances: odd block jg of B·half belongs to
// instance jg / half.  All threads of the CTA run the same rounds.
template <typename OutT>
__device__ void level_phase(const Src& src, int half, int n_batch, real fl, const LevelOut& out,
                            const unsigned char* need, LevelGroup* groups) {
  const long long total = static_cast<long long>(half) * n_batch;
  const int t = threadIdx.x % kEntries, g = threadIdx.x / kEntries;
  const int r = t / 6, c = t % 6;
  const real eye = (r == c) ? 1.0 : 0.0;
  LevelGroup& G = groups[g];
  for (long long base = static_cast<long long>(blockIdx.x) * kGroups; base < total;
       base += static_cast<long long>(gridDim.x) * kGroups) {
    const long long jg = base + g;
    const long long inst = jg / half;
    const int j = static_cast<int>(jg % half);
    const bool live = jg < total && wanted(need, inst);
    if (!__syncthreads_or(live)) continue;
    if (live) {
      G.De[t] = load_d(src, inst, 2 * j, t);
      G.Do[t] = load_d(src, inst, 2 * j + 1, t);
      G.Ueo[t] = load_u(src, inst, 2 * j, t);
      G.Uoe[t] = load_u(src, inst, 2 * j + 1, t);
      G.Dom[t] = j > 0 ? load_d(src, inst, 2 * j - 1, t) : eye;
      G.Uoem[t] = j > 0 ? load_u(src, inst, 2 * j - 1, t) : 0.0;
    } else {   // idle group: well-defined operands, nothing written
      G.De[t] = G.Do[t] = G.Dom[t] = eye;
      G.Ueo[t] = G.Uoe[t] = G.Uoem[t] = 0.0;
    }
    __syncthreads();
    inv6_pair(G.Do, G.Dom, fl, G.Di, G.Dim, G.s0, G.s1, t);
    if (j == 0) G.Dim[t] = eye;      // roll-and-set-identity at block 0
    __syncthreads();
    const real p1m = mtm6(G.Uoem, G.Dim, r, c);
    const real p2 = mm6(G.Ueo, G.Di, r, c);
    G.P1m[t] = p1m;
    G.P2[t] = p2;
    if (live) {
      const long long o = jg * 36 + t;
      put<OutT>(out.m[0], o, G.Di[t]);
      put<OutT>(out.m[1], o, p1m);
      put<OutT>(out.m[2], o, p2);
      put<OutT>(out.m[3], o, mmt6(G.Di, G.Ueo, r, c));
      put<OutT>(out.m[4], o, mm6(G.Di, G.Uoe, r, c));
    }
    __syncthreads();
    if (live) {
      const long long o = jg * 36 + t;
      out.newD[o] = G.De[t] - mm6(G.P1m, G.Uoem, r, c) - mmt6(G.P2, G.Ueo, r, c);
      out.newU[o] = j == half - 1 ? 0.0 : -mm6(G.P2, G.Uoe, r, c);
    }
  }
}

// One odd block j of one root level of instance `inst` (no floor: the 1e-8
// is in the source), the lower blocks apart from the upper ones: outputs
// (Do⁻¹, A1, A2, B1, B2) and newD, newU, newL, all float64.  Called by all
// threads of the CTA together; group g takes j, `live` where it exists.
__device__ void root_level_item(const Src& src, int half, long long inst, int j, bool live,
                                const LevelOut& out, RootGroup& G) {
  const int t = threadIdx.x % kEntries;
  const int r = t / 6, c = t % 6;
  const real eye = (r == c) ? 1.0 : 0.0;
  if (live) {
    G.De[t] = load_d(src, inst, 2 * j, t);
    G.Do[t] = load_d(src, inst, 2 * j + 1, t);
    G.Ueo[t] = load_u(src, inst, 2 * j, t);
    G.Uoe[t] = load_u(src, inst, 2 * j + 1, t);
    G.Leo[t] = load_l(src, inst, 2 * j, t);
    G.Loe[t] = load_l(src, inst, 2 * j + 1, t);
    G.Dom[t] = j > 0 ? load_d(src, inst, 2 * j - 1, t) : eye;
    G.Uoem[t] = j > 0 ? load_u(src, inst, 2 * j - 1, t) : 0.0;
    G.Loem[t] = j > 0 ? load_l(src, inst, 2 * j - 1, t) : 0.0;
  } else {
    G.De[t] = G.Do[t] = G.Dom[t] = eye;
    G.Ueo[t] = G.Uoe[t] = G.Uoem[t] = G.Leo[t] = G.Loe[t] = G.Loem[t] = 0.0;
  }
  __syncthreads();
  inv6_pair(G.Do, G.Dom, 0.0, G.Di, G.Dim, G.s0, G.s1, t);
  const real b1 = mm6(G.Ueo, G.Di, r, c);
  const real a1 = mm6(G.Di, G.Leo, r, c);
  G.B1[t] = b1;
  G.A1[t] = a1;
  G.T[t] = mm6(G.Dim, G.Uoem, r, c);        // Do[j-1]⁻¹·U[2j-1] (0 at j = 0)
  const long long o = (inst * half + j) * 36 + t;
  if (live) {
    put<real>(out.m[0], o, G.Di[t]);
    put<real>(out.m[1], o, a1);
    put<real>(out.m[2], o, mm6(G.Di, G.Uoe, r, c));
    put<real>(out.m[3], o, b1);
    put<real>(out.m[4], o, mm6(G.Loe, G.Di, r, c));
  }
  __syncthreads();
  if (live) {
    const bool last = j == half - 1;
    out.newD[o] = G.De[t] - mm6(G.B1, G.Leo, r, c) - mm6(G.Loem, G.T, r, c);
    out.newU[o] = last ? 0.0 : -mm6(G.B1, G.Uoe, r, c);
    out.newL[o] = last ? 0.0 : -mm6(G.Loe, G.A1, r, c);
  }
}

// One expansion: X (B, 6·2k, 6·2k) from Y (B, 6k, 6k) and the root level's
// (Do⁻¹, A1, A2, B1, B2) (B, k, 6, 6), staged in `sm` (180·k + 108 doubles).  A task is one instance's block rows
// 2j and 2j+1, a CTA at a time: Y's block rows j and j+1, every B1, B2 and
// the odd block's A1, A2, Do⁻¹ staged in shared memory, X_OE[j, ·] formed
// there once, then both output rows written (the even row from Y, the odd
// from X_OE), every operand read from shared memory.
template <typename OutT>
__device__ void expand_phase(const real* __restrict__ Y, int k, const LevelOut& lv, int n_batch,
                             OutT* __restrict__ X, const unsigned char* need, real* sm) {
  const int ms = 2 * k, ldy = 6 * k, ldx = 6 * ms;
  real* Y0 = sm;               // Y[j, ·] rows    (6, 6k)
  real* Y1 = Y0 + 36 * k;      // Y[j+1, ·] rows  (6, 6k), 0 past the last
  real* XOE = Y1 + 36 * k;     // X_OE[j, ·] rows (6, 6k)
  real* B1 = XOE + 36 * k;     // (k, 6, 6)
  real* B2 = B1 + 36 * k;
  real* A1 = B2 + 36 * k;      // (6, 6) of block j
  real* A2 = A1 + 36;
  real* Di = A2 + 36;
  const int tid = threadIdx.x;
  const long long tasks = static_cast<long long>(n_batch) * k;
  for (long long task = blockIdx.x; task < tasks; task += gridDim.x) {
    const long long inst = task / k;
    const int j = static_cast<int>(task % k);
    if (!wanted(need, inst)) continue;                  // the same in the whole CTA
    const real* Yi = Y + inst * 36LL * k * k;
    const long long lo = inst * 36LL * k;               // the level's blocks of inst
    for (int e = tid; e < 36 * k; e += kBlockThreads) {
      const int q = e / ldy, col = e % ldy;
      Y0[e] = Yi[(6 * j + q) * ldy + col];
      Y1[e] = j + 1 < k ? Yi[(6 * (j + 1) + q) * ldy + col] : 0.0;
      B1[e] = static_cast<const real*>(lv.m[3])[lo + e];
      B2[e] = static_cast<const real*>(lv.m[4])[lo + e];
    }
    if (tid < 36) {
      A1[tid] = static_cast<const real*>(lv.m[1])[lo + 36 * j + tid];
      A2[tid] = static_cast<const real*>(lv.m[2])[lo + 36 * j + tid];
      Di[tid] = static_cast<const real*>(lv.m[0])[lo + 36 * j + tid];
    }
    __syncthreads();
    // X_OE[j, b] = -(A1·Y[j, b] + A2·Y[j+1, b]), row q, column col of 6k
    for (int e = tid; e < 36 * k; e += kBlockThreads) {
      const int q = e / ldy, col = e % ldy;
      real acc = 0.0;
#pragma unroll
      for (int p = 0; p < 6; ++p) acc += A1[q * 6 + p] * Y0[p * ldy + col];
#pragma unroll
      for (int p = 0; p < 6; ++p) acc += A2[q * 6 + p] * Y1[p * ldy + col];
      XOE[e] = -acc;
    }
    __syncthreads();
    // rows 6·(2j) .. 6·(2j+2) of X: the even block row from Y[j, ·], the
    // odd from X_OE[j, ·]; column block l = 2b (copy) or 2kk + 1 (times B1,
    // B2 of kk)
    OutT* Xi = X + inst * static_cast<long long>(ldx) * ldx;
    for (int e = tid; e < 12 * ldx; e += kBlockThreads) {
      const int r = e / ldx, colx = e % ldx;
      const int l = colx / 6, c = colx % 6, q = r % 6;
      const real* src = r < 6 ? Y0 : XOE;               // row q of Y[j, ·] or X_OE[j, ·]
      real v;
      if (l % 2 == 0) {
        v = src[q * ldy + 6 * (l / 2) + c];
      } else {
        const int kk = l / 2;
        real acc = 0.0;
#pragma unroll
        for (int p = 0; p < 6; ++p) acc += src[q * ldy + 6 * kk + p] * B1[kk * 36 + p * 6 + c];
        if (kk + 1 < k) {
#pragma unroll
          for (int p = 0; p < 6; ++p)
            acc += src[q * ldy + 6 * (kk + 1) + p] * B2[kk * 36 + p * 6 + c];
        }
        v = (r >= 6 && kk == j ? Di[q * 6 + c] : 0.0) - acc;
      }
      Xi[static_cast<long long>(6 * (2 * j) + r) * ldx + colx] = static_cast<OutT>(v);
    }
    __syncthreads();                                    // the staging is rewritten next
  }
}

struct Plan {
  Src in;                           // the caller's blocks
  int n_batch, n_levels, m, n_sub;
  int halves[kMaxLevels];
  LevelOut chain[kMaxLevels];       // float32 factor, float64 newD/newU
  LevelOut root[kMaxSub];           // float64 root levels
  real* ybuf[2];                    // float64 expansions, ping-pong
  float* root_inv;                  // (B, 6m, 6m)
  const unsigned char* need;
  int* builds;
  int phase_limit;                  // phases to run (a timing aid; all by default)
};

__device__ __forceinline__ Src from_level(const LevelOut& lv, int rows, real diag_add) {
  Src s{};
  s.dD = lv.newD;
  s.dU = lv.newU;
  s.dL = lv.newL;
  s.rows = rows;
  s.n_valid = rows;
  s.diag_add = diag_add;
  return s;
}

// One root level over all instances, a group an odd block.
__device__ void root_level_phase(const Src& src, int half, int n_batch, const LevelOut& out,
                                 const unsigned char* need, RootGroup* groups) {
  const long long total = static_cast<long long>(half) * n_batch;
  const int g = threadIdx.x / kEntries;
  for (long long base = static_cast<long long>(blockIdx.x) * kGroups; base < total;
       base += static_cast<long long>(gridDim.x) * kGroups) {
    const long long jg = base + g;
    const bool live = jg < total && wanted(need, jg / half);
    if (!__syncthreads_or(live)) continue;
    root_level_item(src, half, jg / half, static_cast<int>(jg % half), live, out, groups[g]);
  }
}

// The one block each instance's root reduces to, inverted (the 1e-8 is in
// the source): the float32 root when m = 1, else the expansions' start.
// Counts the factors built.
__device__ void base_phase(const Plan& P, const Src& src, LevelGroup* groups) {
  const int t = threadIdx.x % kEntries, g = threadIdx.x / kEntries;
  LevelGroup& G = groups[g];
  for (long long base = static_cast<long long>(blockIdx.x) * kGroups; base < P.n_batch;
       base += static_cast<long long>(gridDim.x) * kGroups) {
    const long long inst = base + g;
    const bool live = inst < P.n_batch && wanted(P.need, inst);
    if (!__syncthreads_or(live)) continue;
    G.Do[t] = live ? load_d(src, inst, 0, t) : ((t / 6 == t % 6) ? 1.0 : 0.0);
    __syncthreads();
    inv6_pair(G.Do, G.Do, 0.0, G.Di, G.Dim, G.s0, G.s1, t);
    if (live) {
      if (P.n_sub == 0) P.root_inv[inst * 36 + t] = static_cast<float>(G.Di[t]);
      else P.ybuf[0][inst * 36 + t] = G.Di[t];
      if (t == 0 && P.builds != nullptr) atomicAdd(P.builds, 1);
    }
  }
}

__global__ void __launch_bounds__(kBlockThreads, kMinBlocks) factor_kernel(const Plan P) {
  if (P.need != nullptr) {   // the same answer in every CTA: all return before any barrier
    bool any = false;
    for (int i = threadIdx.x; i < P.n_batch; i += kBlockThreads) any = any || P.need[i] != 0;
    if (!__syncthreads_or(any)) return;
  }
  __shared__ GroupMem mem;
  cg::grid_group grid = cg::this_grid();
  int phase = 0;
  const auto next = [&]() {   // false once the phase limit is reached
    ++phase;
    if (phase >= P.phase_limit) return false;
    grid.sync();
    return true;
  };
  Src src = P.in;
  for (int l = 0; l < P.n_levels; ++l) {
    level_phase<float>(src, P.halves[l], P.n_batch, 1e-8, P.chain[l], P.need, mem.level);
    if (!next()) return;
    src = from_level(P.chain[l], P.halves[l], 0.0);
  }
  // the root: 1e-8·I added once, then exact reduction
  if (P.n_levels > 0) {
    src = from_level(P.chain[P.n_levels - 1], P.m, 1e-8);
    src.dL = nullptr;          // the root's lower blocks start as Uᵀ
  } else {
    src.diag_add = 1e-8;
  }
  for (int s = 0; s < P.n_sub; ++s) {
    const int half = (P.m >> s) / 2;
    root_level_phase(src, half, P.n_batch, P.root[s], P.need, mem.root);
    if (!next()) return;
    src = from_level(P.root[s], half, 0.0);
  }
  base_phase(P, src, mem.level);
  // the expansions: the base's inverse is ybuf[0], each expansion writes
  // the other buffer, the last one (s = 0) the float32 root
  for (int s = P.n_sub - 1; s >= 0; --s) {
    if (!next()) return;
    const int k = (P.m >> s) / 2;
    const real* Y = P.ybuf[(P.n_sub - 1 - s) % 2];
    if (s == 0)
      expand_phase<float>(Y, k, P.root[s], P.n_batch, P.root_inv, P.need, mem.expand);
    else
      expand_phase<real>(Y, k, P.root[s], P.n_batch, P.ybuf[(P.n_sub - s) % 2], P.need,
                         mem.expand);
  }
}

int log2_exact(int m) {
  int s = 0;
  while ((1 << s) < m) ++s;
  return (1 << s) == m ? s : -1;
}

// Grid CTAs the phases can use: the largest phase's groups or rows.
long long work_ctas(const Plan& P) {
  long long most = (P.n_batch + kGroups - 1) / kGroups;
  for (int l = 0; l < P.n_levels; ++l)
    most = std::max(most,
                    (static_cast<long long>(P.halves[l]) * P.n_batch + kGroups - 1) / kGroups);
  for (int s = 0; s < P.n_sub; ++s) {
    const long long half = (P.m >> s) / 2;
    most = std::max(most, (half * P.n_batch + kGroups - 1) / kGroups);
    most = std::max(most, half * P.n_batch);      // an expansion's tasks
  }
  return most;
}

// CTAs of factor_kernel one device holds at once (cached per device).
int resident_ctas() {
  static int cache[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, factor_kernel, kBlockThreads, 0)
            != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      return 0;
    cache[dev] = per_sm * sms;
  }
  return cache[dev];
}

}  // namespace

// The factor of n_batch chains of n blocks (a single chain is the batch of
// one) in one cooperative launch.  D, U (B·n, 6, 6) float32; with damp
// (B·n, 6) and free (B·n,) given, each diagonal block read is free ? D +
// diag(damp) : I, plus diag(lift) if lift (6,) is given.  factor: the
// float32 factor in one buffer, level after level each level's (Dinv_o,
// P1m, P2, G1, G2), each (B, m << (n_levels-1-l), 6, 6), then root_inv (B,
// 6m, 6m).  scratch: scratch_doubles float64 (each chain level's newD,
// newU; each root level's five products and newD, newU, newL; two
// expansion buffers).  need: optional (B,) device flags (nullptr = always
// build); builds: optional device counter, +1 per factor built.
// phase_limit <= 0 runs every phase.
extern "C" int uz_chain_factor(const float* D, const float* U, const float* damp,
                               const float* free, const float* lift, int n, int n_batch,
                               int n_levels, int m, float* factor, double* scratch,
                               long long scratch_doubles, const unsigned char* need, int* builds,
                               int phase_limit, void* stream) {
  const int n_sub = log2_exact(m);
  if (n < 1 || n_batch < 1 || n_levels < 0 || n_levels > kMaxLevels || m < 1 || m > kRootMax ||
      n_sub < 0 || (static_cast<long long>(m) << n_levels) < n ||
      (damp != nullptr) != (free != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan P{};
  P.in.D = D;
  P.in.U = U;
  P.in.damp = damp;
  P.in.free = free;
  P.in.lift = damp != nullptr ? lift : nullptr;
  P.in.rows = n;
  P.in.n_valid = n;
  P.n_batch = n_batch;
  P.n_levels = n_levels;
  P.m = m;
  P.n_sub = n_sub;
  P.need = need;
  P.builds = builds;
  P.phase_limit = phase_limit > 0 ? phase_limit : (1 << 30);
  float* f = factor;
  double* at = scratch;
  for (int l = 0; l < n_levels; ++l) {
    const int h = m << (n_levels - 1 - l);
    P.halves[l] = h;
    const long long size = 36LL * h * n_batch;
    for (int k = 0; k < 5; ++k) P.chain[l].m[k] = f + k * size;
    f += 5 * size;
    P.chain[l].newD = at;
    P.chain[l].newU = at + size;
    at += 2 * size;
  }
  P.root_inv = f;
  for (int s = 0; s < n_sub; ++s) {
    const long long size = 36LL * ((m >> s) / 2) * n_batch;
    for (int k = 0; k < 5; ++k) P.root[s].m[k] = at + k * size;
    P.root[s].newD = at + 5 * size;
    P.root[s].newU = at + 6 * size;
    P.root[s].newL = at + 7 * size;
    at += 8 * size;
  }
  const long long ysize = 36LL * (m / 2) * (m / 2) * n_batch;
  P.ybuf[0] = at;
  P.ybuf[1] = at + ysize;
  at += 2 * ysize;
  if (at - scratch > scratch_doubles) return static_cast<int>(cudaErrorInvalidValue);
  const int resident = resident_ctas();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = static_cast<int>(std::min<long long>(work_ctas(P), resident));
  void* args[] = {&P};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(factor_kernel), dim3(grid), dim3(kBlockThreads), args, 0,
      static_cast<cudaStream_t>(stream)));
}
