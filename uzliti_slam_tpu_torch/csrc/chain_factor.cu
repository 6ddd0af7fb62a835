// K9 chain_factor: the cyclic-reduction factor of the chain preconditioner.
//
// Replaces uzliti_slam_tpu/graph/tridiag.py:block_tridiag_factor (:145-195)
// with its helpers _inv3/_inv6 (:22-72), _pad_pow2 (:75-85) and
// _dense_root_inverse (:112-142).  The input is the damped block-tridiagonal
// chain matrix, D (n, 6, 6) on the diagonal and U[i] = A[i, i+1].
//
// uz_chain_factor_level, one launch per reduction level of m = 2·half
// blocks: for every surviving odd block j, with De = D[2j], Do = D[2j+1],
// Ueo = U[2j], Uoe = U[2j+1], and the previous odd pair (Do, Uoe)[j-1]
// (identity and zero at j = 0, the reference's roll-and-zero):
//   Dinv_o = inv6(Do)            (1e-8·I floor, 3x3 Schur over adjugates,
//                                 determinant floor 1e-30, as :47-72, :35)
//   P1m = Uoe[j-1]ᵀ·inv6(Do[j-1])   P2 = Ueo·Dinv_o
//   G1  = Dinv_o·Ueoᵀ               G2 = Dinv_o·Uoe
//   newD = De - P1m·Uoe[j-1] - P2·Ueoᵀ     newU = -P2·Uoe (0 at j = half-1)
// The pad to a power of two and the zeroed U[n-1] are read, not copied:
// rows at or past n_valid read as D = I, U = 0, and U[n_valid-1] reads as 0.
// One CTA holds eight odd blocks, 36 threads each (one per 6x6 entry), the
// operands in shared memory: a 6x6 Schur inverse plus six 6x6 products in
// one thread would spill.  inv6(Do[j-1]) is recomputed by block j rather
// than read from block j-1, so a level needs no second launch.
//
// uz_chain_factor_root, one CTA: the dense inverse of the root system of
// m <= 64 blocks (at most 384 x 384), A = tridiag(Uᵀ, D, U) + 1e-8·I, which
// the reference inverts by pivoted LU and the apply multiplies by.  The root
// is SPD (a Schur complement of the damped chain matrix), so a block LDLᵀ
// without pivoting is stable: 36 threads run the m-step block recursion
//   S_0 = D_0 + 1e-8·I,  K_i = S_i⁻¹·U_i,  S_{i+1} = D_{i+1} + 1e-8·I - U_iᵀ·K_i
// (S_i⁻¹ by the same closed-form 6x6 inverse, without a second floor, so
// m = 1 is exactly _inv6(D_0)), then every thread solves A·x = e_c for one
// column c of the inverse by block forward and back substitution, with the
// 6x6 blocks broadcast from shared memory and the column written straight
// to the output.  No library call.
//
// Refresh flag: when `need` is given, every launch reads it first and
// returns at once if it is 0, so a solve can hold one factor and rebuild it
// in place only when its device-side refresh decision says so; `builds`
// (when given) counts the factors actually built.
//
// Precision: every level and the root are computed in float64, and only the
// factor handed to the apply (K3) is stored in float32.  Each level's
// newD = De - P1m·Uoe - P2·Ueoᵀ cancels, so a float32 reduction loses about
// a bit per level: on the 100k-node solve's first iteration (11 levels) the
// float32 factor is 2.6e-4 of its largest entry away from the float64 one,
// and two float32 implementations that round in different places differ by
// as much.  The carried newD, newU are float64 scratch, as is the root's
// work column; the first level (or a root with no level) reads the
// caller's float32 D, U.
//
// The fleet (kernels/ops.chain_factor with batch > 1, for
// parallel/sharded.py:optimize_batch): each instance is its own chain with
// its own levels and root, all instances of a level in one launch (odd block
// jg belongs to instance jg / half) and one root CTA per instance; `need` is
// then a (B,) flag array, since each instance refreshes its own factor under
// the early exit.  The launches per factor do not grow with B.
//
// What bounds it on the card: the serial chain of dependent steps — one
// launch per level, and the root's m-step recursion of small inverses (a few
// hundred __syncthreads in one CTA).  The bytes (each level's 10 blocks of
// 144 bytes per odd block) are small next to that.  The fleet's 4096 root
// CTAs of a 16-block recursion each fill the card.
#include <cuda_runtime.h>

namespace {

using real = double;               // the factor's arithmetic

constexpr int kEntries = 36;      // threads of one group: one per 6x6 entry
constexpr int kGroups = 8;        // odd blocks per CTA of the level kernel
constexpr int kRootThreads = 384; // one thread per column of a 64-block root
constexpr int kRootMax = 64;      // blocks of the largest root

// max(|x|, 1e-30) floor of the reference's 3x3 determinant, sign kept.
__device__ __forceinline__ real det_floor(real det) {
  return fabs(det) < 1e-30 ? 1e-30 : det;
}

// Entry u (0..8) of the closed-form inverse of the 3x3 matrix M (row stride
// ld): adjugate over determinant, as tridiag.py:_inv3.
__device__ __forceinline__ real inv3_entry(const real* M, int ld, int u) {
  const real a = M[0], b = M[1], c = M[2];
  const real d = M[ld], e = M[ld + 1], f = M[ld + 2];
  const real g = M[2 * ld], h = M[2 * ld + 1], i = M[2 * ld + 2];
  const real A = e * i - f * h;
  const real B = -(d * i - f * g);
  const real C = d * h - e * g;
  const real det = det_floor(a * A + b * B + c * C);
  real v;
  switch (u) {
    case 0: v = A; break;
    case 1: v = -(b * i - c * h); break;
    case 2: v = b * f - c * e; break;
    case 3: v = B; break;
    case 4: v = a * i - c * g; break;
    case 5: v = -(a * f - c * d); break;
    case 6: v = C; break;
    case 7: v = -(a * h - b * g); break;
    default: v = a * e - b * d; break;
  }
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

// out = inverse of (M + fl·I) by the 2x2-block Schur complement over 3x3
// blocks (tridiag.py:_inv6).  Called by all threads of the CTA together;
// threads t = 0..17 work, the barriers are CTA-wide.
__device__ void inv6(const real* M, real fl, real* out, Inv6Scratch& s, int t) {
  if (t < kEntries) s.M[t] = M[t] + ((t / 6 == t % 6) ? fl : 0.0);
  __syncthreads();
  const int r = (t % 9) / 3, c = t % 3;
  if (t < 9) s.Ainv[t] = inv3_entry(s.M, 6, t);                       // A⁻¹
  __syncthreads();
  if (t < 9) s.AinvB[t] = mm3(s.Ainv, 3, s.M + 3, 6, r, c);           // A⁻¹B
  else if (t < 18) s.CAinv[t - 9] = mm3(s.M + 18, 6, s.Ainv, 3, r, c); // CA⁻¹
  __syncthreads();
  if (t < 9) s.S[t] = s.M[21 + r * 6 + c] - mm3(s.M + 18, 6, s.AinvB, 3, r, c);  // D - CA⁻¹B
  __syncthreads();
  if (t < 9) s.Sinv[t] = inv3_entry(s.S, 3, t);
  __syncthreads();
  if (t < 9) s.W[t] = mm3(s.AinvB, 3, s.Sinv, 3, r, c);                // A⁻¹B·S⁻¹
  else if (t < 18) out[(3 + r) * 6 + c] = -mm3(s.Sinv, 3, s.CAinv, 3, r, c);  // BL
  __syncthreads();
  if (t < 9) {
    out[r * 6 + c] = s.Ainv[t] + mm3(s.W, 3, s.CAinv, 3, r, c);       // TL
  } else if (t < 18) {
    out[r * 6 + 3 + c] = -s.W[t - 9];                                  // TR
    out[(3 + r) * 6 + 3 + c] = s.Sinv[t - 9];                          // BR
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

// Block `row` of D or U (float32 from the caller, float64 between levels)
// as the padded, zeroed chain matrix reads it.
template <typename T>
__device__ __forceinline__ real d_at(const T* D, int row, int n_valid, int t) {
  return row < n_valid ? static_cast<real>(D[row * 36 + t]) : ((t / 6 == t % 6) ? 1.0 : 0.0);
}
template <typename T>
__device__ __forceinline__ real u_at(const T* U, int row, int n_valid, int t) {
  return row < n_valid - 1 ? static_cast<real>(U[row * 36 + t]) : 0.0;
}

struct LevelGroup {
  real De[36], Do[36], Dom[36], Ueo[36], Uoe[36], Uoem[36];
  real Di[36], Dim[36], P1m[36], P2[36];
  Inv6Scratch s0, s1;
};

// Is instance `inst`'s factor to be built?  (need: nullptr = always.)
__device__ __forceinline__ bool wanted(const unsigned char* need, long long inst) {
  return need == nullptr || need[inst] != 0;
}

// Odd block jg of the level's n_batch·half belongs to instance jg / half,
// whose D, U rows start at inst·in_stride.
template <typename T>
__global__ void __launch_bounds__(kEntries * kGroups)
factor_level(const T* __restrict__ D, const T* __restrict__ U, int n_valid, int in_stride,
             int half, int n_batch, float* __restrict__ Dinv_o, float* __restrict__ P1m,
             float* __restrict__ P2, float* __restrict__ G1, float* __restrict__ G2,
             real* __restrict__ newD, real* __restrict__ newU,
             const unsigned char* __restrict__ need) {
  const long long total = static_cast<long long>(half) * n_batch;
  const long long j_lo = static_cast<long long>(blockIdx.x) * kGroups;
  const long long j_hi = min(j_lo + kGroups, total) - 1;
  bool any = false;   // the same answer in every thread: return together
  for (long long inst = j_lo / half; inst <= j_hi / half; ++inst) any = any || wanted(need, inst);
  if (!any) return;
  __shared__ LevelGroup groups[kGroups];
  const int t = threadIdx.x;
  const long long jg = j_lo + threadIdx.y;
  const long long inst = jg / half;
  const int j = static_cast<int>(jg % half);
  const bool live = jg < total && wanted(need, inst);
  const T* Di = D + inst * in_stride * 36;
  const T* Ui = U + inst * in_stride * 36;
  LevelGroup& G = groups[threadIdx.y];
  const int r = t / 6, c = t % 6;
  const real eye = (r == c) ? 1.0 : 0.0;
  if (live) {
    G.De[t] = d_at(Di, 2 * j, n_valid, t);
    G.Do[t] = d_at(Di, 2 * j + 1, n_valid, t);
    G.Ueo[t] = u_at(Ui, 2 * j, n_valid, t);
    G.Uoe[t] = u_at(Ui, 2 * j + 1, n_valid, t);
    G.Dom[t] = j > 0 ? d_at(Di, 2 * j - 1, n_valid, t) : eye;
    G.Uoem[t] = j > 0 ? u_at(Ui, 2 * j - 1, n_valid, t) : 0.0;
  } else {   // idle group: well-defined operands, nothing written
    G.De[t] = G.Do[t] = G.Dom[t] = eye;
    G.Ueo[t] = G.Uoe[t] = G.Uoem[t] = 0.0;
  }
  __syncthreads();
  inv6(G.Do, 1e-8, G.Di, G.s0, t);
  inv6(G.Dom, 1e-8, G.Dim, G.s1, t);
  if (j == 0) G.Dim[t] = eye;      // roll-and-set-identity at block 0
  __syncthreads();
  const real p1m = mtm6(G.Uoem, G.Dim, r, c);
  const real p2 = mm6(G.Ueo, G.Di, r, c);
  G.P1m[t] = p1m;
  G.P2[t] = p2;
  if (live) {
    const long long o = jg * 36 + t;
    Dinv_o[o] = static_cast<float>(G.Di[t]);
    P1m[o] = static_cast<float>(p1m);
    P2[o] = static_cast<float>(p2);
    G1[o] = static_cast<float>(mmt6(G.Di, G.Ueo, r, c));
    G2[o] = static_cast<float>(mm6(G.Di, G.Uoe, r, c));
  }
  __syncthreads();
  if (live) {
    const long long o = jg * 36 + t;
    const real t1 = mm6(G.P1m, G.Uoem, r, c);
    const real t2 = mmt6(G.P2, G.Ueo, r, c);
    newD[o] = G.De[t] - t1 - t2;
    newU[o] = j == half - 1 ? 0.0 : -mm6(G.P2, G.Uoe, r, c);
  }
}

// Dynamic shared memory of the root kernel: S⁻¹, U and K for each of m
// blocks.
size_t root_smem_bytes(int m) { return 3ull * m * 36 * sizeof(real); }

// One CTA per instance (blockIdx.x), its D, U rows at inst·in_stride, its
// root and work column at inst·(6m)².
template <typename T>
__global__ void __launch_bounds__(kRootThreads)
factor_root(const T* __restrict__ D, const T* __restrict__ U, int n_valid, int in_stride, int m,
            float* __restrict__ root_inv, real* __restrict__ work,
            const unsigned char* __restrict__ need, int* __restrict__ builds) {
  const long long inst = blockIdx.x;
  if (!wanted(need, inst)) return;
  D += inst * in_stride * 36;
  U += inst * in_stride * 36;
  root_inv += inst * 36LL * m * m;
  work += inst * 36LL * m * m;
  extern __shared__ real root_smem[];
  real (*Sinv)[36] = reinterpret_cast<real (*)[36]>(root_smem);
  real (*Ub)[36] = Sinv + m;
  real (*K)[36] = Ub + m;
  __shared__ real S[36];
  __shared__ Inv6Scratch scratch;
  const int t = threadIdx.x;
  for (int k = t; k < m * 36; k += kRootThreads)
    Ub[k / 36][k % 36] = u_at(U, k / 36, min(n_valid, m), k % 36);
  if (t < kEntries) S[t] = d_at(D, 0, n_valid, t) + ((t / 6 == t % 6) ? 1e-8 : 0.0);
  __syncthreads();
  // block LDLᵀ recursion, 36 threads
  const int r = t / 6, c = t % 6;
  for (int i = 0; i < m; ++i) {
    inv6(S, 0.0, Sinv[i], scratch, t);
    if (i + 1 < m) {
      if (t < kEntries) K[i][t] = mm6(Sinv[i], Ub[i], r, c);
      __syncthreads();
      if (t < kEntries)
        S[t] = d_at(D, i + 1, n_valid, t) + ((r == c) ? 1e-8 : 0.0) - mtm6(Ub[i], K[i], r, c);
      __syncthreads();
    }
  }
  // one column of the inverse per thread: forward w_{i+1} = e_{i+1} - U_iᵀ·v_i
  // with v_i = S_i⁻¹·w_i (kept in the float64 work column), then back
  // x_i = v_i - K_i·x_{i+1}, written to the float32 output
  const int n = 6 * m;
  if (t < n) {
    real w[6], x[6];
#pragma unroll
    for (int a = 0; a < 6; ++a) w[a] = (t / 6 == 0 && t % 6 == a) ? 1.0 : 0.0;
    for (int i = 0; i < m; ++i) {
      real v[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        real s = 0.0;
#pragma unroll
        for (int k = 0; k < 6; ++k) s += Sinv[i][a * 6 + k] * w[k];
        v[a] = s;
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) work[static_cast<long long>(6 * i + a) * n + t] = v[a];
      if (i + 1 < m) {
#pragma unroll
        for (int a = 0; a < 6; ++a) {
          real s = 0.0;
#pragma unroll
          for (int k = 0; k < 6; ++k) s += Ub[i][k * 6 + a] * v[k];
          w[a] = ((t / 6 == i + 1 && t % 6 == a) ? 1.0 : 0.0) - s;
        }
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) x[a] = v[a];
    }
#pragma unroll
    for (int a = 0; a < 6; ++a)
      root_inv[static_cast<long long>(6 * (m - 1) + a) * n + t] = static_cast<float>(x[a]);
    for (int i = m - 2; i >= 0; --i) {
      real xn[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        real s = 0.0;
#pragma unroll
        for (int k = 0; k < 6; ++k) s += K[i][a * 6 + k] * x[k];
        xn[a] = work[static_cast<long long>(6 * i + a) * n + t] - s;
        root_inv[static_cast<long long>(6 * i + a) * n + t] = static_cast<float>(xn[a]);
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) x[a] = xn[a];
    }
  }
  if (t == 0 && builds != nullptr) atomicAdd(builds, 1);
}

template <typename T>
cudaError_t launch_level(const void* D, const void* U, int n_valid, int in_stride, int half,
                         int n_batch, float* Dinv_o, float* P1m, float* P2, float* G1, float* G2,
                         real* newD, real* newU, const unsigned char* need, cudaStream_t stream) {
  const long long total = static_cast<long long>(half) * n_batch;
  factor_level<T><<<static_cast<unsigned>((total + kGroups - 1) / kGroups),
                    dim3(kEntries, kGroups), 0, stream>>>(
      static_cast<const T*>(D), static_cast<const T*>(U), n_valid, in_stride, half, n_batch,
      Dinv_o, P1m, P2, G1, G2, newD, newU, need);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_root(const void* D, const void* U, int n_valid, int in_stride, int m,
                        int n_batch, float* root_inv, real* work, const unsigned char* need,
                        int* builds, cudaStream_t stream) {
  const size_t smem = root_smem_bytes(m);
  const cudaError_t err = cudaFuncSetAttribute(
      factor_root<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  factor_root<T><<<n_batch, kRootThreads, smem, stream>>>(
      static_cast<const T*>(D), static_cast<const T*>(U), n_valid, in_stride, m, root_inv, work,
      need, builds);
  return cudaGetLastError();
}

}  // namespace

// One reduction level of n_batch chains (a single chain is the batch of
// one): the level's (Dinv_o, P1m, P2, G1, G2) in float32 and the next
// level's newD, newU in float64, each (n_batch, half, 6, 6), from D, U
// (instance b's rows at b·in_stride, n_valid of them valid, of 2·half;
// float64 if in_double, else float32).  need: optional (n_batch,) device
// flags (nullptr = always build).
extern "C" int uz_chain_factor_level(const void* D, const void* U, int in_double, int n_valid,
                                     int in_stride, int half, int n_batch, float* Dinv_o,
                                     float* P1m, float* P2, float* G1, float* G2, double* newD,
                                     double* newU, const unsigned char* need, void* stream) {
  if (half <= 0 || n_batch <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      in_double ? launch_level<double>(D, U, n_valid, in_stride, half, n_batch, Dinv_o, P1m, P2,
                                       G1, G2, newD, newU, need, s)
                : launch_level<float>(D, U, n_valid, in_stride, half, n_batch, Dinv_o, P1m, P2,
                                      G1, G2, newD, newU, need, s));
}

// The root inverses (n_batch, 6m, 6m) in float32, m <= 64, one CTA per
// chain; work: n_batch·(6m)² float64 scratch.  builds: optional device
// counter, +1 per factor built.
extern "C" int uz_chain_factor_root(const void* D, const void* U, int in_double, int n_valid,
                                    int in_stride, int m, int n_batch, float* root_inv,
                                    double* work, const unsigned char* need, int* builds,
                                    void* stream) {
  if (m < 1 || m > kRootMax || n_batch < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      in_double ? launch_root<double>(D, U, n_valid, in_stride, m, n_batch, root_inv, work, need,
                                      builds, s)
                : launch_root<float>(D, U, n_valid, in_stride, m, n_batch, root_inv, work, need,
                                     builds, s));
}
