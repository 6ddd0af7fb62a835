// K10 pcg: the vector updates of the preconditioned conjugate gradient.
//
// Replaces the body of uzliti_slam_tpu/graph/solver.py:_pcg (:512-540), the
// fixed-count PCG with a masked stall that every LM iteration runs.  Around
// each Hessian-vector product (K2) and preconditioner apply (K3) the
// reference does two dots, two axpys and the stall logic; here each side is
// one launch (two on the grid route below), and the scalars stay on the
// card in a 4-float buffer scal = [rz, b2, ok, rz kept] that the launches
// read and write:
//   uz_pcg_init  (after z0 = M⁻¹b):  x = 0, r = b, p = z0, rz = rᵀz0, b2 = bᵀb
//   uz_pcg_alpha (after Hp = H·p):   pHp = pᵀHp,
//                ok = pHp > 1e-20 && rz > tol·(b2 + 1e-30),
//                α = ok ? rz / (pHp == 0 ? 1 : pHp) : 0,  x += α·p,  r -= α·Hp
//   uz_pcg_beta  (after z = M⁻¹r):   rz' = rᵀz,  β = ok ? rz' / (rz == 0 ? 1 : rz) : 0,
//                p = ok ? z + β·p : p,  rz = ok ? rz' : rz
// Dots are summed in a fixed order (each thread a fixed strided range, then
// a shared-memory tree), never with atomics, so the same inputs give the
// same bits: the LM accept test downstream compares χ² values that these
// steps move.  The axpys use explicitly rounded multiply and add, so they
// round as the reference's separate `α·p` and `x + ·` do.
//
// Two routes, chosen by the wrapper.  Up to 32768 floats (5461 nodes)
// one CTA per launch: the dot is complete before the update that scales by
// it, in one launch.  Above it, each side is two grid launches: per-CTA
// partial dots of fixed chunks, then every CTA sums all partials in the same
// fixed order (so all hold the same total), and updates its chunk; the
// one-CTA route would leave 131 SMs idle on 6·1e5 floats.  The grid route
// keeps the old rz in scal[3] for the update launch, since CTA 0 rewrites
// scal[0] while the others read.
//
// The fleet (parallel/sharded.py:optimize_batch) takes the CTA route with
// one CTA of 128 threads per instance and scal as (B, 4); a single solve is
// the batch of one: each instance's
// dots, α, β and stall flag are its own, as under the reference's vmap — one
// dot over the whole fleet would couple the instances' CG.  Its launches do
// not grow with B.
//
// What bounds it on the card: at the headline's 6·1024 floats launch
// latency; at 6·1e5 floats the bytes, about 5 passes over an (N, 6) vector
// per side; the fleet's 4096 x 384 floats, the bytes (6 MB a pass).
#include <cuda_runtime.h>

namespace {

constexpr int kPcgThreads = 1024;
constexpr int kBatchThreads = 128;  // one CTA per instance of the fleet
constexpr int kGridThreads = 256;
constexpr int kChunk = 4096;       // floats per CTA on the grid route

// Fixed-order sum over a CTA of T threads; every thread gets the total.
template <int T>
__device__ float cta_sum(float v, float* buf) {
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int s = T / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) buf[threadIdx.x] += buf[threadIdx.x + s];
    __syncthreads();
  }
  const float total = buf[0];
  __syncthreads();
  return total;
}

// The CTA routes: CTA k updates the k-th n-float vector segment with its own
// scal[4k .. 4k + 3] (one CTA, k = 0, for a single solve; one per instance
// for the fleet).
template <int T>
__global__ void __launch_bounds__(T)
pcg_init(const float* __restrict__ b, const float* __restrict__ z, int n, float* __restrict__ x,
         float* __restrict__ r, float* __restrict__ p, float* __restrict__ scal) {
  __shared__ float buf[T];
  const long long o = static_cast<long long>(blockIdx.x) * n;
  b += o; z += o; x += o; r += o; p += o; scal += 4 * blockIdx.x;
  float rz = 0.f, b2 = 0.f;
  for (int i = threadIdx.x; i < n; i += T) {
    const float bi = b[i], zi = z[i];
    x[i] = 0.f;
    r[i] = bi;
    p[i] = zi;
    rz += bi * zi;
    b2 += bi * bi;
  }
  rz = cta_sum<T>(rz, buf);
  b2 = cta_sum<T>(b2, buf);
  if (threadIdx.x == 0) {
    scal[0] = rz;
    scal[1] = b2;
    scal[2] = 1.f;
  }
}

template <int T>
__global__ void __launch_bounds__(T)
pcg_alpha(const float* __restrict__ p, const float* __restrict__ Hp, int n, float tol,
          float* __restrict__ x, float* __restrict__ r, float* __restrict__ scal) {
  __shared__ float buf[T];
  const long long o = static_cast<long long>(blockIdx.x) * n;
  p += o; Hp += o; x += o; r += o; scal += 4 * blockIdx.x;
  const float rz = scal[0], b2 = scal[1];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += T) s += p[i] * Hp[i];
  const float pHp = cta_sum<T>(s, buf);
  const bool ok = (pHp > 1e-20f) && (rz > tol * (b2 + 1e-30f));
  const float alpha = ok ? rz / (pHp == 0.f ? 1.f : pHp) : 0.f;
  for (int i = threadIdx.x; i < n; i += T) {
    x[i] = __fadd_rn(x[i], __fmul_rn(alpha, p[i]));
    r[i] = __fsub_rn(r[i], __fmul_rn(alpha, Hp[i]));
  }
  if (threadIdx.x == 0) scal[2] = ok ? 1.f : 0.f;
}

template <int T>
__global__ void __launch_bounds__(T)
pcg_beta(const float* __restrict__ r, const float* __restrict__ z, int n, float* __restrict__ p,
         float* __restrict__ scal) {
  __shared__ float buf[T];
  const long long o = static_cast<long long>(blockIdx.x) * n;
  r += o; z += o; p += o; scal += 4 * blockIdx.x;
  const float rz = scal[0];
  const bool ok = scal[2] != 0.f;
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += T) s += r[i] * z[i];
  const float rz_new = cta_sum<T>(s, buf);
  const float beta = ok ? rz_new / (rz == 0.f ? 1.f : rz) : 0.f;
  if (ok)
    for (int i = threadIdx.x; i < n; i += T) p[i] = __fadd_rn(z[i], __fmul_rn(beta, p[i]));
  if (threadIdx.x == 0) scal[0] = ok ? rz_new : rz;
}

// ---- grid route ----

__device__ float grid_cta_sum(float v, float* buf) { return cta_sum<kGridThreads>(v, buf); }

// The same total of nb partials in every CTA.
__device__ float sum_partials(const float* __restrict__ partials, int nb, float* buf) {
  float s = 0.f;
  for (int i = threadIdx.x; i < nb; i += kGridThreads) s += partials[i];
  return grid_cta_sum(s, buf);
}

// Partial dots a·b (and, with c, c·c) of this CTA's chunk; with keep_rz,
// CTA 0 also copies scal[0] to scal[3].
__global__ void __launch_bounds__(kGridThreads)
grid_dots(const float* __restrict__ a, const float* __restrict__ b, const float* __restrict__ c,
          int n, float* __restrict__ partials, int nb, float* __restrict__ scal, int keep_rz) {
  __shared__ float buf[kGridThreads];
  const int lo = blockIdx.x * kChunk, hi = min(n, lo + kChunk);
  float s = 0.f, s2 = 0.f;
  for (int i = lo + threadIdx.x; i < hi; i += kGridThreads) {
    s += a[i] * b[i];
    if (c != nullptr) s2 += c[i] * c[i];
  }
  s = grid_cta_sum(s, buf);
  if (c != nullptr) s2 = grid_cta_sum(s2, buf);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = s;
    if (c != nullptr) partials[nb + blockIdx.x] = s2;
    if (keep_rz && blockIdx.x == 0) scal[3] = scal[0];
  }
}

__global__ void __launch_bounds__(kGridThreads)
grid_init(const float* __restrict__ b, const float* __restrict__ z, int n, float* __restrict__ x,
          float* __restrict__ r, float* __restrict__ p, const float* __restrict__ partials,
          int nb, float* __restrict__ scal) {
  __shared__ float buf[kGridThreads];
  const int lo = blockIdx.x * kChunk, hi = min(n, lo + kChunk);
  for (int i = lo + threadIdx.x; i < hi; i += kGridThreads) {
    x[i] = 0.f;
    r[i] = b[i];
    p[i] = z[i];
  }
  if (blockIdx.x == 0) {
    const float rz = sum_partials(partials, nb, buf);
    const float b2 = sum_partials(partials + nb, nb, buf);
    if (threadIdx.x == 0) {
      scal[0] = rz;
      scal[1] = b2;
      scal[2] = 1.f;
    }
  }
}

__global__ void __launch_bounds__(kGridThreads)
grid_alpha(const float* __restrict__ p, const float* __restrict__ Hp, int n, float tol,
           float* __restrict__ x, float* __restrict__ r, const float* __restrict__ partials,
           int nb, float* __restrict__ scal) {
  __shared__ float buf[kGridThreads];
  const float rz = scal[0], b2 = scal[1];
  const float pHp = sum_partials(partials, nb, buf);
  const bool ok = (pHp > 1e-20f) && (rz > tol * (b2 + 1e-30f));
  const float alpha = ok ? rz / (pHp == 0.f ? 1.f : pHp) : 0.f;
  const int lo = blockIdx.x * kChunk, hi = min(n, lo + kChunk);
  for (int i = lo + threadIdx.x; i < hi; i += kGridThreads) {
    x[i] = __fadd_rn(x[i], __fmul_rn(alpha, p[i]));
    r[i] = __fsub_rn(r[i], __fmul_rn(alpha, Hp[i]));
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) scal[2] = ok ? 1.f : 0.f;
}

__global__ void __launch_bounds__(kGridThreads)
grid_beta(const float* __restrict__ z, int n, float* __restrict__ p,
          const float* __restrict__ partials, int nb, float* __restrict__ scal) {
  __shared__ float buf[kGridThreads];
  const float rz = scal[3];
  const bool ok = scal[2] != 0.f;
  const float rz_new = sum_partials(partials, nb, buf);
  const float beta = ok ? rz_new / (rz == 0.f ? 1.f : rz) : 0.f;
  const int lo = blockIdx.x * kChunk, hi = min(n, lo + kChunk);
  if (ok)
    for (int i = lo + threadIdx.x; i < hi; i += kGridThreads)
      p[i] = __fadd_rn(z[i], __fmul_rn(beta, p[i]));
  if (blockIdx.x == 0 && threadIdx.x == 0) scal[0] = ok ? rz_new : rz;
}

int chunks(int n) { return (n + kChunk - 1) / kChunk; }

// The routes an entry may take: the grid route (partials given) holds one
// instance only.
bool bad_route(int n_batch, const float* partials) {
  return n_batch < 1 || (partials != nullptr && n_batch != 1);
}

}  // namespace

// Each entry takes n_batch instances of n floats each (a single solve is the
// batch of one) and scal (n_batch, 4).  partials: nullptr for the CTA route
// (one CTA per instance: kPcgThreads threads for one instance, kBatchThreads
// each for a fleet), else 2·ceil(n / 4096) floats for the grid route.

// x, r, p and scal from b and z0 = M⁻¹b.
extern "C" int uz_pcg_init(const float* b, const float* z, int n, int n_batch, float* x, float* r,
                           float* p, float* scal, float* partials, void* stream) {
  if (bad_route(n_batch, partials)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (partials != nullptr) {
    const int nb = chunks(n);
    grid_dots<<<nb, kGridThreads, 0, s>>>(b, z, b, n, partials, nb, scal, 0);
    grid_init<<<nb, kGridThreads, 0, s>>>(b, z, n, x, r, p, partials, nb, scal);
  } else if (n_batch == 1) {
    pcg_init<kPcgThreads><<<1, kPcgThreads, 0, s>>>(b, z, n, x, r, p, scal);
  } else {
    pcg_init<kBatchThreads><<<n_batch, kBatchThreads, 0, s>>>(b, z, n, x, r, p, scal);
  }
  return static_cast<int>(cudaGetLastError());
}

// The step's first half, after Hp = H·p: x and r updated in place.
extern "C" int uz_pcg_alpha(const float* p, const float* Hp, int n, int n_batch, float tol,
                            float* x, float* r, float* scal, float* partials, void* stream) {
  if (bad_route(n_batch, partials)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (partials != nullptr) {
    const int nb = chunks(n);
    grid_dots<<<nb, kGridThreads, 0, s>>>(p, Hp, nullptr, n, partials, nb, scal, 0);
    grid_alpha<<<nb, kGridThreads, 0, s>>>(p, Hp, n, tol, x, r, partials, nb, scal);
  } else if (n_batch == 1) {
    pcg_alpha<kPcgThreads><<<1, kPcgThreads, 0, s>>>(p, Hp, n, tol, x, r, scal);
  } else {
    pcg_alpha<kBatchThreads><<<n_batch, kBatchThreads, 0, s>>>(p, Hp, n, tol, x, r, scal);
  }
  return static_cast<int>(cudaGetLastError());
}

// The step's second half, after z = M⁻¹r: p updated in place.
extern "C" int uz_pcg_beta(const float* r, const float* z, int n, int n_batch, float* p,
                           float* scal, float* partials, void* stream) {
  if (bad_route(n_batch, partials)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (partials != nullptr) {
    const int nb = chunks(n);
    grid_dots<<<nb, kGridThreads, 0, s>>>(r, z, nullptr, n, partials, nb, scal, 1);
    grid_beta<<<nb, kGridThreads, 0, s>>>(z, n, p, partials, nb, scal);
  } else if (n_batch == 1) {
    pcg_beta<kPcgThreads><<<1, kPcgThreads, 0, s>>>(r, z, n, p, scal);
  } else {
    pcg_beta<kBatchThreads><<<n_batch, kBatchThreads, 0, s>>>(r, z, n, p, scal);
  }
  return static_cast<int>(cudaGetLastError());
}
