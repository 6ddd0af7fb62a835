// K37 pcg_grid: one PCG step's preconditioner half for a single solve above
// K34's cap, in one cooperative launch over the whole card.
//
// Replaces, for a single solve whose chain does not fit K34's cluster (more
// than 16,384 rows at the default cutoff), the body of
// uzliti_slam_tpu/graph/solver.py:_pcg (:512-540) minus its Hessian-vector
// product, with uzliti_slam_tpu/graph/tridiag.py:block_tridiag_apply
// (:198-248) inside it.  What K10 (csrc/pcg.cu, its grid route: two
// launches a side) and K3 (csrc/chain_apply.cu: 2·levels + 1 launches) did
// in 27 launches a step at 100k nodes is one launch here.  It computes K34's
// step (csrc/pcg_chain.cu):
//   uz_pcg_grid_start: z0 = M⁻¹b, then x = 0, r = b, p = z0, rz = rᵀz0,
//                      b2 = bᵀb;
//   uz_pcg_grid_step (after K2 has written Hp = H·p):
//       pHp = pᵀHp, ok = pHp > 1e-20 && rz > tol·(b2 + 1e-30),
//       α = ok ? rz / (pHp == 0 ? 1 : pHp) : 0, x += α·p, r -= α·Hp;
//       z = M⁻¹r through every level and the root;
//       rz' = rᵀz, β = ok ? rz' / (rz == 0 ? 1 : rz) : 0,
//       p = ok ? z + β·p : p, rz = ok ? rz' : rz.
// The scalars stay on the card in K10's scal (1, 4) = [rz, b2, ok, rz kept];
// the axpys are K10's explicitly rounded ones (__fmul_rn, __fadd_rn), the
// apply K3's per-level arithmetic:
//   forward  b'[j] = b[2j] - P1m[j]·b[2j-1] - P2[j]·b[2j+1]   (b[-1] = 0),
//   root     x' = root_inv·b' (a warp a row, lanes striding it, a fixed
//            shuffle tree),
//   back     x[2j] = x'[j],  x[2j+1] = Dinv_o[j]·b[2j+1] - G1[j]·x'[j]
//            - G2[j]·x'[j+1]   (x'[half] = 0).
// Rows at or past n read as zero (the pad to a power of two).  With a
// column mask (the generic loop's planar solve) the level-0 vector is read
// through the mask and z is masked, as minv(r) = M⁻¹(r·m)·m.
//
// What bounds it: the bytes.  At 100k nodes (11 levels, a 64-block root)
// the level products are 5 x 36 floats x 131,008 odd blocks, 94 MB, read
// once a step: 0.028 ms at 3.35 TB/s, with the vectors ~0.035 ms.  They no
// longer fit the 50 MB L2, so K34's premise (products L2-resident across
// the steps, level vectors in one cluster's shared memory) fails here, and
// the products are streamed from device memory once a step across the
// whole card.
//
// Design.
// - One cooperative launch (cudaLaunchCooperativeKernel), its grid every
//   CTA the card holds at once (the occupancy API, as K9), the phases
//   separated by grid.sync(): pHp → (α, x, r and forward level 0) → each
//   forward level → the root → each back level → (rz' → β, p).  r's update
//   rides in forward level 0: each thread recomputes r - α·Hp for the
//   entries it reads (the same rounded bits every time), forward level 0
//   writes back the even rows and back level 0 the odd ones, each entry by
//   the one thread that reads it there, so no phase of its own is needed
//   for it: 2·levels + 2 barriers a step, 2·levels + 1 at the start.
// - Level products in warp tiles: a warp copies 10 odd blocks' matrices (2
//   at a forward level, 3 at a back level) into shared memory with
//   cp.async, 16 bytes a copy, its lanes on consecutive float4s
//   (coalesced); then computes them 5 blocks a pass, lane 6·g + i on block
//   g's output row i.  A lane loads only component i of the vector rows
//   its block needs (so a warp's vector loads are coalesced too) and takes
//   the other components from its block's lanes by warp shuffles: loading
//   whole rows in every lane made each phase wait on scattered loads.
//   The products do not depend on the vectors, so each warp issues its
//   first tile of the next level before the grid barrier that precedes it
//   (across the root for the first back level), and the copy's latency
//   overlaps the barrier's.  256 threads and 34 KB of shared memory a CTA,
//   at most 85 registers a thread: 3 CTAs an SM.  Capped at 64 for 4 CTAs
//   an SM, ptxas spilled and the step took ~9 % longer (PERF.md, PR 15).
//   The planar mask is read where it is used, not held in registers.
// - Level vectors and the back sweep's x live in device scratch that the
//   wrapper allocates once at the start (2.4 MB a vector at 100k: they stay
//   in L2); everything written in the launch is read with ordinary loads
//   after the barrier that follows the write, and only the factor, b and
//   Hp go through the read-only path.
// - Dots summed in a fixed order with no atomics: each CTA sums its rows
//   (a fixed grid-stride assignment, its warps in order) into a partial,
//   and after a barrier every CTA sums all partials in the same order, so
//   every CTA holds the same total and a rerun gives the same bits.
// - Every level and the root run across the whole grid.  Running the coarse
//   levels and the root inside one CTA with block barriers (fewer grid
//   barriers) measured slower at every depth tried (PERF.md, PR 15).
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
__device__ __forceinline__ float level0(const Vectors& v, float alpha, int n, int row, int k) {
  if (row < 0 || row >= n) return 0.f;
  const long long q = 6LL * row + k;
  if (v.start) return __ldg(v.in + q);
  return __fsub_rn(v.r[q], __fmul_rn(alpha, __ldg(v.in + q)));
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
          vm = level0(v, alpha, n, 2 * j - 1, i);
          ve = level0(v, alpha, n, 2 * j, i);
          vo = level0(v, alpha, n, 2 * j + 1, i);
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
            const float bq = __ldg(v.in + q);
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
        vo = l == 0 ? level0(v, alpha, n, 2 * j + 1, i) : bl[6 * (2 * j + 1) + i];
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
        dot += (v.start ? __ldg(v.in + qe) : v.r[qe]) * zv;
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

__global__ void __launch_bounds__(kThreads, kMinCtas)
pcg_grid_kernel(Chain f, Vectors v) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 tiles[];   // kWarps tiles of 3·kTile4 (tile_bytes)
  __shared__ float red[kWarps];
  const int tid = threadIdx.x, warp = tid / 32, G = static_cast<int>(gridDim.x);
  float4* st = tiles + 3 * kTile4 * warp;
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
#pragma unroll 4
    for (long long i = gt; i < nf; i += gts) s += v.p[i] * __ldg(v.in + i);
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
    forward_level(f, v, l, alpha, gw, gws, st, staged, b2);
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
    back_level(f, v, l, alpha, gw, gws, st, staged, dot);
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

// Dynamic shared memory of a CTA: each warp's tile.
constexpr int kTileBytes = kWarps * 3 * kTile4 * static_cast<int>(sizeof(float4));

// CTAs the card holds at once (cached per device, after allowing the
// kernel its dynamic shared memory); 0 on an error.
int resident_ctas() {
  static int cache[kMaxDevices][2] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (cache[dev][0] == 0) {
    int fit = 0, sms = 0;
    if (cudaFuncSetAttribute(pcg_grid_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kTileBytes) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, pcg_grid_kernel, kThreads,
                                                      kTileBytes) != cudaSuccess ||
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

int launch(const void* table, int levels, int m_root, int n, const float* cmask, Vectors v,
           float* scratch, long long scratch_size, int max_ctas, void* stream) {
  Chain f;
  int err = make_chain(table, levels, m_root, n, cmask, scratch, &f);
  if (err != 0) return err;
  if (scratch_size < scratch_floats(levels, m_root)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = resident_ctas();
  if (grid <= 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  if (grid > max_ctas) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&f, &v};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(pcg_grid_kernel), dim3(grid), dim3(kThreads), args,
      kTileBytes, static_cast<cudaStream_t>(stream)));
}

}  // namespace

// A single solve: vectors (n, 6), scal (1, 4); the factor as a host table
// (see make_chain) of a chain of m_root << levels rows, levels >= 1; cmask
// nullptr or 6 floats; scratch (scratch_size floats, at least
// 12·m_root·(2^levels - 1)) and partials (2·max_ctas floats) from the
// wrapper.

// The number of CTAs a launch takes on the current device (0 if it cannot
// run).
extern "C" int uz_pcg_grid_ctas() { return resident_ctas(); }

// x, r, p and scal from b: z0 = M⁻¹b in p.
extern "C" int uz_pcg_grid_start(const void* table, int levels, int m_root, int n,
                                 const float* cmask, const float* b, float* x,
                                 float* r, float* p, float* scal, float* scratch,
                                 long long scratch_size, float* partials, int max_ctas,
                                 void* stream) {
  const Vectors v{b, x, r, p, nullptr, scal, partials, 0.f, 1};
  return launch(table, levels, m_root, n, cmask, v, scratch, scratch_size, max_ctas, stream);
}

// One step after Hp = H·p: x, r, p and scal in place, z = M⁻¹r (scratch).
extern "C" int uz_pcg_grid_step(const float* Hp, float tol, const void* table, int levels,
                                int m_root, int n, const float* cmask, float* x,
                                float* r, float* p, float* z, float* scal, float* scratch,
                                long long scratch_size, float* partials, int max_ctas,
                                void* stream) {
  const Vectors v{Hp, x, r, p, z, scal, partials, tol, 0};
  return launch(table, levels, m_root, n, cmask, v, scratch, scratch_size, max_ctas, stream);
}
