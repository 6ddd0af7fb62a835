// K38 pcg_fleet_solve: a fleet's whole PCG solve in one launch, a CTA an
// instance with its factor and vectors in shared memory.
//
// Replaces uzliti_slam_tpu/graph/solver.py:_pcg (:512-540) under jax.vmap in
// uzliti_slam_tpu/parallel/sharded.py:optimize_batch (:115-146), with
// solver.py:_make_hvp (:306-322) and graph/tridiag.py:block_tridiag_apply
// (:198-248) inside it.  For each of the fleet's B instances: K34's start,
// then `steps` times Hp = H(p·m)·m and K34's step (csrc/pcg_chain.cu), where
// the fleet ran, a step, K2 (csrc/hvp.cu: two launches, float atomics),
// K10's alpha (csrc/pcg.cu), K3 (csrc/chain_apply.cu: 2·levels + 1
// launches) and K10's beta, each streaming every instance's operator,
// factor or vectors through device memory:
//   start: z0 = M⁻¹(b·m)·m, x = 0, r = b, p = z0, rz = rᵀz0, b2 = bᵀb;
//   step:  Hp = H(p·m)·m; pHp = pᵀHp, ok = pHp > 1e-20 && rz > tol·(b2 + 1e-30),
//          α = ok ? rz / (pHp == 0 ? 1 : pHp) : 0, x += α·p, r -= α·Hp;
//          z = M⁻¹(r·m)·m; rz' = rᵀz, β = ok ? rz' / (rz == 0 ? 1 : rz) : 0,
//          p = ok ? z + β·p : p, rz = ok ? rz' : rz.
// Each instance's dots, α, β and stall flag are its own, as under the
// reference's vmap; scal (B, 4) = [rz, b2, ok, rz0] as K34 leaves it.  The
// axpys are K10's rounded ones (__fmul_rn, __fadd_rn); the apply is K3's
// per-level arithmetic in K34's order, the root a warp a row with a fixed
// shuffle tree; a dot sums a fixed assignment of the instance's entries to
// threads, then the warps in order.  No atomics: the same inputs give the
// same bits.  The planar mask m (the generic loop's cmask) is K35's: H(p·m)·m
// and M⁻¹(r·m)·m.
//
// Hv = ((Σ_e J_sideᵀ·W·(Jᵢ·vm[from] + Jⱼ·vm[to])) + damp·vm)·free·m, vm =
// p·m·free, kept matrix-free (JᵀWJ blocks assembled once moved x by 9.7e-5
// of max|x| in float32, csrc/pcg_chain.cu).  Instance b's valid edges are
// the side-0 entries of the flattened fleet's incidence table between
// row_ptr[b·n] and row_ptr[(b+1)·n], compacted in table order at entry.  A
// step's edge pass takes a thread an edge (its Jᵢ, Jⱼ, W as float4 through
// L1) and writes the edge's Jᵢᵀ·Wu and Jⱼᵀ·Wu into shared memory; behind a
// block barrier each node sums its entries' terms in table order.  Only
// valid edges are read.
//
// What bounds it: the bytes, each read once a PCG solve: an instance's
// factor (64 nodes at cutoff 16: the 96 x 96 root, 36.9 KB, and 2 levels'
// products, 34.6 KB), its valid edges' Jᵢ, Jⱼ, W (432 B an edge), b, damp,
// free and its table; ~0.14-0.17 ms for the 4096 x 64 fleet at 3.35 TB/s.
// The design keeps every byte on chip once read: the instance's factor is
// copied into shared memory at entry (cp.async, 16 bytes a copy, while the
// table is compacted), and x, r, p, z, Hp and the level vectors live there
// for the whole solve, so nothing crosses device memory between steps.  At
// 92.8 KB a CTA two instances share an SM, and each is a chain of short
// phases (13 block barriers a step) whose shared-memory loads and warp
// shuffles, not its bytes, set the time: phase stamps put the root's
// matvec first, so a warp sums 12 of its rows at once (kRootIlp).
// scripts/k10_k2_variants.py substitutes and times the knobs: kRootSmem
// false reads the root through L2 at each apply (3 CTAs an SM); kStageOp
// copies the instance's operator into shared memory as well (1 CTA an SM
// at 128 edge slots; without it the operator is read through L1 / L2 each
// step); kPersistent runs the CTAs the card holds at once, each walking the
// instances and copying the next instance's factor into a second buffer
// while the current one solves; kThreads, kMinCtas; -DUZ_FLEET_STAMPS=1
// the stamps.  The shipped values measured fastest, and the edge pass a
// thread an edge beat 6 lanes an edge with warp shuffles (PERF.md §6).
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxLevels = 16;
constexpr int kMaxSmemBytes = 232448;   // shared memory one CTA can use on Hopper
constexpr int kMaxDevices = 64;
constexpr int kMinCtas = 2;             // CTAs an SM the registers are budgeted for
constexpr int kRootIlp = 12;            // rows of root_inv a warp sums at once
constexpr bool kRootSmem = true;        // the root in shared memory (else read through L2)
constexpr bool kStageOp = false;        // the operator in shared memory too
constexpr bool kPersistent = false;     // a resident grid walking the instances

// Phase stamps (%globaltimer, thread 0, summed over a CTA's instances) for
// scripts/k10_k2_variants.py, built with -DUZ_FLEET_STAMPS=1; off in the
// package's build.
#ifndef UZ_FLEET_STAMPS
#define UZ_FLEET_STAMPS 0
#endif
constexpr int kStampCtas = 512, kStampSlots = 12;
#if UZ_FLEET_STAMPS
__device__ unsigned long long g_stamps[kStampCtas][kStampSlots];
#endif
struct Clock {
  unsigned long long last = 0;
  __device__ __forceinline__ void tick(int slot) {
#if UZ_FLEET_STAMPS
    if (threadIdx.x == 0 && blockIdx.x < kStampCtas) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      if (slot >= 0) g_stamps[blockIdx.x][slot] += t - last;
      last = t;
    }
#endif
  }
};

struct Fleet {
  const float* lv[kMaxLevels][5];   // each level's Dinv_o, P1m, P2, G1, G2: (B, half, 6, 6)
  const float* root_inv;            // (B, 6·m_root, 6·m_root)
  const float* cmask;               // 6 column weights, or nullptr
  int levels, m_root, n, batch;     // n: the rows (nodes) of an instance
  int edges;                        // edge slots of an instance
};

// The Gauss-Newton operator of the flattened fleet (K2's arguments) and its
// incidence table.
struct Op {
  const float* Ji;       // (B·edges, 6, 6)
  const float* Jj;
  const float* W;
  const int* e_from;     // (B·edges,), node ids of the flattened fleet
  const int* e_to;
  const float* damp;     // (B·n, 6)
  const float* free;     // (B·n,)
  const int* row_ptr;    // (B·n + 1,)
  const int* entries;    // 2e + side, each node's in table order
};

struct Vecs {
  const float* b;        // (B·n, 6)
  float* x;
  float* r;
  float* p;
  float* scal;           // (B, 4)
  float tol;
  int steps;
};

__host__ __device__ inline long long up4(long long w) { return (w + 3) & ~3LL; }

// Floats of one instance's factor in shared memory: the levels' products
// (level after level its Dinv_o, P1m, P2, G1, G2, half·36 floats each), then
// the root (with kRootSmem).
__host__ __device__ inline long long factor_words(int L, int m_root) {
  return 180LL * m_root * ((1LL << L) - 1) + (kRootSmem ? 36LL * m_root * m_root : 0);
}

// Offset of level l's products in the factor.
__host__ __device__ inline long long level_words(int L, int m_root, int l) {
  return 180LL * m_root * ((1LL << L) - (1LL << (L - l)));
}

// Offset of level l's vector (l = 1..L, 2·half_l rows) in the level region.
__host__ __device__ inline long long vec_words(int L, int m_root, int l) {
  return 6LL * m_root * ((1LL << L) - (1LL << (L + 1 - l)));
}

// A CTA's shared memory, in 4-byte words: the factor (two buffers with
// kPersistent), the vectors, the level vectors and the back sweep's x,
// damp and free, the edges' terms (and the operator with kStageOp), then
// the integer tables (row offsets, entries as (edge, side), the edges'
// endpoints, their fleet ids, a slot's edge) and the sums.
struct Plan {
  long long fac[2], x, p, z, hp, r, vec, xv, damp, fr, ye, opj, cm, red, rp, qe, ef, et, eg, s2c;
  long long total;
};

__host__ __device__ inline Plan plan(int L, int m_root, int n, int E, bool stage_op,
                                     bool persistent) {
  Plan s{};
  const long long F = factor_words(L, m_root), n2 = static_cast<long long>(m_root) << L;
  const long long lvw = 6LL * m_root * ((1LL << L) - 1);
  long long at = 0;
  s.fac[0] = at;
  at += F;
  s.fac[1] = at;
  if (persistent) at += F;
  s.x = at;
  at = up4(at + 6LL * n);
  s.p = at;
  at = up4(at + 6LL * n);
  s.z = at;
  at = up4(at + 6LL * n);
  s.hp = at;
  at = up4(at + 6LL * n);
  s.r = at;
  at = up4(at + 6 * n2);
  s.vec = at;
  at = up4(at + lvw);
  s.xv = at;
  at = up4(at + lvw);
  s.damp = at;
  at = up4(at + 6LL * n);
  s.fr = at;
  at = up4(at + n);
  s.ye = at;
  at = up4(at + 12LL * E);
  s.opj = at;
  if (stage_op) at = up4(at + 108LL * E);
  s.cm = at;
  at += 8;
  s.red = at;
  at += 2 * kWarps;
  s.rp = at;
  at += n + 1;
  s.qe = at;
  at += 2LL * E;
  s.ef = at;
  at += E;
  s.et = at;
  at += E;
  s.eg = at;
  at += E;
  s.s2c = at;
  at += E;
  s.total = at;
  return s;
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

// Copy instance b's factor into dst asynchronously (cp.async, 16 bytes a
// copy, coalesced): level after level its five products, then its root.
__device__ void issue_factor(const Fleet& f, int b, float* dst) {
  const int L = f.levels;
  float4* d = reinterpret_cast<float4*>(dst);
  for (int l = 0; l < L; ++l) {
    const int cnt = 9 * (f.m_root << (L - 1 - l));   // float4s of one (half, 6, 6) product
    for (int k = 0; k < 5; ++k) {
      const float4* src = reinterpret_cast<const float4*>(f.lv[l][k]) +
                          static_cast<long long>(b) * cnt;
      for (int i = threadIdx.x; i < cnt; i += kThreads) __pipeline_memcpy_async(d + i, src + i, 16);
      d += cnt;
    }
  }
  if (kRootSmem) {
    const int cnt = 9 * f.m_root * f.m_root;
    const float4* src =
        reinterpret_cast<const float4*>(f.root_inv) + static_cast<long long>(b) * cnt;
    for (int i = threadIdx.x; i < cnt; i += kThreads) __pipeline_memcpy_async(d + i, src + i, 16);
  }
  __pipeline_commit();
}

// Instance b's table, damp, free and mask into shared memory, and its valid
// edges (the side-0 entries) compacted in table order: eg[c] the fleet id
// of edge c, ef / et its local endpoints, qe[q] = c << 1 | side of entry q.
// With kStage the edges' Jᵢ, Jⱼ, W are copied too (cp.async; they land by
// the caller's wait).  Returns the number of valid edges.
template <bool kStage>
__device__ int stage_instance(const Fleet& f, const Op& op, int b, float* sm, const Plan& s) {
  const int n = f.n, E = f.edges, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int* rp = reinterpret_cast<int*>(sm + s.rp);
  int* qe = reinterpret_cast<int*>(sm + s.qe);
  int* ef = reinterpret_cast<int*>(sm + s.ef);
  int* et = reinterpret_cast<int*>(sm + s.et);
  int* eg = reinterpret_cast<int*>(sm + s.eg);
  int* s2c = reinterpret_cast<int*>(sm + s.s2c);
  int* cnt = reinterpret_cast<int*>(sm + s.red);
  const long long node0 = static_cast<long long>(b) * n, e0 = static_cast<long long>(b) * E;
  const int qa = __ldg(op.row_ptr + node0);
  const int nq = min(max(__ldg(op.row_ptr + node0 + n) - qa, 0), 2 * E);
  for (int i = tid; i <= n; i += kThreads) rp[i] = min(__ldg(op.row_ptr + node0 + i) - qa, nq);
  for (int i = tid; i < 6 * n; i += kThreads) sm[s.damp + i] = __ldg(op.damp + 6 * node0 + i);
  for (int i = tid; i < n; i += kThreads) sm[s.fr + i] = __ldg(op.free + node0 + i);
  if (tid < 6) sm[s.cm + tid] = f.cmask != nullptr ? __ldg(f.cmask + tid) : 1.f;
  int ne = 0;
  for (int q0 = 0; q0 < nq; q0 += kThreads) {
    const int q = q0 + tid;
    const int code = q < nq ? __ldg(op.entries + qa + q) : 1;
    const bool first = (code & 1) == 0;
    const unsigned m = __ballot_sync(0xffffffffu, first);
    if (lane == 0) cnt[warp] = __popc(m);
    __syncthreads();
    int before = ne, total = ne;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? cnt[w] : 0;
      total += cnt[w];
    }
    if (first) {
      const int c = before + __popc(m & ((1u << lane) - 1u));
      eg[c] = code >> 1;
      s2c[(code >> 1) - e0] = c;
    }
    ne = total;
    __syncthreads();
  }
  for (int q = tid; q < nq; q += kThreads) {
    const int code = __ldg(op.entries + qa + q);
    qe[q] = (s2c[(code >> 1) - e0] << 1) | (code & 1);
  }
  for (int c = tid; c < ne; c += kThreads) {
    ef[c] = static_cast<int>(__ldg(op.e_from + eg[c]) - node0);
    et[c] = static_cast<int>(__ldg(op.e_to + eg[c]) - node0);
  }
  if constexpr (kStage) {
    float4* dst = reinterpret_cast<float4*>(sm + s.opj);
    for (int i = tid; i < 27 * ne; i += kThreads) {
      const int c = i / 27, m = (i % 27) / 9, k = i % 9;
      const float* src = (m == 0 ? op.Ji : (m == 1 ? op.Jj : op.W)) + 36LL * eg[c];
      __pipeline_memcpy_async(dst + i, reinterpret_cast<const float4*>(src) + k, 16);
    }
    __pipeline_commit();
  }
  return ne;
}

// out = M⁻¹(r·m)·m on the instance's factor in shared memory (r: the
// level-0 vector, 2^L·m_root rows, zero past n), K3's sweeps in K34's
// order; returns this thread's terms of rᵀout.  Ends with a block barrier
// after each level; out is complete after the caller's next barrier.
__device__ float apply(const Fleet& f, const float* fac, const float* root, const float* r,
                       float* out, float* sm, const Plan& s, Clock& clock) {
  const int L = f.levels, m_root = f.m_root, n = f.n, tid = threadIdx.x;
  const float* cm = sm + s.cm;
  float dot = 0.f;
  // forward: level l's vector to level l + 1's, the level-0 vector masked
  for (int l = 0; l < L; ++l) {
    const int half = m_root << (L - 1 - l);
    const float* bl = l == 0 ? r : sm + s.vec + vec_words(L, m_root, l);
    float* bn = sm + s.vec + vec_words(L, m_root, l + 1);
    const float* P1m = fac + level_words(L, m_root, l) + 36 * half;
    const float* P2 = P1m + 36 * half;
    for (int t = tid; t < 6 * half; t += kThreads) {
      const int j = t / 6, i = t - 6 * j;
      const float* A = P1m + 36 * j + 6 * i;
      const float* B = P2 + 36 * j + 6 * i;
      const float* bo = bl + 6 * (2 * j + 1);
      float a = 0.f, c = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        const float w = l == 0 ? cm[k] : 1.f;
        a += A[k] * (j > 0 ? bl[6 * (2 * j - 1) + k] * w : 0.f);
        c += B[k] * (bo[k] * w);
      }
      bn[t] = bl[12 * j + i] * (l == 0 ? cm[i] : 1.f) - a - c;
    }
    __syncthreads();
  }
  clock.tick(7);
  // the root: a warp a row of root_inv (kRootIlp rows at once), a fixed
  // shuffle tree
  const int nr = 6 * m_root, warp = tid / 32, lane = tid % 32;
  const float* bL = L == 0 ? r : sm + s.vec + vec_words(L, m_root, L);
  float* xL = sm + s.xv + vec_words(L, m_root, L);
  for (int w0 = warp; w0 < nr; w0 += kWarps * kRootIlp) {
    float acc[kRootIlp];
#pragma unroll
    for (int u = 0; u < kRootIlp; ++u) acc[u] = 0.f;
    for (int k = lane; k < nr; k += 32) {
      const float bk = L == 0 ? bL[k] * cm[k % 6] : bL[k];
#pragma unroll
      for (int u = 0; u < kRootIlp; ++u) {
        const int w = min(w0 + u * kWarps, nr - 1);
        acc[u] += (kRootSmem ? root[w * nr + k] : __ldg(root + w * nr + k)) * bk;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < kRootIlp; ++u) acc[u] += __shfl_xor_sync(0xffffffffu, acc[u], o);
#pragma unroll
    for (int u = 0; u < kRootIlp; ++u) {
      const int w = w0 + u * kWarps;
      if (lane != 0 || w >= nr) continue;
      if (L > 0) {
        xL[w] = acc[u];
      } else if (w / 6 < n) {
        const float zv = acc[u] * cm[w % 6];
        out[w] = zv;
        dot += r[w] * zv;
      }
    }
  }
  __syncthreads();
  clock.tick(8);
  // back: level l + 1's x to level l's; level 0's is the output
  for (int l = L - 1; l >= 0; --l) {
    const int half = m_root << (L - 1 - l);
    const float* xc = sm + s.xv + vec_words(L, m_root, l + 1);
    float* xf = sm + s.xv + vec_words(L, m_root, l > 0 ? l : 1);
    const float* bl = l == 0 ? r : sm + s.vec + vec_words(L, m_root, l);
    const float* Dinv = fac + level_words(L, m_root, l);
    const float* G1 = Dinv + 3 * 36 * half;
    const float* G2 = G1 + 36 * half;
    for (int t = tid; t < 6 * half; t += kThreads) {
      const int j = t / 6, i = t - 6 * j;
      const float* D = Dinv + 36 * j + 6 * i;
      const float* A = G1 + 36 * j + 6 * i;
      const float* B = G2 + 36 * j + 6 * i;
      const float* xj = xc + 6 * j;
      const float* bo = bl + 6 * (2 * j + 1);
      const bool next = j + 1 < half;
      float a = 0.f, g1 = 0.f, g2 = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        a += D[k] * (bo[k] * (l == 0 ? cm[k] : 1.f));
        g1 += A[k] * xj[k];
        g2 += B[k] * (next ? xj[6 + k] : 0.f);
      }
      const float even = xj[i], odd = a - g1 - g2;
      if (l > 0) {
        xf[12 * j + i] = even;
        xf[12 * j + 6 + i] = odd;
        continue;
      }
      if (2 * j < n) {
        const float zv = even * cm[i];
        out[12 * j + i] = zv;
        dot += r[12 * j + i] * zv;
      }
      if (2 * j + 1 < n) {
        const float zv = odd * cm[i];
        out[12 * j + 6 + i] = zv;
        dot += r[12 * j + 6 + i] * zv;
      }
    }
    __syncthreads();
  }
  clock.tick(9);
  return dot;
}

// Hp = H(p·m)·m for the instance, as K2's operator: the edge pass (a thread
// an edge) into ye, a block barrier, then each node's entries' terms in
// table order.  Returns this thread's terms of pᵀHp; Hp is complete after
// the caller's next barrier.
template <bool kStage>
__device__ float hvp(const Op& op, int n, int ne, const float* p, float* hp, float* sm,
                     const Plan& s) {
  const int tid = threadIdx.x;
  const float* cm = sm + s.cm;
  const float* fr = sm + s.fr;
  const float* damp = sm + s.damp;
  float* ye = sm + s.ye;
  const int* ef = reinterpret_cast<const int*>(sm + s.ef);
  const int* et = reinterpret_cast<const int*>(sm + s.et);
  const int* eg = reinterpret_cast<const int*>(sm + s.eg);
  const int* qe = reinterpret_cast<const int*>(sm + s.qe);
  const int* rp = reinterpret_cast<const int*>(sm + s.rp);
  // the edge pass, a thread an edge, its Jᵢ, Jⱼ, W read as float4
  for (int c = tid; c < ne; c += kThreads) {
    const int nf = ef[c], nt = et[c];
    float vf[6], vt[6], u[6], wu[6];
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      vf[k] = p[6 * nf + k] * cm[k] * fr[nf];
      vt[k] = p[6 * nt + k] * cm[k] * fr[nt];
    }
    const float4* J4 = kStage ? reinterpret_cast<const float4*>(sm + s.opj + 108LL * c)
                              : nullptr;
    const long long e9 = 9LL * eg[c];
    auto mat = [&](int m, float* out) {   // matrix m (Jᵢ, Jⱼ, W) as 36 floats
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const float4 v4 = kStage ? J4[9 * m + q]
                                 : __ldg(reinterpret_cast<const float4*>(
                                       m == 0 ? op.Ji : (m == 1 ? op.Jj : op.W)) + e9 + q);
        out[4 * q] = v4.x;
        out[4 * q + 1] = v4.y;
        out[4 * q + 2] = v4.z;
        out[4 * q + 3] = v4.w;
      }
    };
    float A[36], B[36];
    mat(0, A);
    mat(1, B);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        a += A[6 * i + k] * vf[k];
        b += B[6 * i + k] * vt[k];
      }
      u[i] = a + b;
    }
    {
      float C[36];
      mat(2, C);
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        float w = 0.f;
#pragma unroll
        for (int k = 0; k < 6; ++k) w += C[6 * i + k] * u[k];
        wu[i] = w;
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      float yi = 0.f, yj = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        yi += A[6 * k + i] * wu[k];
        yj += B[6 * k + i] * wu[k];
      }
      ye[12 * c + i] = yi;
      ye[12 * c + 6 + i] = yj;
    }
  }
  __syncthreads();
  // the node sums, a thread a (row, component), in table order
  float part = 0.f;
  for (int t = tid; t < 6 * n; t += kThreads) {
    const int row = t / 6, k = t - 6 * row;
    float y = 0.f;
    for (int q = rp[row]; q < rp[row + 1]; ++q) {
      const int code = qe[q];
      y += ye[12 * (code >> 1) + 6 * (code & 1) + k];
    }
    const float frr = fr[row];
    const float vm = p[t] * cm[k] * frr;
    const float h = ((y + damp[t] * vm) * frr) * cm[k];
    hp[t] = h;
    part += p[t] * h;
  }
  return part;
}

// Instance b's solve, its factor, table and operator staged.
template <bool kStage>
__device__ void solve_instance(const Fleet& f, const Op& op, const Vecs& v, int b, int ne,
                               const float* fac, float* sm, const Plan& s, Clock& clock) {
  const int n = f.n, tid = threadIdx.x;
  const int n2 = f.m_root << f.levels;
  const long long o = 6LL * b * n;
  float* x = sm + s.x;
  float* p = sm + s.p;
  float* z = sm + s.z;
  float* hp = sm + s.hp;
  float* r = sm + s.r;
  float* red = sm + s.red;
  // the start: x = 0, r = b (rows past n zero), p = z0
  float s2 = 0.f;
  for (int i = tid; i < 6 * n2; i += kThreads) {
    float bi = 0.f;
    if (i < 6 * n) {
      bi = __ldg(v.b + o + i);
      x[i] = 0.f;
      s2 += bi * bi;
    }
    r[i] = bi;
  }
  const float b2 = block_sum(s2, red);
  const int nr = 6 * f.m_root;
  const float* root = kRootSmem ? fac + level_words(f.levels, f.m_root, f.levels)
                                : f.root_inv + static_cast<long long>(b) * nr * nr;
  const float rz0 = block_sum(apply(f, fac, root, r, p, sm, s, clock), red);
  clock.tick(1);
  float rz = rz0;
  bool ok = true;
  for (int step = 0; step < v.steps; ++step) {
    const float pHp = block_sum(hvp<kStage>(op, n, ne, p, hp, sm, s), red);
    clock.tick(2);
    ok = (pHp > 1e-20f) && (rz > v.tol * (b2 + 1e-30f));
    const float alpha = ok ? rz / (pHp == 0.f ? 1.f : pHp) : 0.f;
    for (int i = tid; i < 6 * n; i += kThreads) {
      x[i] = __fadd_rn(x[i], __fmul_rn(alpha, p[i]));
      r[i] = __fsub_rn(r[i], __fmul_rn(alpha, hp[i]));
    }
    __syncthreads();
    clock.tick(3);
    const float rz_new = block_sum(apply(f, fac, root, r, z, sm, s, clock), red);
    clock.tick(4);
    const float beta = ok ? rz_new / (rz == 0.f ? 1.f : rz) : 0.f;
    if (ok)
      for (int i = tid; i < 6 * n; i += kThreads) p[i] = __fadd_rn(z[i], __fmul_rn(beta, p[i]));
    rz = ok ? rz_new : rz;
    __syncthreads();
    clock.tick(5);
  }
  for (int i = tid; i < 6 * n; i += kThreads) {
    v.x[o + i] = x[i];
    v.r[o + i] = r[i];
    v.p[o + i] = p[i];
  }
  if (tid == 0) {
    float* sc = v.scal + 4LL * b;
    sc[0] = rz;
    sc[1] = b2;
    sc[2] = ok ? 1.f : 0.f;
    sc[3] = rz0;
  }
  clock.tick(6);
}

// A CTA an instance (kPersist: each CTA of a resident grid walks instances
// blockIdx.x, + gridDim.x, ..., its next instance's factor copied into the
// other buffer while the current one solves).
template <bool kStage, bool kPersist>
__global__ void __launch_bounds__(kThreads, kMinCtas)
pcg_fleet_kernel(Fleet f, Op op, Vecs v) {
  extern __shared__ __align__(16) float sm[];
  const Plan s = plan(f.levels, f.m_root, f.n, f.edges, kStage, kPersist);
  Clock clock;
  clock.tick(-1);
  const int stride = kPersist ? static_cast<int>(gridDim.x) : f.batch;
  if (kPersist && static_cast<int>(blockIdx.x) < f.batch)
    issue_factor(f, blockIdx.x, sm + s.fac[0]);
  int it = 0;
  for (int b = blockIdx.x; b < f.batch; b += stride, ++it) {
    float* fac = sm + s.fac[kPersist ? (it & 1) : 0];
    if (!kPersist) issue_factor(f, b, fac);
    const int ne = stage_instance<kStage>(f, op, b, sm, s);
    __pipeline_wait_prior(0);
    __syncthreads();
    if (kPersist && b + stride < f.batch) issue_factor(f, b + stride, sm + s.fac[(it + 1) & 1]);
    clock.tick(0);
    solve_instance<kStage>(f, op, v, b, ne, fac, sm, s, clock);
    __syncthreads();
  }
}

const void* shipped_kernel() {
  return reinterpret_cast<const void*>(pcg_fleet_kernel<kStageOp, kPersistent>);
}

// Once per device: the kernel may take a whole CTA's shared memory; the
// persistent form's grid is the CTAs the card holds at once.
int prepare(int smem, int* resident) {
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[dev] == 0) {
    err = cudaFuncSetAttribute(shipped_kernel(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmemBytes);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  *resident = 0;
  if (kPersistent) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, shipped_kernel(), kThreads,
                                                        smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    *resident = per_sm * sms[dev];
  }
  return 0;
}

}  // namespace

#if UZ_FLEET_STAMPS
// The phase stamps' sums, kStampCtas x kStampSlots (ns), then zeroed: stage,
// start, Hv, the α update, the apply's sum, the p update, the write-back,
// then within every apply its forward levels, root and back levels.
extern "C" int fleet_stamps_read(unsigned long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, g_stamps, sizeof(g_stamps));
  if (err == cudaSuccess) {
    static unsigned long long zero[kStampCtas][kStampSlots] = {};
    err = cudaMemcpyToSymbol(g_stamps, zero, sizeof(g_stamps));
  }
  return static_cast<int>(err);
}
#endif

// The fleet's B instances of n rows and `edges` edge slots each: vectors
// (B·n, 6), scal (B, 4); the factor as a host table of pointers, 5 a level
// (Dinv_o, P1m, P2, G1, G2: (B, half, 6, 6)), then root_inv (B, 6·m_root,
// 6·m_root), each 16-byte aligned, of chains of m_root << levels rows;
// cmask nullptr or 6 floats; the operator (Ji, Jj, W (B·edges, 6, 6); e_from,
// e_to (B·edges,); damp (B·n, 6); free (B·n,)) and the flattened fleet's
// incidence table (row_ptr (B·n + 1,), entries (2·B·edges,)).  x, r, p and
// scal after `steps` steps, as K34's start and steps leave them.
extern "C" int uz_pcg_fleet_solve(const void* table, int levels, int m_root, int n, int batch,
                                  int edges, const float* cmask, const float* Ji, const float* Jj,
                                  const float* W, const int* e_from, const int* e_to,
                                  const float* damp, const float* free, const int* row_ptr,
                                  const int* entries, const float* b, int steps, float tol,
                                  float* x, float* r, float* p, float* scal, void* stream) {
  if (levels < 0 || levels > kMaxLevels || m_root < 1 || (m_root & (m_root - 1)) != 0 ||
      n < 1 || n > (static_cast<long long>(m_root) << levels) || batch < 1 || edges < 0 ||
      steps < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = 4 * plan(levels, m_root, n, edges, kStageOp, kPersistent).total;
  if (smem > kMaxSmemBytes) return static_cast<int>(cudaErrorInvalidValue);
  Fleet f{};
  const float* const* ptrs = static_cast<const float* const*>(table);
  for (int l = 0; l < levels; ++l)
    for (int k = 0; k < 5; ++k) f.lv[l][k] = ptrs[5 * l + k];
  f.root_inv = ptrs[5 * levels];
  for (int q = 0; q <= 5 * levels; ++q)
    if (reinterpret_cast<unsigned long long>(ptrs[q]) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
  f.cmask = cmask;
  f.levels = levels;
  f.m_root = m_root;
  f.n = n;
  f.batch = batch;
  f.edges = edges;
  const Op op{Ji, Jj, W, e_from, e_to, damp, free, row_ptr, entries};
  const Vecs v{b, x, r, p, scal, tol, steps};
  int resident = 0;
  const int err = prepare(static_cast<int>(smem), &resident);
  if (err != 0) return err;
  int grid = batch;
  if (kPersistent) {
    if (resident < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
    grid = resident < batch ? resident : batch;
  }
  pcg_fleet_kernel<kStageOp, kPersistent><<<grid, kThreads, smem,
                                             static_cast<cudaStream_t>(stream)>>>(f, op, v);
  return static_cast<int>(cudaGetLastError());
}
