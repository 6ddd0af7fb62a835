// K5 relax_min: multi-source Bellman-Ford over the pose graph's edges, each
// sweep relaxing only the edges of the nodes that changed in the sweep before.
//
// Replaces uzliti_slam_tpu/graph/shortest_path.py:shortest_paths (its
// fori_loop body, :50-55), vmapped over sources by pairwise_graph_distance
// (:60-72) and run on one row by reevaluate_uncertainty (:75-84).  Entries:
//   uz_relax_table        the node-to-edge table of the edges of finite
//                         weight, one CTA (the other entries read it)
//   uz_relax_min          rows (R, N) of start distances -> (R, N)
//                         (shortest_paths)
//   uz_relax_pairs        sources, targets (B,) -> (B,) distances, the (B, N)
//                         start rows and the target gather inside the launch
//                         (pairwise_graph_distance)
//   uz_relax_uncertainty  the oldest valid node (least stamp, first slot on a
//                         tie) as the source; writes where(valid & dist < INF,
//                         dist, old) (reevaluate_uncertainty)
//
// Each of the R rows runs n_iters Jacobi sweeps
//   d'[to]   = min(d[to],    min(d[from] + w, INF))
//   d'[from] = min(d'[from], min(d[to]   + w, INF))
// reading the sweep's START values d, as the JAX body does (it gathers
// dist[ef] and dist[et] before either scatter-min).  After k sweeps a node
// holds the least float sum, taken left to right from a source, over walks
// of at most k edges: with n_iters below the hop diameter (64 sweeps against
// ~250 hops on the 500-node epoch graph) the distances are not shortest
// paths, and Dijkstra or an in-place (Gauss-Seidel) sweep would return
// smaller numbers.
//
// Design: a CTA a row.  Only the nodes whose value fell in sweep k - 1 (the
// frontier; in sweep 0 the nodes of finite start value) can lower anything
// in sweep k: an edge whose ends did not change offers a value that is
// already in place, an edge of weight INF lowers nothing (so the table holds
// only the edges of finite weight; padded slots, which join node 0 to
// itself, and self-loops, whose weight is >= 0, stay out).  So sweep k
// relaxes only the frontier's table entries.  The row is double-buffered:
// the read buffer holds d_k and is not written during the sweep; the write
// buffer holds d_{k-1}, which differs from d_k only on the frontier, so each
// frontier node first lowers its own slot to d_k, then offers d_k[u] + w to
// its neighbours, all with atomicMin on the int bits (distances are >= 0 and
// at most INF = 3.4e38 < FLT_MAX, so their int order is their float order;
// every update is a min, so their order is free).  A neighbour v whose offer
// is below d_k[v] falls in this sweep: it joins the next frontier once (a
// bit a node, two bitmasks by sweep parity) and a list of up to `cap`
// nodes.  A frontier node goes to a group of 4 lanes of one warp, which
// split its table entries.  After the sweep's one barrier the buffers swap;
// a frontier that overflowed its list is read from its bitmask instead.
// The loop ends after n_iters sweeps or at the first empty frontier (a
// fixed point, so the same result).  Both buffers, the bitmasks and the
// lists sit in shared memory while 8·N + 8·⌈N/32⌉ + 8·cap bytes fit a
// CTA's 227 KB; above that the rows go to a global scratch.  Where the
// table (its row offsets and 2·E entries) fits beside them too, each CTA
// copies it into shared memory first (the 500-node epoch: 74 KB a CTA;
// 18 % off K5's epoch there), else it is read through the read-only cache.
// (Measured on the epochs' rows, scripts/k5_k6_variants.py: ~0.6 µs a
// sweep; the bitmask as the only frontier, a thread or a group of lanes a
// word and atomics that return nothing, 0.75-1.7 µs.)
//
// What bounds it on the card: the relaxations of the frontier's edges, a few
// operations each, and the n_iters barriers of a row's sweeps: at the
// epoch's sizes the rows' sweeps are latency (a barrier, the table reads
// and the shared-memory atomics a sweep, a chain of dependent accesses),
// with every row on its own CTA over the 132 SMs.  The table is one CTA's
// counting sort of 2·E entries.
// Inputs must hold distances in [0, INF] and weights >= 0 (or INF).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr float kInf = 3.4e38f;   // shortest_path.INF
constexpr int kTableThreads = 1024;
constexpr int kMaxThreads = 512;
constexpr int kGroup = 4;   // lanes a frontier node: they split its table entries

// jnp.minimum(d + w, INF)
__device__ __forceinline__ float relax(float d, float w) {
  const float v = d + w;
  return v < kInf ? v : kInf;
}

__device__ __forceinline__ void lower(float* slot, float v) {
  atomicMin(reinterpret_cast<int*>(slot), __float_as_int(v));
}

// The table: node n's neighbours and weights are adj[row_ptr[n]:row_ptr[n+1]]
// as (neighbour, weight bits) pairs, over the edges with w < INF and
// from != to.  Counts, an exclusive scan, then a fill through per-node
// cursors (the order within a node's entries is free: every use is a min).
// The cursors live in shared memory (NULL `cursor`) while 4·N bytes fit,
// so a fill's address costs a shared-memory atomic, not a device one.
__global__ void __launch_bounds__(kTableThreads)
relax_table_kernel(const int* __restrict__ e_from, const int* __restrict__ e_to,
                   const float* __restrict__ w, int n_nodes, int n_edges,
                   int* __restrict__ row_ptr, int* cursor_global, int2* __restrict__ adj) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int part[kTableThreads];
  int* cursor = cursor_global == nullptr ? reinterpret_cast<int*>(smem) : cursor_global;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int i = tid; i < n_nodes; i += nt) cursor[i] = 0;
  __syncthreads();
  for (int e = tid; e < n_edges; e += nt) {
    const int f = e_from[e], t = e_to[e];
    if (w[e] < kInf && f != t) {
      atomicAdd(cursor + f, 1);
      atomicAdd(cursor + t, 1);
    }
  }
  __syncthreads();
  const int chunk = (n_nodes + nt - 1) / nt;
  const int lo = min(tid * chunk, n_nodes), hi = min(lo + chunk, n_nodes);
  int own = 0;
  for (int i = lo; i < hi; ++i) own += cursor[i];
  part[tid] = own;
  __syncthreads();
  for (int off = 1; off < nt; off <<= 1) {
    const int v = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int run = part[tid] - own;
  for (int i = lo; i < hi; ++i) {
    const int c = cursor[i];
    row_ptr[i] = run;
    cursor[i] = run;
    run += c;
  }
  if (tid == nt - 1) row_ptr[n_nodes] = part[tid];
  __syncthreads();
  for (int e = tid; e < n_edges; e += nt) {
    const int f = e_from[e], t = e_to[e];
    const float we = w[e];
    if (we < kInf && f != t) {
      adj[atomicAdd(cursor + f, 1)] = make_int2(t, __float_as_int(we));
      adj[atomicAdd(cursor + t, 1)] = make_int2(f, __float_as_int(we));
    }
  }
}

// One row's buffers: distances a, b (N each), in shared memory or in the
// row's slice of the global scratch, then the frontier bitmasks (2 x words)
// and lists (2 x cap) in shared memory.
struct Row {
  float* a;
  float* b;
  unsigned* bits;
  int* list;
};

struct Layout {
  int n, words, cap, rows_in_smem, table_entries, table_in_smem;
};

// The table the sweeps read: the device tables, or their copy in shared
// memory after the row's buffers (kShared).
struct Table {
  const int* row_ptr;
  const int2* adj;
};

__device__ __forceinline__ Row row_buffers(const Layout& L, unsigned char* smem, float* scratch,
                                           long long row) {
  Row r;
  if (L.rows_in_smem) {
    r.a = reinterpret_cast<float*>(smem);
    smem += 8ll * L.n;
  } else {
    r.a = scratch + row * 2ll * L.n;
  }
  r.b = r.a + L.n;
  r.bits = reinterpret_cast<unsigned*>(smem);
  r.list = reinterpret_cast<int*>(r.bits + 2 * L.words);
  return r;
}

__device__ __forceinline__ Table stage_table(const Layout& L, unsigned char* smem,
                                             const int* row_ptr, const int2* adj) {
  if (!L.table_in_smem) return Table{row_ptr, adj};
  int* srp = reinterpret_cast<int*>(smem + 8ll * L.n + 4ll * (2 * L.words + 2 * L.cap));
  int2* sadj = reinterpret_cast<int2*>(srp + ((L.n + 2) & ~1));
  for (int i = threadIdx.x; i <= L.n; i += blockDim.x) srp[i] = __ldg(row_ptr + i);
  const int used = __ldg(row_ptr + L.n);
  for (int i = threadIdx.x; i < used; i += blockDim.x) sadj[i] = __ldg(adj + i);
  return Table{srp, sadj};
}

// v joins the next frontier once: its bit, then a slot of the list while the
// list has room.
__device__ __forceinline__ void join(int v, unsigned* bits, int* list, int* count, int cap) {
  const unsigned bit = 1u << (v & 31);
  if (!(atomicOr(bits + (v >> 5), bit) & bit)) {
    const int p = atomicAdd(count, 1);
    if (p < cap) list[p] = v;
  }
}

// Frontier node u in a sweep, taken by a group of kGroup lanes (g its lane):
// its own write slot lowered to d_k[u], then its offers, the group's lanes
// taking its table entries in turn; a neighbour whose offer is below its
// start value falls and joins the next frontier.
template <bool kShared>
__device__ __forceinline__ void expand(int u, int g, const float* rd, float* wr, const Table& T,
                                       unsigned* nbits, int* nlist, int* ncount, int cap) {
  const float du = rd[u];
  if (g == 0 && du < wr[u]) lower(wr + u, du);
  const int end = kShared ? T.row_ptr[u + 1] : __ldg(T.row_ptr + u + 1);
  for (int e = (kShared ? T.row_ptr[u] : __ldg(T.row_ptr + u)) + g; e < end; e += kGroup) {
    const int2 ent = kShared ? T.adj[e] : __ldg(T.adj + e);
    const float off = relax(du, __int_as_float(ent.y));
    if (off < rd[ent.x]) {
      lower(wr + ent.x, off);
      join(ent.x, nbits, nlist, ncount, cap);
    }
  }
}

// Zero both bitmasks and the counts; the caller fills both buffers with the
// start row in the same pass and then seeds frontier 0.
__device__ __forceinline__ void clear_book(const Layout& L, const Row& r, int* count) {
  for (int i = threadIdx.x; i < 2 * L.words; i += blockDim.x) r.bits[i] = 0u;
  if (threadIdx.x < 3) count[threadIdx.x] = 0;
}

// The sweeps from frontier 0 (bitmask 0, list 0, count[0]); returns the
// buffer holding the result.  A frontier node (from the list, or from a
// word of the bitmask when the list overflowed) goes to a group of kGroup
// lanes of one warp.  Sweep k reads count[k % 3], counts the next frontier
// in count[(k + 1) % 3] and zeroes count[(k + 2) % 3], last read before the
// previous barrier.
template <bool kShared>
__device__ float* sweeps(const Layout& L, const Row& r, const Table& T, int n_iters, int* count) {
  const int tid = threadIdx.x, group = tid / kGroup, g = tid % kGroup;
  const int n_groups = blockDim.x / kGroup;
  const unsigned group_mask = ((1u << kGroup) - 1u) << ((tid & 31) & ~(kGroup - 1));
  float* rd = r.a;
  float* wr = r.b;
  for (int k = 0; k < n_iters; ++k) {
    const int cur = count[k % 3];
    if (cur == 0) break;                       // a fixed point: nothing falls again
    unsigned* cbits = r.bits + (k & 1) * L.words;
    unsigned* nbits = r.bits + ((k + 1) & 1) * L.words;
    const int* clist = r.list + (k & 1) * L.cap;
    int* nlist = r.list + ((k + 1) & 1) * L.cap;
    int* ncount = count + (k + 1) % 3;
    if (tid == 0) count[(k + 2) % 3] = 0;
    if (cur <= L.cap) {
      for (int i = group; i < cur; i += n_groups) {
        const int u = clist[i];
        if (g == 0) atomicAnd(cbits + (u >> 5), ~(1u << (u & 31)));
        expand<kShared>(u, g, rd, wr, T, nbits, nlist, ncount, L.cap);
      }
    } else {
      for (int wi = group; wi < L.words; wi += n_groups) {
        unsigned m = cbits[wi];
        __syncwarp(group_mask);                // the group has read the word
        if (g == 0 && m != 0u) cbits[wi] = 0u;
        while (m) {
          const int bit = __ffs(m) - 1;
          m &= m - 1;
          expand<kShared>(wi * 32 + bit, g, rd, wr, T, nbits, nlist, ncount, L.cap);
        }
      }
    }
    __syncthreads();
    float* t = rd;
    rd = wr;
    wr = t;
  }
  return rd;
}

__device__ __forceinline__ float* run_sweeps(const Layout& L, const Row& r, const Table& T,
                                             int n_iters, int* count) {
  return L.table_in_smem ? sweeps<true>(L, r, T, n_iters, count)
                         : sweeps<false>(L, r, T, n_iters, count);
}

__global__ void __launch_bounds__(kMaxThreads)
relax_rows_kernel(const float* __restrict__ dist0, const int* __restrict__ row_ptr,
                  const int2* __restrict__ adj, Layout L, int n_iters, float* __restrict__ out,
                  float* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int count[3];
  const long long row = blockIdx.x;
  const Row r = row_buffers(L, smem, scratch, row);
  const Table T = stage_table(L, smem, row_ptr, adj);
  const float* d0 = dist0 + row * L.n;
  clear_book(L, r, count);
  for (int i = threadIdx.x; i < L.n; i += blockDim.x) r.a[i] = r.b[i] = d0[i];
  __syncthreads();
  for (int i = threadIdx.x; i < L.n; i += blockDim.x)
    if (r.a[i] < kInf) join(i, r.bits, r.list, count, L.cap);
  __syncthreads();
  const float* res = run_sweeps(L, r, T, n_iters, count);
  float* o = out + row * L.n;
  for (int i = threadIdx.x; i < L.n; i += blockDim.x) o[i] = res[i];
}

// A row holding 0 at `src` and INF elsewhere, `src` the frontier (none if
// src lies outside [0, N)).
__device__ __forceinline__ void seed_source(const Layout& L, const Row& r, int src, int* count) {
  clear_book(L, r, count);
  for (int i = threadIdx.x; i < L.n; i += blockDim.x) r.a[i] = r.b[i] = (i == src ? 0.0f : kInf);
  __syncthreads();
  if (threadIdx.x == 0 && src >= 0 && src < L.n) join(src, r.bits, r.list, count, L.cap);
  __syncthreads();
}

__global__ void __launch_bounds__(kMaxThreads)
relax_pairs_kernel(const int* __restrict__ sources, const int* __restrict__ targets,
                   const int* __restrict__ row_ptr, const int2* __restrict__ adj, Layout L,
                   int n_iters, float* __restrict__ out, float* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int count[3];
  const long long row = blockIdx.x;
  const Row r = row_buffers(L, smem, scratch, row);
  const Table T = stage_table(L, smem, row_ptr, adj);
  seed_source(L, r, sources[row], count);
  const float* res = run_sweeps(L, r, T, n_iters, count);
  if (threadIdx.x == 0) {
    const int t = targets[row];
    out[row] = (t >= 0 && t < L.n) ? res[t] : kInf;
  }
}

// a before b in torch.argmin's order: NaN first, then the smaller key, then
// the lower slot
__device__ __forceinline__ bool before(float ka, int ia, float kb, int ib) {
  const bool na = isnan(ka), nb = isnan(kb);
  if (na != nb) return na;
  if (!na && ka != kb) return ka < kb;
  return ia < ib;
}

__global__ void __launch_bounds__(kMaxThreads)
relax_unc_kernel(const float* __restrict__ stamp, const unsigned char* __restrict__ node_valid,
                 const float* __restrict__ unc_old, const int* __restrict__ row_ptr,
                 const int2* __restrict__ adj, Layout L, int n_iters,
                 float* __restrict__ unc_out, float* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int count[3];
  __shared__ float wkey[kMaxThreads / 32];
  __shared__ int widx[kMaxThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the root: argmin of where(valid, stamp, INF), loads four a thread in flight
  float key = INFINITY;
  int idx = L.n;
  int any = 0;
#pragma unroll 4
  for (int i = tid; i < L.n; i += blockDim.x) {
    const bool v = __ldg(node_valid + i) != 0;
    any |= v;
    const float k = v ? __ldg(stamp + i) : kInf;
    if (before(k, i, key, idx)) {
      key = k;
      idx = i;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float k = __shfl_down_sync(0xffffffffu, key, off);
    const int i = __shfl_down_sync(0xffffffffu, idx, off);
    if (before(k, i, key, idx)) {
      key = k;
      idx = i;
    }
  }
  if (lane == 0) {
    wkey[warp] = key;
    widx[warp] = idx;
  }
  any = __syncthreads_or(any);
  if (!any) {   // no valid node: the uncertainty stays as it was
    for (int i = tid; i < L.n; i += blockDim.x) unc_out[i] = unc_old[i];
    return;
  }
  if (tid == 0) {
    for (int w = 1; w < (int)(blockDim.x + 31) / 32; ++w)
      if (before(wkey[w], widx[w], wkey[0], widx[0])) {
        wkey[0] = wkey[w];
        widx[0] = widx[w];
      }
  }
  __syncthreads();
  const Row r = row_buffers(L, smem, scratch, 0);
  const Table T = stage_table(L, smem, row_ptr, adj);
  seed_source(L, r, widx[0], count);
  const float* res = run_sweeps(L, r, T, n_iters, count);
#pragma unroll 4
  for (int i = tid; i < L.n; i += blockDim.x) {
    const float d = res[i];
    unc_out[i] = (__ldg(node_valid + i) != 0 && d < kInf) ? d : __ldg(unc_old + i);
  }
}

template <typename Kernel>
int prepare(Kernel* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

Layout layout(int n_nodes, int cap, int rows_in_smem, int n_edges, int table_in_smem) {
  return Layout{n_nodes, (n_nodes + 31) / 32, cap, rows_in_smem, 2 * n_edges, table_in_smem};
}

// the rows where they live, then the bitmasks and lists, then the table's
// copy (row_ptr padded to an even count, then 2E (neighbour, weight) pairs)
size_t smem_bytes(const Layout& L) {
  return (L.rows_in_smem ? 8ull * L.n : 0) + 4ull * (2ull * L.words + 2ull * L.cap) +
         (L.table_in_smem ? 4ull * ((L.n + 2) & ~1) + 8ull * L.table_entries : 0);
}

bool bad_threads(int threads) {
  return threads < 32 || threads > kMaxThreads || threads % 32 != 0;
}

}  // namespace

// e_from, e_to: (n_edges,) int32; w: (n_edges,) float.  row_ptr: (n_nodes +
// 1,) int32; cursor: NULL to keep the per-node cursors in shared memory (the
// caller checks 4·n_nodes bytes fit beside the kernel's 4 KB), else
// (n_nodes,) int32 device scratch; adj: (2 * n_edges,) int2.
extern "C" int uz_relax_table(const int* e_from, const int* e_to, const float* w, int n_nodes,
                              int n_edges, int* row_ptr, int* cursor, int* adj, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = cursor == nullptr ? 4ull * n_nodes : 0;
  const int err = prepare(relax_table_kernel, smem);
  if (err) return err;
  relax_table_kernel<<<1, kTableThreads, smem, s>>>(e_from, e_to, w, n_nodes, n_edges, row_ptr,
                                                    cursor, reinterpret_cast<int2*>(adj));
  return static_cast<int>(cudaGetLastError());
}

// The three relaxations share their arguments' tail: the table, `threads`
// a row (a multiple of 32, at most 512; kGroup lanes a frontier node), the
// list capacity, whether the rows live in shared memory (1), the edge
// count and whether the table is copied into shared memory (only with the
// rows there), and the global scratch (NULL when the rows are in shared
// memory, else 2·N floats a row); the bitmasks and lists are always in
// shared memory.  dist0, out: (n_rows, n_nodes) row-major.
extern "C" int uz_relax_min(const float* dist0, const int* row_ptr, const int* adj, int n_rows,
                            int n_nodes, int n_iters, int threads, int cap, int rows_in_smem,
                            int n_edges, int table_in_smem, float* out, float* scratch,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || n_nodes <= 0) return 0;
  if (bad_threads(threads)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(n_nodes, cap, rows_in_smem, n_edges, table_in_smem);
  const size_t smem = smem_bytes(L);
  const int err = prepare(relax_rows_kernel, smem);
  if (err) return err;
  relax_rows_kernel<<<n_rows, threads, smem, s>>>(dist0, row_ptr,
                                                  reinterpret_cast<const int2*>(adj), L, n_iters,
                                                  out, scratch);
  return static_cast<int>(cudaGetLastError());
}

// sources, targets: (n_rows,) int32; out: (n_rows,) float.
extern "C" int uz_relax_pairs(const int* sources, const int* targets, const int* row_ptr,
                              const int* adj, int n_rows, int n_nodes, int n_iters, int threads,
                              int cap, int rows_in_smem, int n_edges, int table_in_smem,
                              float* out, float* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_rows <= 0 || n_nodes <= 0) return 0;
  if (bad_threads(threads)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(n_nodes, cap, rows_in_smem, n_edges, table_in_smem);
  const size_t smem = smem_bytes(L);
  const int err = prepare(relax_pairs_kernel, smem);
  if (err) return err;
  relax_pairs_kernel<<<n_rows, threads, smem, s>>>(sources, targets, row_ptr,
                                                   reinterpret_cast<const int2*>(adj), L,
                                                   n_iters, out, scratch);
  return static_cast<int>(cudaGetLastError());
}

// stamp, unc_old, unc_out: (n_nodes,) float; node_valid: (n_nodes,) bool.
extern "C" int uz_relax_uncertainty(const float* stamp, const unsigned char* node_valid,
                                    const float* unc_old, const int* row_ptr, const int* adj,
                                    int n_nodes, int n_iters, int threads, int cap,
                                    int rows_in_smem, int n_edges, int table_in_smem,
                                    float* unc_out, float* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_nodes <= 0) return 0;
  if (bad_threads(threads)) return static_cast<int>(cudaErrorInvalidValue);
  const Layout L = layout(n_nodes, cap, rows_in_smem, n_edges, table_in_smem);
  const size_t smem = smem_bytes(L);
  const int err = prepare(relax_unc_kernel, smem);
  if (err) return err;
  relax_unc_kernel<<<1, threads, smem, s>>>(stamp, node_valid, unc_old, row_ptr,
                                            reinterpret_cast<const int2*>(adj), L, n_iters,
                                            unc_out, scratch);
  return static_cast<int>(cudaGetLastError());
}
