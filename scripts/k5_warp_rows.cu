// K5's pairs entry with one warp a row: a variant of
// uzliti_slam_tpu_torch/csrc/relax_min.cu, timed beside it by
// scripts/k5_k6_variants.py (specs "k5:warps=W").
//
// The package runs each row on a CTA of its own (kops.RELAX_THREADS threads)
// and ends each sweep with a block barrier.  Here a CTA holds W rows, one a
// warp: a sweep ends with __syncwarp, the warp's four-lane groups take the
// frontier nodes (8 at a time), and the table is copied into shared memory
// once a CTA for its W rows where it fits.  Same frontier algorithm, the same
// results bit for bit: the frontier's (node, value) pairs of sweep k - 1 are
// relaxed from a read buffer that no one writes during the sweep; each
// frontier node first lowers its own slot of the write buffer; offers go in
// by atomicMin on the int bits.
//
// Exports uz_relax_pairs_warps; the table is the package's (kops.relax_table).
// Layout, in this order of preference: rows and table in shared memory; rows
// only; the table only (rows in `scratch`, 2N floats a row); neither.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC -shared -o libk5_warp_rows.so scripts/k5_warp_rows.cu
#include <cuda_runtime.h>

namespace {

constexpr float kInf = 3.4e38f;
constexpr int kGroup = 4;
constexpr int kMaxWarps = 8;
constexpr long long kSmem = 232448 - 1024;   // a CTA's shared memory, the static part left out

struct Layout {
  int n, words, cap, warps, rows_in_smem, table_in_smem, table_entries;
};

__device__ __forceinline__ float relax(float d, float w) {
  const float v = d + w;
  return v < kInf ? v : kInf;
}

__device__ __forceinline__ void lower(float* slot, float v) {
  atomicMin(reinterpret_cast<int*>(slot), __float_as_int(v));
}

__device__ __forceinline__ void join(int v, unsigned* bits, int* list, int* count, int cap) {
  const unsigned bit = 1u << (v & 31);
  if (!(atomicOr(bits + (v >> 5), bit) & bit)) {
    const int p = atomicAdd(count, 1);
    if (p < cap) list[p] = v;
  }
}

template <bool kShared>
__device__ __forceinline__ void expand(int u, int g, const float* rd, float* wr, const int* rp,
                                       const int2* adj, unsigned* nbits, int* nlist,
                                       int* ncount, int cap) {
  const float du = rd[u];
  if (g == 0 && du < wr[u]) lower(wr + u, du);
  const int end = kShared ? rp[u + 1] : __ldg(rp + u + 1);
  for (int e = (kShared ? rp[u] : __ldg(rp + u)) + g; e < end; e += kGroup) {
    const int2 ent = kShared ? adj[e] : __ldg(adj + e);
    const float off = relax(du, __int_as_float(ent.y));
    if (off < rd[ent.x]) {
      lower(wr + ent.x, off);
      join(ent.x, nbits, nlist, ncount, cap);
    }
  }
}

template <bool kShared>
__global__ void __launch_bounds__(32 * kMaxWarps)
pairs_warp_rows(const int* __restrict__ sources, const int* __restrict__ targets,
                const int* __restrict__ row_ptr, const int2* __restrict__ adj, int n_rows,
                Layout L, int n_iters, float* __restrict__ out, float* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned char* p = smem;
  const int* rp = row_ptr;
  const int2* ad = adj;
  if (kShared) {
    int* srp = reinterpret_cast<int*>(p);
    int2* sadj = reinterpret_cast<int2*>(srp + ((L.n + 2) & ~1));
    for (int i = threadIdx.x; i <= L.n; i += blockDim.x) srp[i] = __ldg(row_ptr + i);
    const int used = __ldg(row_ptr + L.n);
    for (int i = threadIdx.x; i < used; i += blockDim.x) sadj[i] = __ldg(adj + i);
    rp = srp;
    ad = sadj;
    p += 4ll * ((L.n + 2) & ~1) + 8ll * L.table_entries;
  }
  __syncthreads();   // the CTA's only barrier
  const long long row = static_cast<long long>(blockIdx.x) * L.warps + warp;
  if (row >= n_rows) return;
  const long long per_warp =
      (L.rows_in_smem ? 8ll * L.n : 0) + 4ll * (2 * L.words + 2 * L.cap) + 16;
  p += warp * per_warp;
  float* a;
  if (L.rows_in_smem) {
    a = reinterpret_cast<float*>(p);
    p += 8ll * L.n;
  } else {
    a = scratch + row * 2ll * L.n;
  }
  float* b = a + L.n;
  unsigned* bits = reinterpret_cast<unsigned*>(p);
  int* list = reinterpret_cast<int*>(bits + 2 * L.words);
  int* count = list + 2 * L.cap;

  for (int i = lane; i < 2 * L.words; i += 32) bits[i] = 0u;
  if (lane < 3) count[lane] = 0;
  const int src = sources[row];
  for (int i = lane; i < L.n; i += 32) a[i] = b[i] = (i == src ? 0.0f : kInf);
  __syncwarp();
  if (lane == 0 && src >= 0 && src < L.n) join(src, bits, list, count, L.cap);
  __syncwarp();

  const int group = lane / kGroup, g = lane % kGroup, n_groups = 32 / kGroup;
  const unsigned group_mask = ((1u << kGroup) - 1u) << (lane & ~(kGroup - 1));
  float* rd = a;
  float* wr = b;
  for (int k = 0; k < n_iters; ++k) {
    const int cur = count[k % 3];
    if (cur == 0) break;
    unsigned* cbits = bits + (k & 1) * L.words;
    unsigned* nbits = bits + ((k + 1) & 1) * L.words;
    const int* clist = list + (k & 1) * L.cap;
    int* nlist = list + ((k + 1) & 1) * L.cap;
    int* ncount = count + (k + 1) % 3;
    if (lane == 0) count[(k + 2) % 3] = 0;
    if (cur <= L.cap) {
      for (int i = group; i < cur; i += n_groups) {
        const int u = clist[i];
        if (g == 0) atomicAnd(cbits + (u >> 5), ~(1u << (u & 31)));
        expand<kShared>(u, g, rd, wr, rp, ad, nbits, nlist, ncount, L.cap);
      }
    } else {
      for (int wi = group; wi < L.words; wi += n_groups) {
        unsigned m = cbits[wi];
        __syncwarp(group_mask);
        if (g == 0 && m != 0u) cbits[wi] = 0u;
        while (m) {
          const int bit = __ffs(m) - 1;
          m &= m - 1;
          expand<kShared>(wi * 32 + bit, g, rd, wr, rp, ad, nbits, nlist, ncount, L.cap);
        }
      }
    }
    __syncwarp();
    float* t = rd;
    rd = wr;
    wr = t;
  }
  if (lane == 0) {
    const int t = targets[row];
    out[row] = (t >= 0 && t < L.n) ? rd[t] : kInf;
  }
}

}  // namespace

// sources, targets: (n_rows,) int32; row_ptr, adj: the package's table of
// n_edges edge slots; scratch: n_rows x 2N floats (read only where the rows
// do not fit); layout_out (host, 2 ints): rows in shared memory, table there.
extern "C" int uz_relax_pairs_warps(const int* sources, const int* targets, const int* row_ptr,
                                    const int* adj, int n_rows, int n_nodes, int n_iters,
                                    int warps, int cap, int n_edges, float* out, float* scratch,
                                    int* layout_out, void* stream) {
  if (n_rows <= 0) return 0;
  if (warps < 1 || warps > kMaxWarps) return static_cast<int>(cudaErrorInvalidValue);
  Layout L{n_nodes, (n_nodes + 31) / 32, cap, warps, 1, 1, 2 * n_edges};
  const long long book = 4ll * (2 * L.words + 2 * cap) + 16, rows = 8ll * n_nodes;
  const long long table = 4ll * ((n_nodes + 2) & ~1) + 8ll * L.table_entries;
  if (warps * (rows + book) + table <= kSmem) {
  } else if (warps * (rows + book) <= kSmem) {
    L.table_in_smem = 0;
  } else if (warps * book + table <= kSmem) {
    L.rows_in_smem = 0;
  } else if (warps * book <= kSmem) {
    L.rows_in_smem = L.table_in_smem = 0;
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  layout_out[0] = L.rows_in_smem;
  layout_out[1] = L.table_in_smem;
  const size_t smem = (L.table_in_smem ? table : 0) + warps * ((L.rows_in_smem ? rows : 0) + book);
  auto kernel = L.table_in_smem ? pairs_warp_rows<true> : pairs_warp_rows<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int blocks = (n_rows + warps - 1) / warps;
  kernel<<<blocks, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      sources, targets, row_ptr, reinterpret_cast<const int2*>(adj), n_rows, L, n_iters, out,
      scratch);
  return static_cast<int>(cudaGetLastError());
}
