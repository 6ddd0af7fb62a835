// K31 uid_slots and K32 edge_key_match: the scope protocol's lookups.
//
// K31 replaces uzliti_slam_tpu/parallel/scope.py:uid_to_slot (:96-101):
// each of B query uids -> the lowest slot whose node is live and holds that
// uid, else -1.  The reference builds a (B, N) compare of node_uid under
// node_valid and takes any + argmax, O(B.N) bytes of mask; it is called once
// per delta node inside apply_delta's scan, on the edge endpoints, by
// apply_ack, once per reply row inside apply_scope's scan and by the
// runner's payload absorb.  The reference itself routes around it with a
// host hash map (runner.py:171-186) whose entries go stale when nodes are
// invalidated.
//
// K32 replaces apply_delta's (De, E) compare of (from_slot, to_slot, type)
// over the present rows (scope.py:222-229) and apply_ack's (A, E) compare
// in uid space (node_uid[e_from], node_uid[e_to], e_type) over all E rows,
// reduced over the ACK's rows (scope.py:282-288).
//
// Design.  Both kernels keep the (at most 1024) queries in shared memory and
// make one grid-stride pass over the table, a thread a row; each row is
// compared with every query (broadcast reads of shared memory).
//   K31: a live row that matches a query does atomicMin of its slot into
//   the query's output, which the wrapper fills with 0xFFFFFFFF (-1 as an
//   int32) beforehand: the minimum is the reference's first hit, "none"
//   needs no second pass, and nothing is cached between calls, so a lookup
//   always reads the live node_uid / node_valid (no stale map).
//   K32: a row writes its own flag (any query matches it: apply_ack's
//   reduction); a matched query's flag is set by a byte store of 1 into an
//   array the wrapper zeroes (every writer stores the same value).  The row
//   count is read on the device (num_rows; all E rows when null), so the
//   host reads nothing.  With node_uid the row's endpoints are mapped to
//   uid space.  A query whose first key is negative (an unresolved
//   endpoint) matches nothing: no present row refers to a slot the delta is
//   about to insert, and an ACK row with edge_from -1 acknowledges nothing.
//
// What bounds them on the card: K31 reads 5 bytes a table row (uid and
// flag) and B uids, writes 4.B bytes, and does N.B compares; at N = 100k and
// B = 160 that is 0.5 MB (0.15 us at 3.35 TB/s) and 16M compares (0.24 us
// at 67 T/s).  K32 reads 12 bytes a row (16 in uid space, the uid gathers
// hitting L2) and 12 a query.  Both are small next to their launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQueries = 1024;   // SCOPE_MAX_ROWS in kernels/ops.py

__global__ void __launch_bounds__(kThreads)
uid_slots_kernel(const int* __restrict__ node_uid, const unsigned char* __restrict__ node_valid,
                 int N, const int* __restrict__ uids, int B, unsigned* __restrict__ out) {
  __shared__ int q[kMaxQueries];
  for (int i = threadIdx.x; i < B; i += blockDim.x) q[i] = uids[i];
  __syncthreads();
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < N; r += gridDim.x * blockDim.x) {
    if (!node_valid[r]) continue;
    const int u = node_uid[r];
    if (u < 0) continue;
    for (int b = 0; b < B; ++b) {
      if (q[b] == u) atomicMin(out + b, static_cast<unsigned>(r));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
edge_key_kernel(const int* __restrict__ qa, const int* __restrict__ qb,
                const int* __restrict__ qt, int Q, const int* __restrict__ ra,
                const int* __restrict__ rb, const int* __restrict__ rt, int E,
                const int* __restrict__ num_rows, const int* __restrict__ node_uid,
                unsigned char* __restrict__ query_hit, unsigned char* __restrict__ row_hit) {
  __shared__ int sa[kMaxQueries], sb[kMaxQueries], st[kMaxQueries];
  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    sa[i] = qa[i];
    sb[i] = qb[i];
    st[i] = qt[i];
  }
  __syncthreads();
  int rows = E;
  if (num_rows != nullptr) rows = min(max(*num_rows, 0), E);
  for (int r = blockIdx.x * blockDim.x + threadIdx.x; r < E; r += gridDim.x * blockDim.x) {
    unsigned char any = 0;
    if (r < rows) {
      int a = ra[r], b = rb[r];
      if (node_uid != nullptr) {
        a = node_uid[a];
        b = node_uid[b];
      }
      const int t = rt[r];
      for (int q = 0; q < Q; ++q) {
        if (sa[q] >= 0 && sa[q] == a && sb[q] == b && st[q] == t) {
          any = 1;
          query_hit[q] = 1;
        }
      }
    }
    row_hit[r] = any;
  }
}

int grid_for(int n) {
  const int blocks = (n + kThreads - 1) / kThreads;
  return blocks < 1 ? 1 : (blocks > 132 * 8 ? 132 * 8 : blocks);
}

}  // namespace

// node_uid (N,) int32, node_valid (N,) bool, uids (B,) int32 (B <= 1024);
// out (B,) int32 filled with -1 by the wrapper.
extern "C" int uz_uid_slots(const int* node_uid, const unsigned char* node_valid, int N,
                            const int* uids, int B, int* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > kMaxQueries) return static_cast<int>(cudaErrorInvalidValue);
  uid_slots_kernel<<<grid_for(N), kThreads, 0, s>>>(node_uid, node_valid, N, uids, B,
                                                   reinterpret_cast<unsigned*>(out));
  return static_cast<int>(cudaGetLastError());
}

// queries qa, qb, qt (Q,) int32 (Q <= 1024); rows ra, rb, rt (E,) int32;
// num_rows: a device int32 (rows below it are compared) or null (all E);
// node_uid: (N,) int32 mapping the rows' endpoints to uids, or null.
// Out: query_hit (Q,) bool zeroed by the wrapper, row_hit (E,) bool.
extern "C" int uz_edge_key_match(const int* qa, const int* qb, const int* qt, int Q,
                                 const int* ra, const int* rb, const int* rt, int E,
                                 const int* num_rows, const int* node_uid,
                                 unsigned char* query_hit, unsigned char* row_hit,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q > kMaxQueries) return static_cast<int>(cudaErrorInvalidValue);
  edge_key_kernel<<<grid_for(E), kThreads, 0, s>>>(qa, qb, qt, Q, ra, rb, rt, E, num_rows,
                                                  node_uid, query_hit, row_hit);
  return static_cast<int>(cudaGetLastError());
}
