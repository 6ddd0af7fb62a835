// K33 delta_apply: the scope protocol's batched upserts, two entries.
//
// uz_delta_upsert replaces uzliti_slam_tpu/parallel/scope.py:apply_delta
// (:170-270) after its lookups (K31 uid_slots, K32 edge_key_match): a serial
// lax.scan of add_node under lax.cond over the Dn delta nodes (:196-215), the
// in-delta (De, De) edge dedup (:232-240), a serial scan of add_edge over
// the De edges (:242-257) and the ACK (:264-269).  uz_scope_merge replaces
// scope.py:apply_scope (:317-351): a serial scan over the K reply rows, each
// freezing a live node at the reply's pose or appending a fixed anchor.
//
// Design: one CTA of 1024 threads, a thread a row (Dn, De, K <= 1024; the
// wrapper raises above that).  The serial scans become:
//   - first occurrence: a row whose uid an earlier row of the delta inserts
//     finds that row's slot, as the scan's lookup of the growing table does
//     (the O(rows^2) compares run over shared memory);
//   - a block prefix sum (warp shuffles, then one warp over the 32 warp
//     totals) gives each inserted node and appended edge its slot, num_nodes
//     or num_edges plus its rank; a slot past the capacity is dropped and
//     every later one with it, as the scan's add_node / add_edge do;
//   - an edge endpoint that K31 did not find resolves against the uids just
//     inserted (shared memory): the lowest slot holding it;
//   - an edge row is a duplicate when the table holds its (from, to, type)
//     (K32) or an EARLIER row with resolved endpoints carries the same
//     (from_uid, to_uid, type), whether or not that row was itself a table
//     duplicate (:233-240);
//   - the information matrix is masked by edge type as info_for_edge_type
//     does, (info * m_row) * m_col in float32;
//   - the ACK: a node row's uid where it was inserted or is known; an edge
//     row's from-uid where it was appended, or has resolved endpoints and
//     is a duplicate (:254); the edge's to-uid and type are the delta's.
//   - apply_scope: the last row of each live or inserted uid writes the pose
//     and freezes the node (the scan's last write wins); the first
//     occurrence of an unknown uid >= 0 appends it fixed, with its pose as
//     the odometry pose and uncertainty 0.
// The tables are the wrapper's copies, updated in place; only the written
// rows and the two counters are touched.
//
// What bounds it on the card: the delta's bytes (for Dn = 32, De = 64:
// 32 x 76 B of nodes, 64 x 205 B of edges, ~16 KB in and out) are 5 ns at
// 3.35 TB/s; the kernel is one CTA's latency (a few microseconds of
// __syncthreads and dependent loads), far above that bound.  The table
// copies the wrapper makes (the reference's functional update) move the
// whole node and edge tables and cost more than the kernel at a large
// global graph.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxRows = 1024;   // SCOPE_MAX_ROWS in kernels/ops.py

// Exclusive prefix sum of one int a thread over the whole block (blockDim =
// kThreads); the total lands in buf[32].  Synchronises the block.
__device__ int block_exclusive_scan(int v, int* buf) {
  __syncthreads();   // buf may still be read from a previous scan
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = buf[lane];
    int inc = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    buf[lane] = inc - w;
    if (lane == 31) buf[32] = inc;
  }
  __syncthreads();
  return buf[warp] + incl - v;
}

// info_for_edge_type's per-type mask (graph/state.py): default all ones.
__device__ __forceinline__ void type_mask(int t, float m[6]) {
  int bits = 0x3F;                                   // bit k keeps row/column k
  if (t == 3 || t == 4) bits = 0x07;                 // 3D translation / GPS
  else if (t == 2) bits = 0x38;                      // 3D rotation
  else if (t == 5 || t == 105) bits = 0x23;          // 2D full / laser: x, y, yaw
  else if (t == 6) bits = 0x20;                      // 2D rotation
  else if (t == 7) bits = 0x03;                      // 2D translation
#pragma unroll
  for (int k = 0; k < 6; ++k) m[k] = (bits >> k) & 1 ? 1.0f : 0.0f;
}

struct NodeTable {
  float* pose;
  float* odom_pose;
  float* stamp;
  float* uncertainty;
  unsigned char* valid;
  unsigned char* fixed;
  int* uid;
  int* num_nodes;
  int N;
};

struct EdgeTable {
  int* from;
  int* to;
  float* transform;
  float* info;
  int* type;
  unsigned char* valid;
  float* error;
  float* age;
  float* score;
  int* num_edges;
  int E;
};

// a new node row; its pose only where pose is not null (apply_scope's
// last row of the uid writes that)
__device__ __forceinline__ void write_node(const NodeTable& t, int slot, const float* pose,
                                           const float* odom, float stamp, float unc,
                                           bool fixed, int uid) {
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    if (pose != nullptr) t.pose[7 * slot + k] = pose[k];
    t.odom_pose[7 * slot + k] = odom[k];
  }
  t.stamp[slot] = stamp;
  t.uncertainty[slot] = unc;
  t.valid[slot] = 1;
  t.fixed[slot] = fixed ? 1 : 0;
  t.uid[slot] = uid;
}

// the lowest inserted slot holding uid among the first n rows, or -1
__device__ __forceinline__ int inserted_slot(const int* s_uid, const int* s_slot, int n,
                                             int uid) {
  for (int j = 0; j < n; ++j) {
    if (s_uid[j] == uid && s_slot[j] >= 0) return s_slot[j];
  }
  return -1;
}

__global__ void __launch_bounds__(kThreads)
delta_upsert_kernel(NodeTable nt, EdgeTable et, const int* __restrict__ n_uid,
                    const float* __restrict__ n_pose, const float* __restrict__ n_odom,
                    const float* __restrict__ n_stamp, const float* __restrict__ n_unc,
                    const int* __restrict__ node_found, int Dn,
                    const int* __restrict__ e_from_uid, const int* __restrict__ e_to_uid,
                    const int* __restrict__ e_type, const float* __restrict__ e_transform,
                    const float* __restrict__ e_info, const float* __restrict__ e_score,
                    const unsigned char* __restrict__ e_valid, const int* __restrict__ ef_found,
                    const int* __restrict__ et_found, const unsigned char* __restrict__ table_dup,
                    int De, int first_occurrence, int* __restrict__ ack_nodes,
                    int* __restrict__ ack_from) {
  __shared__ int s_uid[kMaxRows], s_slot[kMaxRows];
  __shared__ int s_fu[kMaxRows], s_tu[kMaxRows], s_ty[kMaxRows], s_eok[kMaxRows];
  __shared__ int buf[33];
  const int i = threadIdx.x;
  const int n0 = *nt.num_nodes, e0 = *et.num_edges;

  // --- nodes: first occurrences of unknown uids take slots in row order
  int uid = -1, found = -1;
  if (i < Dn) {
    uid = n_uid[i];
    found = node_found[i];
    s_uid[i] = uid;
  }
  __syncthreads();
  int is_new = (i < Dn && uid >= 0 && found < 0) ? 1 : 0;
  if (is_new && first_occurrence) {
    for (int j = 0; j < i; ++j) {
      if (s_uid[j] == uid) {
        is_new = 0;
        break;
      }
    }
  }
  const int rank = block_exclusive_scan(is_new, buf);
  const int n_new = buf[32];
  const bool ins = is_new && n0 + rank < nt.N;
  if (i < Dn) s_slot[i] = ins ? n0 + rank : -1;
  if (ins) {
    write_node(nt, n0 + rank, n_pose + 7 * i, n_odom + 7 * i, n_stamp[i], n_unc[i], false, uid);
  }
  __syncthreads();
  if (i < Dn) {
    bool applied;
    if (uid < 0) applied = false;
    else if (found >= 0) applied = true;
    else if (is_new) applied = ins;
    else applied = inserted_slot(s_uid, s_slot, i, uid) >= 0;   // a repeat: its first row's
    ack_nodes[i] = applied ? uid : -1;
  }

  // --- edges
  int fu = -1, tu = -1, ty = -1, fs = -1, ts = -1;
  if (i < De) {
    fu = e_from_uid[i];
    tu = e_to_uid[i];
    ty = e_type[i];
    fs = ef_found[i];
    ts = et_found[i];
    if (fs < 0 && fu >= 0) fs = inserted_slot(s_uid, s_slot, Dn, fu);
    if (ts < 0 && tu >= 0) ts = inserted_slot(s_uid, s_slot, Dn, tu);
    s_fu[i] = fu;
    s_tu[i] = tu;
    s_ty[i] = ty;
  }
  const int eok = (i < De && fs >= 0 && ts >= 0 && ty >= 0) ? 1 : 0;
  if (i < De) s_eok[i] = eok;
  __syncthreads();
  int dup = 0;
  if (i < De) {
    dup = table_dup[i] ? 1 : 0;
    for (int j = 0; j < i && !dup; ++j) {
      if (s_eok[j] && s_fu[j] == fu && s_tu[j] == tu && s_ty[j] == ty) dup = 1;
    }
  }
  const int ok = eok && !dup;
  const int erank = block_exclusive_scan(ok, buf);
  const int e_new = buf[32];
  const bool app = ok && e0 + erank < et.E;
  if (app) {
    const int r = e0 + erank;
    et.from[r] = fs;
    et.to[r] = ts;
#pragma unroll
    for (int k = 0; k < 7; ++k) et.transform[7 * r + k] = e_transform[7 * i + k];
    float m[6];
    type_mask(ty, m);
    for (int a = 0; a < 6; ++a) {
      for (int b = 0; b < 6; ++b) {
        et.info[36 * r + 6 * a + b] = __fmul_rn(__fmul_rn(e_info[36 * i + 6 * a + b], m[a]), m[b]);
      }
    }
    et.type[r] = ty;
    et.valid[r] = e_valid[i] ? 1 : 0;
    et.error[r] = 0.0f;
    et.age[r] = 0.0f;
    et.score[r] = e_score[i];
  }
  if (i < De) {
    const bool applied = ok ? app : (eok && dup);
    ack_from[i] = applied ? fu : -1;
  }
  __syncthreads();
  if (i == 0) {
    *nt.num_nodes = n0 + min(n_new, max(nt.N - n0, 0));
    *et.num_edges = e0 + min(e_new, max(et.E - e0, 0));
  }
}

__global__ void __launch_bounds__(kThreads)
scope_merge_kernel(NodeTable nt, const int* __restrict__ uid_in, const float* __restrict__ pose,
                   const float* __restrict__ stamp, const int* __restrict__ found_in, int K) {
  __shared__ int s_uid[kMaxRows], s_slot[kMaxRows];
  __shared__ int buf[33];
  const int i = threadIdx.x;
  const int n0 = *nt.num_nodes;
  int uid = -1, found = -1;
  if (i < K) {
    uid = uid_in[i];
    found = found_in[i];
    s_uid[i] = uid;
  }
  __syncthreads();
  int is_new = (i < K && uid >= 0 && found < 0) ? 1 : 0;
  for (int j = 0; j < i && is_new; ++j) {
    if (s_uid[j] == uid) is_new = 0;
  }
  const int rank = block_exclusive_scan(is_new, buf);
  const int n_new = buf[32];
  const bool ins = is_new && n0 + rank < nt.N;
  if (i < K) s_slot[i] = ins ? n0 + rank : -1;
  __syncthreads();
  if (i < K && uid >= 0) {
    if (ins) {
      write_node(nt, n0 + rank, nullptr, pose + 7 * i, stamp[i], 0.0f, true, uid);
    }
    bool last = true;
    for (int j = i + 1; j < K; ++j) {
      if (s_uid[j] == uid) {
        last = false;
        break;
      }
    }
    const int target = found >= 0 ? found : inserted_slot(s_uid, s_slot, i + 1, uid);
    if (last && target >= 0) {
#pragma unroll
      for (int k = 0; k < 7; ++k) nt.pose[7 * target + k] = pose[7 * i + k];
      nt.fixed[target] = 1;
    }
  }
  __syncthreads();
  if (i == 0) *nt.num_nodes = n0 + min(n_new, max(nt.N - n0, 0));
}

}  // namespace

// The node table (the wrapper's copies, updated in place): pose, odom_pose
// (N, 7) float32, stamp, uncertainty (N,) float32, node_valid, node_fixed
// (N,) bool, node_uid (N,) int32, num_nodes () int32; the edge table:
// e_from, e_to (E,) int32, e_transform (E, 7), e_info (E, 6, 6) float32,
// e_type (E,) int32, e_valid (E,) bool, e_error, e_age, e_score (E,)
// float32, num_edges () int32.  The delta's Dn node rows and De edge rows
// (Dn, De <= 1024) with K31's slots (node_found: K31's or the caller's
// existing slots; ef_found, et_found) and K32's table_dup.  Out: ack_nodes
// (Dn,), ack_from (De,) int32.
extern "C" int uz_delta_upsert(float* pose, float* odom_pose, float* stamp, float* uncertainty,
                               unsigned char* node_valid, unsigned char* node_fixed,
                               int* node_uid, int* num_nodes, int N, int* e_from, int* e_to,
                               float* e_transform_t, float* e_info_t, int* e_type_t,
                               unsigned char* e_valid_t, float* e_error, float* e_age,
                               float* e_score_t, int* num_edges, int E, const int* n_uid,
                               const float* n_pose, const float* n_odom, const float* n_stamp,
                               const float* n_unc, const int* node_found, int Dn,
                               const int* e_from_uid, const int* e_to_uid, const int* e_type,
                               const float* e_transform, const float* e_info,
                               const float* e_score, const unsigned char* e_valid,
                               const int* ef_found, const int* et_found,
                               const unsigned char* table_dup, int De, int first_occurrence,
                               int* ack_nodes, int* ack_from, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Dn > kMaxRows || De > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  NodeTable nt{pose, odom_pose, stamp, uncertainty, node_valid, node_fixed, node_uid, num_nodes,
               N};
  EdgeTable et{e_from, e_to, e_transform_t, e_info_t, e_type_t, e_valid_t, e_error, e_age,
               e_score_t, num_edges, E};
  delta_upsert_kernel<<<1, kThreads, 0, s>>>(nt, et, n_uid, n_pose, n_odom, n_stamp, n_unc,
                                             node_found, Dn, e_from_uid, e_to_uid, e_type,
                                             e_transform, e_info, e_score, e_valid, ef_found,
                                             et_found, table_dup, De, first_occurrence,
                                             ack_nodes, ack_from);
  return static_cast<int>(cudaGetLastError());
}

// The node table as above; the reply's K rows (K <= 1024): uid (K,) int32,
// pose (K, 7), stamp (K,) float32, and K31's slots found (K,) int32.
extern "C" int uz_scope_merge(float* pose, float* odom_pose, float* stamp, float* uncertainty,
                              unsigned char* node_valid, unsigned char* node_fixed,
                              int* node_uid, int* num_nodes, int N, const int* uid,
                              const float* r_pose, const float* r_stamp, const int* found, int K,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  NodeTable nt{pose, odom_pose, stamp, uncertainty, node_valid, node_fixed, node_uid, num_nodes,
               N};
  scope_merge_kernel<<<1, kThreads, 0, s>>>(nt, uid, r_pose, r_stamp, found, K);
  return static_cast<int>(cudaGetLastError());
}
