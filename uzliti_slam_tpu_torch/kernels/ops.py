"""The port's hand-written CUDA kernels, their wrappers and plain twins.

Each public function here is a wrapper: on CPU tensors it runs the kernel's
plain PyTorch version (``*_plain``, which is also what ``chip_smoke.py``
holds the kernel against on the card); on CUDA tensors it checks device,
dtype, shape and contiguity, launches the kernel from ``csrc/`` on the
current stream, raises if the launch failed, and adds one to
``launches[name]``.  There is no fallback from a CUDA tensor to the plain
version.  The wrapper allocates every output and scratch buffer; the
kernels allocate nothing and never synchronise.

=============  ======================  =======================================
kernel         source                  replaces (JAX package)
=============  ======================  =======================================
linearize      csrc/linearize.cu       graph/solver.py:_make_fused_linearize
hvp            csrc/hvp.cu             graph/solver.py:_make_hvp
chain_apply    csrc/chain_apply.cu     graph/tridiag.py:block_tridiag_apply
                                       (and its vmap in the fleet)
residual_chi2  csrc/residual_chi2.cu   factors.batched_residuals +
                                       solver._robust_chi2_from_r (and
                                       their vmap in the fleet)
relax_min      csrc/relax_min.cu       graph/shortest_path.py:shortest_paths;
                                       entries relax_pairs (pairwise_graph_
                                       distance), relax_uncertainty
                                       (reevaluate_uncertainty) and
                                       relax_table (the table all three read),
                                       one count each
cluster_labels csrc/cluster_labels.cu  graph/filter.py:_cluster_labels; entry
                                       cluster_roots (filter_loop_closures'
                                       steps before RANSAC, own count)
ransac_rigid   csrc/ransac_rigid.cu    ops/ransac.py:ransac_rigid (+
                                       _valid_sample's draw, kabsch,
                                       kabsch_quat)
components     csrc/components.cu      graph/solver.py:connected_components
                                       and gauge_fix_mask in one launch
                                       (components_gauge, the solves'
                                       call), or either alone (components,
                                       gauge_fix); one count
chain_factor   csrc/chain_factor.cu    graph/tridiag.py:block_tridiag_factor
                                       (+ _inv3, _inv6, _pad_pow2,
                                       _dense_root_inverse; and their vmap
                                       in the fleet) with solver.py's
                                       damped diagonal (build_pack)
pcg            csrc/pcg.cu             graph/solver.py:_pcg's vector updates
                                       (and their vmap in the fleet; three
                                       wrappers, one count)
project_rays   csrc/occupancy.cu       mapping/occupancy.py:_project_rays +
                                       _mark_node_cells
fast_nms       csrc/fast_nms.cu        ops/features.py:fast_score + nms (every
                                       pyramid level in one launch)
grid_topk      csrc/grid_topk.cu       ops/features.py:select_topk_grid
orb_describe   csrc/orb_describe.cu    ops/features.py:_sep_blur +
                                       intensity_centroid_angles +
                                       brief_descriptors (every level and
                                       binary_gist in one launch)
scan_bins      csrc/scan_bins.cu       ops/scan.py:depth_to_scan's per-pixel
                                       part + _bin_min_max; second entry
                                       bin_min_max (own count): the point
                                       math and _bin_min_max of
                                       points_to_scan / cloud_to_scan
hamming_top2   csrc/hamming_top2.cu    ops/matching.py:hamming_matrix +
                                       knn_match + ratio_test (match_descriptors)
                                       and recognizer.py:gist_query (two
                                       wrappers, one count)
bilateral      csrc/bilateral.cu       ops/depth.py:joint_bilateral_filter
icp            csrc/icp.cu             ops/icp.py:_correspondences inside
                                       icp_point_to_line (all iterations)
merge_pairs    csrc/merge_pairs.cu     graph/lifecycle.py:find_merge_pairs
calib_gn       csrc/calib_gn.cu        graph/calibration.py:calibrate (the
                                       Gauss-Newton steps, jacfwd included)
feature_votes  csrc/feature_votes.cu   recognition/recognizer.py:
                                       feature_set_query (one launch, its
                                       top-k in the last CTA)
repository     csrc/repository.cu      recognizer.py:repository_add's search
                                       (repo_nearest) and repository_query
                                       (repo_votes); two wrappers, one count,
                                       one launch each
bow_words      csrc/bow_words.cu       recognition/vocabulary.py:quantize and
                                       build_vocabulary's rounds (word_assign,
                                       word_majority); two wrappers, one count
bow_query      csrc/bow_query.cu       vocabulary.py:bow_query + bow_score
voxel_grid     csrc/voxel_grid.cu      ops/gicp.py:voxel_downsample
knn_normals    csrc/gicp.cu            ops/gicp.py:estimate_normals
gicp           csrc/gicp.cu            ops/gicp.py:gicp_6d (all iterations)
pnp            csrc/pnp.cu             ops/pnp.py:pnp_ransac (the draws, the
                                       _dlt_pose, _homography_pose and kabsch
                                       fits, the consensus, argmax and
                                       Gauss-Newton polish; pnp_ransac)
sift_describe  csrc/sift_describe.cu   ops/features.py:sift_descriptors (+
                                       _sep_blur radius 1 and
                                       intensity_centroid_angles)
l2_top2        csrc/l2_top2.cu         ops/matching.py:l2_matrix + knn_match
                                       + ratio_test (match_descriptors_l2)
uid_slots      csrc/scope_match.cu     parallel/scope.py:uid_to_slot
edge_key_match csrc/scope_match.cu     scope.py:apply_delta's (De, E) edge
                                       dedup and apply_ack's (A, E) compare
                                       in uid space
delta_upsert   csrc/delta_apply.cu     scope.py:apply_delta's node and edge
                                       scans, its in-delta dedup and ACK
scope_merge    csrc/delta_apply.cu     scope.py:apply_scope's scan (own
                                       count)
pcg_chain      csrc/pcg_chain.cu       graph/solver.py:_pcg's body minus the
                                       Hessian-vector product, with
                                       tridiag.py:block_tridiag_apply inside
                                       it (a single solve; K10 + K3 fused)
pcg_chain_     csrc/pcg_chain.cu       graph/solver.py:_pcg's whole loop with
solve                                  _make_hvp and block_tridiag_apply
                                       inside it (a single solve with no
                                       reduce hook; K2 + K34 fused)
pcg_grid       csrc/pcg_grid.cu        graph/solver.py:_pcg's body minus the
                                       Hessian-vector product, with
                                       tridiag.py:block_tridiag_apply inside
                                       it (a single solve above K34's cap;
                                       K10 + K3 in one cooperative launch)
pcg_fleet_     csrc/pcg_fleet.cu       graph/solver.py:_pcg's whole loop with
solve                                  _make_hvp and block_tridiag_apply
                                       inside it, under the fleet's vmap
                                       (parallel/sharded.py:optimize_batch):
                                       a CTA an instance, one launch a PCG
                                       solve (K2 + K10 + K3 fused)
lm_candidate   csrc/lm_step.cu         graph/solver.py's LM tail: retraction,
                                       batched_residuals, _robust_chi2_from_r
lm_accept      csrc/lm_step.cu         the accept rule with the λ schedule and
                                       the early exit (one count each)
=============  ======================  =======================================

K3, K4, K9, K10 and K36 take a batch of B instances of equal sizes,
flattened (the fleet of ``parallel/sharded.optimize_batch``); a single solve
is the batch of one.  K9 builds the damped diagonal it factors as it reads
Hb, and runs its levels and root in one cooperative launch.  The solve's
PCG has five routes (``solver._pcg``): a single solve within K34's cap
with no reduce hook takes ``pcg_chain_solve`` (K35),
one launch a PCG solve; with a reduce hook (the edge-sharded solve, whose
all-reduce sits between Hv and the dot) K2 and ``pcg_chain_step`` (K34), one
launch each a step; a single solve above the cap, K2 and K37 (one
cooperative launch a step, with or without a reduce hook); a fleet whose
instance fits one CTA's shared memory (``pcg_fleet_route``),
``pcg_fleet_solve`` (K38), one launch a PCG solve; a larger fleet, K2, K10
and K3.
K1, K35 and K38 sum node rows over the solve's incidence table
(``incidence_table``) in a fixed order, without float atomics.

What bounds each kernel on the card, and what its design does about it, is
written at the top of its source file.
"""

from __future__ import annotations

import array
import ctypes
import functools
import math
import weakref
from typing import NamedTuple

import numpy as np
import torch

from uzliti_slam_tpu_torch.graph import factors
from uzliti_slam_tpu_torch.kernels import _build
from uzliti_slam_tpu_torch.ops import lie

launches = {"linearize": 0, "hvp": 0, "chain_apply": 0, "residual_chi2": 0,
            "relax_min": 0, "relax_table": 0, "relax_pairs": 0, "relax_uncertainty": 0,
            "cluster_labels": 0, "cluster_roots": 0, "ransac_rigid": 0, "components": 0,
            "chain_factor": 0, "pcg": 0, "project_rays": 0, "fast_nms": 0, "grid_topk": 0,
            "orb_describe": 0, "scan_bins": 0, "hamming_top2": 0, "bilateral": 0, "icp": 0,
            "merge_pairs": 0, "calib_gn": 0, "bin_min_max": 0, "feature_votes": 0,
            "repository": 0, "bow_words": 0, "bow_query": 0, "voxel_grid": 0,
            "knn_normals": 0, "gicp": 0, "pnp": 0, "sift_describe": 0, "l2_top2": 0,
            "uid_slots": 0, "edge_key_match": 0, "delta_upsert": 0, "scope_merge": 0,
            "pcg_chain": 0, "pcg_chain_solve": 0, "lm_candidate": 0,
            "lm_accept": 0, "pcg_grid": 0, "pcg_fleet_solve": 0}

_THREADS = 256  # kThreads in csrc/lie.cuh: K4's partial sums, one per block
_SMEM_BYTES = 232448  # shared memory one CTA can use on Hopper
INF = 3.4e38  # shortest-path "unreachable", uzliti_slam_tpu/graph/shortest_path.py:INF


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check(name: str, t: torch.Tensor, shape: tuple, dtype: torch.dtype,
           device: torch.device) -> int:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    return t.data_ptr()


def _check_aligned(name: str, t: torch.Tensor) -> None:
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: not 16-byte aligned (the kernel loads 128-bit words)")


_checked_memo: dict = {}


def _check_fixed(site: str, items) -> list:
    """``_check`` of ``items`` ((name, tensor, shape, dtype), all on the
    first tensor's device), remembered per call site: a wrapper called
    every LM iteration with the same graph tensors checks them once.  Weak
    references: the memo keeps no tensor alive."""
    shapes = tuple((shape, dtype) for _, _, shape, dtype in items)
    hit = _checked_memo.get(site)
    if (hit is not None and hit[1] == shapes
            and all(ref() is t for ref, (_, t, _, _) in zip(hit[0], items))):
        return hit[2]
    dev = items[0][1].device
    ptrs = [_check(name, t, shape, dtype, dev) for name, t, shape, dtype in items]
    _checked_memo[site] = (tuple(weakref.ref(t) for _, t, _, _ in items), shapes, ptrs)
    return ptrs


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_OUT_OF_RESOURCES = 701     # cudaErrorLaunchOutOfResources
_COOPERATIVE_TOO_LARGE = 720     # cudaErrorCooperativeLaunchTooLarge


def _raise_on(err: int, kernel: str) -> None:
    if err == _COOPERATIVE_TOO_LARGE and kernel == "pcg_grid":
        # K37 sizes its cooperative grid by occupancy, and says so with this
        # code when not one CTA fits an SM
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {err}: its "
                           "cooperative grid does not fit on the device")
    if err == _OUT_OF_RESOURCES and kernel in ("pcg_chain", "pcg_chain_solve"):
        # K34 and K35 check with cudaOccupancyMaxActiveClusters before their
        # first launch on a device that their cluster fits, and say so with
        # this code
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {err}: an "
                           f"{PCG_CHAIN_CLUSTER}-CTA cluster with {_SMEM_BYTES} bytes of "
                           "shared memory a CTA does not fit on the device")
    if err == _OUT_OF_RESOURCES and kernel == "calib_gn":
        raise RuntimeError(f"calib_gn: CUDA launch failed with cudaError_t {err}: its cluster "
                           "does not fit on the device")
    if err == _OUT_OF_RESOURCES and kernel == "icp":
        raise RuntimeError(f"icp: CUDA launch failed with cudaError_t {err}: a 16-CTA cluster "
                           f"with {ICP_MAX_POINTS} target points' shared memory a CTA does not "
                           "fit on the device")
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {err}")


# ---------------------------------------------------------------------------
# The incidence table (K1's and K35's node sums)
# ---------------------------------------------------------------------------

class IncidenceTable(NamedTuple):
    """Each node's (edge, side) pairs of the valid edges, as CSR: node n's
    entries are ``entries[row_ptr[n]:row_ptr[n + 1]]``, entry 2e + side
    (side 0: edge e leaves n, side 1: it enters n), in increasing order.
    ``entries`` has 2E slots; those from ``row_ptr[N]`` on belong to invalid
    edges and are never read."""
    row_ptr: torch.Tensor   # (N + 1,) int32
    entries: torch.Tensor   # (2E,) int32


def incidence_table(e_from, e_to, e_valid, n_nodes: int) -> IncidenceTable:
    """The table of the edges where ``e_valid``, built without a host
    synchronisation (a stable sort of the entries by node, the invalid
    edges' entries keyed past every node, then a ``searchsorted`` of the
    node ids): padded slots, which all join node 0 to itself, stay out."""
    node = _entry_terms(e_from, e_to).to(torch.int32)
    valid = e_valid.to(torch.bool)
    key = torch.where(_entry_terms(valid, valid), node, n_nodes)
    order = torch.sort(key, stable=True)
    ids = torch.arange(n_nodes + 1, dtype=torch.int32, device=e_from.device)
    row_ptr = torch.searchsorted(order.values, ids, out_int32=True)
    return IncidenceTable(row_ptr, order.indices.to(torch.int32))


def _entry_terms(from_side, to_side) -> torch.Tensor:
    """Per-edge terms of both sides (E, ...) interleaved as table entries
    (2E, ...): entry 2e + side."""
    return torch.stack([from_side, to_side], dim=1).flatten(0, 1)


def _check_table(table: IncidenceTable, n: int, E: int, dev) -> list:
    return [_check("row_ptr", table.row_ptr, (n + 1,), torch.int32, dev),
            _check("entries", table.entries, (2 * E,), torch.int32, dev)]


# ---------------------------------------------------------------------------
# K1 linearize
# ---------------------------------------------------------------------------

def _column_bits(col_mask) -> int:
    """K1's ``col_keep``: bit k set keeps Jacobian column k (63: all)."""
    if col_mask is None:
        return 0x3F
    vals = [float(c) for c in col_mask]
    if len(vals) != 6 or any(v not in (0.0, 1.0) for v in vals):
        raise ValueError(f"linearize: col_mask {col_mask!r}, expected six 0/1 entries")
    return sum(1 << k for k, v in enumerate(vals) if v)


def linearize_plain(r, adj_meas_inv, info, valid, e_from, e_to, free, both_free,
                    is_chain, huber_delta: float, col_mask=None, reduce=None):
    """Plain version of K1: (Ji, Jj, W, grad, Hb, U).

    ``valid`` (E,), ``is_chain`` (E,) and ``free``/``both_free`` (N,) are
    float 0/1 masks; ``both_free[i]`` = node i and node i+1 both free.
    ``col_mask``: six 0/1 floats multiplying the Jacobians' columns (the
    planar solve's ``[1, 1, 0, 0, 0, 1]``), or None.  ``reduce``: applied
    in place to the packed (78·N,) node sums grad | Hb | U, whose views
    are returned (the edge-sharded solve's all-reduce), or None.
    """
    n, E = free.shape[0], r.shape[0]
    W = factors.weighted_info(r, info, valid, huber_delta)
    Ji, Jj = factors.jacobians_from_residual(r, adj_meas_inv)
    if _column_bits(col_mask) != 0x3F:
        cm = torch.tensor(col_mask, dtype=r.dtype, device=r.device)
        Ji, Jj = Ji * cm, Jj * cm
    JiT, JjT = Ji.transpose(-1, -2), Jj.transpose(-1, -2)
    Wr = W @ r[..., None]
    gi = (JiT @ Wr)[..., 0]
    gj = (JjT @ Wr)[..., 0]
    WJj = W @ Jj
    Hii = JiT @ (W @ Ji)
    Hjj = JjT @ WJj
    Uc = (JiT @ WJj) * is_chain[:, None, None]
    pf = torch.cat([gi, Hii.reshape(E, 36), Uc.reshape(E, 36)], dim=1)
    pt = torch.cat([gj, Hjj.reshape(E, 36)], dim=1)
    sf = torch.zeros(n, 78, dtype=r.dtype, device=r.device).index_add_(0, e_from, pf)
    st = torch.zeros(n, 42, dtype=r.dtype, device=r.device).index_add_(0, e_to, pt)
    grad = (sf[:, :6] + st[:, :6]) * free[:, None]
    Hb = (sf[:, 6:42] + st[:, 6:42]).reshape(n, 6, 6)
    U = sf[:, 42:].reshape(n, 6, 6) * both_free[:, None, None]
    acc = torch.cat([grad.reshape(-1), Hb.reshape(-1), U.reshape(-1)])
    if reduce is not None:
        reduce(acc)
    return (Ji, Jj, W, acc[: 6 * n].view(n, 6), acc[6 * n: 42 * n].view(n, 6, 6),
            acc[42 * n:].view(n, 6, 6))


def linearize(r, adj_meas_inv, info, valid, e_from, e_to, free, both_free,
              is_chain, huber_delta: float, col_mask=None, reduce=None, table=None):
    """K1: fused per-edge Jacobians, robust weights and node-row sums, the
    Jacobians' columns masked by ``col_mask`` and the packed node sums
    handed to ``reduce`` as in ``linearize_plain``.  ``table``: the
    incidence table of the edges where ``valid`` (the solve builds it once),
    which the kernel sums node rows over; on CPU tensors the plain version,
    in edge order, needs none."""
    if r.device.type == "cpu":
        return linearize_plain(r, adj_meas_inv, info, valid, e_from, e_to, free,
                               both_free, is_chain, huber_delta, col_mask, reduce)
    dev, f32 = r.device, torch.float32
    E, n = r.shape[0], free.shape[0]
    if table is None:
        raise ValueError("linearize: a CUDA device needs the incidence table (incidence_table)")
    ptrs = [
        _check("r", r, (E, 6), f32, dev),
        _check("adj_meas_inv", adj_meas_inv, (E, 6, 6), f32, dev),
        _check("info", info, (E, 6, 6), f32, dev),
        _check("valid", valid, (E,), f32, dev),
        _check("free", free, (n,), f32, dev),
        _check("both_free", both_free, (n,), f32, dev),
        _check("is_chain", is_chain, (E,), f32, dev),
        *_check_table(table, n, E, dev),
    ]
    col_keep = _column_bits(col_mask)
    lib = _build.load()
    J = torch.empty(3, E, 6, 6, dtype=f32, device=dev)
    acc = torch.empty(n * 78, dtype=f32, device=dev)
    grad = acc[: 6 * n].view(n, 6)
    Hb = acc[6 * n: 42 * n].view(n, 6, 6)
    U = acc[42 * n:].view(n, 6, 6)
    err = lib.uz_linearize(*ptrs, float(huber_delta), E, n, col_keep,
                           J[0].data_ptr(), J[1].data_ptr(), J[2].data_ptr(),
                           grad.data_ptr(), Hb.data_ptr(), U.data_ptr(), _stream(dev))
    _raise_on(err, "linearize")
    launches["linearize"] += 1
    if reduce is not None:
        reduce(acc)
    return J[0], J[1], J[2], grad, Hb, U


# ---------------------------------------------------------------------------
# K2 hvp
# ---------------------------------------------------------------------------

def hvp_plain(Ji, Jj, W, e_from, e_to, v, damp, free):
    """Plain version of K2: (H + damp) @ v, rows/cols masked to free nodes."""
    n = v.shape[0]
    vm = v * free[:, None]
    u = (Ji @ vm.index_select(0, e_from)[..., None]
         + Jj @ vm.index_select(0, e_to)[..., None])
    Wu = W @ u
    yi = (Ji.transpose(-1, -2) @ Wu)[..., 0]
    yj = (Jj.transpose(-1, -2) @ Wu)[..., 0]
    zeros = torch.zeros(n, 6, dtype=v.dtype, device=v.device)
    y = zeros.index_add(0, e_from, yi) + zeros.index_add(0, e_to, yj)
    return (y + damp * vm) * free[:, None]


def hvp(Ji, Jj, W, e_from, e_to, v, damp, free):
    """K2: matrix-free Gauss-Newton Hessian-vector product."""
    if v.device.type == "cpu":
        return hvp_plain(Ji, Jj, W, e_from, e_to, v, damp, free)
    dev, f32 = v.device, torch.float32
    E, n = e_from.shape[0], v.shape[0]
    ptrs = [
        _check("Ji", Ji, (E, 6, 6), f32, dev),
        _check("Jj", Jj, (E, 6, 6), f32, dev),
        _check("W", W, (E, 6, 6), f32, dev),
        _check("e_from", e_from, (E,), torch.int32, dev),
        _check("e_to", e_to, (E,), torch.int32, dev),
        _check("v", v, (n, 6), f32, dev),
        _check("damp", damp, (n, 6), f32, dev),
        _check("free", free, (n,), f32, dev),
    ]
    lib = _build.load()
    y = torch.empty(n, 6, dtype=f32, device=dev)
    _raise_on(lib.uz_hvp(*ptrs, E, n, y.data_ptr(), _stream(dev)), "hvp")
    launches["hvp"] += 1
    return y


# ---------------------------------------------------------------------------
# K3 chain_apply
# ---------------------------------------------------------------------------

def _pow2(n: int) -> int:
    return 1 << max((n - 1).bit_length(), 0)


def chain_apply_plain(factor, b):
    """Plain version of K3: solve A x = b for each of B chains with a
    ``chain_factor`` result ``(levels, root_inv, n)`` (levels' tensors (B,
    half, 6, 6), roots (B, 6m, 6m)); b the chains' right-hand sides stacked
    (B·n, 6), as the flattened fleet holds them (a single chain: B = 1)."""
    levels, root_inv, n_orig = factor
    B = root_inv.shape[0]
    n2 = _pow2(n_orig)
    bk = torch.cat([b.view(B, n_orig, 6), b.new_zeros(B, n2 - n_orig, 6)], dim=1)
    b_levels = []
    for Dinv_o, P1m, P2, G1, G2 in levels:
        be, bo = bk[:, 0::2], bk[:, 1::2]
        bo_m = torch.cat([bo.new_zeros(B, 1, 6), bo[:, :-1]], dim=1)
        b_levels.append(bo)
        bk = be - (P1m @ bo_m[..., None])[..., 0] - (P2 @ bo[..., None])[..., 0]
    x = (root_inv @ bk.reshape(B, -1, 1))[..., 0].reshape(B, -1, 6)
    for (Dinv_o, P1m, P2, G1, G2), bo in zip(reversed(levels), reversed(b_levels)):
        x_next = torch.cat([x[:, 1:], x.new_zeros(B, 1, 6)], dim=1)
        x_o = ((Dinv_o @ bo[..., None]) - (G1 @ x[..., None])
               - (G2 @ x_next[..., None]))[..., 0]
        x = torch.stack([x, x_o], dim=2).reshape(B, -1, 6)
    return x[:, :n_orig].reshape(-1, 6)


def chain_apply(factor, b):
    """K3: the chain preconditioner's forward/back substitution and the
    root matvec, for each of the factor's B chains at once: one launch per
    level and direction and one for the roots, whatever B."""
    if b.device.type == "cpu":
        return chain_apply_plain(factor, b)
    levels, root_inv, n_orig = factor
    B = root_inv.shape[0]
    dev, f32 = b.device, torch.float32
    _check("b", b, (B * n_orig, 6), f32, dev)
    lib = _build.load()
    stream = _stream(dev)
    bufs, valid_rows = [b], [n_orig]
    for li, (Dinv_o, P1m, P2, G1, G2) in enumerate(levels):
        half = Dinv_o.shape[1]
        if 2 * half < valid_rows[-1]:
            raise ValueError(f"chain_apply: level {li} holds {2 * half} rows < {valid_rows[-1]}")
        out = torch.empty(B * half, 6, dtype=f32, device=dev)
        err = lib.uz_chain_forward(
            bufs[-1].data_ptr(), valid_rows[-1], valid_rows[-1],
            _check("P1m", P1m, (B, half, 6, 6), f32, dev),
            _check("P2", P2, (B, half, 6, 6), f32, dev), half, B, out.data_ptr(), stream)
        _raise_on(err, "chain_apply")
        bufs.append(out)
        valid_rows.append(half)
    # the root: m_root blocks, or the padded system when there is no level
    m_root = levels[-1][0].shape[1] if levels else _pow2(n_orig)
    root_rows = m_root if levels else n_orig
    x = torch.empty(B * root_rows, 6, dtype=f32, device=dev)
    err = lib.uz_chain_root(_check("root_inv", root_inv, (B, 6 * m_root, 6 * m_root), f32, dev),
                            bufs[-1].data_ptr(), valid_rows[-1], valid_rows[-1], 6 * m_root, B,
                            x.data_ptr(), root_rows, stream)
    _raise_on(err, "chain_apply")
    for li in reversed(range(len(levels))):
        Dinv_o, _, _, G1, G2 = levels[li]
        half = Dinv_o.shape[1]
        rows = n_orig if li == 0 else 2 * half
        out = torch.empty(B * rows, 6, dtype=f32, device=dev)
        err = lib.uz_chain_backward(
            bufs[li].data_ptr(), valid_rows[li], valid_rows[li], x.data_ptr(),
            _check("Dinv_o", Dinv_o, (B, half, 6, 6), f32, dev),
            _check("G1", G1, (B, half, 6, 6), f32, dev),
            _check("G2", G2, (B, half, 6, 6), f32, dev),
            half, B, out.data_ptr(), rows, stream)
        _raise_on(err, "chain_apply")
        x = out
    launches["chain_apply"] += 1
    return x


# ---------------------------------------------------------------------------
# K4 residual_chi2
# ---------------------------------------------------------------------------

def residual_chi2_plain(poses, e_from, e_to, meas, info, valid, huber_delta: float,
                        batch: int = 1):
    """Plain version of K4 on ``batch`` instances of a flattened table
    (instance b's edges at b·E, their endpoints into the flattened poses; a
    single graph: batch 1): (r (B·E, 6), each instance's Σ ρ(rᵀΛr)·valid
    (B,))."""
    r = factors.batched_residuals(
        poses.index_select(0, e_from), poses.index_select(0, e_to), meas
    )
    rho = factors.robust_costs(r, info, valid, huber_delta)
    return r, torch.sum(rho.view(batch, -1), dim=1)


def residual_chi2(poses, e_from, e_to, meas, info, valid, huber_delta: float, batch: int = 1):
    """K4: edge residuals of ``poses`` and one robust χ² per instance (B,),
    each summed in the order of a single solve of it."""
    if poses.device.type == "cpu":
        return residual_chi2_plain(poses, e_from, e_to, meas, info, valid, huber_delta, batch)
    dev, f32 = poses.device, torch.float32
    BE, n = e_from.shape[0], poses.shape[0]
    if batch < 1 or BE % batch or n % batch:
        raise ValueError(f"residual_chi2: {BE} edges, {n} nodes in {batch} instances")
    E = BE // batch
    ptrs = [
        _check("poses", poses, (n, 7), f32, dev),
        _check("e_from", e_from, (BE,), torch.int32, dev),
        _check("e_to", e_to, (BE,), torch.int32, dev),
        _check("meas", meas, (BE, 7), f32, dev),
        _check("info", info, (BE, 6, 6), f32, dev),
        _check("valid", valid, (BE,), f32, dev),
    ]
    lib = _build.load()
    nb = -(-E // _THREADS)
    out = torch.empty(BE * 6 + batch * (nb + 1), dtype=f32, device=dev)
    r = out[: BE * 6].view(BE, 6)
    partials = out[BE * 6: BE * 6 + batch * nb]
    chi2 = out[BE * 6 + batch * nb:]
    err = lib.uz_residual_chi2(*ptrs, float(huber_delta), E, batch, r.data_ptr(),
                               partials.data_ptr(), chi2.data_ptr(), _stream(dev))
    _raise_on(err, "residual_chi2")
    launches["residual_chi2"] += 1
    return r, chi2


# ---------------------------------------------------------------------------
# K36 lm_step (the LM iteration's tail: candidate, then accept)
# ---------------------------------------------------------------------------
# An LM solve of ``batch`` flattened instances keeps an ``LmState``: its
# iterate and residuals, updated in place, and one column (or row) per
# iteration of the χ² history, λ, the accept flags and the early exit's
# gain, done, stale and refresh flags.  Each iteration, after its PCG solve:
# ``lm_candidate`` (retraction, residuals and χ² of the candidate, one
# launch), the caller's reduce of χ² if any, then ``lm_accept`` (the accept
# rule, one launch).  Column ``it`` is read and ``it + 1`` written, so no
# block of a launch reads what another writes.


class LmState(NamedTuple):
    """An LM loop's state: ``poses`` (B·N, 7) and ``r`` (B·E, 6) updated in
    place; ``hist`` and ``lam`` (B, iterations + 1), column 0 the start;
    ``acc`` and ``gain`` (B, iterations); ``done``, ``stale`` and ``need``
    (iterations + 1, B), row ``it`` the state entering iteration ``it``
    (row 0 not read: nothing done, stale 0), ``need[it]`` K9's refresh flag
    there (early exit).  ``ptrs``: on the card, the checked pointers K36's
    accept writes through, fixed for the solve."""
    poses: torch.Tensor
    r: torch.Tensor
    hist: torch.Tensor
    lam: torch.Tensor
    acc: torch.Tensor
    gain: torch.Tensor
    done: torch.Tensor
    stale: torch.Tensor
    need: torch.Tensor
    ptrs: tuple | None = None


class LmRules(NamedTuple):
    """The accept rule's constants (``SolverConfig``'s), as floats; the
    kernel takes them rounded to float32 and computes λ / factor as
    λ·fl(1/factor), as PyTorch divides a CUDA tensor by a Python float (and
    XLA the reference's λ by its constant); on CPU tensors the plain version
    divides."""
    factor: float
    lam_min: float
    lam_max: float
    lam_init: float
    tol: float
    refresh: int
    early_exit: bool


def lm_state(poses, r0, chi2_0, iterations: int, lambda_init: float, batch: int = 1) -> LmState:
    """The state entering iteration 0: a copy of ``poses``, ``r0`` itself,
    χ²₀ (B,) in column 0 of the history and λ₀ in every column of ``lam``."""
    dev, f32 = poses.device, torch.float32
    B, I = batch, iterations
    hist = torch.empty(B, I + 1, dtype=f32, device=dev)
    hist[:, 0].copy_(chi2_0)
    flags = torch.empty(2, I + 1, B, dtype=torch.bool, device=dev)
    state = LmState(poses.clone(), r0, hist,
                    torch.full((B, I + 1), lambda_init, dtype=f32, device=dev),
                    torch.empty(B, I, dtype=torch.bool, device=dev),
                    torch.empty(B, I, dtype=f32, device=dev), flags[0],
                    torch.empty(I + 1, B, dtype=torch.int32, device=dev), flags[1])
    return state if dev.type == "cpu" else state._replace(ptrs=_state_ptrs(state))


def _state_ptrs(state: LmState) -> tuple:
    """The state's tensors checked (B instances, I iterations), as
    ``uz_lm_accept`` takes them."""
    dev, f32 = state.poses.device, torch.float32
    B, cols = state.hist.shape
    I = cols - 1
    BN, BE = state.poses.shape[0], state.r.shape[0]
    if BN % B or BE % B:
        raise ValueError(f"lm_accept: {BN} nodes, {BE} edges in {B} instances")
    return (_check("poses", state.poses, (BN, 7), f32, dev),
            _check("r", state.r, (BE, 6), f32, dev),
            _check("hist", state.hist, (B, I + 1), f32, dev),
            _check("lam", state.lam, (B, I + 1), f32, dev),
            _check("acc", state.acc, (B, I), torch.bool, dev),
            _check("gain", state.gain, (B, I), f32, dev),
            _check("done", state.done, (I + 1, B), torch.bool, dev),
            _check("stale", state.stale, (I + 1, B), torch.int32, dev),
            _check("need", state.need, (I + 1, B), torch.bool, dev))


def lm_candidate_plain(poses, dx, free, e_from, e_to, meas, info, valid, huber_delta: float,
                       batch: int = 1):
    """Plain version of K36's first entry: (cand = poses ∘ exp(dx·free),
    its residuals (B·E, 6), each instance's robust χ² (B,))."""
    cand = lie.pose_retract(poses, dx * free[:, None])
    r, chi2 = residual_chi2_plain(cand, e_from, e_to, meas, info, valid, huber_delta, batch)
    return cand, r, chi2


_tickets: dict = {}


def _ticket_buffer(device, batch: int) -> torch.Tensor:
    """K36's per-instance counters on ``device``, zeroed once; the kernel
    leaves them zeroed."""
    t = _tickets.get(device)
    if t is None or t.numel() < batch:
        t = torch.zeros(max(batch, 4096), dtype=torch.int32, device=device)
        _tickets[device] = t
    return t


def lm_candidate(poses, dx, free, e_from, e_to, meas, info, valid, huber_delta: float,
                 batch: int = 1):
    """K36's first entry: every node's candidate pose, every edge's
    candidate residual and each instance's robust χ² (summed in K4's order),
    one launch."""
    if poses.device.type == "cpu":
        return lm_candidate_plain(poses, dx, free, e_from, e_to, meas, info, valid,
                                  huber_delta, batch)
    dev, f32 = poses.device, torch.float32
    BE, BN = e_from.shape[0], poses.shape[0]
    if batch < 1 or BE % batch or BN % batch:
        raise ValueError(f"lm_candidate: {BE} edges, {BN} nodes in {batch} instances")
    E, N = BE // batch, BN // batch
    # the graph's tensors and the iterate are the same every iteration
    fixed = _check_fixed("lm_candidate", [
        ("poses", poses, (BN, 7), f32), ("free", free, (BN,), f32),
        ("e_from", e_from, (BE,), torch.int32), ("e_to", e_to, (BE,), torch.int32),
        ("meas", meas, (BE, 7), f32), ("info", info, (BE, 6, 6), f32),
        ("valid", valid, (BE,), f32)])
    ptrs = [fixed[0], _check("dx", dx, (BN, 6), f32, dev), *fixed[1:]]
    lib = _build.load()
    nb = -(-E // _THREADS)
    out = torch.empty(BN * 7 + BE * 6 + batch * (nb + 1), dtype=f32, device=dev)
    cand = out[: BN * 7].view(BN, 7)
    r = out[BN * 7: BN * 7 + BE * 6].view(BE, 6)
    partials = out[BN * 7 + BE * 6: BN * 7 + BE * 6 + batch * nb]
    chi2 = out[BN * 7 + BE * 6 + batch * nb:]
    err = lib.uz_lm_candidate(*ptrs, float(huber_delta), N, E, batch, cand.data_ptr(),
                              r.data_ptr(), partials.data_ptr(),
                              _ticket_buffer(dev, batch).data_ptr(), chi2.data_ptr(),
                              _stream(dev))
    _raise_on(err, "lm_candidate")
    launches["lm_candidate"] += 1
    return cand, r, chi2


def _rows(mask, a, b, batch: int):
    """``a`` where ``mask`` (B,), else ``b``, over the instances' rows of a
    flattened tensor."""
    shape = (batch, -1) + tuple(a.shape[1:])
    m = mask.view((batch,) + (1,) * a.dim())
    return torch.where(m, a.view(shape), b.view(shape)).view(a.shape)


def lm_accept_plain(state: LmState, cand, r_cand, chi2_new, it: int, rules: LmRules) -> None:
    """Plain version of K36's second entry: the accept rule of iteration
    ``it`` on ``state``, in place (``solver.py:925-946`` with the early
    exit's gain and termination, ``:988-997`` without)."""
    B = state.hist.shape[0]
    cur, lam = state.hist[:, it], state.lam[:, it]
    early = rules.early_exit
    was_done = state.done[it] if early and it > 0 else torch.zeros_like(chi2_new, dtype=torch.bool)
    active = ~was_done
    accept = (chi2_new < cur) & active
    state.poses.copy_(_rows(accept, cand, state.poses, B))
    state.r.copy_(_rows(accept, r_cand, state.r, B))
    lam_next = torch.clamp(torch.where(accept, lam / rules.factor, lam * rules.factor),
                           rules.lam_min, rules.lam_max)
    state.hist[:, it + 1] = torch.where(accept, chi2_new, cur)
    state.acc[:, it] = accept
    if not early:
        state.lam[:, it + 1] = lam_next
        return
    gain = (cur - chi2_new) / torch.clamp(cur, min=1e-12)
    # converged (tiny accepted gain with λ already relaxed) or stuck
    # (rejected with λ at its ceiling)
    finished = ((accept & (gain < rules.tol) & (lam <= rules.lam_init))
                | (~accept & (lam >= rules.lam_max)))
    stale = (torch.where(state.need[it], 0, state.stale[it]) if it > 0
             else torch.zeros_like(state.stale[0]))
    stale_next = torch.where(accept, stale + 1, rules.refresh)
    done_next = was_done | (active & finished)
    state.gain[:, it] = gain
    state.lam[:, it + 1] = torch.where(active, lam_next, lam)
    state.stale[it + 1] = stale_next
    state.done[it + 1] = done_next
    state.need[it + 1] = (stale_next >= rules.refresh) & ~done_next


def lm_accept(state: LmState, cand, r_cand, chi2_new, it: int, rules: LmRules) -> None:
    """K36's second entry: the accept rule of iteration ``it``, one launch:
    rows of ``state.poses`` and ``state.r`` selected in place, the scalars
    of column ``it + 1`` written."""
    if cand.device.type == "cpu":
        return lm_accept_plain(state, cand, r_cand, chi2_new, it, rules)
    dev, f32 = cand.device, torch.float32
    B, cols = state.hist.shape
    I = cols - 1
    BN, BE = state.poses.shape[0], state.r.shape[0]
    if not 0 <= it < I:
        raise ValueError(f"lm_accept: iteration {it} of {I}")
    ptrs = state.ptrs if state.ptrs is not None else _state_ptrs(state)
    cand_ptrs = [_check("cand", cand, (BN, 7), f32, dev),
                 _check("r_cand", r_cand, (BE, 6), f32, dev),
                 _check("chi2_new", chi2_new, (B,), f32, dev)]
    lib = _build.load()
    err = lib.uz_lm_accept(*cand_ptrs, BN // B, BE // B, B, it, I, int(rules.early_exit),
                           1.0 / rules.factor, rules.factor, rules.lam_min, rules.lam_max,
                           rules.lam_init, rules.tol, int(rules.refresh), *ptrs, _stream(dev))
    _raise_on(err, "lm_accept")
    launches["lm_accept"] += 1


# ---------------------------------------------------------------------------
# K5 relax_min (entries relax_table, relax_min, relax_pairs, relax_uncertainty)
# ---------------------------------------------------------------------------

RELAX_THREADS = 128         # a row's CTA in relax_min and relax_pairs
RELAX_ROOT_THREADS = 512    # relax_uncertainty's one row
RELAX_LIST_CAP = 1024       # a frontier list's entries (a longer frontier is read from its bitmask)
# the relaxation kernels' static shared memory (count[3], and the root's
# argmin partials wkey / widx in relax_unc_kernel: 140 bytes), rounded up;
# their dynamic shared memory may take only what it leaves
RELAX_STATIC_SMEM = 256


class RelaxTable(NamedTuple):
    """Each node's neighbours over the edges of finite weight that are not
    self-loops, as CSR: node n's entries are ``adj[row_ptr[n]:row_ptr[n + 1]]``,
    rows of (neighbour, the weight's float32 bits).  ``adj`` has 2E rows;
    those from ``row_ptr[N]`` on are never read.  The order within a node's
    entries is free (every use is a min): the plain version keeps edge order,
    the kernel's fill order varies."""
    row_ptr: torch.Tensor   # (N + 1,) int32
    adj: torch.Tensor       # (2E, 2) int32


def relax_table_plain(e_from, e_to, w, n_nodes: int) -> RelaxTable:
    """Plain version of K5's table: a stable sort of the 2E entries by node,
    the left-out edges' entries keyed past every node."""
    keep = (w < INF) & (e_from != e_to)
    node = _entry_terms(e_from, e_to).to(torch.int32)
    key = torch.where(_entry_terms(keep, keep), node, n_nodes)
    order = torch.sort(key, stable=True)
    ids = torch.arange(n_nodes + 1, dtype=torch.int32, device=e_from.device)
    row_ptr = torch.searchsorted(order.values, ids, out_int32=True)
    nbr = _entry_terms(e_to, e_from).to(torch.int32)
    bits = _entry_terms(w, w).contiguous().view(torch.int32)
    return RelaxTable(row_ptr, torch.stack([nbr[order.indices], bits[order.indices]], dim=1))


def relax_table(e_from, e_to, w, n_nodes: int) -> RelaxTable:
    """K5's table entry: one CTA's counting sort, one launch."""
    if e_from.device.type == "cpu":
        return relax_table_plain(e_from, e_to, w, n_nodes)
    dev = e_from.device
    E = e_from.shape[0]
    ptrs = [
        _check("e_from", e_from, (E,), torch.int32, dev),
        _check("e_to", e_to, (E,), torch.int32, dev),
        _check("w", w, (E,), torch.float32, dev),
    ]
    lib = _build.load()
    row_ptr = torch.empty(n_nodes + 1, dtype=torch.int32, device=dev)
    # the per-node cursors in shared memory beside the kernel's 4 KB while they fit
    cursor = (None if 4 * n_nodes + 4096 <= _SMEM_BYTES
              else torch.empty(n_nodes, dtype=torch.int32, device=dev))
    adj = torch.empty(2 * E, 2, dtype=torch.int32, device=dev)
    err = lib.uz_relax_table(*ptrs, n_nodes, E, row_ptr.data_ptr(),
                             None if cursor is None else cursor.data_ptr(), adj.data_ptr(),
                             _stream(dev))
    _raise_on(err, "relax_table")
    launches["relax_table"] += 1
    return RelaxTable(row_ptr, adj)


def relax_layout(n_nodes: int, n_edges: int) -> tuple[int, bool, bool, int]:
    """Where a row of K5's relaxations lives: (list capacity, rows in
    shared memory, the table copied into shared memory, float32 words of
    global scratch a row).  The frontier's two bitmasks and lists
    (8·⌈N/32⌉ + 8·cap bytes) live in shared memory, the two distance
    buffers (8·N) beside them while they fit, else in a global scratch;
    with the rows there, the table (row offsets padded to an even count,
    2E entries of 8 bytes) joins them where it fits too.  All of it within
    a CTA's shared memory less the kernels' static part."""
    budget = _SMEM_BYTES - RELAX_STATIC_SMEM
    cap = min(n_nodes, RELAX_LIST_CAP)
    book = 4 * (2 * ((n_nodes + 31) // 32) + 2 * cap)
    if book > budget:
        raise ValueError(f"relax: {n_nodes} nodes' frontier bitmasks exceed one CTA's shared "
                         "memory")
    rows_smem = 8 * n_nodes + book <= budget
    table = 4 * ((n_nodes + 2) & ~1) + 16 * n_edges
    table_smem = rows_smem and 8 * n_nodes + book + table <= budget
    return cap, rows_smem, table_smem, 0 if rows_smem else 2 * n_nodes


def _relax_tail(table: RelaxTable, n_nodes: int, rows: int, n_iters: int, threads: int,
                dev) -> tuple[list, torch.Tensor | None]:
    """The arguments the three relaxations share (table, sizes, layout) and
    their scratch; each of them takes its kernel's C arguments in this order."""
    E = table.adj.shape[0] // 2
    cap, rows_smem, table_smem, per_row = relax_layout(n_nodes, E)
    scratch = (torch.empty(rows * per_row, dtype=torch.float32, device=dev) if per_row
               else None)
    return [table.row_ptr.data_ptr(), table.adj.data_ptr(), int(n_iters), int(threads), cap,
            int(rows_smem), E, int(table_smem)], scratch


def relax_min_plain(dist0, e_from, e_to, w, n_iters: int):
    """Plain version of K5: ``n_iters`` Bellman-Ford sweeps of every row of
    ``dist0`` (R, N), each relaxing both directions of every edge from the
    sweep's start values (the JAX fori_loop body)."""
    ef, et = e_from.long(), e_to.long()
    rows = dist0.shape[0]
    ef_r, et_r = ef.expand(rows, -1), et.expand(rows, -1)
    dist = dist0
    for _ in range(n_iters):
        via_f = torch.clamp(dist[:, ef] + w, max=INF)
        via_t = torch.clamp(dist[:, et] + w, max=INF)
        dist = dist.scatter_reduce(1, et_r, via_f, "amin")
        dist = dist.scatter_reduce(1, ef_r, via_t, "amin")
    return dist


def relax_min(dist0, e_from, e_to, w, n_iters: int):
    """K5: multi-source Bellman-Ford of every row of ``dist0`` (R, N), one
    CTA a row over the changed nodes only; with its table, two launches.
    ``dist0`` holds values in [0, INF] and ``w`` weights >= 0 or INF."""
    if dist0.device.type == "cpu":
        return relax_min_plain(dist0, e_from, e_to, w, n_iters)
    dev = dist0.device
    rows, n = dist0.shape
    ptr = _check("dist0", dist0, (rows, n), torch.float32, dev)
    table = relax_table(e_from, e_to, w, n)
    tail, scratch = _relax_tail(table, n, rows, n_iters, RELAX_THREADS, dev)
    out = torch.empty(rows, n, dtype=torch.float32, device=dev)
    err = _build.load().uz_relax_min(ptr, tail[0], tail[1], rows, n, *tail[2:], out.data_ptr(),
                                     None if scratch is None else scratch.data_ptr(),
                                     _stream(dev))
    _raise_on(err, "relax_min")
    launches["relax_min"] += 1
    return out


def relax_pairs_plain(sources, targets, e_from, e_to, w, n_nodes: int, n_iters: int):
    """Plain version of K5's pairs entry: the (B, N) rows holding 0 at each
    source, relaxed, read at each target (``pairwise_graph_distance``)."""
    b = sources.shape[0]
    init = torch.full((b, n_nodes), INF, device=sources.device).scatter(
        1, sources.long()[:, None], 0.0)
    dist = relax_min_plain(init, e_from, e_to, w, n_iters)
    return torch.gather(dist, 1, targets.long()[:, None])[:, 0]


def relax_pairs(sources, targets, e_from, e_to, w, n_nodes: int, n_iters: int):
    """K5's pairs entry: (B,) graph distances from ``sources`` to
    ``targets`` (int32), a CTA a pair, the start rows and the target gather
    inside the launch; with its table, two launches."""
    if sources.device.type == "cpu":
        return relax_pairs_plain(sources, targets, e_from, e_to, w, n_nodes, n_iters)
    dev = sources.device
    b = sources.shape[0]
    ptrs = [_check("sources", sources, (b,), torch.int32, dev),
            _check("targets", targets, (b,), torch.int32, dev)]
    table = relax_table(e_from, e_to, w, n_nodes)
    tail, scratch = _relax_tail(table, n_nodes, b, n_iters, RELAX_THREADS, dev)
    out = torch.empty(b, dtype=torch.float32, device=dev)
    err = _build.load().uz_relax_pairs(*ptrs, tail[0], tail[1], b, n_nodes, *tail[2:],
                                       out.data_ptr(),
                                       None if scratch is None else scratch.data_ptr(),
                                       _stream(dev))
    _raise_on(err, "relax_pairs")
    launches["relax_pairs"] += 1
    return out


def relax_uncertainty_plain(stamp, node_valid, uncertainty, e_from, e_to, w, n_iters: int):
    """Plain version of K5's uncertainty entry: the distances from the
    oldest valid node (the least stamp, the first slot on a tie; slot 0
    when none is valid) where a node is valid and reached, else the old
    value (``reevaluate_uncertainty``)."""
    root = torch.argmin(torch.where(node_valid, stamp, INF))
    d0 = torch.full((stamp.shape[0],), INF, device=stamp.device).index_fill(0, root.view(1), 0.0)
    dist = relax_min_plain(d0[None], e_from, e_to, w, n_iters)[0]
    return torch.where(node_valid & (dist < INF), dist, uncertainty)


def relax_uncertainty(stamp, node_valid, uncertainty, e_from, e_to, w, n_iters: int):
    """K5's uncertainty entry: the root, the relaxation and the write-back
    in one CTA (``RELAX_ROOT_THREADS`` threads); with its table, two
    launches.  Returns the new (N,) uncertainty."""
    if stamp.device.type == "cpu":
        return relax_uncertainty_plain(stamp, node_valid, uncertainty, e_from, e_to, w, n_iters)
    dev = stamp.device
    n = stamp.shape[0]
    ptrs = [_check("stamp", stamp, (n,), torch.float32, dev),
            _check("node_valid", node_valid, (n,), torch.bool, dev),
            _check("uncertainty", uncertainty, (n,), torch.float32, dev)]
    table = relax_table(e_from, e_to, w, n)
    tail, scratch = _relax_tail(table, n, 1, n_iters, RELAX_ROOT_THREADS, dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    err = _build.load().uz_relax_uncertainty(*ptrs, tail[0], tail[1], n, *tail[2:],
                                             out.data_ptr(),
                                             None if scratch is None else scratch.data_ptr(),
                                             _stream(dev))
    _raise_on(err, "relax_uncertainty")
    launches["relax_uncertainty"] += 1
    return out


# ---------------------------------------------------------------------------
# K6 cluster_labels (entries cluster_labels, cluster_roots)
# ---------------------------------------------------------------------------

CLUSTER_CTA_MAX = 256   # K6's one-CTA form: B <= 8 column words a lane (cluster_labels.cu kMaxB)


def cluster_scratch(b: int, roots: bool, n_roots: int = 0) -> int:
    """int32 words of K6's grid route (B > ``CLUSTER_CTA_MAX``): the bit
    matrix, labels, stamps, masks and flags, and the roots' arrays
    (``csrc/cluster_labels.cu:grid_scratch_ints``)."""
    words = (b + 31) // 32
    n = b * words + 5 * b + 3 * words + 3
    if roots:
        n += 5 * (b + 1) + 2 * words + 1 + n_roots
    return n


def _cluster_scratch(b: int, roots: bool, n_roots: int, dev):
    """(pointer, words) of K6's scratch: none on the one-CTA form."""
    if b <= CLUSTER_CTA_MAX:
        return None, 0
    words = cluster_scratch(b, roots, n_roots)
    return torch.empty(words, dtype=torch.int32, device=dev), words


def cluster_labels_plain(stamp_from, stamp_to, valid, max_dt: float, n_iters: int):
    """Plain version of K6: min-label propagation over the (B, B) stamp
    adjacency, ``n_iters`` Jacobi rounds."""
    adj = (
        (torch.abs(stamp_from[:, None] - stamp_from[None, :]) < max_dt)
        & (torch.abs(stamp_to[:, None] - stamp_to[None, :]) < max_dt)
        & valid[:, None] & valid[None, :]
    )
    b = stamp_from.shape[0]
    labels = torch.where(valid, torch.arange(b, dtype=torch.int32, device=valid.device), b)
    for _ in range(n_iters):
        neigh = torch.where(adj, labels[None, :], b)
        labels = torch.minimum(labels, neigh.min(dim=-1).values)
    return labels


def cluster_labels(stamp_from, stamp_to, valid, max_dt: float, n_iters: int):
    """K6: spatio-temporal cluster labels of B candidates: one CTA for B <=
    ``CLUSTER_CTA_MAX``, else one cooperative launch over the card."""
    if stamp_from.device.type == "cpu":
        return cluster_labels_plain(stamp_from, stamp_to, valid, max_dt, n_iters)
    dev, f32 = stamp_from.device, torch.float32
    b = stamp_from.shape[0]
    ptrs = [
        _check("stamp_from", stamp_from, (b,), f32, dev),
        _check("stamp_to", stamp_to, (b,), f32, dev),
        _check("valid", valid, (b,), torch.bool, dev),
    ]
    lib = _build.load()
    labels = torch.empty(b, dtype=torch.int32, device=dev)
    scratch, words = _cluster_scratch(b, False, 0, dev)
    err = lib.uz_cluster_labels(*ptrs, b, float(max_dt), int(n_iters), labels.data_ptr(),
                                _ptr(scratch), words, _stream(dev))
    _raise_on(err, "cluster_labels")
    launches["cluster_labels"] += 1
    return labels


def first_indices(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of the first ``size`` True entries of ``mask`` (B,), -1
    padded: ``jnp.nonzero(mask, size=size, fill_value=-1)`` without a host
    read."""
    b = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int32), dim=0) - 1
    slot = torch.where(mask & (pos < size), pos, size).long()
    out = torch.full((size + 1,), -1, dtype=torch.int32, device=mask.device)
    ids = torch.arange(b, dtype=torch.int32, device=mask.device)
    # every spilled or False entry lands in the spare slot ``size``
    return out.scatter(0, slot, ids)[:size]


class ClusterRootsOut(NamedTuple):
    """K6's roots entry: what ``filter_loop_closures`` computes before its
    RANSAC but the endpoint positions."""
    valid: torch.Tensor       # (B,) bool: the candidate participates
    labels: torch.Tensor      # (B,) int32 cluster label (B = none)
    root_live: torch.Tensor   # (R,) bool
    root_safe: torch.Tensor   # (R,) int64 root candidate slot (0 if dead)
    member: torch.Tensor      # (R, B) bool
    sf: torch.Tensor          # (B,) float32 'from' stamp
    st: torch.Tensor          # (B,) float32 'to' stamp


def cluster_root_count(b: int, min_cluster_size: int) -> int:
    """R: at most B // min_cluster_size clusters can pass the size gate."""
    return max(1, min(b, b // max(min_cluster_size, 1)))


def cluster_roots_plain(cand_idx, e_from, e_to, e_valid, node_valid, stamp, max_dt: float,
                        min_cluster_size: int, min_time_span: float, n_iters: int,
                        cand_mask=None) -> ClusterRootsOut:
    """Plain version of K6's roots entry (``filter.py:105-154``): the
    candidates' validity (``cand_mask``, else their edges' validity, and
    both endpoints valid) and stamps, the labels, per-cluster size and stamp
    spans, the gates, the roots (label == own slot, first ``R`` in slot
    order) and their member masks."""
    b = cand_idx.shape[0]
    dev = cand_idx.device
    present = cand_idx >= 0
    ci = torch.where(present, cand_idx, 0).long()
    ef, et = e_from[ci].long(), e_to[ci].long()
    valid = present & (e_valid[ci] if cand_mask is None else cand_mask)
    valid = valid & node_valid[ef] & node_valid[et]
    sf, st = stamp[ef], stamp[et]
    labels = cluster_labels_plain(sf, st, valid, max_dt, n_iters)

    # per-cluster stats over b + 1 segments (label b = no cluster)
    lab = labels.long()

    def seg(x, op, init):
        base = torch.full((b + 1,), init, dtype=x.dtype, device=dev)
        return base.scatter_reduce(0, lab, torch.where(valid, x, init), op, include_self=False)

    csize = torch.zeros(b + 1, dtype=torch.int32, device=dev).scatter_add(
        0, lab, valid.to(torch.int32))
    f_min, f_max = seg(sf, "amin", math.inf), seg(sf, "amax", -math.inf)
    t_min, t_max = seg(st, "amin", math.inf), seg(st, "amax", -math.inf)
    runs = ((csize >= min_cluster_size)
            & ((f_max - f_min) >= min_time_span)
            & ((t_max - t_min) >= min_time_span))

    ids = torch.arange(b, device=dev)
    is_root = (lab == ids) & valid & runs[:b]
    root_slot = first_indices(is_root, cluster_root_count(b, min_cluster_size))
    root_live = root_slot >= 0
    root_safe = torch.where(root_live, root_slot, 0).long()
    member = (lab[None, :] == root_safe[:, None]) & valid[None, :] & root_live[:, None]
    return ClusterRootsOut(valid, labels, root_live, root_safe, member, sf, st)


def cluster_roots(cand_idx, e_from, e_to, e_valid, node_valid, stamp, max_dt: float,
                  min_cluster_size: int, min_time_span: float, n_iters: int,
                  cand_mask=None) -> ClusterRootsOut:
    """K6's roots entry: the gathers, the labels, the gates, the compaction
    and the member masks in one launch: one CTA for B <=
    ``CLUSTER_CTA_MAX``, else one cooperative launch over the card."""
    if cand_idx.device.type == "cpu":
        return cluster_roots_plain(cand_idx, e_from, e_to, e_valid, node_valid, stamp, max_dt,
                                   min_cluster_size, min_time_span, n_iters, cand_mask)
    dev = cand_idx.device
    b, E, n = cand_idx.shape[0], e_from.shape[0], stamp.shape[0]
    mask = e_valid if cand_mask is None else cand_mask
    ptrs = [
        _check("cand_idx", cand_idx, (b,), torch.int32, dev),
        _check("e_from", e_from, (E,), torch.int32, dev),
        _check("e_to", e_to, (E,), torch.int32, dev),
        _check("cand_mask" if cand_mask is not None else "e_valid", mask,
               (E,) if cand_mask is None else (b,), torch.bool, dev),
        int(cand_mask is None),
        _check("node_valid", node_valid, (n,), torch.bool, dev),
        _check("stamp", stamp, (n,), torch.float32, dev),
    ]
    r = cluster_root_count(b, min_cluster_size)
    out = ClusterRootsOut(
        torch.empty(b, dtype=torch.bool, device=dev), torch.empty(b, dtype=torch.int32, device=dev),
        torch.empty(r, dtype=torch.bool, device=dev), torch.empty(r, dtype=torch.int64, device=dev),
        torch.empty(r, b, dtype=torch.bool, device=dev),
        torch.empty(b, dtype=torch.float32, device=dev),
        torch.empty(b, dtype=torch.float32, device=dev))
    scratch, words = _cluster_scratch(b, True, r, dev)
    err = _build.load().uz_cluster_roots(
        *ptrs, b, float(max_dt), int(n_iters), int(min_cluster_size), float(min_time_span), r,
        *(t.data_ptr() for t in (out.valid, out.labels, out.sf, out.st, out.root_live,
                                 out.root_safe, out.member)), _ptr(scratch), words,
        _stream(dev))
    _raise_on(err, "cluster_roots")
    launches["cluster_roots"] += 1
    return out


# ---------------------------------------------------------------------------
# K7 ransac_rigid
# ---------------------------------------------------------------------------

def _fit_weights(valid, weights, dtype):
    """The fits' weights: ``weights * valid`` (the reference's w), or valid
    as 0/1 without weights."""
    return valid.to(dtype) if weights is None else weights * valid


def ransac_hypotheses_plain(src, dst, valid, tri, weights=None):
    """The hypothesis stage of K7's plain version: (clamped triplets (R, K,
    3), squared error of every point under every Horn fit (R, K, M))."""
    from uzliti_slam_tpu_torch.ops import lie, ransac

    R, M, _ = src.shape
    K = tri.shape[1]
    ti = tri.long().clamp(0, M - 1)            # gathers clamp, as in JAX
    flat = ti.reshape(R, K * 3)

    def pick(x):
        return torch.gather(x, 1, flat[..., None].expand(R, K * 3, 3)).reshape(R, K, 3, 3)

    w = torch.gather(_fit_weights(valid, weights, src.dtype), 1, flat).reshape(R, K, 3)
    hyp = ransac.kabsch_quat(pick(src), pick(dst), w)
    pred = lie.pose_apply(hyp[:, :, None, :], src[:, None])          # (R, K, M, 3)
    return ti, torch.sum((pred - dst[:, None]) ** 2, dim=-1)


def ransac_rigid_plain(src, dst, valid, tri, inlier_thresh: float, min_consensus: int,
                       min_sigma: float, weights=None, uniforms=None, quality=None,
                       beta: float = 4.0):
    """Plain version of K7 for R roots: src/dst (R, M, 3), valid (R, M),
    triplets tri (R, K, 3) or, with ``tri`` None, the draw's ``uniforms``
    (R, 3K) mapped to triplets by ``ops/ransac.triplets_from_uniforms``
    (soft PROSAC on ``quality`` (R, M) where given); optional weights (R, M)
    multiplying ``valid`` in the fits.  Returns (pose (R, 7), consensus (R,)
    int32, mse (R,), information (R, 6, 6), ok (R,), best (R,) int32, counts
    (R, K) int32, tri (R, K, 3) int32), as
    ``uzliti_slam_tpu/ops/ransac.py:ransac_rigid``."""
    from uzliti_slam_tpu_torch.ops import lie, ransac

    if tri is None:
        tri = ransac.triplets_from_uniforms(uniforms, valid, quality, beta)
    R, M, _ = src.shape
    w = _fit_weights(valid, weights, src.dtype)
    ti, err2 = ransac_hypotheses_plain(src, dst, valid, tri, weights)
    inl = (err2 < inlier_thresh**2) & valid[:, None]
    counts = inl.sum(-1, dtype=torch.int32)
    distinct = (ti[..., 0] != ti[..., 1]) & (ti[..., 1] != ti[..., 2]) & (ti[..., 0] != ti[..., 2])
    sample_valid = torch.gather(valid, 1, ti.reshape(R, -1)).reshape(ti.shape).all(-1) & distinct
    counts = torch.where(sample_valid, counts, -1)
    best = torch.argmax(counts, dim=1)
    best_inl = torch.gather(inl, 1, best[:, None, None].expand(R, 1, M))[:, 0]
    refit = ransac.kabsch(src, dst, best_inl.to(src.dtype) * w)
    err2_refit = torch.sum((lie.pose_apply(refit[:, None], src) - dst) ** 2, dim=-1)
    inl_refit = (err2_refit < inlier_thresh**2) & valid
    consensus = inl_refit.sum(-1, dtype=torch.int32)
    mse = torch.sum(err2_refit * inl_refit, dim=-1) / torch.clamp(consensus, min=1)
    base = 0.1 * consensus.to(src.dtype) / torch.clamp(mse, min=min_sigma**2)
    information = torch.diag_embed(torch.stack([base] * 3 + [base * 100.0] * 3, dim=-1))
    ok = (consensus >= min_consensus) & (torch.gather(counts, 1, best[:, None])[:, 0] > 0)
    return (refit, consensus, mse, information, ok, best.to(torch.int32), counts,
            tri.to(torch.int32))


def _root_view(name: str, t: torch.Tensor, R: int, M: int, device) -> tuple[int, int]:
    """Pointer and root stride of a (R, M, 3) float32 tensor whose rows are
    contiguous and whose roots are contiguous or one broadcast row."""
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (R, M, 3):
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on {t.device}, expected "
                         f"float32 {(R, M, 3)} on {device}")
    if t.stride(2) != 1 or t.stride(1) != 3 or t.stride(0) not in (0, 3 * M):
        raise ValueError(f"{name}: strides {t.stride()} are neither contiguous nor a "
                         "broadcast row")
    return t.data_ptr(), t.stride(0)


RANSAC_MAX_HYPOTHESES = 1024   # kRootThreads in csrc/ransac_rigid.cu


def _ransac_outputs(dev, R: int, K: int):
    """K7's outputs, views of one int32 allocation split once: pose (R, 7),
    information (R, 6, 6) and mse (R,) reinterpreted as float32, consensus
    and best (R,), counts (R, K), the triplets (R, K, 3), and ok (R,) bool
    in the bytes of the last R words."""
    pose, info, mse, consensus, best, counts, tri, ok = torch.empty(
        R * (47 + 4 * K), dtype=torch.int32, device=dev).split(
            [7 * R, 36 * R, R, R, R, K * R, 3 * K * R, R])
    return (pose.view(torch.float32).view(R, 7), info.view(torch.float32).view(R, 6, 6),
            mse.view(torch.float32), consensus, best, counts.view(R, K), tri.view(R, K, 3),
            ok.view(torch.bool)[:R])


def ransac_rigid(src, dst, valid, tri, inlier_thresh: float, min_consensus: int,
                 min_sigma: float, weights=None, uniforms=None, quality=None,
                 beta: float = 4.0):
    """K7: RANSAC rigid fits of R roots, a cluster of up to 4 CTAs of 1024
    threads per root (the hypotheses split among them), the draw included: with ``tri`` None the kernel maps ``uniforms`` (R,
    3K) to triplets (soft PROSAC on ``quality`` where given) and returns
    them.  ``src``/``dst`` may be broadcast views of one (M, 3) table (root
    stride 0); ``weights`` (R, M), where given, multiplies ``valid`` in the
    fits.  The outputs are views of one allocation."""
    if src.device.type == "cpu":
        return ransac_rigid_plain(src, dst, valid, tri, inlier_thresh, min_consensus, min_sigma,
                                  weights, uniforms, quality, beta)
    dev, f32, i32 = src.device, torch.float32, torch.int32
    R, M, _ = src.shape
    if (tri is None) == (uniforms is None):
        raise ValueError("ransac_rigid: give the triplets or the draw's uniforms, not both")
    K = tri.shape[1] if tri is not None else uniforms.shape[1] // 3
    if not 0 < K <= RANSAC_MAX_HYPOTHESES:
        raise ValueError(f"ransac_rigid: {K} hypotheses, the kernel takes "
                         f"1..{RANSAC_MAX_HYPOTHESES}")
    src_p, src_s = _root_view("src", src, R, M, dev)
    dst_p, dst_s = _root_view("dst", dst, R, M, dev)
    valid_p = _check("valid", valid, (R, M), torch.bool, dev)
    weights_p = None if weights is None else _check("weights", weights, (R, M), f32, dev)
    if tri is None:
        u_p = _check("uniforms", uniforms, (R, 3 * K), f32, dev)
        q_p = None if quality is None else _check("quality", quality, (R, M), f32, dev)
        tri_p = None
    else:
        u_p = q_p = None
        tri_p = _check("tri", tri, (R, K, 3), i32, dev)
    pose, information, mse, consensus, best, counts, tri_out, ok = _ransac_outputs(dev, R, K)
    lib = _build.load()
    err = lib.uz_ransac_rigid(
        src_p, src_s, dst_p, dst_s, valid_p, weights_p, q_p, u_p, tri_p, R, M, K,
        float(inlier_thresh**2), int(min_consensus), float(min_sigma**2), float(beta),
        pose.data_ptr(), consensus.data_ptr(), mse.data_ptr(), information.data_ptr(),
        ok.data_ptr(), best.data_ptr(), counts.data_ptr(),
        tri_out.data_ptr() if tri is None else None, _stream(dev))
    _raise_on(err, "ransac_rigid")
    launches["ransac_rigid"] += 1
    return pose, consensus, mse, information, ok, best, counts, tri_out if tri is None else tri


# ---------------------------------------------------------------------------
# K8 components (connected components + gauge fixing)
# ---------------------------------------------------------------------------

def _components_round(labels, ef, et, e_valid):
    big = torch.iinfo(torch.int32).max
    upd = torch.where(e_valid, torch.minimum(labels[ef], labels[et]), big)
    labels = labels.scatter_reduce(0, ef, upd, "amin")
    labels = labels.scatter_reduce(0, et, upd, "amin")
    labels = labels[labels.long()]
    return labels[labels.long()]


def components_plain(e_from, e_to, e_valid, n_nodes: int, n_iters: int, rounds=None):
    """Plain version of K8's labels: min-label propagation over valid edges
    with two pointer jumps per round, all ``n_iters`` rounds; (N,) int32.
    With ``rounds`` (a () int32 tensor) it also writes the rounds K8 runs:
    up to and including the first that changes no label, at most
    ``n_iters`` (a host read a round)."""
    labels = torch.arange(n_nodes, dtype=torch.int32, device=e_from.device)
    ef, et = e_from.long(), e_to.long()
    ran = None
    for it in range(n_iters):
        new = _components_round(labels, ef, et, e_valid)
        if ran is None and rounds is not None and torch.equal(new, labels):
            ran = it + 1
        labels = new
    if rounds is not None:
        rounds.fill_(n_iters if ran is None else ran)
    return labels


def gauge_fix_plain(labels, node_valid, node_fixed, stamp):
    """Plain version of K8's gauge pass: pre-fixed valid nodes, plus the
    oldest valid node (least slot on a tie) of every component without one."""
    n = labels.shape[0]
    dev = labels.device
    lab = labels.long()
    valid_fixed = node_valid & node_fixed
    has_fixed = torch.zeros(n, dtype=torch.int32, device=dev).scatter_reduce(
        0, lab, valid_fixed.to(torch.int32), "amax", include_self=False)
    stamp_key = torch.where(node_valid, stamp, torch.inf)
    min_stamp = torch.full((n,), torch.inf, device=dev).scatter_reduce(
        0, lab, stamp_key, "amin", include_self=False)
    is_oldest_cand = node_valid & (stamp_key == min_stamp[lab])
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    min_idx = torch.full((n,), n, dtype=torch.int32, device=dev).scatter_reduce(
        0, lab, torch.where(is_oldest_cand, ids, n), "amin", include_self=False)
    is_oldest = is_oldest_cand & (ids == min_idx[lab])
    return valid_fixed | (is_oldest & (has_fixed[lab] == 0))


def components_gauge_plain(e_from, e_to, e_valid, node_valid, node_fixed, stamp, n_nodes: int,
                           n_iters: int, rounds=None):
    """Plain version of ``components_gauge``: (labels (N,) int32, gauge (N,)
    bool)."""
    labels = components_plain(e_from, e_to, e_valid, n_nodes, n_iters, rounds)
    return labels, gauge_fix_plain(labels, node_valid, node_fixed, stamp)


def components_smem(n_nodes: int) -> int:
    """Bytes of K8's one-CTA form: labels, scatter target and jump buffer
    (the 64-bit gauge keys over the last two), the fixed bits
    (``csrc/components.cu:cta_smem``)."""
    return 12 * n_nodes + 4 * ((n_nodes + 31) // 32)


def components_route(n_nodes: int) -> str:
    """K8's form at N nodes: "cta" (one CTA, shared memory) or "grid" (one
    cooperative launch over the card)."""
    return "cta" if components_smem(n_nodes) <= _SMEM_BYTES else "grid"


def components_scratch(n_nodes: int) -> int:
    """int32 words of K8's cooperative form: the 64-bit keys (2N), the
    scatter target and jump buffer, the fixed bits and three flags
    (``csrc/components.cu:grid_scratch_ints``), rounded up to an even count
    so that what follows it stays 8-byte aligned."""
    n = 4 * n_nodes + (n_nodes + 31) // 32 + 3
    return n + (n & 1)


def _components_launch(e_from, e_to, e_valid, n_nodes: int, n_iters: int, labels_in=None,
                       gauge_of=None, labels_out: bool = True, rounds=None, route=None):
    """One K8 launch (``uz_components_gauge``): the labels (or ``labels_in``)
    and, with ``gauge_of`` = (node_valid, node_fixed, stamp), the gauge.
    The scratch (on the cooperative form), the labels and the gauge are
    views of one allocation; the graph's tensors are checked once a call
    site (``_check_fixed``)."""
    dev, i32, bl = e_from.device, torch.int32, torch.bool
    E, n = e_from.shape[0], n_nodes
    items = [("e_from", e_from, (E,), i32), ("e_to", e_to, (E,), i32),
             ("e_valid", e_valid, (E,), bl)]
    if gauge_of is not None:
        items += [(name, t, (n,), dt) for name, t, dt in
                  zip(("node_valid", "node_fixed", "stamp"), gauge_of, (bl, bl, torch.float32))]
    if labels_in is not None:
        items.append(("labels", labels_in, (n,), i32))
    site = f"components{'_in' if labels_in is not None else ''}{'_g' if gauge_of else ''}"
    ptrs = _check_fixed(site, items)
    node = ptrs[3:6] if gauge_of is not None else [None] * 3
    lab_in = ptrs[-1] if labels_in is not None else None
    rnd = None if rounds is None else _check("rounds", rounds, (), i32, dev)
    grid = (route or components_route(n)) == "grid"
    words = components_scratch(n) if grid else 0
    out_words = (n if labels_out else 0) + ((n + 3) // 4 if gauge_of is not None else 0)
    buf = torch.empty(words + out_words, dtype=i32, device=dev)
    labels = buf[words: words + n] if labels_out else None
    gauge = (buf[words + (n if labels_out else 0):].view(bl)[:n] if gauge_of is not None
             else None)
    err = _build.load().uz_components_gauge(*ptrs[:3], E, n, int(n_iters), lab_in, *node,
                                            _ptr(labels), _ptr(gauge), rnd,
                                            buf.data_ptr() if grid else None, _stream(dev))
    _raise_on(err, "components")
    launches["components"] += 1
    return labels, gauge


def components(e_from, e_to, e_valid, n_nodes: int, n_iters: int, rounds=None):
    """K8's labels alone (``connected_components``), one launch: one CTA in
    shared memory while ``components_smem(N)`` fits, else one cooperative
    grid; the rounds stop at the fixed point (``rounds`` reports them)."""
    if e_from.device.type == "cpu":
        return components_plain(e_from, e_to, e_valid, n_nodes, n_iters, rounds)
    return _components_launch(e_from, e_to, e_valid, n_nodes, n_iters, rounds=rounds)[0]


def gauge_fix(labels, node_valid, node_fixed, stamp):
    """K8's gauge from given labels (``gauge_fix_mask``): (N,) bool, one
    launch."""
    if labels.device.type == "cpu":
        return gauge_fix_plain(labels, node_valid, node_fixed, stamp)
    n = labels.shape[0]
    none = torch.empty(0, dtype=torch.int32, device=labels.device)
    no_edge = torch.empty(0, dtype=torch.bool, device=labels.device)
    return _components_launch(none, none, no_edge, n, 0, labels_in=labels,
                              gauge_of=(node_valid, node_fixed, stamp), labels_out=False)[1]


def components_gauge(e_from, e_to, e_valid, node_valid, node_fixed, stamp, n_nodes: int,
                     n_iters: int, rounds=None, route=None):
    """K8 as a solve runs it: the labels (rounds to the fixed point, at most
    ``n_iters``) and the gauge from them in one launch; (labels (N,) int32,
    gauge (N,) bool).  ``route`` "grid" takes the cooperative form at any N
    (a measuring aid; by default the form follows ``components_route``)."""
    if e_from.device.type == "cpu":
        return components_gauge_plain(e_from, e_to, e_valid, node_valid, node_fixed, stamp,
                                      n_nodes, n_iters, rounds)
    return _components_launch(e_from, e_to, e_valid, n_nodes, n_iters,
                              gauge_of=(node_valid, node_fixed, stamp), rounds=rounds, route=route)


# ---------------------------------------------------------------------------
# K9 chain_factor
# ---------------------------------------------------------------------------

def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    inv = torch.stack(
        [
            A, -(b * i - c * h), b * f - c * e,
            B, a * i - c * g, -(a * f - c * d),
            C, -(a * h - b * g), a * e - b * d,
        ],
        dim=-1,
    ).reshape(M.shape)
    return inv / det[..., None, None]


def _inv6(M: torch.Tensor) -> torch.Tensor:
    """Batched SPD-ish 6x6 inverse with a 1e-8·I damping floor: 2x2-block
    Schur inversion over 3x3 sub-blocks, each inverted in closed form."""
    M = M + 1e-8 * torch.eye(6, dtype=M.dtype, device=M.device)
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    C = M[..., 3:, :3]
    D = M[..., 3:, 3:]
    Ainv = _inv3(A)
    AinvB = Ainv @ B
    S = D - C @ AinvB          # Schur complement of A (SPD for damped SPD M)
    Sinv = _inv3(S)
    CAinv = C @ Ainv
    TL = Ainv + AinvB @ Sinv @ CAinv
    TR = -AinvB @ Sinv
    BL = -Sinv @ CAinv
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([BL, Sinv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _pad_pow2(D: torch.Tensor, U: torch.Tensor):
    """D padded with identity blocks and U with zero blocks to 2^k rows
    (the rows are dimension -3; leading dimensions are a batch)."""
    n = D.shape[-3]
    n2 = _pow2(n)
    if n2 == n:
        return D, U
    pad = n2 - n
    batch = D.shape[:-3]
    eye = torch.eye(6, dtype=D.dtype, device=D.device).expand(*batch, pad, 6, 6)
    return torch.cat([D, eye], dim=-3), torch.cat([U, U.new_zeros(*batch, pad, 6, 6)], dim=-3)


def root_matrix_plain(Dk: torch.Tensor, Uk: torch.Tensor) -> torch.Tensor:
    """The dense (6m, 6m) root system tridiag(Uᵀ, D, U) + 1e-8·I that the
    factor inverts (Uk[m-1] is not read); leading dimensions are a batch."""
    m = Dk.shape[-3]
    dev, dt = Dk.device, Dk.dtype
    eye = torch.eye(m, dtype=dt, device=dev)
    sup = torch.diag(torch.ones(m - 1, dtype=dt, device=dev), 1)
    Us = torch.cat([Uk[..., : m - 1, :, :], Uk.new_zeros(*Uk.shape[:-3], 1, 6, 6)], dim=-3)
    # A[i, :, j, :] = D[i] (i=j), U[i] (j=i+1), U[j]ᵀ (j=i-1)
    A = (
        torch.einsum("ij,...iab->...iajb", eye, Dk)
        + torch.einsum("ij,...iab->...iajb", sup, Us)
        + torch.einsum("ji,...jba->...iajb", sup, Us)
    ).reshape(*Dk.shape[:-3], m * 6, m * 6)
    return A + 1e-8 * torch.eye(m * 6, dtype=dt, device=dev)


def _dense_root_inverse(Dk: torch.Tensor, Uk: torch.Tensor) -> torch.Tensor:
    """Dense inverse of the remaining (m·6)×(m·6) block-tridiagonal system,
    by LU (``torch.linalg.inv_ex``: no error check, so no host sync), in
    row-major layout (the CUDA library returns it column-major)."""
    if Dk.shape[-3] == 1:
        return _inv6(Dk[..., 0, :, :])
    return torch.linalg.inv_ex(root_matrix_plain(Dk, Uk))[0].contiguous()


def chain_reduce_plain(D: torch.Tensor, U: torch.Tensor, dense_cutoff: int = 64,
                       work_dtype: torch.dtype = torch.float64):
    """The factor's reduction levels, computed in ``work_dtype`` and stored
    in D's dtype, and the root blocks (Dk, Uk) they leave, in
    ``work_dtype``.  Float64 by default, as K9 computes: each level's newD
    cancels, and a float32 reduction (the reference's) loses about a bit
    per level (2.6e-4 of the largest entry after 11 levels).  D, U (..., n,
    6, 6): leading dimensions are a batch of independent chains."""
    out_dtype = D.dtype
    n_orig = D.shape[-3]
    batch = D.shape[:-3]
    D, U = D.to(work_dtype), U.to(work_dtype).clone()
    U[..., n_orig - 1, :, :] = 0.0
    D, U = _pad_pow2(D, U)
    eye = torch.eye(6, dtype=D.dtype, device=D.device)
    levels = []
    Dk, Uk = D, U
    while Dk.shape[-3] > max(dense_cutoff, 1):
        De, Do = Dk[..., 0::2, :, :], Dk[..., 1::2, :, :]
        Ueo = Uk[..., 0::2, :, :]          # couples even j -> odd j+1
        Uoe = Uk[..., 1::2, :, :]          # couples odd j+1 -> even j+2
        Dinv_o = _inv6(Do)
        Uoe_m = torch.cat([Uoe.new_zeros(*batch, 1, 6, 6), Uoe[..., :-1, :, :]], dim=-3)
        Dinv_om = torch.cat([eye.expand(*batch, 1, 6, 6), Dinv_o[..., :-1, :, :]], dim=-3)

        P1m = Uoe_m.transpose(-1, -2) @ Dinv_om
        P2 = Ueo @ Dinv_o
        G1 = Dinv_o @ Ueo.transpose(-1, -2)
        G2 = Dinv_o @ Uoe

        t1 = P1m @ Uoe_m
        t2 = P2 @ Ueo.transpose(-1, -2)
        newD = De - t1 - t2
        newU = -(P2 @ Uoe)
        newU[..., -1, :, :] = 0.0
        levels.append(tuple(t.to(out_dtype) for t in (Dinv_o, P1m, P2, G1, G2)))
        Dk, Uk = newD, newU
    return tuple(levels), Dk, Uk


def damped_blocks_plain(Hb, damp, free, lift=None):
    """The damped diagonal blocks the solver factors: free ? Hb + diag(damp)
    : I, plus diag(``lift``) (the planar solve's (6,) lift of the masked
    coordinates) when given (``solver.py:867-868``), in Hb's dtype."""
    eye = torch.eye(6, dtype=Hb.dtype, device=Hb.device)
    Dm = torch.where(free[:, None, None] > 0, Hb + torch.diag_embed(damp), eye)
    return Dm if lift is None else Dm + torch.diag(lift)


def chain_factor_plain(D: torch.Tensor, U: torch.Tensor, dense_cutoff: int = 64,
                       batch: int = 1, work_dtype: torch.dtype = torch.float64,
                       damp=None, free=None, lift=None):
    """Plain version of K9: ``(levels, root_inv, n)`` of ``batch``
    symmetric block-tridiagonal matrices, stacked in D, U (B·n, 6, 6) as the
    flattened fleet holds them (a single chain: batch 1), chain b's diagonal
    blocks D[b·n:(b+1)·n] and U[i] = A[i, i+1] (its last U treated as zero).
    With ``damp`` (B·n, 6) and ``free`` (B·n,), D is Hb and the diagonal
    blocks are ``damped_blocks_plain(D, damp, free, lift)``.  Each level is
    ``(Dinv_o, P1m, P2, G1, G2)``, each (B, half, 6, 6), the roots (B, 6m,
    6m).  Computed in ``work_dtype`` (float64, as K9 computes, where the
    reference computes in float32), returned in D's dtype."""
    if damp is not None:
        D = damped_blocks_plain(D, damp, free, lift)
    n = D.shape[0] // batch
    levels, Dk, Uk = chain_reduce_plain(D.view(batch, n, 6, 6), U.view(batch, n, 6, 6),
                                        dense_cutoff, work_dtype)
    return levels, _dense_root_inverse(Dk, Uk).to(D.dtype), n


_factor_builds: dict = {}


def factor_builds(device) -> torch.Tensor:
    """The () int32 count, on ``device``, of the chain factors that K9 (or
    its plain version, on the CPU) has actually built: a held factor whose
    refresh flag is 0 is not rebuilt and not counted."""
    device = torch.device(device)
    if device not in _factor_builds:
        _factor_builds[device] = torch.zeros((), dtype=torch.int32, device=device)
    return _factor_builds[device]


def _factor_shapes(n: int, dense_cutoff: int) -> tuple[list[int], int]:
    """The halves of the reduction levels of an n-block chain and the number
    of root blocks."""
    m, halves = _pow2(n), []
    while m > max(dense_cutoff, 1):
        m //= 2
        halves.append(m)
    return halves, m


def _select_factor_into(need: torch.Tensor, fresh, held) -> None:
    """``held`` overwritten by ``fresh`` where ``need`` (B,), chain by
    chain."""
    def sel(a, b):
        b.copy_(torch.where(need.view((-1,) + (1,) * (a.dim() - 1)), a, b))

    for a, b in zip((t for lv in fresh[0] for t in lv), (t for lv in held[0] for t in lv)):
        sel(a, b)
    sel(fresh[1], held[1])


def chain_factor_scratch(halves, m_root: int, batch: int) -> int:
    """Float64 scratch of one K9 launch, in doubles: each chain level's newD
    and newU, each of the root's log2(m) levels' five products and newD,
    newU, newL, and two buffers for the root's expansions
    (csrc/chain_factor.cu)."""
    per = 2 * 36 * sum(halves) + 8 * 36 * (m_root - 1) + 2 * 36 * (m_root // 2) ** 2
    return per * batch


_made: dict = {}   # id(root_inv) -> weak refs to a factor K9 made and its base pointer


def _factor_buffer(halves, m_root: int, B: int, dev):
    """A new factor's tensors, views of one float32 buffer in K9's layout:
    level after level its (Dinv_o, P1m, P2, G1, G2), then the roots."""
    sizes = [5 * B * h * 36 for h in halves]
    buf = torch.empty(sum(sizes) + B * 36 * m_root * m_root, dtype=torch.float32, device=dev)
    levels, at = [], 0
    for h, size in zip(halves, sizes):
        levels.append(tuple(buf[at: at + size].view(5, B, h, 6, 6).unbind(0)))
        at += size
    levels, root_inv = tuple(levels), buf[at:].view(B, 6 * m_root, 6 * m_root)
    first = levels[0][0] if levels else root_inv
    for key in [k for k, (r, _, _) in _made.items() if r() is None]:
        del _made[key]
    _made[id(root_inv)] = (weakref.ref(root_inv), weakref.ref(first), buf.data_ptr())
    return levels, root_inv


def _held_buffer(held, halves, m_root: int, B: int, n: int, dev) -> int:
    """The base pointer of a held factor, which must be one ``chain_factor``
    made (its tensors in K9's layout in one buffer): known at once for a
    factor this process made and still holds, else checked tensor by
    tensor."""
    levels, root_inv, n_held = held
    if n_held != n or [lv[0].shape[:-2] for lv in levels] != [(B, h) for h in halves]:
        raise ValueError("chain_factor: the held factor has other shapes")
    first = levels[0][0] if levels else root_inv
    made = _made.get(id(root_inv))
    if made is not None and made[0]() is root_inv and made[1]() is first:
        return made[2]
    base = at = first.data_ptr()
    for lv, h in zip(levels, halves):
        for nm, t in zip(("Dinv_o", "P1m", "P2", "G1", "G2"), lv):
            if t.data_ptr() != at:
                raise ValueError(f"chain_factor: the held factor's {nm} is not in K9's layout")
            _check(nm, t, (B, h, 6, 6), torch.float32, dev)
            at += 4 * B * h * 36
    if root_inv.data_ptr() != at:
        raise ValueError("chain_factor: the held factor's root_inv is not in K9's layout")
    _check("root_inv", root_inv, (B, 6 * m_root, 6 * m_root), torch.float32, dev)
    return base


def chain_factor(D, U, dense_cutoff: int = 64, batch: int = 1, held=None, need=None,
                 damp=None, free=None, lift=None, phase_limit: int = 0):
    """K9: the chain preconditioner's cyclic-reduction factor of ``batch``
    chains stacked in D, U (B·n, 6, 6), each chain its own levels and root,
    in one cooperative launch (the levels, then the root by the same
    reduction continued inside it and expanded back).

    With ``damp`` (B·n, 6) and ``free`` (B·n,), D is the Hessian's diagonal
    blocks Hb and the kernel factors ``damped_blocks_plain(Hb, damp, free,
    lift)``, building each block as it reads it (``lift``: the planar
    solve's (6,) diagonal, or None).  Without ``held`` it builds a new
    factor, its tensors views of one buffer.  With ``held`` (a factor this
    function made, of the same shapes) it rebuilds ``held`` in place and
    returns it; with ``need`` (a (B,) bool device flag) too, only the chains
    whose flag is set, leaving the others as they are.  The flags are read
    on the device (a launch where all are 0 returns at once), never on the
    host.  On CPU tensors the plain version builds the factor and
    selects it into ``held`` with ``torch.where``.  ``phase_limit`` > 0
    stops the launch after that many of its phases (a timing aid: the
    factor is then incomplete).
    """
    if (damp is None) != (free is None):
        raise ValueError("chain_factor: damp and free go together")
    if D.device.type == "cpu":
        fresh = chain_factor_plain(D, U, dense_cutoff, batch, damp=damp, free=free, lift=lift)
        builds = factor_builds(D.device)
        if held is None:
            builds.add_(batch)
            return fresh
        if need is None:
            need = torch.ones(batch, dtype=torch.bool)
        builds.add_(need.sum().to(builds.dtype))
        _select_factor_into(need, fresh, held)
        return held
    B, dev, f32 = batch, D.device, torch.float32
    if B < 1 or D.shape[0] % B:
        raise ValueError(f"chain_factor: {D.shape[0]} blocks in {B} instances")
    n = D.shape[0] // B
    ptrs = [_check("D", D, (B * n, 6, 6), f32, dev), _check("U", U, (B * n, 6, 6), f32, dev)]
    if damp is None:
        ptrs += [None, None, None]
    else:
        ptrs += [_check("damp", damp, (B * n, 6), f32, dev),
                 _check("free", free, (B * n,), f32, dev),
                 None if lift is None else _check("lift", lift, (6,), f32, dev)]
    halves, m_root = _factor_shapes(n, dense_cutoff)
    if m_root > 64:
        raise ValueError(f"chain_factor: a root of {m_root} blocks (dense_cutoff {dense_cutoff});"
                         " the root kernel takes at most 64")
    if held is None:
        if need is not None:
            raise ValueError("chain_factor: a refresh flag needs a held factor")
        levels, root_inv = _factor_buffer(halves, m_root, B, dev)
        base, need_ptr = (levels[0][0] if levels else root_inv).data_ptr(), None
    else:
        base = _held_buffer(held, halves, m_root, B, n, dev)
        levels, root_inv, _ = held
        need_ptr = None if need is None else _check("need", need, (B,), torch.bool, dev)
    lib = _build.load()
    size = chain_factor_scratch(halves, m_root, B)
    scratch = torch.empty(max(size, 1), dtype=torch.float64, device=dev)
    err = lib.uz_chain_factor(*ptrs, n, B, len(halves), m_root, base, scratch.data_ptr(), size,
                              need_ptr, factor_builds(dev).data_ptr(), int(phase_limit),
                              _stream(dev))
    _raise_on(err, "chain_factor")
    launches["chain_factor"] += 1
    return levels, root_inv, n


# ---------------------------------------------------------------------------
# K10 pcg (the vector updates of solver._pcg)
# ---------------------------------------------------------------------------
# State: x, r, p the flattened (B·n, 6) of B instances (a single solve: B =
# 1) and one row of scalars per instance, scal (B, 3) = [rz, b2, ok] in the
# plain version and (B, 4) in the kernel's, on the device, updated in place
# by the step functions: each instance's dots, α, β and stall flag are its
# own, as under the reference's vmap.

PCG_CTA_MAX = 32768   # floats: above this a single solve takes K10's grid route (csrc/pcg.cu)
_PCG_CHUNK = 4096     # floats per CTA on the grid route


def pcg_init_plain(b, z, batch: int = 1):
    """Plain version of K10's first launch: (x, r, p, scal) from b and
    z0 = M⁻¹b."""
    bv, zv = b.view(batch, -1), z.view(batch, -1)
    x = torch.zeros_like(b)
    r = b.clone()
    p = z.clone()
    scal = torch.stack([torch.sum(bv * zv, dim=1), torch.sum(bv * bv, dim=1),
                        torch.ones_like(bv[:, 0])], dim=1)
    return x, r, p, scal


def pcg_alpha_plain(p, Hp, x, r, scal, tol: float) -> None:
    """Plain version of K10 after Hp = H·p: the stall test and x, r in place."""
    B = scal.shape[0]
    pv, Hpv = p.view(B, -1), Hp.view(B, -1)
    rz, b2 = scal[:, 0], scal[:, 1]
    pHp = torch.sum(pv * Hpv, dim=1)
    ok = (pHp > 1e-20) & (rz > tol * (b2 + 1e-30))
    alpha = torch.where(ok, rz / torch.where(pHp == 0, 1.0, pHp), 0.0)[:, None]
    x.view(B, -1).copy_(x.view(B, -1) + alpha * pv)
    r.view(B, -1).copy_(r.view(B, -1) - alpha * Hpv)
    scal[:, 2] = ok.to(scal.dtype)


def pcg_beta_plain(r, z, p, scal) -> None:
    """Plain version of K10 after z = M⁻¹r: p and rz in place."""
    B = scal.shape[0]
    rv, zv, pv = r.view(B, -1), z.view(B, -1), p.view(B, -1)
    rz, ok = scal[:, 0], scal[:, 2] > 0
    rz_new = torch.sum(rv * zv, dim=1)
    beta = torch.where(ok, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)[:, None]
    pv.copy_(torch.where(ok[:, None], zv + beta * pv, pv))
    scal[:, 0] = torch.where(ok, rz_new, rz)


def _pcg_route(name: str, dev, batch: int, **vectors):
    """Check the vectors (B·n, 6) and give (floats per instance, the grid
    route's scratch or None): one CTA per instance holds at most
    PCG_CTA_MAX floats, and only a single solve takes the grid route."""
    rows = next(iter(vectors.values())).shape[0]
    if batch < 1 or rows % batch:
        raise ValueError(f"{name}: {rows} nodes in {batch} instances")
    for nm, t in vectors.items():
        _check(nm, t, (rows, 6), torch.float32, dev)
    n = 6 * (rows // batch)
    if n <= PCG_CTA_MAX:
        return n, None
    if batch > 1:
        raise ValueError(f"{name}: {n} floats an instance; one CTA each holds at most "
                         f"{PCG_CTA_MAX}")
    return n, torch.empty(2 * -(-n // _PCG_CHUNK), dtype=torch.float32, device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def pcg_init(b, z, batch: int = 1):
    """K10 before the loop: x = 0, r = b, p = z0, and each instance's rz =
    rᵀz0, b2 = bᵀb in scal (B, 4)."""
    if b.device.type == "cpu":
        return pcg_init_plain(b, z, batch)
    dev = b.device
    n, partials = _pcg_route("pcg_init", dev, batch, b=b, z=z)
    lib = _build.load()
    xrp = torch.empty(3, b.shape[0], 6, dtype=torch.float32, device=dev)
    scal = torch.empty(batch, 4, dtype=torch.float32, device=dev)
    err = lib.uz_pcg_init(b.data_ptr(), z.data_ptr(), n, batch, xrp[0].data_ptr(),
                          xrp[1].data_ptr(), xrp[2].data_ptr(), scal.data_ptr(), _ptr(partials),
                          _stream(dev))
    _raise_on(err, "pcg")
    launches["pcg"] += 1
    return xrp[0], xrp[1], xrp[2], scal


def pcg_alpha(p, Hp, x, r, scal, tol: float) -> None:
    """K10 after Hp = H·p: each instance's pHp, stall flag and α; x += α·p,
    r -= α·Hp."""
    if p.device.type == "cpu":
        return pcg_alpha_plain(p, Hp, x, r, scal, tol)
    dev, batch = p.device, scal.shape[0]
    n, partials = _pcg_route("pcg_alpha", dev, batch, p=p, Hp=Hp, x=x, r=r)
    lib = _build.load()
    err = lib.uz_pcg_alpha(p.data_ptr(), Hp.data_ptr(), n, batch, float(tol), x.data_ptr(),
                           r.data_ptr(), _check("scal", scal, (batch, 4), torch.float32, dev),
                           _ptr(partials), _stream(dev))
    _raise_on(err, "pcg")
    launches["pcg"] += 1


def pcg_beta(r, z, p, scal) -> None:
    """K10 after z = M⁻¹r: each instance's rz' and β; p = z + β·p and rz =
    rz' where not stalled."""
    if r.device.type == "cpu":
        return pcg_beta_plain(r, z, p, scal)
    dev, batch = r.device, scal.shape[0]
    n, partials = _pcg_route("pcg_beta", dev, batch, r=r, z=z, p=p)
    lib = _build.load()
    err = lib.uz_pcg_beta(r.data_ptr(), z.data_ptr(), n, batch, p.data_ptr(),
                          _check("scal", scal, (batch, 4), torch.float32, dev),
                          _ptr(partials), _stream(dev))
    _raise_on(err, "pcg")
    launches["pcg"] += 1


# ---------------------------------------------------------------------------
# K34 pcg_chain (solver._pcg's step around K2: K10 and K3 in one launch)
# ---------------------------------------------------------------------------
# A PCG solve is ``pcg_chain_start`` then, per step, K2's Hp = H·p and
# ``pcg_chain_step``.  Both take the chain factor and, for the generic
# loop's planar solve, its column mask ``cmask`` (6,): the preconditioner is
# then M⁻¹(r·m)·m.  Their state is a ``PcgState``.  The route follows from
# size and batch: a single solve whose level vectors fit the 8-CTA cluster's
# shared memory (``pcg_chain_route``) takes K34, one launch for the start and
# one a step; a larger single solve K37 (``pcg_grid_start``, below), one
# cooperative launch for the start and one a step; a fleet (batch > 1) K10
# around K3.

PCG_CHAIN_CLUSTER = 8        # CTAs of K34's cluster (csrc/pcg_chain.cu kCluster)
_PCG_CHAIN_WARPS = 16        # kChainThreads / 32


class PcgState(NamedTuple):
    """A PCG solve's vectors (B·n, 6) and scalars, updated in place by the
    steps.  ``scal`` is (B, 3) = [rz, b2, ok] in the plain version and (B,
    4) on the card (K10's layout, which K34 and K37 keep); ``fused`` holds
    K34's or K37's fixed launch arguments, or None on K10's route."""
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    scal: torch.Tensor
    fused: object = None


def pcg_chain_smem(levels: int, m_root: int) -> int:
    """Bytes of shared memory one CTA of K34 takes for a chain of ``levels``
    reduction levels and ``m_root`` root blocks (csrc/pcg_chain.cu
    smem_floats): its rows of every level, two back-sweep buffers, the
    root vector and the sums.  At the default cutoff (a 64-block root)
    16,384 rows fit."""
    rr = max(m_root // PCG_CHAIN_CLUSTER, 1)
    level_rows = rr * ((1 << (levels + 1)) - 1)
    x_rows = rr << (levels - 1) if levels else 0
    return 4 * (6 * level_rows + 2 * 6 * x_rows + 6 * m_root + 8 + _PCG_CHAIN_WARPS)


def pcg_chain_route(factor, batch: int = 1) -> bool:
    """Whether a solve with this chain factor takes K34: a single chain
    (batch 1) whose level vectors fit one CTA's shared memory in the 8-CTA
    cluster (``pcg_chain_smem``)."""
    levels, root_inv, _ = factor
    return batch == 1 and pcg_chain_smem(len(levels), root_inv.shape[-1] // 6) <= _SMEM_BYTES


def _preconditioned(apply, factor, v, cmask):
    """M⁻¹v through ``apply`` (K3 or its plain version), or M⁻¹(v·m)·m with
    the generic loop's planar mask."""
    if cmask is None:
        return apply(factor, v)
    return apply(factor, v * cmask) * cmask


def pcg_chain_start_plain(factor, b, batch: int = 1, cmask=None) -> PcgState:
    """Plain version of K34's start: z0 = M⁻¹b (K3's plain version), then
    K10's init."""
    return PcgState(*pcg_init_plain(b, _preconditioned(chain_apply_plain, factor, b, cmask),
                                    batch))


def pcg_chain_step_plain(factor, Hp, state: PcgState, tol: float, cmask=None) -> None:
    """Plain version of K34's step after Hp = H·p: K10's first half, z =
    M⁻¹r (K3's plain version), K10's second half, in place."""
    x, r, p, scal, _ = state
    pcg_alpha_plain(p, Hp, x, r, scal, tol)
    pcg_beta_plain(r, _preconditioned(chain_apply_plain, factor, r, cmask), p, scal)


class _Fused(NamedTuple):
    factor: tuple
    cmask: object
    table: object      # the host table the arguments point into
    scratch: tuple     # the device scratch the arguments point into (M⁻¹r, ...)
    step: object       # the C entry
    args: tuple        # its arguments after Hp and tol
    kernel: str        # its launch count


_LEVEL_NAMES = ("Dinv_o", "P1m", "P2", "G1", "G2")


def _factor_ptrs(factor, dev, batch: int = 1) -> list:
    """The factor's pointers, each level's Dinv_o, P1m, P2, G1, G2, then
    root_inv, checked for ``batch`` chains."""
    levels, root_inv, _ = factor
    L, m_root = len(levels), root_inv.shape[-1] // 6
    ptrs = []
    for li, lv in enumerate(levels):
        half = m_root << (L - 1 - li)
        for nm, t in zip(_LEVEL_NAMES, lv):
            ptrs.append(_check(nm, t, (batch, half, 6, 6), torch.float32, dev))
    ptrs.append(_check("root_inv", root_inv, (batch, 6 * m_root, 6 * m_root), torch.float32,
                       dev))
    return ptrs


def _chain_table(factor, dev):
    """(host table of the factor's pointers, levels, root blocks, rows):
    ``_factor_ptrs`` of one chain of a power-of-two padding within K34's
    cap."""
    levels, root_inv, n = factor
    L = len(levels)
    m_root = root_inv.shape[-1] // 6
    if m_root < 1 or m_root << L != _pow2(n) or pcg_chain_smem(L, m_root) > _SMEM_BYTES:
        raise ValueError(f"pcg_chain: a chain of {n} rows, {L} levels and a {m_root}-block "
                         f"root is outside K34's cap ({_SMEM_BYTES} bytes of shared memory "
                         "a CTA)")
    ptrs = _factor_ptrs(factor, dev)
    return (ctypes.c_void_p * len(ptrs))(*ptrs), L, m_root, n


def pcg_chain_start(factor, b, batch: int = 1, cmask=None) -> PcgState:
    """K34 before the loop (z0 = M⁻¹b, x = 0, r = b, p = z0, rz, b2), in one
    launch; a single chain above K34's cap K37's start (``pcg_grid_start``);
    a fleet K3 then K10's init."""
    if b.device.type == "cpu":
        return pcg_chain_start_plain(factor, b, batch, cmask)
    if batch > 1:
        return PcgState(*pcg_init(b, _preconditioned(chain_apply, factor, b, cmask), batch))
    if not pcg_chain_route(factor, batch):
        return pcg_grid_start(factor, b, cmask)
    dev, f32 = b.device, torch.float32
    table, L, m_root, n = _chain_table(factor, dev)
    _check("b", b, (n, 6), f32, dev)
    cm = None if cmask is None else _check("cmask", cmask, (6,), f32, dev)
    lib = _build.load()
    x, r, p, z = torch.empty(4, n, 6, dtype=f32, device=dev).unbind(0)
    scal = torch.empty(1, 4, dtype=f32, device=dev)
    stream = _stream(dev)
    head = (ctypes.addressof(table), L, m_root, n, cm)
    err = lib.uz_pcg_chain_start(*head, b.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(),
                                 scal.data_ptr(), stream)
    _raise_on(err, "pcg_chain")
    launches["pcg_chain"] += 1
    args = head + (x.data_ptr(), r.data_ptr(), p.data_ptr(), z.data_ptr(), scal.data_ptr(),
                   stream)
    return PcgState(x, r, p, scal, _Fused(factor, cmask, table, (z,), lib.uz_pcg_chain_step, args,
                                          "pcg_chain"))


def pcg_chain_step(factor, Hp, state: PcgState, tol: float, cmask=None) -> None:
    """K34 after Hp = H·p: α, x and r; z = M⁻¹r through every level and the
    root; β, p and rz, in one launch on the state ``pcg_chain_start`` made
    (on the stream current then); above K34's cap K37's step, the same in
    one cooperative launch; in a fleet K10, K3, K10."""
    if Hp.device.type == "cpu":
        return pcg_chain_step_plain(factor, Hp, state, tol, cmask)
    x, r, p, scal, fused = state
    if fused is None:
        pcg_alpha(p, Hp, x, r, scal, tol)
        return pcg_beta(r, _preconditioned(chain_apply, factor, r, cmask), p, scal)
    if fused.factor is not factor or fused.cmask is not cmask:
        raise ValueError("pcg_chain_step: the state was started with another factor or mask")
    _check("Hp", Hp, tuple(p.shape), torch.float32, p.device)
    _raise_on(fused.step(Hp.data_ptr(), tol, *fused.args), fused.kernel)
    launches[fused.kernel] += 1


# ---------------------------------------------------------------------------
# K37 pcg_grid (K34's step above its cap: one cooperative launch a step)
# ---------------------------------------------------------------------------
# A single chain whose level vectors do not fit K34's cluster: the same
# start and step (the plain versions are K34's), in one cooperative launch
# over the whole card, the level vectors in device scratch allocated at the
# start.  ``pcg_chain_start`` / ``pcg_chain_step`` take it above the cap;
# ``pcg_grid_start`` takes any single chain of one level or more.

_PCG_GRID_MAX_CTAS = 4096  # partial-sum slots: more CTAs than any card holds at once


def pcg_grid_scratch(levels: int, m_root: int) -> int:
    """Floats of K37's vector scratch: each level's forward vector and
    back-sweep x, levels 1..L, m_root << (L - l) rows of 6 each
    (csrc/pcg_grid.cu scratch_floats)."""
    return 2 * 6 * m_root * ((1 << levels) - 1)


def _grid_table(factor, dev):
    """``_chain_table`` for K37: one chain of a power-of-two padding with at
    least one level, its level products 16-byte aligned (the kernel reads
    them as float4)."""
    levels, root_inv, n = factor
    L = len(levels)
    m_root = root_inv.shape[-1] // 6
    if L < 1 or m_root < 1 or m_root << L != _pow2(n):
        raise ValueError(f"pcg_grid: a chain of {n} rows, {L} levels and a {m_root}-block "
                         "root; K37 takes one chain with at least one level")
    ptrs = _factor_ptrs(factor, dev)
    for i, ptr in enumerate(ptrs[:-1]):
        if ptr % 16:
            raise ValueError(f"pcg_grid: {_LEVEL_NAMES[i % 5]} of level {i // 5} is not "
                             "16-byte aligned")
    return (ctypes.c_void_p * len(ptrs))(*ptrs), L, m_root, n


def pcg_grid_start(factor, b, cmask=None) -> PcgState:
    """K37 before the loop (z0 = M⁻¹b, x = 0, r = b, p = z0, rz, b2), in one
    cooperative launch, for one chain of at least one level; its steps are
    ``pcg_chain_step`` on the state it returns."""
    if b.device.type == "cpu":
        return pcg_chain_start_plain(factor, b, 1, cmask)
    dev, f32 = b.device, torch.float32
    table, L, m_root, n = _grid_table(factor, dev)
    _check("b", b, (n, 6), f32, dev)
    cm = None if cmask is None else _check("cmask", cmask, (6,), f32, dev)
    lib = _build.load()
    x, r, p, z = torch.empty(4, n, 6, dtype=f32, device=dev).unbind(0)
    scal = torch.empty(1, 4, dtype=f32, device=dev)
    size = pcg_grid_scratch(L, m_root)
    scratch = torch.empty(size, dtype=f32, device=dev)
    partials = torch.empty(2 * _PCG_GRID_MAX_CTAS, dtype=f32, device=dev)
    stream = _stream(dev)
    head = (ctypes.addressof(table), L, m_root, n, cm)
    rest = (scratch.data_ptr(), size, partials.data_ptr(), _PCG_GRID_MAX_CTAS, stream)
    err = lib.uz_pcg_grid_start(*head, b.data_ptr(), x.data_ptr(), r.data_ptr(), p.data_ptr(),
                                scal.data_ptr(), *rest)
    _raise_on(err, "pcg_grid")
    launches["pcg_grid"] += 1
    args = head + (x.data_ptr(), r.data_ptr(), p.data_ptr(), z.data_ptr(),
                   scal.data_ptr()) + rest
    return PcgState(x, r, p, scal, _Fused(factor, cmask, table, (z, scratch, partials),
                                          lib.uz_pcg_grid_step, args, "pcg_grid"))


# ---------------------------------------------------------------------------
# K35 pcg_chain_solve (solver._pcg's whole loop: K2 and K34 in one launch)
# ---------------------------------------------------------------------------

class HvpOperator(NamedTuple):
    """The Gauss-Newton operator of one LM iteration, as K2 takes it, and
    the solve's incidence table: Hv = (Σ JᵀW(Jᵢ·vm[from] + Jⱼ·vm[to]) +
    damp·vm)·free, vm = v·free."""
    Ji: torch.Tensor      # (E, 6, 6)
    Jj: torch.Tensor
    W: torch.Tensor
    e_from: torch.Tensor  # (E,) int32
    e_to: torch.Tensor
    damp: torch.Tensor    # (n, 6)
    free: torch.Tensor    # (n,)
    table: IncidenceTable


def _masked_hvp(op: HvpOperator, v, cmask):
    """K2's plain version, or H(v·m)·m with the generic loop's planar mask."""
    if cmask is not None:
        v = v * cmask
    y = hvp_plain(op.Ji, op.Jj, op.W, op.e_from, op.e_to, v, op.damp, op.free)
    return y if cmask is None else y * cmask


def _operator_ptrs(kernel: str, op: HvpOperator, n: int, dev) -> list:
    """The operator's and its table's pointers for ``n`` rows, checked: Ji,
    Jj, W (E, 6, 6) 16-byte aligned (the kernels copy them as float4), e_from,
    e_to (E,), damp (n, 6), free (n,), row_ptr (n + 1,), entries (2E,)."""
    f32, i32, E = torch.float32, torch.int32, op.e_from.shape[0]
    ptrs = [
        _check("Ji", op.Ji, (E, 6, 6), f32, dev),
        _check("Jj", op.Jj, (E, 6, 6), f32, dev),
        _check("W", op.W, (E, 6, 6), f32, dev),
        _check("e_from", op.e_from, (E,), i32, dev),
        _check("e_to", op.e_to, (E,), i32, dev),
        _check("damp", op.damp, (n, 6), f32, dev),
        _check("free", op.free, (n,), f32, dev),
        *_check_table(op.table, n, E, dev),
    ]
    for nm, ptr in zip(("Ji", "Jj", "W"), ptrs):
        if ptr % 16:
            raise ValueError(f"{kernel}: {nm} is not 16-byte aligned")
    return ptrs


def pcg_fleet_solve_plain(factor, op: HvpOperator, b, steps: int, tol: float,
                          cmask=None) -> PcgState:
    """Plain version of K38 (and of K35, the batch of one): K34's plain
    start for the factor's B chains, then per step K2's plain version and
    K34's plain step (with ``cmask`` the generic loop's wraps: H(p·m)·m and
    M⁻¹(r·m)·m), each instance's scalars its own."""
    batch = factor[1].shape[0]
    state = pcg_chain_start_plain(factor, b, batch, cmask)
    for _ in range(steps):
        pcg_chain_step_plain(factor, _masked_hvp(op, state.p, cmask), state, tol, cmask)
    return state


def pcg_chain_solve_plain(factor, op: HvpOperator, b, steps: int, tol: float,
                          cmask=None) -> PcgState:
    """Plain version of K35: a single chain's ``pcg_fleet_solve_plain``."""
    return pcg_fleet_solve_plain(factor, op, b, steps, tol, cmask)


def pcg_chain_solve(factor, op: HvpOperator, b, steps: int, tol: float,
                    cmask=None) -> PcgState:
    """K35: a single solve's whole PCG (K34's start, then ``steps`` times
    Hp = H(p·m)·m and K34's step) in one launch of K34's cluster, Hp
    summed over ``op.table`` without atomics; the chain must be on K34's
    route (``pcg_chain_route``).  Returns the final state (scal (1, 4))."""
    if b.device.type == "cpu":
        return pcg_chain_solve_plain(factor, op, b, steps, tol, cmask)
    dev, f32, i32 = b.device, torch.float32, torch.int32
    table, L, m_root, n = _chain_table(factor, dev)
    E = op.e_from.shape[0]
    if steps < 0:
        raise ValueError(f"pcg_chain_solve: {steps} steps")
    ptrs = _operator_ptrs("pcg_chain_solve", op, n, dev)
    b_ptr = _check("b", b, (n, 6), f32, dev)
    cm = None if cmask is None else _check("cmask", cmask, (6,), f32, dev)
    lib = _build.load()
    x, r, p, z, hp = torch.empty(5, n, 6, dtype=f32, device=dev).unbind(0)
    scal = torch.empty(1, 4, dtype=f32, device=dev)
    # the operator in table order and the steps' products (csrc/pcg_chain.cu Op)
    iscratch = torch.empty(2 * 2 * E, dtype=i32, device=dev)
    fscratch = torch.empty(114 * 2 * E, dtype=f32, device=dev)
    err = lib.uz_pcg_chain_solve(ctypes.addressof(table), L, m_root, n, cm, *ptrs, E, b_ptr,
                                 int(steps), float(tol), x.data_ptr(), r.data_ptr(), p.data_ptr(),
                                 z.data_ptr(), hp.data_ptr(), scal.data_ptr(), iscratch.data_ptr(),
                                 fscratch.data_ptr(), _stream(dev))
    _raise_on(err, "pcg_chain_solve")
    launches["pcg_chain_solve"] += 1
    return PcgState(x, r, p, scal)


# ---------------------------------------------------------------------------
# K38 pcg_fleet_solve (a fleet's whole PCG solve: a CTA an instance)
# ---------------------------------------------------------------------------

_FLEET_WARPS = 8   # kThreads / 32 in csrc/pcg_fleet.cu


def pcg_fleet_smem(levels: int, m_root: int, n: int, edges: int) -> int:
    """Bytes of shared memory one CTA of K38 takes for an instance of ``n``
    rows and ``edges`` edge slots with ``levels`` reduction levels and
    ``m_root`` root blocks (csrc/pcg_fleet.cu ``plan``, the shipped layout:
    the factor, the vectors, the level vectors, damp and free, the edges'
    terms, the mask, the sums and the integer tables).  At 64 nodes, 128
    edge slots and cutoff 16: 92,772 bytes, 2 CTAs an SM."""
    def up4(w):
        return (w + 3) & ~3

    n2, lvw = m_root << levels, 6 * m_root * ((1 << levels) - 1)
    at = 180 * m_root * ((1 << levels) - 1) + 36 * m_root * m_root
    for words in (6 * n, 6 * n, 6 * n, 6 * n, 6 * n2, lvw, lvw, 6 * n, n, 12 * edges):
        at = up4(at + words)
    return 4 * (at + 8 + 2 * _FLEET_WARPS + (n + 1) + 2 * edges + 4 * edges)


def pcg_fleet_route(factor, batch: int, n_edges: int) -> bool:
    """Whether a solve of ``batch`` > 1 chains with this factor and
    ``n_edges`` edge slots in all takes K38: an instance that fits one CTA's
    shared memory (``pcg_fleet_smem``)."""
    levels, root_inv, n = factor
    if batch < 2 or n_edges % batch:
        return False
    return pcg_fleet_smem(len(levels), root_inv.shape[-1] // 6, n,
                          n_edges // batch) <= _SMEM_BYTES


def pcg_fleet_solve(factor, op: HvpOperator, b, steps: int, tol: float,
                    cmask=None) -> PcgState:
    """K38: the whole PCG solve of each of the factor's B chains (K34's
    start, then ``steps`` times Hp = H(p·m)·m and K34's step) in one launch,
    a CTA an instance with its factor and vectors in shared memory; ``op``
    is the flattened fleet's operator and incidence table (instance b's
    nodes at b·n, its edges at b·E).  Returns the final state (scal (B,
    4)); K34's plain start and steps on CPU tensors."""
    if b.device.type == "cpu":
        return pcg_fleet_solve_plain(factor, op, b, steps, tol, cmask)
    levels, root_inv, n = factor
    dev, f32 = b.device, torch.float32
    B, L, m_root, E = root_inv.shape[0], len(levels), root_inv.shape[-1] // 6, op.e_from.shape[0]
    if steps < 0:
        raise ValueError(f"pcg_fleet_solve: {steps} steps")
    if m_root < 1 or m_root << L != _pow2(n) or E % B:
        raise ValueError(f"pcg_fleet_solve: {B} chains of {n} rows, {L} levels, a "
                         f"{m_root}-block root and {E} edge slots")
    if pcg_fleet_smem(L, m_root, n, E // B) > _SMEM_BYTES:
        raise ValueError(f"pcg_fleet_solve: an instance of {n} rows and {E // B} edge slots is "
                         f"outside K38's cap ({_SMEM_BYTES} bytes of shared memory a CTA)")
    fptrs = _factor_ptrs(factor, dev, B)
    for i, ptr in enumerate(fptrs):
        if ptr % 16:
            raise ValueError(f"pcg_fleet_solve: the factor's tensor {i} is not 16-byte aligned")
    table = (ctypes.c_void_p * len(fptrs))(*fptrs)
    ptrs = _operator_ptrs("pcg_fleet_solve", op, B * n, dev)
    b_ptr = _check("b", b, (B * n, 6), f32, dev)
    cm = None if cmask is None else _check("cmask", cmask, (6,), f32, dev)
    lib = _build.load()
    x, r, p = torch.empty(3, B * n, 6, dtype=f32, device=dev).unbind(0)
    scal = torch.empty(B, 4, dtype=f32, device=dev)
    err = lib.uz_pcg_fleet_solve(ctypes.addressof(table), L, m_root, n, B, E // B, cm, *ptrs,
                                 b_ptr, int(steps), float(tol), x.data_ptr(), r.data_ptr(),
                                 p.data_ptr(), scal.data_ptr(), _stream(dev))
    _raise_on(err, "pcg_fleet_solve")
    launches["pcg_fleet_solve"] += 1
    return PcgState(x, r, p, scal)


# ---------------------------------------------------------------------------
# K11 project_rays (occupancy projection)
# ---------------------------------------------------------------------------

BIG = 1e9   # no-return sentinel, uzliti_slam_tpu/mapping/occupancy.py:_project_rays


def mark_cells_plain(logodds, cx, cy, mask, mark_value: float, clamp: float):
    """``mark_value`` added to the cell of each node of ``mask`` (N,) that
    lies inside the grid, then clipped to ±clamp
    (occupancy._mark_node_cells)."""
    size = logodds.shape[0]
    inside = (cx >= 0) & (cx < size) & (cy >= 0) & (cy < size) & mask
    cell = torch.where(inside, cy * size + cx, size * size).long()
    flat = torch.zeros(size * size + 1, dtype=logodds.dtype, device=logodds.device)
    flat.index_add_(0, cell, torch.full(cell.shape, mark_value, dtype=logodds.dtype,
                                        device=logodds.device))
    return torch.clamp(logodds + flat[:-1].reshape(size, size), -clamp, clamp)


_PROJECT_NODE_CHUNK = 64   # nodes per gather of project_rays_plain (bounds its memory)


def pack_center_tables(D: np.ndarray, bin0: np.ndarray, Wray: np.ndarray) -> np.ndarray:
    """K11's table: one 16-byte row a cell, (D, bin0's int32 bits, Wray, 0)
    as (size², 4) float32 (the kernel reads a row with one 128-bit load)."""
    table = np.zeros((D.shape[0], 4), dtype=np.float32)
    table[:, 0], table[:, 2] = D, Wray
    table.view(np.int32)[:, 1] = bin0
    return table


def unpack_center_tables(table: torch.Tensor):
    """(D, bin0, Wray) of a ``pack_center_tables`` table."""
    return table[:, 0], table.view(torch.int32)[:, 1], table[:, 2]


def project_reach(res: float, max_range: float) -> int:
    """R: a node's terms are 0 beyond R cells of its own cell along either
    axis (a term needs D < max_range + 0.71·res; one cell to spare for the
    float32 tables), as ``csrc/occupancy.cu`` computes it."""
    return math.ceil(float(np.float32(max_range) + np.float32(0.71 * res))
                     / float(np.float32(res))) + 1


def project_rays_plain(logodds, cx, cy, kbin, scans, idx, count, table, res: float,
                       max_range: float, hit: float, miss: float, clamp: float, mark: bool):
    """Plain version of K11: (log-odds (size, size), per-cell sum of
    |node terms| (size, size) float64).

    For the ``count`` nodes ``idx[:count]`` (node slots into ``cx``, ``cy``,
    ``kbin`` (in [0, B)), ``scans``), every cell within ``project_reach``
    of the node's cell (the others' terms are 0) gathers the centre tables
    ``table`` (``pack_center_tables``, size² rows) at (r - cy + c0, c - cx +
    c0) and the node's range at bin (bin0 - kbin) mod B, classifies itself
    free or occupied, and the terms are summed in float64 over nodes; then
    clip, and with ``mark`` the node footprint marks and a second clip.
    Reads ``count`` on the host.
    """
    size, B = logodds.shape[0], scans.shape[1]
    dev, c0 = logodds.device, size // 2
    D, bin0, Wray = unpack_center_tables(table)
    nodes = idx[: int(count)].long()
    R = min(project_reach(res, max_range), size)
    offs = torch.arange(-R, R + 1, device=dev)
    acc = torch.zeros(size * size + 1, dtype=torch.float64, device=dev)
    mag = torch.zeros(size * size + 1, dtype=torch.float64, device=dev)
    for s in range(0, nodes.shape[0], _PROJECT_NODE_CHUNK):
        nd = nodes[s: s + _PROJECT_NODE_CHUNK]
        k = nd.shape[0]
        r = cy[nd].long()[:, None] + offs                              # (k, 2R + 1)
        c = cx[nd].long()[:, None] + offs
        pr, pc = offs + c0, offs + c0                                  # the table's row, column
        on = (((r >= 0) & (r < size) & (pr >= 0) & (pr < size))[:, :, None]
              & ((c >= 0) & (c < size) & (pc >= 0) & (pc < size))[:, None, :])
        q = (pr.clamp(0, size - 1)[:, None] * size + pc.clamp(0, size - 1)[None, :]).expand(
            k, -1, -1)
        d, w = D[q], Wray[q]
        bb = torch.remainder(bin0[q].long() - kbin[nd].long()[:, None, None], B)
        rng = torch.gather(scans[nd], 1, bb.reshape(k, -1)).reshape(bb.shape)
        rng = torch.where(torch.isfinite(rng), rng, BIG)
        has = rng < BIG * 0.5
        reach = torch.clamp(rng, max=max_range)
        free = has & (d < reach - res)
        occ = has & (rng <= max_range) & (torch.abs(d - rng) < 0.71 * res)
        E = torch.where(on, w * (free * miss + occ * hit), 0.0).double()
        cell = torch.where(on, r.clamp(0, size - 1)[:, :, None] * size
                           + c.clamp(0, size - 1)[:, None, :], size * size)
        acc.index_add_(0, cell.reshape(-1), E.reshape(-1))
        mag.index_add_(0, cell.reshape(-1), E.abs().reshape(-1))
    acc, mag = acc[:-1].view(size, size), mag[:-1].view(size, size)
    out = torch.clamp(logodds + acc.to(logodds.dtype), -clamp, clamp)
    if mark:
        active = torch.zeros(cx.shape[0], dtype=torch.bool, device=dev).index_fill_(0, nodes, True)
        out = mark_cells_plain(out, cx, cy, active, 2.0 * miss, clamp)
    return out, mag


def project_rays(logodds, cx, cy, kbin, scans, idx, count, table, res: float,
                 max_range: float, hit: float, miss: float, clamp: float, mark: bool):
    """K11: the occupancy projection of the ``count`` (a () int32 device
    tensor) nodes ``idx[:count]`` onto ``logodds``; returns the new grid.
    One launch: a CTA a 16 x 16 tile, each node's reach culled; the count is
    read by the kernel, never on the host.  ``kbin`` must lie in [0, B);
    ``table`` is ``pack_center_tables``' (size², 4) float32."""
    if logodds.device.type == "cpu":
        return project_rays_plain(logodds, cx, cy, kbin, scans, idx, count, table, res,
                                  max_range, hit, miss, clamp, mark)[0]
    dev, f32, i32 = logodds.device, torch.float32, torch.int32
    size = logodds.shape[0]
    n, B = scans.shape
    ptrs = [
        _check("logodds", logodds, (size, size), f32, dev),
        _check("table", table, (size * size, 4), f32, dev),
        _check("scans", scans, (n, B), f32, dev),
    ]
    _check_aligned("table", table)
    node = [_check(name, t, (n,), i32, dev)
            for name, t in (("cx", cx), ("cy", cy), ("kbin", kbin), ("idx", idx))]
    cnt = _check("count", count, (), i32, dev)
    lib = _build.load()
    out = torch.empty(size, size, dtype=f32, device=dev)
    err = lib.uz_project_rays(*ptrs, B, *node, cnt, size, float(res), float(0.71 * res),
                              float(max_range), float(hit), float(miss), float(clamp),
                              int(bool(mark)), float(2.0 * miss), out.data_ptr(), _stream(dev))
    _raise_on(err, "project_rays")
    launches["project_rays"] += 1
    return out


# ---------------------------------------------------------------------------
# K12 fast_nms (FAST-9/16 score + 3x3 non-maximum suppression)
# ---------------------------------------------------------------------------

def _images(name: str, t: torch.Tensor) -> tuple[int, int, int]:
    if t.dim() != 3:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected (C, H, W)")
    return tuple(t.shape)


def fast_nms_plain(img, threshold: float):
    """Plain version of K12: ``nms(fast_score(img, threshold))`` of (C, H,
    W) float32 images, or of each level of a list of them."""
    from uzliti_slam_tpu_torch.ops import features

    if not isinstance(img, torch.Tensor):
        return [fast_nms_plain(level, threshold) for level in img]
    return features.nms(features.fast_score(img, threshold))


FAST_NMS_LAUNCH_LEVELS = 8     # levels a launch (kMaxLevels in csrc/fast_nms.cu)


def fast_nms(imgs, threshold: float):
    """K12: FAST-9/16 scores with the border mask and the 3x3 NMS fused, of
    every level of ``imgs`` (a list of (C, H, W) float32 tensors, the
    cameras alike), one CTA per 32 x 32 tile of any level, up to 8 levels a
    launch (⌈L/8⌉ launches); returns the list of (C, H, W) score maps,
    views of one buffer laid end to end.  One level's tensor gives its one
    map."""
    one = isinstance(imgs, torch.Tensor)
    levels = [imgs] if one else list(imgs)
    if not levels:
        raise ValueError("fast_nms: no level")
    if levels[0].device.type == "cpu":
        return fast_nms_plain(imgs, threshold)
    dev = levels[0].device
    C = _images("img", levels[0])[0]
    shapes = [_images("img", img)[1:] for img in levels]
    ptrs = [_check("img", img, (C, H, W), torch.float32, dev)
            for img, (H, W) in zip(levels, shapes)]
    buf = torch.empty(sum(C * H * W for H, W in shapes), dtype=torch.float32, device=dev)
    outs = [m.view(C, H, W) for m, (H, W) in zip(buf.split([C * H * W for H, W in shapes]),
                                                  shapes)]
    lib = _build.load()
    for l0 in range(0, len(levels), FAST_NMS_LAUNCH_LEVELS):
        part = range(l0, min(l0 + FAST_NMS_LAUNCH_LEVELS, len(levels)))
        table = []
        for lv in part:
            table += [ptrs[lv], outs[lv].data_ptr(), *shapes[lv]]
        host = array.array("q", table)      # the table's 64-bit rows, alive through the call
        err = lib.uz_fast_nms_levels(host.buffer_info()[0], len(part), C, float(threshold),
                                     _stream(dev))
        _raise_on(err, "fast_nms")
        launches["fast_nms"] += 1
    return outs[0] if one else outs


# ---------------------------------------------------------------------------
# K13 grid_topk (per-cell top-k, then the global top-k or padding)
# ---------------------------------------------------------------------------

def _grid_shapes(H: int, W: int, k_total: int, grid: int) -> tuple[int, int, int, int]:
    """(cell height, cell width, k per cell, keypoints from the cells)."""
    k_cell = max(k_total // (grid * grid), 1)
    return H // grid, W // grid, k_cell, grid * grid * k_cell


def grid_topk_level_plain(score, k_total: int, grid: int):
    """Plain version of K13 on one level's (C, H, W) scores: (uv (C,
    k_total, 2), resp (C, k_total), valid (C, k_total)).  A stable
    descending sort, so ties go to the lower index (row-major in the cell,
    then cell order), as XLA's top_k and approx_max_k do on the CPU;
    ``torch.topk`` does not promise that order.  With one keypoint per cell
    the tie goes to the higher index, as XLA's k = 1 form (a max reduction)
    does."""
    C, H, W = score.shape
    gh, gw, k_cell, n = _grid_shapes(H, W, k_total, grid)
    dev = score.device
    sc = score[:, : gh * grid, : gw * grid].reshape(C, grid, gh, grid, gw)
    sc = sc.permute(0, 1, 3, 2, 4).reshape(C, grid * grid, gh * gw)
    if k_cell == 1:
        # XLA's approx_max_k with k = 1 is a max reduction, whose ties keep
        # the last index on the CPU
        last = sc.shape[-1] - 1 - torch.argmax(torch.flip(sc, dims=(-1,)), dim=-1, keepdim=True)
        vals, idx = torch.gather(sc, -1, last), last
    else:
        vals, idx = torch.sort(sc, dim=-1, descending=True, stable=True)
        vals, idx = vals[..., :k_cell], idx[..., :k_cell]
    cell = torch.arange(grid * grid, device=dev)[:, None]
    ys = (cell // grid) * gh + idx // gw
    xs = (cell % grid) * gw + idx % gw
    uv = torch.stack([xs.reshape(C, -1), ys.reshape(C, -1)], dim=-1).to(torch.float32)
    resp = vals.reshape(C, -1)
    valid = resp > 0
    if n > k_total:
        key = torch.where(valid, resp, -1.0)
        top_vals, top_idx = torch.sort(key, dim=-1, descending=True, stable=True)
        resp, top_idx = top_vals[:, :k_total], top_idx[:, :k_total]
        uv = torch.gather(uv, 1, top_idx[..., None].expand(C, k_total, 2))
        valid = resp > 0
    elif n < k_total:
        pad = k_total - n
        uv = torch.cat([uv, uv.new_zeros(C, pad, 2)], dim=1)
        resp = torch.cat([resp, resp.new_zeros(C, pad)], dim=1)
        valid = torch.cat([valid, valid.new_zeros(C, pad)], dim=1)
    return uv, resp, valid


def grid_topk_plain(scores, k_total: int, grid: int):
    """Plain version of K13: ``grid_topk_level_plain`` of one level's (C,
    H, W) scores, or of each level of a list, stacked: (uv (levels, C,
    k_total, 2), resp (levels, C, k_total), valid (levels, C, k_total))."""
    if isinstance(scores, torch.Tensor):
        return grid_topk_level_plain(scores, k_total, grid)
    levels = [grid_topk_level_plain(s, k_total, grid) for s in scores]
    return tuple(torch.stack(t) for t in zip(*levels))


GRID_TOPK_LAUNCH_LEVELS = 8    # levels a launch (kMaxLevels in csrc/grid_topk.cu)


def grid_topk(scores, k_total: int, grid: int):
    """K13: the exact top-k of each (level, camera, cell) for every level of
    ``scores`` (a list of (C, H, W) tensors, the cameras alike; or one
    level's tensor), up to 8 levels a launch (⌈L/8⌉ launches, each writing
    its levels' slices of the outputs), one CTA per cell, ties to the lower
    index (the last for one keypoint a cell); when the cells give more than
    ``k_total``, a second launch (one CTA per camera and level) keeps the
    global top ``k_total``; when fewer, the kernel writes the padding.
    Returns (uv (levels, C, k_total, 2), resp (levels, C, k_total), valid
    (levels, C, k_total)); for one level's tensor, without the level
    dimension."""
    if isinstance(scores, torch.Tensor):
        return tuple(t[0] for t in grid_topk([scores], k_total, grid))
    L = len(scores)
    if L == 0:
        raise ValueError("grid_topk: no level")
    if scores[0].device.type == "cpu":
        return grid_topk_plain(scores, k_total, grid)
    dev = scores[0].device
    C = _images("score", scores[0])[0]
    table = []
    for score in scores:
        H, W = score.shape[-2:]
        table += [_check("score", score, (C, H, W), torch.float32, dev), H, W]
        gh, gw, k_cell, n = _grid_shapes(H, W, k_total, grid)
        if gh * gw == 0 or k_cell > gh * gw:
            raise ValueError(f"grid_topk: {k_cell} per cell of {gh}x{gw} pixels")
    lib = _build.load()
    uv = torch.empty(L, C, k_total, 2, dtype=torch.float32, device=dev)
    resp = torch.empty(L, C, k_total, dtype=torch.float32, device=dev)
    valid = torch.empty(L, C, k_total, dtype=torch.bool, device=dev)
    # the cells' candidates go to scratch when a global top-k follows
    scratch = (torch.empty(L, C, n, 3, dtype=torch.float32, device=dev) if n > k_total
               else None)
    for l0 in range(0, L, GRID_TOPK_LAUNCH_LEVELS):
        l1 = min(l0 + GRID_TOPK_LAUNCH_LEVELS, L)
        host = (ctypes.c_longlong * (3 * (l1 - l0)))(*table[3 * l0: 3 * l1])
        err = lib.uz_grid_topk(ctypes.addressof(host), l1 - l0, C, grid, k_cell, k_total,
                               None if scratch is None else scratch[l0].data_ptr(),
                               uv[l0].data_ptr(), resp[l0].data_ptr(), valid[l0].data_ptr(),
                               _stream(dev))
        _raise_on(err, "grid_topk")
        launches["grid_topk"] += 1
    return uv, resp, valid


# ---------------------------------------------------------------------------
# K14 orb_describe (intensity-centroid angle, steered descriptor on the
# box-blurred image; every row of a keyframe in one launch)
# ---------------------------------------------------------------------------

class DescribeRow(NamedTuple):
    """One row of a K14 call: keypoints ``uv`` (C, K, 2) on images ``img``
    (C, H, W), described with ``pattern`` (256, 2, 2); ``angles`` (C, K)
    given (the GIST's roll) or None (the intensity-centroid angles)."""
    img: torch.Tensor
    uv: torch.Tensor
    pattern: torch.Tensor
    angles: torch.Tensor | None = None


def orb_describe_plain(img, uv, pattern, angles=None):
    """Plain version of K14 on one row, (C, H, W) images and (C, K, 2)
    keypoints: (angles (C, K), descriptors (C, K, 32) uint8).  Given
    ``angles`` are used as they are (the GIST's roll)."""
    from uzliti_slam_tpu_torch.ops import features

    if angles is None:
        angles = features.intensity_centroid_angles(img, uv)
    return angles, features.brief_descriptors(img, uv, angles, pattern)


def orb_describe_levels_plain(blocks):
    """Plain version of K14 on blocks of rows (``orb_describe_levels``):
    ``orb_describe_plain`` of each row, a block's rows concatenated along
    the keypoints: [(angles (C, ΣK), descriptors (C, ΣK, 32)), ...]."""
    out = []
    for block in blocks:
        rows = [orb_describe_plain(*row) for row in block]
        out.append((torch.cat([a for a, _ in rows], dim=1),
                    torch.cat([d for _, d in rows], dim=1)))
    return out


ORB_DESCRIBE_MAX_ROWS = 16    # kMaxRows in csrc/orb_describe.cu
ORB_DESCRIBE_WINDOW = (72, 76)  # kWinH rows x kWinP floats in csrc/orb_describe.cu

_pattern_reaches: dict = {}


def describe_reach(pattern: torch.Tensor) -> int:
    """How far from a keypoint's pixel K14's 5x5 sums read for ``pattern``:
    the ceiling of its largest point norm as the kernel computes it
    (float32 squares, their sum, a correctly rounded square root), + 1 for
    the rounding of a sample and + 2 for the blur.  Read on the host once
    per pattern tensor (and again after an in-place change to it)."""
    hit = _pattern_reaches.get(id(pattern))
    if hit is not None and hit[0]() is pattern and hit[1] == pattern._version:
        return hit[2]
    p = pattern.detach().to("cpu", torch.float32).numpy().reshape(-1, 2)
    n2 = (p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]).max()
    norm = np.sqrt(n2)
    if not np.isfinite(norm):
        raise ValueError("pattern: a point is not finite")
    reach = int(np.ceil(norm)) + 3
    for key in [k for k, (r, _, _) in _pattern_reaches.items() if r() is None]:
        del _pattern_reaches[key]
    _pattern_reaches[id(pattern)] = (weakref.ref(pattern), pattern._version, reach)
    return reach


def describe_window(reach: int, H: int, W: int) -> tuple[int, int]:
    """The most rows and row floats K14's window takes for a pattern of
    ``reach`` on (H, W) images: the square of side 2·reach + 1 clipped to
    the image and its 2-pixel border, its row widened by up to 3 floats to
    align its 128-bit loads."""
    return min(2 * reach + 1, H + 4), min(2 * reach + 1, W + 4) + 3


def orb_describe_levels(blocks):
    """K14: the descriptors of every row of every block in one launch (a
    keyframe's pyramid levels, all cameras, in one block; its GIST in
    another), one CTA per keypoint: the intensity-centroid angle on the
    unblurred image (or the row's given angles), the pattern rotated by it,
    and 256 nearest-pixel tests whose 5x5 box sums are taken on the
    keypoint's window of the unblurred image, packed by ``__ballot_sync``.
    ``blocks`` is a list of lists of ``DescribeRow``, a block's rows on the
    same cameras; returns per block (angles (C, ΣK), descriptors (C, ΣK,
    32) uint8), its rows side by side along the keypoints, as
    ``torch.cat(dim=1)`` of the rows' own (a given row's angles copied).
    Raises where a row's window (``describe_window``) exceeds the kernel's
    ``ORB_DESCRIBE_WINDOW``."""
    dev = blocks[0][0].img.device
    if dev.type == "cpu":
        return orb_describe_levels_plain(blocks)
    n_rows = sum(len(block) for block in blocks)
    if not 1 <= n_rows <= ORB_DESCRIBE_MAX_ROWS:
        raise ValueError(f"orb_describe: {n_rows} rows, the kernel takes "
                         f"1..{ORB_DESCRIBE_MAX_ROWS}")
    f32 = torch.float32
    table, out, patterns, total = [], [], {}, 0
    for block in blocks:
        C = _images("img", block[0].img)[0]
        Kt = sum(row.uv.shape[1] for row in block)
        ang = torch.empty(C, Kt, dtype=f32, device=dev)
        desc = torch.empty(C, Kt, 32, dtype=torch.uint8, device=dev)
        a_ptr, d_ptr = ang.data_ptr(), desc.data_ptr()
        for img, uv, pattern, given in block:
            H, W = img.shape[-2:]
            K = uv.shape[1]
            if id(pattern) not in patterns:
                ptr = _check("pattern", pattern, (256, 2, 2), f32, dev)
                _check_aligned("pattern", pattern)
                patterns[id(pattern)] = ptr, describe_reach(pattern)
            ptr, reach = patterns[id(pattern)]
            rows, floats = describe_window(reach, H, W)
            if rows > ORB_DESCRIBE_WINDOW[0] or floats > ORB_DESCRIBE_WINDOW[1]:
                raise ValueError(f"pattern: its window on {H}x{W} images takes {rows} rows of "
                                 f"{floats} floats, the kernel holds {ORB_DESCRIBE_WINDOW}")
            table += [_check("img", img, (C, H, W), f32, dev),
                      _check("uv", uv, (C, K, 2), f32, dev), ptr,
                      0 if given is None else _check("angles", given, (C, K), f32, dev),
                      a_ptr, d_ptr, C, H, W, K, Kt]
            a_ptr, d_ptr = a_ptr + 4 * K, d_ptr + 32 * K
            total += C * K
        out.append((ang, desc))
    if total == 0:      # no keypoint: the kernel would not launch
        return out
    lib = _build.load()
    host = array.array("q", table)      # the table's 64-bit rows, alive through the call
    err = lib.uz_orb_describe_rows(host.buffer_info()[0], n_rows, _stream(dev))
    _raise_on(err, "orb_describe")
    launches["orb_describe"] += 1
    return out


# ---------------------------------------------------------------------------
# K29 sift_describe (radius-1 blur, intensity-centroid angle, SIFT descriptor)
# ---------------------------------------------------------------------------

SIFT_GRID = 16      # the descriptor's sample grid (kG in csrc/sift_describe.cu)
_sift_windows: dict = {}


def sift_window(device) -> torch.Tensor:
    """The (16, 16) float32 Gaussian window of the SIFT descriptor (σ = half
    the grid), by the reference's formula (``features.py:458-460``) on the
    host, cached per device: a constant of the descriptor."""
    device = torch.device(device)
    if device not in _sift_windows:
        G = SIFT_GRID
        yy = torch.arange(G, dtype=torch.float32) - (G - 1) / 2.0
        w = torch.exp(-(yy[:, None] ** 2 + yy[None, :] ** 2) / (2.0 * (G / 2.0) ** 2))
        _sift_windows[device] = w.to(device)
    return _sift_windows[device]


def sift_describe_plain(img, uv, window):
    """Plain version of K29 on (C, H, W) images and (C, K, 2) keypoints:
    (angles (C, K), descriptors (C, K, 128) float32)."""
    from uzliti_slam_tpu_torch.ops import features

    angles = features.intensity_centroid_angles(img, uv)
    return angles, features.sift_descriptors(img, uv, angles, window=window)


def sift_describe(img, uv, window):
    """K29: a separable 3x3 box blur of each image (one launch), then one
    warp per keypoint: the intensity-centroid angle on the unblurred image
    (K14's code), the rotated 18x18 grid gathered into shared memory, 8-bin
    soft orientation histograms of 4x4 cells in registers, the normalise,
    clip, normalise."""
    if img.device.type == "cpu":
        return sift_describe_plain(img, uv, window)
    dev, f32 = img.device, torch.float32
    C, H, W = _images("img", img)
    K = uv.shape[1]
    ptrs = [_check("img", img, (C, H, W), f32, dev), _check("uv", uv, (C, K, 2), f32, dev),
            _check("window", window, (SIFT_GRID, SIFT_GRID), f32, dev)]
    lib = _build.load()
    blurred = torch.empty(C, H, W, dtype=f32, device=dev)
    ang = torch.empty(C, K, dtype=f32, device=dev)
    desc = torch.empty(C, K, 128, dtype=f32, device=dev)
    err = lib.uz_sift_describe(*ptrs, C, H, W, K, blurred.data_ptr(), ang.data_ptr(),
                               desc.data_ptr(), _stream(dev))
    _raise_on(err, "sift_describe")
    launches["sift_describe"] += 1
    return ang, desc


# ---------------------------------------------------------------------------
# K30 l2_top2 (squared-L2 2-NN and ratio test of float descriptors)
# ---------------------------------------------------------------------------

L2_MAX_DIM = 128    # descriptor width one tile holds (kDMax in csrc/l2_top2.cu)


def l2_top2_plain(a, b, valid_a, valid_b, ratio_sq: float, max_sq: float):
    """Plain version of K30: the reference's ``l2_matrix``, ``knn_match``
    (masked pairs 1e9, the two smallest of each row, ties to the lower
    index) and ``ratio_test`` on squared distances (gates in float32), ok
    also requiring ``valid_a``.  Returns (idx (Na,) int32, ok (Na,) bool,
    best (Na,) float32)."""
    from uzliti_slam_tpu_torch.ops import matching

    vals, idx = matching.knn_match(matching.l2_matrix(a, b), valid_a, valid_b)
    match, ok = matching.ratio_test(vals, idx, ratio_sq, max_sq)
    return match.to(torch.int32), ok & valid_a, vals[..., 0]


def l2_top2(a, b, valid_a, valid_b, ratio_sq: float, max_sq: float):
    """K30: a CTA per 32 queries walking the stored descriptors in tiles of
    32 through shared memory, float32 dot products on the CUDA cores, a
    running best and second per query; no distance matrix in memory."""
    if a.device.type == "cpu":
        return l2_top2_plain(a, b, valid_a, valid_b, ratio_sq, max_sq)
    dev, f32 = a.device, torch.float32
    (Na, D), Nb = a.shape, b.shape[0]
    if not 0 < D <= L2_MAX_DIM or Nb < 2:
        raise ValueError(f"l2_top2: width {D} (at most {L2_MAX_DIM}) and {Nb} stored "
                         "descriptors (at least 2)")
    ptrs = [_check("a", a, (Na, D), f32, dev), _check("b", b, (Nb, D), f32, dev),
            _check("valid_a", valid_a, (Na,), torch.bool, dev),
            _check("valid_b", valid_b, (Nb,), torch.bool, dev)]
    lib = _build.load()
    idx = torch.empty(Na, dtype=torch.int32, device=dev)
    ok = torch.empty(Na, dtype=torch.bool, device=dev)
    best = torch.empty(Na, dtype=f32, device=dev)
    err = lib.uz_l2_top2(*ptrs, Na, Nb, D, float(ratio_sq), float(max_sq), idx.data_ptr(),
                         ok.data_ptr(), best.data_ptr(), _stream(dev))
    _raise_on(err, "l2_top2")
    launches["l2_top2"] += 1
    return idx, ok, best


# ---------------------------------------------------------------------------
# K15 scan_bins (depth -> per-bin near/far range)
# ---------------------------------------------------------------------------

SCAN_MAX_BINS = 1024     # kMaxBins in csrc/scan_bins.cu: a scratch row's near and far halves
_scan_scratch: dict = {}


def scan_bins_scratch(device, C: int) -> torch.Tensor:
    """K15's table on ``device``: (rows, 2·SCAN_MAX_BINS + 1) int32, a row a
    camera of INT_MAX (near), -1 (far) and an arrival counter 0.  Made once
    a device (again for more cameras); every call leaves it as it found it,
    its last CTA putting back what the others folded in."""
    key = str(device)
    t = _scan_scratch.get(key)
    if t is None or t.shape[0] < C:
        t = torch.full((max(C, 2), 2 * SCAN_MAX_BINS + 1), torch.iinfo(torch.int32).max,
                       dtype=torch.int32, device=device)
        t[:, SCAN_MAX_BINS:2 * SCAN_MAX_BINS] = -1
        t[:, -1] = 0
        _scan_scratch[key] = t
    return t


def fma_plain(a, b, c):
    """a·b + c rounded once to float32, as a fused multiply-add: the
    product is exact in float64, so only the double rounding of the sum
    (rare) can differ from the card's ``fmaf``."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def scan_pixels_plain(depth, cam, xf, n_bins: int, angle_min: float, angle_max: float,
                      height_band, max_range: float, min_range: float):
    """The per-pixel part of K15's plain version on (C, H, W) depth in
    metres and (C, 12) camera-to-base transforms: (range, ok, bin), each
    (C, H·W).

    The reference's compiled form is followed, as XLA on the CPU emits it:
    each row of the extrinsic product is fma(r2, z, fma(r0, x, r1·y)) + t
    and the squared range fma(x, x, y·y) (LLVM contracts a multiply into
    the add that uses it); the bin index is ``scan.bin_index``.  K15
    writes the same contractions with ``__fmaf_rn`` and every other
    operation with ``__f*_rn``."""
    from uzliti_slam_tpu_torch.ops import scan

    C, h, w = depth.shape
    dev = depth.device
    vv = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w)
    uu = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w)
    xc = (uu - cam.cx) / cam.fx * depth
    yc = (vv - cam.cy) / cam.fy * depth
    zc = depth
    m = [xf[:, i, None, None] for i in range(12)]

    def row(i):
        return fma_plain(m[3 * i + 2], zc, fma_plain(m[3 * i], xc, m[3 * i + 1] * yc)) + m[9 + i]

    xb, yb, zb = row(0), row(1), row(2)
    valid = (depth > 0.01) & torch.isfinite(depth)
    # the square root in float64, rounded once: torch's float32 sqrt on the
    # CPU is not always the correctly rounded one (XLA's and the card's are)
    rng = torch.sqrt(fma_plain(xb, xb, yb * yb).double()).to(torch.float32)
    bearing = torch.atan2(yb, xb)
    ok = (valid & (zb >= height_band[0]) & (zb <= height_band[1])
          & (rng >= min_range) & (rng <= max_range)
          & (bearing >= angle_min) & (bearing < angle_max))
    bins = scan.bin_index(bearing, n_bins, angle_min, angle_max)
    return rng.reshape(C, -1), ok.reshape(C, -1), bins.reshape(C, -1)


def scan_bins_plain(depth, cam, xf, n_bins: int, angle_min: float, angle_max: float,
                    height_band, max_range: float, min_range: float):
    """Plain version of K15: (near (C, B), far (C, B)), +inf where a bin is
    empty, from (C, H, W) depth in metres."""
    rng, ok, bins = scan_pixels_plain(depth, cam, xf, n_bins, angle_min, angle_max,
                                      height_band, max_range, min_range)
    near, far = bin_reduce_plain(rng, ok, bins, n_bins, max_range)
    return near, torch.where(torch.isfinite(far), far, torch.inf)


def bin_reduce_plain(rng, ok, bins, n_bins: int, max_range: float):
    """The reduction at the core of K15's plain versions (the reference's
    ``_bin_min_max``): per-bin (near, far) of (..., P) ranges, flags and
    bins (leading dimensions: one scan each), from the 21-bit quantised
    ranges of the ``ok`` entries by ``scatter_reduce``; +inf / -inf for an
    empty bin.  The write-back is q · fl(1 / scale): the compiled form of
    the reference's ``q / scale``."""
    from uzliti_slam_tpu_torch.ops import scan

    scale = scan.range_scale(max_range)
    q = torch.clamp(rng * scale, 0.0, float(scan.Q_MAX)).to(torch.int32)
    lead = rng.shape[:-1]
    slot = torch.where(ok, bins.long(), n_bins)
    big = torch.iinfo(torch.int32).max
    mn = torch.full(lead + (n_bins + 1,), big, dtype=torch.int32, device=q.device)
    mx = torch.full(lead + (n_bins + 1,), -1, dtype=torch.int32, device=q.device)
    mn = mn.scatter_reduce(-1, slot, q, "amin")[..., :n_bins]
    mx = mx.scatter_reduce(-1, slot, q, "amax")[..., :n_bins]
    has = mx >= 0
    inv = scan.f32_reciprocal(scale)
    return (torch.where(has, mn.to(torch.float32) * inv, math.inf),
            torch.where(has, mx.to(torch.float32) * inv, -math.inf))


def bin_min_max_plain(points, valid, n_bins: int, angle_min: float, angle_max: float,
                      max_range: float, min_range: float, height_band=None):
    """Plain version of K15's ``bin_min_max`` entry: the scans (near, far),
    each (..., n_bins) and +inf where a bin is empty, of the points (..., P,
    2) in the scan frame (``points_to_scan``) or (..., P, 3) with z within
    ``height_band`` (``cloud_to_scan``), with flags ``valid`` (..., P);
    leading dimensions are a batch of scans.  ``scan._hypot``, atan2,
    ``scan._planar_ok``, the band, ``scan.bin_index``, then
    ``bin_reduce_plain``."""
    from uzliti_slam_tpu_torch.ops import scan

    x, y = points[..., 0], points[..., 1]
    rng = scan._hypot(x, y)
    bearing = torch.atan2(y, x)
    ok = scan._planar_ok(rng, bearing, valid, angle_min, angle_max, max_range, min_range)
    if height_band is not None:
        z = points[..., 2]
        ok = ok & (z >= height_band[0]) & (z <= height_band[1])
    bins = scan.bin_index(bearing, n_bins, angle_min, angle_max)
    near, far = bin_reduce_plain(rng, ok, bins, n_bins, max_range)
    return near, torch.where(torch.isfinite(far), far, math.inf)


def bin_min_max(points, valid, n_bins: int, angle_min: float, angle_max: float,
                max_range: float, min_range: float, height_band=None):
    """K15's second entry point: one CTA per scan computes each point's
    range, bearing, gates and bin, then atomicMin / atomicMax of the 21-bit
    quantised ranges on int32 bins in shared memory (exact and
    order-free), then q · fl(1/scale) or +inf.  ``points`` (..., P, 2), or
    (..., P, 3) with ``height_band``.  Returns (near, far), views of one
    allocation."""
    if points.device.type == "cpu":
        return bin_min_max_plain(points, valid, n_bins, angle_min, angle_max, max_range,
                                 min_range, height_band)
    from uzliti_slam_tpu_torch.ops import scan

    dev, f32 = points.device, torch.float32
    lead, P, D = tuple(points.shape[:-2]), points.shape[-2], points.shape[-1]
    B = math.prod(lead)
    if not 0 < n_bins <= 1023:
        raise ValueError(f"bin_min_max: {n_bins} bins, the kernel takes 1..1023")
    if (D, height_band is not None) not in ((2, False), (3, True)):
        raise ValueError(f"bin_min_max: points of {D} coordinates with height_band "
                         f"{height_band}: (x, y) without a band or (x, y, z) with one")
    ptrs = [_check("points", points, lead + (P, D), f32, dev),
            _check("valid", valid, lead + (P,), torch.bool, dev)]
    band = (0.0, 0.0) if height_band is None else height_band
    lib = _build.load()
    out = torch.empty(2, B, n_bins, dtype=f32, device=dev)
    scale = scan.range_scale(max_range)
    err = lib.uz_bin_min_max(*ptrs, B, P, D, n_bins, float(angle_min), float(angle_max),
                             scan.bin_factor(n_bins, angle_min, angle_max), float(min_range),
                             float(max_range), float(band[0]), float(band[1]), scale,
                             scan.f32_reciprocal(scale), out.data_ptr(), _stream(dev))
    _raise_on(err, "bin_min_max")
    launches["bin_min_max"] += 1
    return out[0].view(lead + (n_bins,)), out[1].view(lead + (n_bins,))


def scan_bins(depth, cam, xf, n_bins: int, angle_min: float, angle_max: float,
              height_band, max_range: float, min_range: float):
    """K15: one launch over every camera's pixels (backprojection, extrinsic,
    band, range, bearing, bin) into per-bin atomicMin/atomicMax of the
    21-bit quantised range in each CTA's shared table, folded into the
    device's table (``scan_bins_scratch``); each camera's last CTA writes
    q · fl(1/scale) (or +inf) and resets the table.  Returns (near, far),
    views of one allocation."""
    if depth.device.type == "cpu":
        return scan_bins_plain(depth, cam, xf, n_bins, angle_min, angle_max, height_band,
                               max_range, min_range)
    from uzliti_slam_tpu_torch.ops import scan

    dev, f32 = depth.device, torch.float32
    C, H, W = _images("depth", depth)
    if not 0 < n_bins <= 1023:
        raise ValueError(f"scan_bins: {n_bins} bins, the kernel takes 1..1023")
    ptrs = [_check("depth", depth, (C, H, W), f32, dev), _check("xf", xf, (C, 12), f32, dev)]
    lib = _build.load()
    scratch = scan_bins_scratch(dev, C)
    out = torch.empty(2, C, n_bins, dtype=f32, device=dev)
    scale = scan.range_scale(max_range)
    err = lib.uz_scan_bins(*ptrs, C, H, W, float(cam.fx), float(cam.fy), float(cam.cx),
                           float(cam.cy), n_bins, float(angle_min), float(angle_max),
                           scan.bin_factor(n_bins, angle_min, angle_max), float(height_band[0]),
                           float(height_band[1]), float(min_range), float(max_range), scale,
                           scan.f32_reciprocal(scale), scratch.data_ptr(), out.data_ptr(),
                           _stream(dev))
    _raise_on(err, "scan_bins")
    launches["scan_bins"] += 1
    return out[0], out[1]


# ---------------------------------------------------------------------------
# K16 hamming_top2 (descriptor matching and the GIST query)
# ---------------------------------------------------------------------------

MASKED = 1e9   # knn_match's padding of masked pairs (not +inf)


def smallest_k(d: torch.Tensor, k: int):
    """The k smallest entries of the last dimension and their indices, ties
    to the lower index (a stable sort: ``torch.topk`` promises no order)."""
    vals, idx = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def hamming_top2_plain(query, bank, bank_valid, cslot, valid_a, ratio: float, max_dist: float):
    """Plain version of K16's matching: the stored descriptors of candidate
    node ``cslot[c]`` (``bank`` (N, F, 32) uint8, ``bank_valid`` (N, F))
    against ``query`` (Na, 32): the reference's ``knn_match`` (masked pairs
    1e9, the two smallest Hamming distances of each query) and
    ``ratio_test`` (gates in float32), as ``ops/matching.py`` has them.
    Returns (idx (C, Na) int32, ok (C, Na) bool, best (C, Na) float32)."""
    from uzliti_slam_tpu_torch.ops import matching

    cs = cslot.long()
    d = matching.hamming_matrix_packed(query, bank.index_select(0, cs))      # (C, Na, F)
    vals, idx = matching.knn_match(d, valid_a, bank_valid.index_select(0, cs))
    match, ok = matching.ratio_test(vals, idx, ratio, max_dist)
    return match.to(torch.int32), ok & valid_a[None, :], vals[..., 0]


def _smem_check(name: str, nbytes: int) -> None:
    if nbytes > _SMEM_BYTES:
        raise ValueError(f"{name}: {nbytes} bytes of shared memory, one CTA holds {_SMEM_BYTES}")


def hamming_top2(query, bank, bank_valid, cslot, valid_a, ratio: float, max_dist: float):
    """K16: all candidates' matching in one launch, a CTA per (8 queries,
    candidate); each query's scan of its candidate's stored descriptors
    split over 8 lanes, each keeping a (best, second) pair of (distance,
    index) keys, merged by shuffles."""
    if query.device.type == "cpu":
        return hamming_top2_plain(query, bank, bank_valid, cslot, valid_a, ratio, max_dist)
    dev, u8 = query.device, torch.uint8
    Na, (N, F, _), C = query.shape[0], bank.shape, cslot.shape[0]
    ptrs = [_check("query", query, (Na, 32), u8, dev), _check("bank", bank, (N, F, 32), u8, dev),
            _check("bank_valid", bank_valid, (N, F), torch.bool, dev),
            _check("cslot", cslot, (C,), torch.int32, dev),
            _check("valid_a", valid_a, (Na,), torch.bool, dev)]
    _check_aligned("query", query)
    _check_aligned("bank", bank)
    lib = _build.load()
    idx = torch.empty(C, Na, dtype=torch.int32, device=dev)
    ok = torch.empty(C, Na, dtype=torch.bool, device=dev)
    best = torch.empty(C, Na, dtype=torch.float32, device=dev)
    err = lib.uz_hamming_top2(*ptrs, C, Na, F, float(ratio), float(max_dist), idx.data_ptr(),
                              ok.data_ptr(), best.data_ptr(), _stream(dev))
    _raise_on(err, "hamming_top2")
    launches["hamming_top2"] += 1
    return idx, ok, best


def gist_topk_plain(query, bank, stamp, valid, q_stamp, k: int, min_dt: float, max_dist: float):
    """Plain version of K16's GIST query: the Hamming distance of ``query``
    (32,) to every entry of ``bank`` (N, 32), +inf where an entry is not
    valid or lies within ``min_dt`` of ``q_stamp`` (a () float32 tensor),
    the k smallest, ties to the lower index.  Returns (slots (k,) int32,
    dist (k,) float32, ok (k,) bool: finite and <= max_dist)."""
    from uzliti_slam_tpu_torch.ops import matching

    d = matching.hamming_matrix_packed(query[None], bank)[0]
    eligible = valid & (torch.abs(stamp - q_stamp) >= min_dt)
    d = torch.where(eligible, d, torch.inf)
    vals, idx = smallest_k(d, k)
    return idx.to(torch.int32), vals, torch.isfinite(vals) & (vals <= max_dist)


def gist_topk(query, bank, stamp, valid, q_stamp, k: int, min_dt: float, max_dist: float):
    """K16's GIST entry: the bank split over one thread-block cluster (1-8
    CTAs by its size), each thread's best (distance, index) keys in
    registers, merged across the warp, the CTA and the cluster (through
    distributed shared memory); one pass over the bank per 8 keys of k.
    No part of the bank is held in shared memory, so its size is not
    capped."""
    if query.device.type == "cpu":
        return gist_topk_plain(query, bank, stamp, valid, q_stamp, k, min_dt, max_dist)
    dev, N = query.device, bank.shape[0]
    if not 0 < k <= N:
        raise ValueError(f"gist_topk: k = {k} of a {N}-entry bank")
    ptrs = [_check("query", query, (32,), torch.uint8, dev),
            _check("bank", bank, (N, 32), torch.uint8, dev),
            _check("stamp", stamp, (N,), torch.float32, dev),
            _check("valid", valid, (N,), torch.bool, dev),
            _check("q_stamp", q_stamp, (), torch.float32, dev)]
    _check_aligned("query", query)
    _check_aligned("bank", bank)
    lib = _build.load()
    slots = torch.empty(k, dtype=torch.int32, device=dev)
    dist = torch.empty(k, dtype=torch.float32, device=dev)
    ok = torch.empty(k, dtype=torch.bool, device=dev)
    err = lib.uz_gist_topk(*ptrs, N, k, float(min_dt), float(max_dist), slots.data_ptr(),
                           dist.data_ptr(), ok.data_ptr(), _stream(dev))
    _raise_on(err, "hamming_top2")
    launches["hamming_top2"] += 1
    return slots, dist, ok


# ---------------------------------------------------------------------------
# K17 bilateral (joint bilateral depth filter)
# ---------------------------------------------------------------------------

BILATERAL_RADIUS = 2
SIGMA_SPACE, SIGMA_COLOR = 1.5, 10.0   # ops/depth.py:joint_bilateral_filter's defaults


def _f32(x: float) -> float:
    return float(np.float32(x))


def bilateral_taps() -> tuple[tuple[int, int], ...]:
    """(dy, dx) of the taps in the reference's dy-major order."""
    r = BILATERAL_RADIUS
    return tuple((dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1))


def bilateral_spatial() -> tuple[float, ...]:
    """The 25 spatial weights exp(-(dy² + dx²) / (2 σs²)) as float32, the
    reference's compiled constants (exp of the float32 argument, correctly
    rounded)."""
    return tuple(_f32(math.exp(_f32(-(dy * dy + dx * dx) / (2 * SIGMA_SPACE**2))))
                 for dy, dx in bilateral_taps())


# the colour exponent's factor: XLA turns x / (2 σc²) into x · fl(1 / (2 σc²))
NEG_INV_2SC2 = -_f32(1.0 / (2 * SIGMA_COLOR**2))


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = img[..., y + dy, x + dx], zero outside (the
    reference's ``_shift2d``)."""
    h, w = img.shape[-2:]
    out = torch.zeros_like(img)
    out[..., max(-dy, 0): h + min(-dy, 0), max(-dx, 0): w + min(-dx, 0)] = \
        img[..., max(dy, 0): h + min(dy, 0), max(dx, 0): w + min(dx, 0)]
    return out


def bilateral_plain(depth, guide):
    """Plain version of K17 on (C, H, W) float32 depth (metres) and guide:
    the reference's tap order, exponent and products, num summed by a fused
    multiply-add (``fma_plain``), as the compiled reference."""
    valid = (depth > 0.0) & torch.isfinite(depth)
    d = torch.where(valid, depth, 0.0)
    vf = valid.to(depth.dtype)
    num = torch.zeros_like(d)
    den = torch.zeros_like(d)
    for (dy, dx), ws in zip(bilateral_taps(), bilateral_spatial()):
        t = _shift(guide, -dy, -dx) - guide
        w = (torch.exp((t * t) * NEG_INV_2SC2) * ws) * _shift(vf, -dy, -dx)
        num = fma_plain(w, _shift(d, -dy, -dx), num)
        den = den + w
    return torch.where(den > 1e-6, num / torch.clamp(den, min=1e-9), 0.0)


BILATERAL_TILE = (16, 32)    # kTy x kTx in csrc/bilateral.cu


@functools.cache
def bilateral_spatial_host() -> array.array:
    """``bilateral_spatial()`` as a float32 host array, built once per
    process: the table K17's entry copies into its launch."""
    return array.array("f", bilateral_spatial())


def bilateral_tile_paths_plain(guide):
    """Which colour path each of K17's tiles takes on (C, H, W) guides: (C,
    ceil(H / 16), ceil(W / 32)) int32, 1 where every guide value of the tile
    and its halo of 2 (0 outside the image) is an integer in [0, 255] (the
    colour table), 0 where the kernel evaluates expf at each tap."""
    C, H, W = guide.shape
    ty, tx = BILATERAL_TILE
    r = BILATERAL_RADIUS
    ny, nx = -(-H // ty), -(-W // tx)
    ok = (guide >= 0) & (guide <= 255) & (guide == torch.trunc(guide))
    pad = torch.ones(C, ny * ty + 2 * r, nx * tx + 2 * r, dtype=torch.bool, device=guide.device)
    pad[:, r: r + H, r: r + W] = ok
    bad = torch.nn.functional.max_pool2d((~pad)[:, None].to(torch.float32),
                                         (ty + 2 * r, tx + 2 * r), stride=(ty, tx))
    return (bad[:, 0] == 0).to(torch.int32)


def bilateral(depth, guide, tile_paths: bool = False):
    """K17: a CTA per 32 x 16 tile over shared tiles of the masked depth and
    the guide with a halo of 2, two pixels a thread, cameras on the grid;
    the colour weights from a table where the tile's guides are all integers
    in [0, 255]; (C, H, W) float32 -> (C, H, W) float32.  With
    ``tile_paths``, also returns which path each tile took (the layout of
    ``bilateral_tile_paths_plain``, which answers on CPU tensors)."""
    if depth.device.type == "cpu":
        out = bilateral_plain(depth, guide)
        return (out, bilateral_tile_paths_plain(guide)) if tile_paths else out
    dev, f32 = depth.device, torch.float32
    C, H, W = _images("depth", depth)
    ptrs = [_check("depth", depth, (C, H, W), f32, dev), _check("guide", guide, (C, H, W), f32, dev)]
    lib = _build.load()
    out = torch.empty_like(depth)
    ty, tx = BILATERAL_TILE
    paths = (torch.empty(C, -(-H // ty), -(-W // tx), dtype=torch.int32, device=dev)
             if tile_paths else None)
    err = lib.uz_bilateral(*ptrs, C, H, W, bilateral_spatial_host().buffer_info()[0],
                           NEG_INV_2SC2, out.data_ptr(), _ptr(paths), _stream(dev))
    _raise_on(err, "bilateral")
    launches["bilateral"] += 1
    return (out, paths) if tile_paths else out


# ---------------------------------------------------------------------------
# K18 icp (point-to-line ICP, all iterations in one launch)
# ---------------------------------------------------------------------------

ICP_MAX_POINTS = 8192   # target points a CTA's shared memory holds (21 bytes each)


def lu_solve_plain(A, b):
    """x with A x = b for (..., n, n) and b (..., n) or (..., n, r):
    Gaussian elimination with partial pivoting (the first largest pivot),
    multipliers by division, the right-hand sides eliminated alongside, then
    back substitution (the kernels' 3x3 and 6x6 solves, K18's, K27's and
    K28's, those two multiplying by each pivot's reciprocal: the same to a
    rounding; no ``torch.linalg``)."""
    vec = b.dim() == A.dim() - 1
    A, b = A.clone(), (b[..., None] if vec else b).clone()
    n = A.shape[-1]
    ar = torch.arange(n, device=A.device)
    for k in range(n):
        p = (k + torch.argmax(A[..., k:, k].abs(), dim=-1))[..., None]
        swap = torch.where(ar == k, p, torch.where(ar == p, k, ar))
        A = torch.gather(A, -2, swap[..., None].expand(A.shape))
        b = torch.gather(b, -2, swap[..., None].expand(b.shape))
        for i in range(k + 1, n):
            li = A[..., i, k] / A[..., k, k]
            A[..., i, k + 1:] = A[..., i, k + 1:] - li[..., None] * A[..., k, k + 1:]
            b[..., i, :] = b[..., i, :] - li[..., None] * b[..., k, :]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = b[..., i, :]
        for j in range(i + 1, n):
            s = s - A[..., i, j, None] * x[j]
        x[i] = s / A[..., i, i, None]
    x = torch.stack(x, dim=-2)
    return x[..., 0] if vec else x


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3, 3) matrices by ``lu_solve_plain`` (no host read)."""
    return lu_solve_plain(A, torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape))


def icp_terms_plain(pose, src, src_valid, dst, dst_valid, max_corr2: float):
    """Point-to-line terms at ``pose`` (B, 3): (J (B, M, 3), r (B, M), w (B,
    M) float 0/1), with K18's order of operations; the two nearest targets
    by a stable sort (ties to the lower index, +inf at invalid targets)."""
    c, s = torch.cos(pose[:, 2:3]), torch.sin(pose[:, 2:3])
    px, py = src[..., 0], src[..., 1]
    mx = (c * px - s * py) + pose[:, 0:1]
    my = (s * px + c * py) + pose[:, 1:2]
    ex = mx[..., None] - dst[:, None, :, 0]
    ey = my[..., None] - dst[:, None, :, 1]
    d2 = torch.where(dst_valid[:, None, :], ex * ex + ey * ey, torch.inf)
    vals, idx = smallest_k(d2, 2)
    pick = lambda k: torch.gather(dst, 1, idx[..., k, None].expand(idx.shape[:2] + (2,)))  # noqa: E731
    p1, p2 = pick(0), pick(1)
    sx, sy = p2[..., 0] - p1[..., 0], p2[..., 1] - p1[..., 1]
    length = torch.clamp(torch.sqrt(sx * sx + sy * sy), min=1e-9)
    nx, ny = -sy / length, sx / length
    r = (mx - p1[..., 0]) * nx + (my - p1[..., 1]) * ny
    w = (src_valid & (vals[..., 0] < max_corr2) & torch.isfinite(vals[..., 0])
         & torch.isfinite(vals[..., 1])).to(src.dtype)
    t0, t1 = -my + pose[:, 1:2], mx - pose[:, 0:1]
    J = torch.stack([nx, ny, nx * t0 + ny * t1], dim=-1)
    return J, r, w


def _icp_normal(J, r, w, diag: float):
    H = torch.sum((J[..., :, None] * J[..., None, :]) * w[..., None, None], dim=1)
    H = H + diag * torch.eye(3, dtype=J.dtype, device=J.device)
    return H, torch.sum((J * r[..., None]) * w[..., None], dim=1)


def icp_plain(src, src_valid, dst, dst_valid, init, iterations: int, max_corr2: float,
              min_fraction: float, max_t: float, max_r: float, sigma2: float):
    """Plain version of K18 on a batch: src (B, M, 2), dst (B, N, 2), their
    validity, init (B, 3).  Returns (pose (B, 3), fraction (B,), mse (B,),
    cov (B, 3, 3), ok (B,))."""
    pose = init
    for _ in range(iterations):
        H, b = _icp_normal(*icp_terms_plain(pose, src, src_valid, dst, dst_valid, max_corr2), 1e-9)
        pose = pose + -lu_solve_plain(H, b)
    J, r, w = icp_terms_plain(pose, src, src_valid, dst, dst_valid, max_corr2)
    n_good = w.sum(-1)
    n_src = torch.clamp(src_valid.sum(-1, dtype=torch.int32), min=1)
    fraction = n_good / n_src.to(n_good.dtype)
    mse = torch.sum((r * r) * w, dim=-1) / torch.clamp(n_good, min=1.0)
    cov = sigma2 * inv3(_icp_normal(J, r, w, 1e-6)[0])
    corr = pose - init
    corr_ok = (corr[:, 0].abs() < max_t) & (corr[:, 1].abs() < max_t) & (corr[:, 2].abs() < max_r)
    ok = (fraction >= min_fraction) & corr_ok & torch.isfinite(pose).all(-1)
    return pose, fraction, mse, cov, ok


def icp(src, src_valid, dst, dst_valid, init, iterations: int, max_corr2: float,
        min_fraction: float, max_t: float, max_r: float, sigma2: float):
    """K18: every iteration, the audit, the covariance and the gates of a
    batch of problems in one launch, a thread-block cluster of 16 CTAs a
    problem (the search split over the cluster's warps, the sums reduced
    through distributed shared memory)."""
    if src.device.type == "cpu":
        return icp_plain(src, src_valid, dst, dst_valid, init, iterations, max_corr2,
                         min_fraction, max_t, max_r, sigma2)
    dev, f32 = src.device, torch.float32
    B, M, _ = src.shape
    N = dst.shape[1]
    if not 2 <= N <= ICP_MAX_POINTS:
        raise ValueError(f"icp: {N} target points, the kernel takes 2..{ICP_MAX_POINTS}")
    ptrs = [_check("src", src, (B, M, 2), f32, dev),
            _check("src_valid", src_valid, (B, M), torch.bool, dev),
            _check("dst", dst, (B, N, 2), f32, dev),
            _check("dst_valid", dst_valid, (B, N), torch.bool, dev),
            _check("init", init, (B, 3), f32, dev)]
    lib = _build.load()
    pose = torch.empty(B, 3, dtype=f32, device=dev)
    fraction = torch.empty(B, dtype=f32, device=dev)
    mse = torch.empty(B, dtype=f32, device=dev)
    cov = torch.empty(B, 3, 3, dtype=f32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    err = lib.uz_icp(*ptrs, B, M, N, int(iterations), float(max_corr2), float(min_fraction),
                     float(max_t), float(max_r), float(sigma2), pose.data_ptr(),
                     fraction.data_ptr(), mse.data_ptr(), cov.data_ptr(), ok.data_ptr(),
                     _stream(dev))
    _raise_on(err, "icp")
    launches["icp"] += 1
    return pose, fraction, mse, cov, ok


# ---------------------------------------------------------------------------
# K19 merge_pairs (the node-merge pair search)
# ---------------------------------------------------------------------------

MERGE_MAX_NODES = 65535   # the 64-bit keys hold the flat index i·N + j in 32 bits
_DEG_PER_RAD = float(np.float32(180.0 / math.pi))   # jnp.degrees' float32 factor


def sqrt_f32(x):
    """Correctly rounded float32 square root (taken in float64: torch's
    float32 sqrt on the CPU is not always the correctly rounded one)."""
    return torch.sqrt(x.double()).to(torch.float32)


def sum_sq_fma(*xs):
    """x₀² + x₁² + ... as XLA on the CPU compiles a sum of squares: x₀·x₀,
    then one fused multiply-add per further term."""
    acc = xs[0] * xs[0]
    for x in xs[1:]:
        acc = fma_plain(x, x, acc)
    return acc


def merge_pair_gates_plain(ti, qi, tj, qj):
    """(dt, dr): translation distance and relative rotation angle in degrees
    of pose pairs (broadcasting ``t`` (..., 3) and ``q`` (..., 4)), in the
    reference's compiled form: ``quat_mul(conj(q_i), q_j)`` with each
    component a chain of fused multiply-adds, the norms as ``sum_sq_fma``
    with correctly rounded roots, ``degrees`` as · fl(180/π).  K19 repeats
    these operations one for one (the fused multiply-adds in float64)."""
    dt = sqrt_f32(sum_sq_fma(*(ti - tj).unbind(-1)))
    aw, ax, ay, az = qi[..., 0], -qi[..., 1], -qi[..., 2], -qi[..., 3]
    bw, bx, by, bz = qj.unbind(-1)
    f = fma_plain
    w = f(-az, bz, f(-ay, by, f(aw, bw, -(ax * bx))))
    x = f(-az, by, f(ay, bz, f(aw, bx, ax * bw)))
    y = f(az, bx, f(ay, bw, f(aw, by, -(ax * bz))))
    z = f(az, bw, f(-ay, bx, f(aw, bz, ax * by)))
    # rotation_angle = ‖quat_to_axis_angle(quat_normalize(·))‖
    n = sqrt_f32(torch.clamp(sum_sq_fma(w, x, y, z), min=1e-30))
    w, x, y, z = w / n, x / n, y / n, z / n
    neg = w < 0
    w, x, y, z = (torch.where(neg, -c, c) for c in (w, x, y, z))
    w = torch.clamp(w, -1.0, 1.0)
    vn = sqrt_f32(torch.clamp(sum_sq_fma(x, y, z), min=1e-30))
    small = vn < 1e-6
    one = torch.ones_like(w)
    scale = torch.where(small, 2.0 / torch.where(torch.abs(w) < 1e-12, one, w),
                        (2.0 * torch.atan2(vn, w)) / torch.where(small, one, vn))
    ang = sqrt_f32(torch.clamp(sum_sq_fma(scale * x, scale * y, scale * z), min=1e-30))
    return dt, ang * _DEG_PER_RAD


_MERGE_ROW_CHUNK = 1024   # rows of the N² score per pass of the plain version


def merge_pairs_plain(pose, stamp, eligible, dist_thresh: float, angle_thresh_deg: float,
                      max_pairs: int):
    """Plain version of K19, the reference's form: the N² score (dt where
    the pair is close, +inf elsewhere), then ``max_pairs`` rounds of a flat
    argmin (the first minimum: ties to the lower flat index) that mask both
    nodes' rows and columns, written by index.  Returns (keep, absorb, ok)."""
    n, dev = pose.shape[0], pose.device
    t, q = pose[:, :3], pose[:, 3:]
    score = torch.empty(n, n, dtype=torch.float32, device=dev)
    for r0 in range(0, n, _MERGE_ROW_CHUNK):
        r1 = min(r0 + _MERGE_ROW_CHUNK, n)
        dt, dr = merge_pair_gates_plain(t[r0:r1, None], q[r0:r1, None], t[None], q[None])
        close = ((dt < dist_thresh) & (dr < angle_thresh_deg) & eligible[r0:r1, None]
                 & eligible[None, :] & (stamp[r0:r1, None] < stamp[None, :]))
        score[r0:r1] = torch.where(close, dt, torch.inf)
    flat = score.view(-1)
    used = torch.zeros(n, dtype=torch.bool, device=dev)
    slots = torch.arange(n, device=dev)
    keep, absorb, oks = [], [], []
    for _ in range(max_pairs):
        best = torch.argmin(flat).view(1)
        i, j = best // n, best % n
        ok = torch.isfinite(flat.index_select(0, best)) & ~used[i] & ~used[j]
        used = used | (ok & ((slots == i) | (slots == j)))
        for s in (i, j):
            score.index_fill_(0, s, torch.inf)
            score.index_fill_(1, s, torch.inf)
        keep.append(i)
        absorb.append(j)
        oks.append(ok)
    return (torch.cat(keep).to(torch.int32), torch.cat(absorb).to(torch.int32), torch.cat(oks))


MERGE_FILTER_ULPS = 64   # s_hi above s*: the float32 sum of squares is a few ulps off


def _f32_bits(x) -> int:
    return int(np.array(x, np.float32).view(np.uint32))


def _bits_f32(b: int) -> float:
    return float(np.array(b, np.uint32).view(np.float32))


@functools.lru_cache(maxsize=64)
def merge_dist_bound(dist_thresh: float) -> tuple[float, float]:
    """(s*, s_hi) of the float32 threshold t = fl(dist_thresh): s* is the
    least float32 s >= +0 whose correctly rounded root reaches t, so that
    for every float32 s, fl(√s) < t exactly when s < s* (the rounded root
    is monotone); NaN for a NaN t, 0 for t <= 0.  s_hi lies
    MERGE_FILTER_ULPS ulps above s* (capped at +inf): K19's float32 bound
    on a pair's squared distance, which no pair with dt < t exceeds."""
    t = np.float32(dist_thresh)
    if np.isnan(t):
        return math.nan, math.nan
    if t <= 0:
        return 0.0, _bits_f32(MERGE_FILTER_ULPS)
    lo, hi = 0, 0x7F800000   # fl(√+inf) = +inf >= t: the answer lies in (lo, hi]
    while hi - lo > 1:
        mid = (lo + hi) // 2
        s = np.float64(_bits_f32(mid))
        if np.float32(np.sqrt(s)) >= t:
            hi = mid
        else:
            lo = mid
    return _bits_f32(hi), _bits_f32(min(hi + MERGE_FILTER_ULPS, 0x7F800000))


# kHistBins + kCoarseBins in csrc/merge_pairs.cu: the keys' top 16 and top 8 bits
MERGE_HIST_BINS = (1 << 16) + (1 << 8)


def merge_pairs_scratch(device) -> torch.Tensor:
    """K19's histograms of its keys' top 16 and top 8 bits and its arrival
    counter on ``device``: MERGE_HIST_BINS + 1 int32, 0 between calls (the
    kernel's last CTA puts them back), so K19's calls on a device must not
    overlap (they run on its current stream).  Made once a device."""
    key = str(device)
    t = _merge_scratch.get(key)
    if t is None:
        t = torch.zeros(MERGE_HIST_BINS + 1, dtype=torch.int32, device=device)
        _merge_scratch[key] = t
    return t


_merge_scratch: dict = {}


def merge_pairs(pose, stamp, eligible, dist_thresh: float, angle_thresh_deg: float,
                max_pairs: int):
    """K19, one launch: a warp per row i tests the stamps and a float32
    bound on the squared distance first, the exact gates only for the few
    pairs that pass, and keeps the row's 2·max_pairs - 1 smallest keys
    (float bits of dt << 32 | i·N + j), sorted; the last CTA to finish
    gathers the smallest keys (a histogram of their top 16 bits says how
    many fit its shared memory) and runs the greedy rounds over them.
    Returns (keep, absorb, ok)."""
    if pose.device.type == "cpu":
        return merge_pairs_plain(pose, stamp, eligible, dist_thresh, angle_thresh_deg, max_pairs)
    dev = pose.device
    n = pose.shape[0]
    if not 1 <= n <= MERGE_MAX_NODES:
        raise ValueError(f"merge_pairs: {n} nodes, the kernel takes 1..{MERGE_MAX_NODES} "
                         "(the flat index i·N + j must fit 32 bits)")
    if not 1 <= max_pairs <= 32:
        raise ValueError(f"merge_pairs: max_pairs = {max_pairs}, the kernel takes 1..32")
    ptrs = [_check("pose", pose, (n, 7), torch.float32, dev),
            _check("stamp", stamp, (n,), torch.float32, dev),
            _check("eligible", eligible, (n,), torch.bool, dev)]
    lib = _build.load()
    cand = torch.empty(n * (2 * max_pairs - 1), dtype=torch.int64, device=dev)   # the rows' keys
    out = torch.empty(2 * max_pairs + (max_pairs + 3) // 4, dtype=torch.int32, device=dev)
    keep, absorb = out[:max_pairs], out[max_pairs:2 * max_pairs]
    ok = out[2 * max_pairs:].view(torch.bool)[:max_pairs]
    _, s_hi = merge_dist_bound(float(dist_thresh))
    hist = merge_pairs_scratch(dev).data_ptr()
    err = lib.uz_merge_pairs(*ptrs, n, float(dist_thresh), s_hi, float(angle_thresh_deg),
                             max_pairs, cand.data_ptr(), hist, hist + 4 * MERGE_HIST_BINS,
                             keep.data_ptr(), absorb.data_ptr(), ok.data_ptr(), _stream(dev))
    _raise_on(err, "merge_pairs")
    launches["merge_pairs"] += 1
    return keep, absorb, ok


# ---------------------------------------------------------------------------
# K20 calib_gn (the calibration's Gauss-Newton steps)
# ---------------------------------------------------------------------------

CALIB_SENSORS = (1, 2)    # sensor counts the kernel is built for (6·S + 3 parameters)
CALIB_CLUSTER_CTAS = 16   # kCtas in csrc/calib_gn.cu: the one cluster's CTAs (above 8 non-portable)
CALIB_THREADS = 256       # kThreads in csrc/calib_gn.cu: a CTA's threads, its units a pass


def calib_scratch_ints(E: int) -> int:
    """K20's int32 scratch: each CTA's residual groups, their units, first
    units and constants (30·⌈E/CTAs⌉ + 1 a CTA: kScratchPerEdge in
    csrc/calib_gn.cu)."""
    ctas = CALIB_CLUSTER_CTAS
    return ctas * (30 * (-(-E // ctas)) + 1)


def calib_sqrt_prior(prior_weight: float) -> float:
    """√prior_weight as the reference takes it: the float32 square root of
    the float32 weight."""
    return float(np.sqrt(np.float32(prior_weight)))


def calib_residuals(theta, Xi, Xj, meas, is_sensor, is_odom, sf, st, L0, sqrt_prior: float):
    """The calibration's stacked residual vector (6E + 6E + 6S + 3,) at
    ``theta`` = [δL (6S), p (3)], as ``uzliti_slam_tpu/graph/calibration.py``
    forms it: sensor factors r = log(T_e⁻¹ · (X_i L_sf)⁻¹ (X_j L_st)) on
    ``is_sensor`` edges, drift-corrected odometry factors r = log((X_i⁻¹
    X_j)⁻¹ · warp(T_e, p)) on ``is_odom`` edges, the extrinsics' prior
    √w · δL and the drift parameters' 1e-2 · (p - [1, 0, 0])."""
    from uzliti_slam_tpu_torch.graph.calibration import odometry_drift_correct
    from uzliti_slam_tpu_torch.ops import lie

    S = L0.shape[0]
    L = lie.pose_retract(L0, theta[:6 * S].reshape(S, 6))
    p = theta[6 * S:]
    pred = lie.pose_relative(lie.pose_compose(Xi, L[sf.long()]), lie.pose_compose(Xj, L[st.long()]))
    r_sens = lie.se3_log(lie.pose_compose(lie.pose_inverse(meas), pred)) * is_sensor[:, None]
    r_odo = lie.se3_log(lie.pose_compose(lie.pose_inverse(lie.pose_relative(Xi, Xj)),
                                         odometry_drift_correct(meas, p))) * is_odom[:, None]
    nominal = (torch.arange(3, device=theta.device) == 0).to(theta.dtype)
    return torch.cat([r_sens.reshape(-1), r_odo.reshape(-1), sqrt_prior * theta[:6 * S],
                      1e-2 * (p - nominal)])


def calib_gn_plain(Xi, Xj, meas, is_sensor, is_odom, sf, st, L0, iterations: int,
                   prior_weight: float, damping: float):
    """Plain version of K20, the reference's steps: the residuals, their
    dense forward-mode Jacobian (``torch.func.jacfwd``, as ``jax.jacfwd``),
    JᵀJ + damping·I, Jᵀr, ``torch.linalg.solve``.  Returns (theta (6S+3,),
    cost history (iterations + 1,)), the cost ½‖r‖² at every iterate."""
    sp = calib_sqrt_prior(prior_weight)

    def res(th):
        return calib_residuals(th, Xi, Xj, meas, is_sensor, is_odom, sf, st, L0, sp)

    P = 6 * L0.shape[0] + 3
    theta = (torch.arange(P, device=Xi.device) == P - 3).to(torch.float32)   # [0, 1, 0, 0]
    eye = torch.eye(P, device=Xi.device)
    hist = []
    for _ in range(iterations):
        r = res(theta)
        hist.append(0.5 * torch.sum(r * r))
        J = torch.func.jacfwd(res)(theta)
        H = J.T @ J + damping * eye
        theta = theta - torch.linalg.solve(H, J.T @ r)
    r = res(theta)
    hist.append(0.5 * torch.sum(r * r))
    return theta, torch.stack(hist)


def calib_gn(Xi, Xj, meas, is_sensor, is_odom, sf, st, L0, iterations: int,
             prior_weight: float, damping: float):
    """K20, one launch: a thread-block cluster of CALIB_CLUSTER_CTAS CTAs
    runs every step.  A step: an edge pass
    over each CTA's residual groups, a lane per block of 3 tangents that can
    be nonzero for the group (each lane recomputes the value chain), JᵀJ,
    Jᵀr and ‖r‖² summed in float64 in a fixed order (a tile of Jacobian rows
    in shared memory, a thread an entry), the CTAs' sums reduced in the
    leader in rank order, the priors, the damping and a pivoted solve by a
    warp, θ read back by every CTA.  No host read.  Returns (theta, cost
    history)."""
    if Xi.device.type == "cpu":
        return calib_gn_plain(Xi, Xj, meas, is_sensor, is_odom, sf, st, L0, iterations,
                              prior_weight, damping)
    dev, f32 = Xi.device, torch.float32
    E, S = Xi.shape[0], L0.shape[0]
    if S not in CALIB_SENSORS:
        raise ValueError(f"calib_gn: {S} sensors, the kernel is built for {CALIB_SENSORS}")
    if iterations < 0:
        raise ValueError(f"calib_gn: {iterations} iterations")
    ptrs = [_check("Xi", Xi, (E, 7), f32, dev), _check("Xj", Xj, (E, 7), f32, dev),
            _check("meas", meas, (E, 7), f32, dev),
            _check("is_sensor", is_sensor, (E,), torch.bool, dev),
            _check("is_odom", is_odom, (E,), torch.bool, dev),
            _check("sf", sf, (E,), torch.int32, dev), _check("st", st, (E,), torch.int32, dev),
            _check("L0", L0, (S, 7), f32, dev)]
    lib = _build.load()
    P = 6 * S + 3
    scratch = torch.empty(calib_scratch_ints(E), dtype=torch.int32, device=dev)
    out = torch.empty(P + iterations + 1, dtype=f32, device=dev)
    theta, hist = out[:P], out[P:]
    err = lib.uz_calib_gn(*ptrs, E, S, int(iterations), calib_sqrt_prior(prior_weight),
                          float(damping), scratch.data_ptr(), theta.data_ptr(),
                          hist.data_ptr(), _stream(dev))
    _raise_on(err, "calib_gn")
    launches["calib_gn"] += 1
    return theta, hist


# ---------------------------------------------------------------------------
# K21-K24: the feature-set, repository and bag-of-words recognizers
# ---------------------------------------------------------------------------

_VOTE_NODE_CHUNK = 256   # nodes per pass of feature_votes_plain (bounds its memory)
_DESC_CHUNK = 8192       # descriptors per pass of the other plain versions


def largest_k(v: torch.Tensor, k: int):
    """The k largest entries of the last dimension and their indices, ties to
    the lower index, as XLA's ``top_k`` (a stable descending sort)."""
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _hamming(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    from uzliti_slam_tpu_torch.ops import matching

    return matching.hamming_matrix_packed(a, b)


def _topk_check(name: str, k: int, n: int) -> None:
    if not 0 < k <= n:
        raise ValueError(f"{name}: k = {k} of {n} entries")


def feature_votes_plain(query, qvalid, bank, bank_valid, stamp, valid, q_stamp, k: int,
                        thresh: float, min_sim: float, min_dt: float):
    """Plain version of K21, ``recognizer.feature_set_query`` of the JAX
    package: for each node, the query descriptors (``query`` (Fq, 32),
    ``qvalid``) whose nearest valid stored descriptor (``bank`` (N, Fb, 32),
    ``bank_valid`` (N, Fb)) lies within Hamming ``thresh``; sim = votes /
    max(#valid queries, 1) in float32, -1 where the node is not ``valid`` or
    lies within ``min_dt`` of ``q_stamp``; the k largest, ties to the lower
    slot.  Chunked over nodes.  Returns (slots (k,) int32, sims (k,)
    float32, ok (k,): sim >= min_sim)."""
    N = bank.shape[0]
    votes = []
    for s in range(0, N, _VOTE_NODE_CHUNK):
        d = _hamming(query, bank[s:s + _VOTE_NODE_CHUNK])              # (c, Fq, Fb)
        d = torch.where(bank_valid[s:s + _VOTE_NODE_CHUNK, None, :], d, torch.inf)
        votes.append(((d.amin(-1) <= thresh) & qvalid).sum(-1))
    nq = torch.clamp(qvalid.sum(), min=1)
    sim = torch.cat(votes).to(torch.float32) / nq.to(torch.float32)
    eligible = valid & (torch.abs(stamp - q_stamp) >= min_dt)
    top, idx = largest_k(torch.where(eligible, sim, -1.0), k)
    return idx.to(torch.int32), top, top >= min_sim


def hamming_by_and(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The identity K21 and K22 compute their distances by on the tensor
    cores: popc(a) + popc(b) - 2·popc(a & b), for packed descriptors a (Na,
    32) and b (Nb, 32) uint8 -> (Na, Nb) int32, equal to the popcount of a
    XOR b."""
    table = torch.tensor([bin(v).count("1") for v in range(256)], dtype=torch.int32,
                         device=a.device)
    pa, pb = table[a.long()].sum(-1), table[b.long()].sum(-1)
    both = table[(a[:, None, :] & b[None, :, :]).long()].sum(-1)
    return pa[:, None] + pb[None, :] - 2 * both


# the first bytes of K21's and K22's scratch hold the last-CTA ticket; the
# sims, keys or votes start here (kScratchSims / kScratchData in csrc)
RECOGNITION_SCRATCH_DATA = 16

_recognition_scratch: dict = {}


def recognition_scratch(device, entry: str, nbytes: int) -> torch.Tensor:
    """The device scratch of K21's or K22's ``entry`` ("feature_votes",
    "repo_nearest", "repo_votes") on ``device``, at least ``nbytes``: made
    once a device and entry, zero-filled, and grown by reallocation (zero-
    filled, to the next power of two) when a larger call arrives.  Its
    ticket, keys and votes are zero between calls (each launch's last CTA
    puts them back), so an entry's calls on a device must not overlap (they
    run on its current stream)."""
    key = (entry, device)
    t = _recognition_scratch.get(key)
    if t is None or t.numel() < nbytes:
        t = torch.zeros(1 << max(6, (nbytes - 1).bit_length()), dtype=torch.uint8, device=device)
        _recognition_scratch[key] = t
    return t


def feature_votes(query, qvalid, bank, bank_valid, stamp, valid, q_stamp, k: int,
                  thresh: float, min_sim: float, min_dt: float):
    """K21, one launch a query: the CTAs the card holds claim nodes from a
    device counter a batch at a time, an ineligible node skipped before any
    byte of it is read, eligible nodes' descriptors brought in by cp.async a
    stage at a time (whole nodes where two or more fit) with the next stage
    in flight; each warp's strips of 16
    queries against them on the tensor cores (a b1 mma with AND + popcount
    a 16 x 8 tile, d = popc(a) + popc(b) - 2·popc(a & b)), a strip stopping
    once every valid query has hit; the votes counted as integers; the last
    CTA's top-k over the sims in one pass.  The sims, the ticket and the
    counter live in ``recognition_scratch``."""
    if query.device.type == "cpu":
        return feature_votes_plain(query, qvalid, bank, bank_valid, stamp, valid, q_stamp, k,
                                   thresh, min_sim, min_dt)
    dev, u8 = query.device, torch.uint8
    Fq, (N, Fb, _) = query.shape[0], bank.shape
    _topk_check("feature_votes", k, N)
    ptrs = [_check("query", query, (Fq, 32), u8, dev),
            _check("qvalid", qvalid, (Fq,), torch.bool, dev),
            _check("bank", bank, (N, Fb, 32), u8, dev),
            _check("bank_valid", bank_valid, (N, Fb), torch.bool, dev),
            _check("stamp", stamp, (N,), torch.float32, dev),
            _check("valid", valid, (N,), torch.bool, dev),
            _check("q_stamp", q_stamp, (), torch.float32, dev)]
    _check_aligned("query", query)
    _check_aligned("bank", bank)
    lib = _build.load()
    scratch = recognition_scratch(dev, "feature_votes", RECOGNITION_SCRATCH_DATA + 4 * N)
    slots = torch.empty(k, dtype=torch.int32, device=dev)
    top = torch.empty(k, dtype=torch.float32, device=dev)
    ok = torch.empty(k, dtype=torch.bool, device=dev)
    err = lib.uz_feature_votes(*ptrs, Fq, Fb, N, k, float(thresh), float(min_sim), float(min_dt),
                               scratch.data_ptr(), slots.data_ptr(), top.data_ptr(), ok.data_ptr(),
                               _stream(dev))
    _raise_on(err, "feature_votes")
    launches["feature_votes"] += 1
    return slots, top, ok


def _masked_hamming_chunks(query, bank, bank_valid):
    """(start, (F, c) distances with +inf where the stored descriptor is not
    valid) over chunks of ``bank``."""
    for s in range(0, bank.shape[0], _DESC_CHUNK):
        d = _hamming(query, bank[s:s + _DESC_CHUNK])
        yield s, torch.where(bank_valid[None, s:s + _DESC_CHUNK], d, torch.inf)


def repo_nearest_plain(query, qvalid, bank, bank_valid, thresh: float):
    """Plain version of K22's first entry, the search of
    ``recognizer.repository_add``: each query's nearest valid descriptor of
    ``bank`` (D, 32) (the first index among equals; +inf and index 0 where
    none is valid), and the in-frame duplicates: query i has a valid
    earlier query j < i within Hamming ``thresh``.  Returns (nn_dist (F,)
    float32, nn_idx (F,) int32, dup (F,) bool)."""
    F, dev = query.shape[0], query.device
    best = torch.full((F,), torch.inf, device=dev)
    arg = torch.zeros(F, dtype=torch.int64, device=dev)
    for s, d in _masked_hamming_chunks(query, bank, bank_valid):
        i = torch.argmin(d, dim=-1)                       # the first minimum
        v = torch.gather(d, 1, i[:, None])[:, 0]
        better = v < best                                 # earlier chunks keep ties
        best, arg = torch.where(better, v, best), torch.where(better, i + s, arg)
    order = torch.arange(F, device=dev)
    earlier = ((_hamming(query, query) <= thresh) & qvalid[None, :]
               & (order[None, :] < order[:, None]))
    return best, arg.to(torch.int32), earlier.any(-1)


def repo_nearest(query, qvalid, bank, bank_valid, thresh: float):
    """K22's search, one launch: a CTA per tile of stored descriptors (64
    at the step's D = 16,384: 256 CTAs), the next tile's cp.async in
    flight; warps' strips of 16 queries against it on the tensor cores,
    each query's smallest (distance << 32 | index) key kept in shared memory
    and merged across CTAs by one 64-bit ``atomicMax`` of its complement
    (the first index among equal distances); the last CTA decodes and
    resets the keys and runs the F x F duplicate test on the same mma.  The
    keys and the ticket live in ``recognition_scratch``."""
    if query.device.type == "cpu":
        return repo_nearest_plain(query, qvalid, bank, bank_valid, thresh)
    dev, u8 = query.device, torch.uint8
    F, D = query.shape[0], bank.shape[0]
    ptrs = [_check("query", query, (F, 32), u8, dev),
            _check("qvalid", qvalid, (F,), torch.bool, dev),
            _check("bank", bank, (D, 32), u8, dev),
            _check("bank_valid", bank_valid, (D,), torch.bool, dev)]
    _check_aligned("query", query)
    _check_aligned("bank", bank)
    lib = _build.load()
    scratch = recognition_scratch(dev, "repo_nearest", RECOGNITION_SCRATCH_DATA + 8 * F)
    nn_dist = torch.empty(F, dtype=torch.float32, device=dev)
    nn_idx = torch.empty(F, dtype=torch.int32, device=dev)
    dup = torch.empty(F, dtype=torch.bool, device=dev)
    err = lib.uz_repo_nearest(*ptrs, F, D, float(thresh), scratch.data_ptr(), nn_dist.data_ptr(),
                              nn_idx.data_ptr(), dup.data_ptr(), _stream(dev))
    _raise_on(err, "repository")
    launches["repository"] += 1
    return nn_dist, nn_idx, dup


def repo_votes_plain(query, qvalid, bank, bank_valid, links, link_valid, node_stamp, node_valid,
                     q_stamp, k: int, thresh: float, min_votes: float, min_dt: float):
    """Plain version of K22's second entry, ``recognizer.repository_query``:
    the stored descriptors that any valid query hits within Hamming
    ``thresh``, votes per node over their valid links (``links``,
    ``link_valid`` (D, L)), -1 where the node is not valid or lies within
    ``min_dt`` of ``q_stamp``, the k largest, ties to the lower slot.
    Returns (slots (k,) int32, votes (k,) int32, ok (k,): votes >=
    min_votes)."""
    hit = torch.cat([((d <= thresh) & qvalid[:, None]).any(0)
                     for _, d in _masked_hamming_chunks(query, bank, bank_valid)])
    n = node_stamp.shape[0]
    contrib = (hit[:, None] & link_valid).to(torch.int32).reshape(-1)
    seg = torch.where(link_valid, links, n).reshape(-1).long()
    votes = torch.zeros(n + 1, dtype=torch.int32, device=query.device).index_add_(
        0, seg, contrib)[:n]
    eligible = node_valid & (torch.abs(node_stamp - q_stamp) >= min_dt)
    top, idx = largest_k(torch.where(eligible, votes, -1), k)
    return idx.to(torch.int32), top, top >= min_votes


def repo_votes(query, qvalid, bank, bank_valid, links, link_valid, node_stamp, node_valid,
               q_stamp, k: int, thresh: float, min_votes: float, min_dt: float):
    """K22's query, one launch: an ineligible node's count started far
    below 0 (the gates first); warps' strips of 16 stored descriptors
    against the queries on the tensor cores, a strip stopping once every
    valid descriptor has hit; a hit adds its valid links' votes by integer
    ``atomicAdd`` (exact in any order); the last CTA's top-k in one pass (a
    negative count -1), which zeroes the counts after it.  The votes and
    the ticket live in ``recognition_scratch``."""
    if query.device.type == "cpu":
        return repo_votes_plain(query, qvalid, bank, bank_valid, links, link_valid, node_stamp,
                                node_valid, q_stamp, k, thresh, min_votes, min_dt)
    dev, u8 = query.device, torch.uint8
    F, (D, L), N = query.shape[0], links.shape, node_stamp.shape[0]
    _topk_check("repo_votes", k, N)
    ptrs = [_check("query", query, (F, 32), u8, dev),
            _check("qvalid", qvalid, (F,), torch.bool, dev),
            _check("bank", bank, (D, 32), u8, dev),
            _check("bank_valid", bank_valid, (D,), torch.bool, dev),
            _check("links", links, (D, L), torch.int32, dev),
            _check("link_valid", link_valid, (D, L), torch.bool, dev),
            _check("node_stamp", node_stamp, (N,), torch.float32, dev),
            _check("node_valid", node_valid, (N,), torch.bool, dev),
            _check("q_stamp", q_stamp, (), torch.float32, dev)]
    _check_aligned("query", query)
    _check_aligned("bank", bank)
    lib = _build.load()
    scratch = recognition_scratch(dev, "repo_votes", RECOGNITION_SCRATCH_DATA + 4 * N)
    slots = torch.empty(k, dtype=torch.int32, device=dev)
    top = torch.empty(k, dtype=torch.int32, device=dev)
    ok = torch.empty(k, dtype=torch.bool, device=dev)
    err = lib.uz_repo_votes(*ptrs, F, D, L, N, k, float(thresh), float(min_votes), float(min_dt),
                            scratch.data_ptr(), slots.data_ptr(), top.data_ptr(), ok.data_ptr(),
                            _stream(dev))
    _raise_on(err, "repository")
    launches["repository"] += 1
    return slots, top, ok


def word_assign_plain(desc, valid, centers):
    """Plain version of K23's first entry (``vocabulary.quantize`` and each
    k-majority round of ``build_vocabulary``): each descriptor's nearest
    word among ``centers`` (K, 32) by Hamming distance, the first among
    equals, whatever its validity, and the term histogram of the valid
    ones.  Returns (word (M,) int32, dist (M,) int32, hist (K,) int32)."""
    words, dists = [], []
    for s in range(0, desc.shape[0], _DESC_CHUNK):
        d = _hamming(desc[s:s + _DESC_CHUNK], centers)
        w = torch.argmin(d, dim=-1)                       # the first minimum
        words.append(w)
        dists.append(torch.gather(d, 1, w[:, None])[:, 0])
    word = torch.cat(words)
    hist = torch.zeros(centers.shape[0], dtype=torch.int32, device=desc.device).index_add_(
        0, word[valid], torch.ones_like(word[valid], dtype=torch.int32))
    return word.to(torch.int32), torch.cat(dists).to(torch.int32), hist


def word_assign(desc, valid, centers):
    """K23's assignment: a thread per descriptor against the K packed words
    in shared memory (strict '<' in word order: the first among equals), the
    histogram by integer ``atomicAdd``."""
    if desc.device.type == "cpu":
        return word_assign_plain(desc, valid, centers)
    dev, u8 = desc.device, torch.uint8
    M, K = desc.shape[0], centers.shape[0]
    _smem_check("word_assign", 32 * K)
    ptrs = [_check("desc", desc, (M, 32), u8, dev), _check("valid", valid, (M,), torch.bool, dev),
            _check("centers", centers, (K, 32), u8, dev)]
    lib = _build.load()
    word = torch.empty(M, dtype=torch.int32, device=dev)
    dist = torch.empty(M, dtype=torch.int32, device=dev)
    hist = torch.zeros(K, dtype=torch.int32, device=dev)
    err = lib.uz_word_assign(*ptrs, M, K, word.data_ptr(), dist.data_ptr(), hist.data_ptr(),
                             _stream(dev))
    _raise_on(err, "bow_words")
    launches["bow_words"] += 1
    return word, dist, hist


def word_majority_plain(desc, valid, word, counts):
    """Plain version of K23's second entry, the k-majority update of
    ``build_vocabulary``: per word, the number of its valid members with
    each bit set; a bit of the new centre is set where that number exceeds
    half the word's member count ``counts`` (K,) (``sums > 0.5 · counts``,
    exact in integers).  Returns the centres (K, 32) uint8; a word without
    members gets zeros."""
    from uzliti_slam_tpu_torch.ops import matching

    K = counts.shape[0]
    sums = torch.zeros(K, 256, dtype=torch.int32, device=desc.device)
    for s in range(0, desc.shape[0], _DESC_CHUNK):
        v = valid[s:s + _DESC_CHUNK]
        bits = matching.unpack_bits(desc[s:s + _DESC_CHUNK][v]).to(torch.int32)
        sums.index_add_(0, word[s:s + _DESC_CHUNK][v].long(), bits)
    return matching.pack_bits(2 * sums > counts[:, None])


def word_majority(desc, valid, word, counts):
    """K23's update: a thread per valid descriptor adds its set bits to its
    word's counters (integer ``atomicAdd``), then a thread per centre byte
    takes the majority."""
    if desc.device.type == "cpu":
        return word_majority_plain(desc, valid, word, counts)
    dev, u8 = desc.device, torch.uint8
    M, K = desc.shape[0], counts.shape[0]
    ptrs = [_check("desc", desc, (M, 32), u8, dev), _check("valid", valid, (M,), torch.bool, dev),
            _check("word", word, (M,), torch.int32, dev),
            _check("counts", counts, (K,), torch.int32, dev)]
    lib = _build.load()
    sums = torch.zeros(K, 256, dtype=torch.int32, device=dev)
    centers = torch.empty(K, 32, dtype=u8, device=dev)
    err = lib.uz_word_majority(*ptrs, M, K, sums.data_ptr(), centers.data_ptr(), _stream(dev))
    _raise_on(err, "bow_words")
    launches["bow_words"] += 1
    return centers


def bow_scores_plain(bank, stamp, valid, q, q_stamp, min_dt: float):
    """The gated scores of ``bow_query_plain``: (N,) float32."""
    s = 1.0 - 0.5 * torch.sum(torch.abs(bank - q[None]), dim=-1)
    eligible = (valid & (torch.sum(torch.abs(bank), dim=-1) > 1e-9)
                & (torch.sum(torch.abs(q)) > 1e-9) & (torch.abs(stamp - q_stamp) >= min_dt))
    return torch.where(eligible, s, -1.0)


def bow_query_plain(bank, stamp, valid, q, q_stamp, k: int, min_score: float, min_dt: float):
    """Plain version of K24, ``vocabulary.bow_query`` with ``bow_score``:
    1 - ½‖v_n - q‖₁ for every row of ``bank`` (N, K), -1 where the row is
    not valid, is zero (Σ|v_n| <= 1e-9), the query is zero, or the row lies
    within ``min_dt`` of ``q_stamp``; the k largest, ties to the lower slot.
    Returns (slots (k,) int32, scores (k,) float32, ok (k,): score >=
    min_score)."""
    top, idx = largest_k(bow_scores_plain(bank, stamp, valid, q, q_stamp, min_dt), k)
    return idx.to(torch.int32), top, top >= min_score


def bow_query(bank, stamp, valid, q, q_stamp, k: int, min_score: float, min_dt: float):
    """K24: a warp per bank row sums |v - q| and |v| over the K words in a
    fixed lane order and a fixed shuffle tree, applies the gates; then a
    one-CTA top-k over the scores."""
    if bank.device.type == "cpu":
        return bow_query_plain(bank, stamp, valid, q, q_stamp, k, min_score, min_dt)
    dev, f32 = bank.device, torch.float32
    N, K = bank.shape
    _topk_check("bow_query", k, N)
    _smem_check("bow_query", 4 * K)
    ptrs = [_check("bank", bank, (N, K), f32, dev), _check("stamp", stamp, (N,), f32, dev),
            _check("valid", valid, (N,), torch.bool, dev), _check("q", q, (K,), f32, dev),
            _check("q_stamp", q_stamp, (), f32, dev)]
    lib = _build.load()
    scores = torch.empty(N, dtype=f32, device=dev)
    slots = torch.empty(k, dtype=torch.int32, device=dev)
    top = torch.empty(k, dtype=f32, device=dev)
    ok = torch.empty(k, dtype=torch.bool, device=dev)
    err = lib.uz_bow_query(*ptrs, N, K, k, float(min_score), float(min_dt), scores.data_ptr(),
                           slots.data_ptr(), top.data_ptr(), ok.data_ptr(), _stream(dev))
    _raise_on(err, "bow_query")
    launches["bow_query"] += 1
    return slots, top, ok


# ---------------------------------------------------------------------------
# K25 voxel_grid (the gicp estimator's voxel cloud)
# ---------------------------------------------------------------------------

VOXEL_PRIMES = (73856093, 19349663, 83492791)
VOXEL_EMPTY = 0xFFFFFFFF      # the id of an invalid point, and the padding of the kept ids
VOXEL_FIXED = 2.0 ** 28       # fixed-point scale of the voxel sums (kFixed in csrc/voxel_grid.cu)
VOXEL_CHUNK = 4096            # points one CTA sorts (kChunk)
VOXEL_MAX_OUT = 2048          # voxels the kernel keeps at most (60 B of shared memory each)


def voxel_ids_plain(points, valid, inv_voxel: float):
    """The reference's spatial-hash voxel ids as int64 holding the uint32
    value: floor(p · inv_voxel) as int32 (XLA compiles the division by the
    voxel size into a multiplication by its float32 reciprocal), + 32768
    as uint32, times the three primes with wrap-around, XOR; 0xFFFFFFFF at
    invalid points."""
    q = torch.floor(points * inv_voxel).to(torch.int32).to(torch.int64)
    qq = (q + 32768) & 0xFFFFFFFF
    ids = [(qq[..., a] * p) & 0xFFFFFFFF for a, p in enumerate(VOXEL_PRIMES)]
    return torch.where(valid, ids[0] ^ ids[1] ^ ids[2], VOXEL_EMPTY)


def voxel_grid_plain(points, lab, valid, inv_voxel: float, max_out: int):
    """Plain version of K25 (``uzliti_slam_tpu/ops/gicp.py:voxel_downsample``):
    the ``max_out`` smallest distinct ids ascending (0xFFFFFFFF padding),
    each point's slot by a left binary search (clipped to the last slot), a
    hit where the slot holds the point's id and the point is valid, and the
    hits' (x, y, z, L, a, b) summed per slot in fixed point (round(v ·
    2²⁸) in int64: exact, so the order of the sums does not matter), the
    means in float64 rounded to float32.  A non-finite coordinate of any
    point makes its slot's coordinate NaN, as the reference's ``p · 0``
    sum does.  Returns (points (V, 3), lab (V, 3), valid (V,))."""
    ids = voxel_ids_plain(points, valid, inv_voxel)
    kept = torch.unique(ids)[:max_out]
    uids = torch.full((max_out,), VOXEL_EMPTY, dtype=torch.int64, device=points.device)
    uids[:kept.shape[0]] = kept
    slot = torch.clamp(torch.searchsorted(uids, ids), max=max_out - 1)
    hit = (uids[slot] == ids) & valid
    vals = torch.cat([points, lab], dim=-1)
    finite = torch.isfinite(vals)
    fixed = torch.where(hit[:, None] & finite, torch.round(vals.double() * VOXEL_FIXED), 0.0)
    sums = torch.zeros(max_out, 6, dtype=torch.int64, device=points.device).index_add_(
        0, slot, fixed.to(torch.int64))
    cnt = torch.zeros(max_out, dtype=torch.int64, device=points.device).index_add_(
        0, slot, hit.to(torch.int64))
    poison = torch.zeros(max_out, 6, dtype=torch.int64, device=points.device).index_add_(
        0, slot, (~finite).to(torch.int64)) > 0
    mean = (sums.double() / VOXEL_FIXED) / torch.clamp(cnt, min=1).double()[:, None]
    mean = torch.where(poison, math.nan, mean).to(torch.float32)
    return (mean[:, :3].contiguous(), mean[:, 3:].contiguous(),
            (cnt > 0) & (uids != VOXEL_EMPTY))


def voxel_grid(points, lab, valid, inv_voxel: float, max_out: int):
    """K25: each CTA sorts a chunk's ids in shared memory and keeps its
    ``max_out`` smallest distinct; a tree of pairwise merges keeps the
    smallest ``max_out`` of all; each point binary-searches its slot and adds
    into shared-memory fixed-point sums, flushed by integer atomics."""
    if points.device.type == "cpu":
        return voxel_grid_plain(points, lab, valid, inv_voxel, max_out)
    dev, f32, i32 = points.device, torch.float32, torch.int32
    N = points.shape[0]
    if not 0 < max_out <= VOXEL_MAX_OUT:
        raise ValueError(f"voxel_grid: max_out = {max_out}, the kernel keeps 1..{VOXEL_MAX_OUT}")
    _smem_check("voxel_grid", 60 * max_out)
    ptrs = [_check("points", points, (N, 3), f32, dev), _check("lab", lab, (N, 3), f32, dev),
            _check("valid", valid, (N,), torch.bool, dev)]
    lib = _build.load()
    n_chunks = max(1, -(-N // VOXEL_CHUNK))
    ids = torch.empty(max(N, 1), dtype=i32, device=dev)
    lists = torch.empty(2, n_chunks, max_out, dtype=i32, device=dev)
    sums = torch.empty(max_out, 6, dtype=torch.int64, device=dev)
    counts = torch.empty(2, max_out, dtype=i32, device=dev)    # hits, poison bits
    out_pts = torch.empty(max_out, 3, dtype=f32, device=dev)
    out_lab = torch.empty(max_out, 3, dtype=f32, device=dev)
    out_valid = torch.empty(max_out, dtype=torch.bool, device=dev)
    err = lib.uz_voxel_grid(*ptrs, N, float(inv_voxel), max_out, ids.data_ptr(),
                            lists.data_ptr(), sums.data_ptr(), counts.data_ptr(),
                            out_pts.data_ptr(), out_lab.data_ptr(), out_valid.data_ptr(),
                            _stream(dev))
    _raise_on(err, "voxel_grid")
    launches["voxel_grid"] += 1
    return out_pts, out_lab, out_valid


# ---------------------------------------------------------------------------
# K26 knn_normals (the gicp estimator's k-NN PCA normals)
# ---------------------------------------------------------------------------

KNN_K = 8            # neighbours (kK in csrc/gicp.cu)
JACOBI_SWEEPS = 8    # cyclic Jacobi sweeps of the 3x3 covariance (kEighSweeps)
KNN_MAX_POINTS = 4096


def jacobi_eigh3_plain(A, sweeps: int = JACOBI_SWEEPS):
    """Eigen-decomposition of symmetric (..., 3, 3) matrices by cyclic
    Jacobi, pairs (0, 1), (0, 2), (1, 2), a fixed number of sweeps, with
    K26's arithmetic: t = sgn(θ)/(|θ| + √(θ² + 1)), θ = (a_qq − a_pp)/(2
    a_pq), no rotation where a_pq = 0.  Returns (eigenvalues (..., 3)
    unsorted, eigenvectors (..., 3, 3) as columns)."""
    a = {(i, j): A[..., i, j] for i in range(3) for j in range(i, 3)}
    one, zero = torch.ones_like(a[0, 0]), torch.zeros_like(a[0, 0])
    v = [[one if i == j else zero for j in range(3)] for i in range(3)]

    def key(i, j):
        return (i, j) if i <= j else (j, i)

    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            r = 3 - p - q
            apq, app, aqq = a[p, q], a[p, p], a[q, q]
            rot = apq != 0
            theta = (aqq - app) / (2.0 * torch.where(rot, apq, one))
            t = torch.where(theta >= 0, one, -one) / (theta.abs() + torch.sqrt(theta * theta + 1.0))
            t = torch.where(rot, t, zero)
            c = 1.0 / torch.sqrt(t * t + 1.0)
            s = t * c
            arp, arq = a[key(r, p)], a[key(r, q)]
            a[p, p], a[q, q], a[p, q] = app - t * apq, aqq + t * apq, torch.where(rot, zero, apq)
            a[key(r, p)], a[key(r, q)] = c * arp - s * arq, s * arp + c * arq
            for i in range(3):
                vp, vq = v[i][p], v[i][q]
                v[i][p], v[i][q] = c * vp - s * vq, s * vp + c * vq
    vals = torch.stack([a[0, 0], a[1, 1], a[2, 2]], dim=-1)
    vecs = torch.stack([torch.stack(row, dim=-1) for row in v], dim=-2)
    return vals, vecs


def knn_covariance_plain(points, valid, k: int = KNN_K):
    """The k-NN covariances (B, M, 3, 3) of K26's plain version: squared
    distances as XLA compiles them (fma(z, z, fma(y, y, x·x))), +inf at
    invalid points, the k nearest (ties to the lower index), their weighted
    mean and covariance summed in neighbour order, + 1e-9·I."""
    d = points[..., :, None, :] - points[..., None, :, :]
    d2 = sum_sq_fma(d[..., 0], d[..., 1], d[..., 2])
    d2 = torch.where(valid[..., None, :], d2, torch.inf)
    vals, idx = smallest_k(d2, k)
    wn = torch.isfinite(vals).to(points.dtype)
    B, M = idx.shape[:2]
    neigh = torch.gather(points, 1, idx.reshape(B, M * k, 1).expand(B, M * k, 3)).reshape(
        B, M, k, 3)
    s, n = torch.zeros_like(points), torch.zeros_like(wn[..., 0])
    for j in range(k):
        s = s + neigh[..., j, :] * wn[..., j, None]
        n = n + wn[..., j]
    mu = s / torch.clamp(n, min=1.0)[..., None]
    c = (neigh - mu[..., None, :]) * wn[..., None]
    cov = torch.zeros(B, M, 3, 3, dtype=points.dtype, device=points.device)
    for j in range(k):
        cov = cov + c[..., j, :, None] * c[..., j, None, :]
    return cov + 1e-9 * torch.eye(3, dtype=points.dtype, device=points.device)


def knn_normals_plain(points, valid, k: int = KNN_K):
    """Plain version of K26 (``uzliti_slam_tpu/ops/gicp.py:estimate_normals``)
    on (B, M, 3) clouds: ``knn_covariance_plain``'s covariances and the
    eigenvector of the smallest eigenvalue by ``jacobi_eigh3_plain`` (the
    first on a tie)."""
    cov = knn_covariance_plain(points, valid, k)
    B, M = cov.shape[:2]
    ev, vecs = jacobi_eigh3_plain(cov)
    low = torch.argmin(ev, dim=-1)
    return torch.gather(vecs, -1, low[..., None, None].expand(B, M, 3, 1))[..., 0]


def knn_normals(points, valid, k: int = KNN_K):
    """K26: one thread per point with its problem's cloud in shared memory,
    a running top-k in registers, the covariance and a cyclic Jacobi in
    float32; every problem of the batch in one launch."""
    if points.shape[-2] < k:
        raise ValueError(f"knn_normals: {points.shape[-2]} points, k = {k} neighbours")
    if points.device.type == "cpu":
        return knn_normals_plain(points, valid, k)
    dev, f32 = points.device, torch.float32
    B, M, _ = points.shape
    if k != KNN_K:
        raise ValueError(f"knn_normals: k = {k}, the kernel is built for {KNN_K}")
    if not 0 < M <= KNN_MAX_POINTS:
        raise ValueError(f"knn_normals: {M} points, the kernel takes 1..{KNN_MAX_POINTS}")
    _smem_check("knn_normals", 16 * M)
    ptrs = [_check("points", points, (B, M, 3), f32, dev),
            _check("valid", valid, (B, M), torch.bool, dev)]
    lib = _build.load()
    normals = torch.empty(B, M, 3, dtype=f32, device=dev)
    err = lib.uz_knn_normals(*ptrs, B, M, normals.data_ptr(), _stream(dev))
    _raise_on(err, "knn_normals")
    launches["knn_normals"] += 1
    return normals


# ---------------------------------------------------------------------------
# K27 gicp (the 6-D colored ICP, every iteration in one launch)
# ---------------------------------------------------------------------------

GICP_MAX_POINTS = 2048   # target points a CTA holds (48 bytes each: kMaxTargets in csrc/gicp.cu)


def argmin_key_plain(d):
    """The high word of K27's 64-bit merge key of distances d: 0 for a NaN,
    else d in unsigned total order (−0 as +0) plus 1, as int64.  With the
    index as the low word, an unsigned minimum over a row's keys is the
    first NaN, else the first smallest entry: ``first_argmin_plain``."""
    d = torch.where(d == 0, 0.0, d).to(torch.float32).contiguous()
    u = d.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    return torch.where(torch.isnan(d), 0, u + 1)


def first_argmin_plain(d):
    """The index K27's key rule picks in each row of d (..., N): the least
    (``argmin_key_plain``, index) pair, i.e. ``torch.argmin``'s choice."""
    return torch.argmin(argmin_key_plain(d), dim=-1)


def _gicp_pairs(moved, dst):
    d = moved[..., :, None, :] - dst[..., None, :, :]
    return sum_sq_fma(d[..., 0], d[..., 1], d[..., 2])


def gicp_first_matches_plain(src, src_lab, dst, dst_lab, dst_valid, init, color_weight: float):
    """Each source point's target in gicp_plain's first iteration (B, M):
    the first argmin of fma(w, d_Lab, d_xyz) over the valid targets at the
    initial poses, +inf at the others."""
    from uzliti_slam_tpu_torch.ops import lie

    B = dst.shape[0]
    d_col = _gicp_pairs(src_lab[None].expand(B, -1, -1), dst_lab)
    moved = lie.pose_apply(init[:, None], src[None])
    d6 = fma_plain(torch.full_like(d_col, color_weight), d_col, _gicp_pairs(moved, dst))
    return torch.argmin(torch.where(dst_valid[:, None, :], d6, torch.inf), dim=-1).to(torch.int32)


def gicp_plain(src, src_lab, src_valid, dst, dst_lab, dst_valid, normals, init, iterations: int,
               max_corr2: float, color_weight: float, min_fraction: float, max_t: float,
               max_r: float):
    """Plain version of K27 (``uzliti_slam_tpu/ops/gicp.py:gicp_6d`` after
    its normals): one source cloud (M, 3) against B target clouds (B, N, 3)
    from poses init (B, 7).  Per iteration the 6-D distance as XLA compiles
    it (fma(w, d_Lab, d_xyz), each a chain of fused multiply-adds), the
    first argmin over valid targets, point-to-plane rows weighted by the
    source's validity and max_corr2, JᵀJ + 1e-6·I, the pivoted solve, the
    left update exp(-dx) ∘ pose; then the nearest-target audit, fraction,
    mse and the gates.  Returns (pose (B, 7), fraction (B,), mse (B,), ok
    (B,))."""
    from uzliti_slam_tpu_torch.ops import lie

    B = dst.shape[0]
    d_col = _gicp_pairs(src_lab[None].expand(B, -1, -1), dst_lab)
    eye = torch.eye(6, dtype=src.dtype, device=src.device)
    pose = init
    for _ in range(iterations):
        moved = lie.pose_apply(pose[:, None], src[None])
        d6 = fma_plain(torch.full_like(d_col, color_weight), d_col, _gicp_pairs(moved, dst))
        j = torch.argmin(torch.where(dst_valid[:, None, :], d6, torch.inf), dim=-1)
        pick = j[..., None].expand(j.shape + (3,))
        p, nrm = torch.gather(dst, 1, pick), torch.gather(normals, 1, pick)
        e = moved - p
        geo = sum_sq_fma(e[..., 0], e[..., 1], e[..., 2])
        w = (src_valid[None] & (geo < max_corr2)).to(src.dtype)
        r = torch.sum(e * nrm, dim=-1)
        J = torch.cat([nrm, torch.cross(moved, nrm, dim=-1)], dim=-1)
        H = torch.sum(J[..., :, None] * J[..., None, :] * w[..., None, None], dim=1) + 1e-6 * eye
        b = torch.sum(J * (r * w)[..., None], dim=1)
        pose = lie.pose_compose(lie.se3_exp(-lu_solve_plain(H, b)), pose)
    moved = lie.pose_apply(pose[:, None], src[None])
    nn = torch.where(dst_valid[:, None, :], _gicp_pairs(moved, dst), torch.inf).amin(-1)
    good = src_valid[None] & (nn < max_corr2)
    n_good = good.sum(-1, dtype=torch.int32)
    n_src = torch.clamp(src_valid.sum(dtype=torch.int32), min=1)
    fraction = n_good.to(src.dtype) / n_src.to(src.dtype)
    mse = torch.where(good, nn, 0.0).sum(-1) / torch.clamp(n_good, min=1).to(src.dtype)
    corr = lie.pose_relative(init, pose)
    dt = torch.sqrt(torch.sum(lie.pose_t(corr) ** 2, dim=-1))
    dr = lie.rotation_angle(lie.pose_q(corr))
    ok = ((fraction > min_fraction) & (dt <= max_t) & (dr <= max_r)
          & torch.isfinite(pose).all(-1))
    return pose, fraction, mse, ok


def gicp(src, src_lab, src_valid, dst, dst_lab, dst_valid, normals, init, iterations: int,
         max_corr2: float, color_weight: float, min_fraction: float, max_t: float, max_r: float,
         matches=None):
    """K27: a thread-block cluster per target cloud (8 CTAs of 512), the
    target (position and flag, Lab, normal: 48 bytes a point) in every CTA's
    shared memory, 16 lanes a source point's search merged by the
    first-argmin key (``argmin_key_plain``), the 27 sums in a fixed order
    across the cluster and warp 0's 6x6 solve; every iteration, the audit
    and the gates in one launch.  ``matches`` (B, M) int32 on the card, or None:
    receives each source point's target in the first iteration (the
    argmin ``gicp_first_matches_plain`` gives)."""
    if src.device.type == "cpu":
        if matches is not None:
            matches.copy_(gicp_first_matches_plain(src, src_lab, dst, dst_lab, dst_valid, init,
                                                   color_weight))
        return gicp_plain(src, src_lab, src_valid, dst, dst_lab, dst_valid, normals, init,
                          iterations, max_corr2, color_weight, min_fraction, max_t, max_r)
    dev, f32 = src.device, torch.float32
    M, (B, N, _) = src.shape[0], dst.shape
    if not 0 < N <= GICP_MAX_POINTS:
        raise ValueError(f"gicp: {N} target points, the kernel takes 1..{GICP_MAX_POINTS}")
    ptrs = [_check("src", src, (M, 3), f32, dev), _check("src_lab", src_lab, (M, 3), f32, dev),
            _check("src_valid", src_valid, (M,), torch.bool, dev),
            _check("dst", dst, (B, N, 3), f32, dev), _check("dst_lab", dst_lab, (B, N, 3), f32, dev),
            _check("dst_valid", dst_valid, (B, N), torch.bool, dev),
            _check("normals", normals, (B, N, 3), f32, dev), _check("init", init, (B, 7), f32, dev)]
    matches_p = None if matches is None else _check("matches", matches, (B, M), torch.int32, dev)
    lib = _build.load()
    pose = torch.empty(B, 7, dtype=f32, device=dev)
    fraction = torch.empty(B, dtype=f32, device=dev)
    mse = torch.empty(B, dtype=f32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    err = lib.uz_gicp(*ptrs, B, M, N, int(iterations), float(max_corr2), float(color_weight),
                      float(min_fraction), float(max_t), float(max_r), pose.data_ptr(),
                      fraction.data_ptr(), mse.data_ptr(), ok.data_ptr(), matches_p, _stream(dev))
    _raise_on(err, "gicp")
    launches["gicp"] += 1
    return pose, fraction, mse, ok


# ---------------------------------------------------------------------------
# K28 pnp (the PnP RANSAC: draws, fits, consensus and polish in one launch)
# ---------------------------------------------------------------------------

PNP_SAMPLE = 6          # correspondences a hypothesis is fitted to
SVD_SWEEPS = 12         # one-sided Jacobi sweeps at most (kSvdSweeps in csrc/pnp.cu)
SVD_TOL = 1e-7          # a pair is rotated where |a_p·a_q| > SVD_TOL·|a_p||a_q|
PNP_MAX_POINTS = 2048   # correspondences a CTA stages (33 bytes each: kMaxPoints in csrc/pnp.cu)
PNP_MAX_HYPOTHESES = 1 << 20   # hypotheses a candidate (a vote's low 20 bits: kVoteBits)
JACOBI_ORDERS = ("cyclic", "parallel")


def round_robin_pairs(n: int) -> list:
    """K28's parallel order of the one-sided Jacobi's column pairs: the
    rounds of a round-robin over n + (n odd) slots (slot P − 1 meets r in
    round r, and slot j meets (2r − j) mod (P − 1), or P − 1 where that is
    j), each round a list of disjoint (p, q), p < q, without the padding
    slot: 11 rounds of 6 pairs for n = 12, 9 rounds of 4 for n = 9."""
    P = n + (n & 1)
    m = P - 1
    rounds = []
    for r in range(m):
        pairs = []
        for j in range(P):
            k = r if j == m else ((2 * r - j) % m if (2 * r - j) % m != j else m)
            if j < k < n:
                pairs.append((j, k))
        rounds.append(pairs)
    return rounds


def jacobi_svd_plain(A, sweeps: int = SVD_SWEEPS, order: str = "cyclic"):
    """One-sided (Hestenes) Jacobi on (..., m, n): column pairs (p, q) are
    rotated, with V, until they are orthogonal (|γ| ≤ SVD_TOL·√(αβ)), at
    most ``sweeps`` times; a sweep that rotates no pair of any matrix ends
    it (the kernels stop each matrix at its own such sweep, which changes
    nothing after).  ``order`` "cyclic" takes the pairs one after another in
    row-major order (``uz::proper_rotation``'s); "parallel" rotates the
    disjoint pairs of each ``round_robin_pairs`` round at once (K28's
    (12, 12) and (12, 9) systems).  Returns (A·V (..., m, n), V (..., n,
    n), σ (..., n) the column norms of A·V, unsorted)."""
    if order not in JACOBI_ORDERS:
        raise ValueError(f"jacobi_svd_plain: order {order!r}, one of {JACOBI_ORDERS}")
    m, n = A.shape[-2:]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape[:-2] + (n, n))
    AV = torch.cat([A, eye], dim=-2)          # A's rows over V's: one rotation for both
    if order == "cyclic":
        rounds = [[(p, q)] for p in range(n - 1) for q in range(p + 1, n)]
    else:
        rounds = round_robin_pairs(n)
    for _ in range(sweeps):
        rotated = False
        for pairs in rounds:
            p = torch.tensor([pq[0] for pq in pairs], device=A.device)
            q = torch.tensor([pq[1] for pq in pairs], device=A.device)
            cp, cq = AV[..., :, p], AV[..., :, q]
            ap, aq = cp[..., :m, :], cq[..., :m, :]
            alpha, beta, gamma = (ap * ap).sum(-2), (aq * aq).sum(-2), (ap * aq).sum(-2)
            rot = gamma.abs() > SVD_TOL * torch.sqrt(alpha * beta)
            rotated = rotated or bool(rot.any())
            zeta = (beta - alpha) / (2.0 * torch.where(rot, gamma, torch.ones_like(gamma)))
            t = (torch.where(zeta >= 0, 1.0, -1.0)
                 / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta)))
            t = torch.where(rot, t, 0.0)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = (c * t)[..., None, :]
            c = c[..., None, :]
            AV[..., :, p], AV[..., :, q] = c * cp - s * cq, s * cp + c * cq
        if not rotated:
            break
    A, V = AV[..., :m, :], AV[..., m:, :]
    return A, V, torch.sqrt((A * A).sum(-2))


def _normalize3(v):
    return v / torch.sqrt((v * v).sum(-1, keepdim=True))


def proper_rotation_plain(C):
    """R = U diag(1, 1, sgn(det U · det V)) Vᵀ of (..., 3, 3) matrices C = U
    S Vᵀ, as ``uz::proper_rotation`` (``csrc/linalg.cuh``, K7's refit and
    K28's fits): the one-sided Jacobi, u₁, u₂ from the
    two largest singular pairs (u₂ Gram-Schmidt'ed against u₁; any unit
    vector orthogonal to u₁ at rank 1), u₃ = u₁ × u₂, v₃ = v₁ × v₂; the
    identity where C has no spread.  Returns (R, σ summed)."""
    AV, V, sig = jacobi_svd_plain(C)
    order = torch.sort(sig, dim=-1, descending=True, stable=True).indices
    i1, i2 = order[..., 0], order[..., 1]

    def col(M, i):
        return torch.gather(M, -1, i[..., None, None].expand(M.shape[:-1] + (1,)))[..., 0]

    s1, s2 = torch.gather(sig, -1, i1[..., None])[..., 0], torch.gather(sig, -1, i2[..., None])[..., 0]
    u1, u2, v1, v2 = _normalize3(col(AV, i1)), col(AV, i2), col(V, i1), col(V, i2)
    u2_gs = u2 - (u1 * u2).sum(-1, keepdim=True) * u1
    first = u1[..., 0].abs() < 0.9
    e = torch.stack([first, ~first, torch.zeros_like(first)], dim=-1).to(C.dtype)
    u2 = _normalize3(torch.where((s2 > 1e-7 * s1)[..., None], u2_gs, torch.cross(u1, e, dim=-1)))
    u3, v3 = torch.cross(u1, u2, dim=-1), torch.cross(v1, v2, dim=-1)
    R = (u1[..., :, None] * v1[..., None, :] + u2[..., :, None] * v2[..., None, :]
         + u3[..., :, None] * v3[..., None, :])
    eye = torch.eye(3, dtype=C.dtype, device=C.device).expand(R.shape)
    return torch.where((s1 > 1e-30)[..., None, None], R, eye), sig.sum(-1)


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def null_vector_plain(A, order: str = "parallel"):
    """The right singular vector of the smallest singular value of (..., m,
    n) matrices (the first on a tie), by ``jacobi_svd_plain`` in ``order``
    (K28's parallel rounds by default)."""
    _, V, sig = jacobi_svd_plain(A, order=order)
    j = torch.argmin(sig, dim=-1)
    return torch.gather(V, -1, j[..., None, None].expand(V.shape[:-1] + (1,)))[..., 0]


def dlt_system_plain(X, xn, w):
    """The DLT's weighted (..., 2n, 12) system of (..., n, ·) samples: the
    rows [X̃, 0, −x·X̃] and [0, X̃, −y·X̃] of the homogeneous points X̃."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
    zero = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, zero, -xn[..., 0:1] * Xh], dim=-1)
    r2 = torch.cat([zero, Xh, -xn[..., 1:2] * Xh], dim=-1)
    return torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)


def dlt_pose_plain(X, xn, w, order: str = "parallel"):
    """``uzliti_slam_tpu/ops/pnp.py:_dlt_pose`` on (..., n, ·) samples: the
    (2n, 12) system, its null vector (Jacobi in ``order``), the det(M₃) sign
    folded into M, the proper polar factor of M₃ and t = M₄ / max(Σσ/3,
    1e-12)."""
    from uzliti_slam_tpu_torch.ops import lie

    A = dlt_system_plain(X, xn, w)
    M = null_vector_plain(A, order).reshape(A.shape[:-2] + (3, 4))
    M = M * torch.where(_det3(M[..., :3]) < 0, -1.0, 1.0)[..., None, None]
    R, ssum = proper_rotation_plain(M[..., :3])
    t = M[..., 3] / torch.clamp(ssum / 3.0, min=1e-12)[..., None]
    return lie.make_pose(t, lie.matrix_to_quat(R))


def _norm3(v):
    return torch.sqrt((v * v).sum(-1))


def homography_pose_plain(X, xn, w, order: str = "parallel"):
    """``uzliti_slam_tpu/ops/pnp.py:_homography_pose`` on (..., n, ·)
    samples: the weighted centroid, the plane's two largest singular
    directions (cyclic one-sided Jacobi of the 6x3 spread), the (2n, 9)
    system's null vector H (Jacobi in ``order``), σ = sgn(H₂₂), Gram-Schmidt
    of the scaled columns, and the world-to-camera rotation completed
    through the plane normal."""
    from uzliti_slam_tpu_torch.ops import lie

    wsum = torch.clamp(w.sum(-1), min=1e-6)
    c0 = (X * w[..., None]).sum(-2) / wsum[..., None]
    _, V, sig = jacobi_svd_plain((X - c0[..., None, :]) * w[..., None])
    by_sig = torch.sort(sig, dim=-1, descending=True, stable=True).indices

    def col(i):
        return torch.gather(V, -1, by_sig[..., i, None, None].expand(V.shape[:-1] + (1,)))[..., 0]

    e1, e2 = col(0), col(1)
    d = X - c0[..., None, :]
    px, py = (d * e1[..., None, :]).sum(-1), (d * e2[..., None, :]).sum(-1)
    x, y = xn[..., 0], xn[..., 1]
    z0, o = torch.zeros_like(px), torch.ones_like(px)
    r1 = torch.stack([px, py, o, z0, z0, z0, -x * px, -x * py, -x], dim=-1)
    r2 = torch.stack([z0, z0, z0, px, py, o, -y * px, -y * py, -y], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    H = null_vector_plain(A, order).reshape(A.shape[:-2] + (3, 3))
    s = torch.sqrt(_norm3(H[..., :, 0]) * _norm3(H[..., :, 1])) + 1e-12
    sigma = torch.where(H[..., 2, 2] > 0, 1.0, -1.0)
    Hs = sigma[..., None, None] * H / s[..., None, None]
    r1c = Hs[..., :, 0] / (_norm3(Hs[..., :, 0]) + 1e-12)[..., None]
    r2o = Hs[..., :, 1] - r1c * (r1c * Hs[..., :, 1]).sum(-1, keepdim=True)
    r2c = r2o / (_norm3(r2o) + 1e-12)[..., None]
    r3c = torch.cross(r1c, r2c, dim=-1)
    npl = torch.cross(e1, e2, dim=-1)
    Rc = (r1c[..., :, None] * e1[..., None, :] + r2c[..., :, None] * e2[..., None, :]
          + r3c[..., :, None] * npl[..., None, :])
    tc = Hs[..., :, 2] - (Rc * c0[..., None, :]).sum(-1)
    return lie.make_pose(tc, lie.matrix_to_quat(Rc))


def kabsch_pose_plain(src, dst, w):
    """``uzliti_slam_tpu/ops/ransac.py:kabsch`` with its SVD as
    ``proper_rotation_plain``: weighted means, the cross-covariance
    (cd·w)ᵀ cs / Σw, R = U diag(1, 1, d) Vᵀ, t = μ_d − R μ_s."""
    from uzliti_slam_tpu_torch.ops import lie

    w = torch.clamp(w, min=0.0)
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    mu_s, mu_d = (src * w[..., None]).sum(-2) / wsum, (dst * w[..., None]).sum(-2) / wsum
    cs, cd = src - mu_s[..., None, :], dst - mu_d[..., None, :]
    cov = ((cd * w[..., None])[..., :, :, None] * cs[..., :, None, :]).sum(-3) / wsum[..., None]
    R, _ = proper_rotation_plain(cov)
    return lie.make_pose(mu_d - (R * mu_s[..., None, :]).sum(-1), lie.matrix_to_quat(R))


def pnp_pick(t, samples):
    """The entries of t (B, M) or (B, M, d) at the draws' samples (B, H,
    6): (B, H, 6) or (B, H, 6, d)."""
    B, H, n = samples.shape
    flat = samples.long().reshape(B, H * n)
    if t.dim() == 2:
        return torch.gather(t, 1, flat).reshape(B, H, n)
    return torch.gather(t, 1, flat[..., None].expand(B, H * n, t.shape[-1])).reshape(
        B, H, n, t.shape[-1])


def pnp_hypotheses_plain(X, xn, valid, depth, keys, order: str = "parallel"):
    """Plain version of K28's draws and fits: per candidate b and draw h
    the 6 largest keys over the valid correspondences (−1e9 elsewhere, ties
    to the lower index), then the DLT, homography and (with ``depth``)
    Kabsch hypotheses of those 6, the null vectors by Jacobi in ``order``.
    X (B, M, 3), xn (B, M, 2), valid (B, M), depth (B, M) or None, keys (B,
    H, M).  Returns (samples (B, H, 6) int32, poses (B, F·H, 7),
    family-major, F = 3 with depth, else 2)."""
    scores = torch.where(valid[:, None, :], keys, -1e9)
    samples = largest_k(scores, PNP_SAMPLE)[1]

    def pick(t):
        return pnp_pick(t, samples)

    Xs, xs, ws = pick(X), pick(xn), pick(valid).to(X.dtype)
    poses = [dlt_pose_plain(Xs, xs, ws, order), homography_pose_plain(Xs, xs, ws, order)]
    if depth is not None:
        X_cam = torch.cat([xn * depth[..., None], depth[..., None]], dim=-1)
        poses.append(kabsch_pose_plain(Xs, pick(X_cam), pick(valid & (depth > 0.05)).to(X.dtype)))
    return samples.to(torch.int32), torch.cat(poses, dim=1)


def project_norm_plain(pose, X):
    """``_project_norm``: normalised image coordinates of X under pose, the
    depth clamped to 1e-6 where |z| < 1e-6."""
    from uzliti_slam_tpu_torch.ops import lie

    pc = lie.pose_apply(pose[..., None, :], X)
    z = torch.where(pc[..., 2].abs() < 1e-6, 1e-6, pc[..., 2])
    return pc[..., :2] / z[..., None], pc


def _pnp_inliers(pose, X, xn, valid, depth, thresh2: float, depth_tol: float):
    """(inliers, squared reprojection errors) of X under poses (..., 7):
    the error as XLA compiles it (fma(v, v, u·u)), in front (z > 0.05) and,
    where the depth is measured (> 0.05), within depth_tol·max(depth, 1)."""
    proj, pc = project_norm_plain(pose, X)
    e = proj - xn
    err2 = fma_plain(e[..., 1], e[..., 1], e[..., 0] * e[..., 0])
    inl = (err2 < thresh2) & valid & (pc[..., 2] > 0.05)
    if depth is not None:
        inl = inl & (~(depth > 0.05) | ((pc[..., 2] - depth).abs()
                                        < depth_tol * torch.clamp(depth, min=1.0)))
    return inl, err2


def pnp_refine_plain(X, xn, valid, depth, samples, poses, thresh2: float, depth_tol: float,
                     min_consensus: float, iterations: int, f_mean2: float):
    """Plain version of K28's consensus and polish (``pnp_ransac`` after
    its hypotheses): the (B, K, M) consensus, −1 where a sample holds an
    invalid correspondence, the first argmax, ``iterations`` Gauss-Newton
    steps p ← p ∘ exp(dx) on the best inliers' reprojection rows (and
    measured-depth rows) with the forward-mode Jacobian
    (``torch.func.jacfwd``, as ``jax.jacfwd``), JᵀJ + 1e-8·I, the pivoted
    solve; then the final inliers, consensus, mse in px² and ok.  Returns
    (pose (B, 7), consensus (B,) int32, mse (B,), ok (B,), best (B,) int32,
    counts (B, K) int32)."""
    from uzliti_slam_tpu_torch.ops import lie

    B, K, _ = poses.shape
    d_b = None if depth is None else depth[:, None]
    inl, _ = _pnp_inliers(poses, X[:, None], xn[:, None], valid[:, None], d_b,
                          thresh2, depth_tol)
    counts = inl.sum(-1, dtype=torch.int32)
    sample_ok = torch.gather(valid, 1, samples.long().reshape(B, -1)).reshape(
        samples.shape).all(-1)
    counts = torch.where(sample_ok.repeat(1, K // samples.shape[1]), counts, -1)
    best = torch.argmax(counts, dim=1)
    pose = torch.gather(poses, 1, best[:, None, None].expand(B, 1, 7))[:, 0]
    w = torch.gather(inl, 1, best[:, None, None].expand(B, 1, inl.shape[-1]))[:, 0].to(X.dtype)
    d_w = None if depth is None else w * (depth > 0.05).to(X.dtype)

    def resid(dx, p, X, xn, w, depth, d_w):
        pp = lie.pose_retract(p, dx)
        proj, pc = project_norm_plain(pp, X)
        rp = ((proj - xn) * w[:, None]).reshape(-1)
        if depth is None:
            return rp
        return torch.cat([rp, (pc[:, 2] - depth) / torch.clamp(depth, min=1.0) * d_w])

    jac = torch.func.vmap(torch.func.jacfwd(resid), in_dims=(None, 0, 0, 0, 0,
                                                            None if depth is None else 0,
                                                            None if depth is None else 0))
    res = torch.func.vmap(resid, in_dims=(None, 0, 0, 0, 0, None if depth is None else 0,
                                          None if depth is None else 0))
    zero = torch.zeros(6, dtype=X.dtype, device=X.device)
    eye = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(iterations):
        r, J = res(zero, pose, X, xn, w, depth, d_w), jac(zero, pose, X, xn, w, depth, d_w)
        Jt = J.transpose(-1, -2)
        H = (Jt[..., :, None, :] * Jt[..., None, :, :]).sum(-1) + 1e-8 * eye
        pose = lie.pose_retract(pose, -lu_solve_plain(H, (Jt * r[:, None, :]).sum(-1)))
    inl_f, err2_f = _pnp_inliers(pose, X, xn, valid, depth, thresh2, depth_tol)
    consensus = inl_f.sum(-1, dtype=torch.int32)
    mse = (torch.where(inl_f, err2_f, 0.0).sum(-1)
           / torch.clamp(consensus, min=1).to(X.dtype)) * f_mean2
    ok = (consensus >= min_consensus) & torch.isfinite(pose).all(-1)
    return pose, consensus, mse, ok, best.to(torch.int32), counts


def pnp_ransac_plain(X, xn, valid, depth, keys, thresh2: float, depth_tol: float,
                     min_consensus: float, iterations: int, f_mean2: float,
                     order: str = "parallel"):
    """Plain version of K28: ``pnp_hypotheses_plain`` (Jacobi in
    ``order``), then ``pnp_refine_plain`` of its hypotheses.  Returns
    (samples, poses, pose, consensus, mse, ok, best, counts)."""
    samples, poses = pnp_hypotheses_plain(X, xn, valid, depth, keys, order)
    return (samples, poses, *pnp_refine_plain(X, xn, valid, depth, samples, poses, thresh2,
                                              depth_tol, min_consensus, iterations, f_mean2))


_STAMPS_RESET = {}


def _stamps_reset(dev):
    """(−1, 0, 0, 0) on the card, made once per device (no host copy a call)."""
    if dev not in _STAMPS_RESET:
        _STAMPS_RESET[dev] = torch.tensor([-1, 0, 0, 0], dtype=torch.int64, device=dev)
    return _STAMPS_RESET[dev]


def pnp_ransac(X, xn, valid, depth, keys, thresh2: float, depth_tol: float,
               min_consensus: float, iterations: int, f_mean2: float, stamps=None):
    """K28 in one launch: a thread-block cluster per candidate (8 CTAs, 8
    draws a CTA a pass); a warp per (two draws, family) makes its draws,
    fits them (the (12, 12) and (12, 9) systems a column a lane, Jacobi in
    ``round_robin_pairs`` rounds) and scores them over the correspondences
    staged in shared memory; the first argmax from each CTA's 32-bit vote;
    the Gauss-Newton polish in the leader CTA, warp 0 solving; the final
    audit.  ``stamps`` (B, 4) int64 on the card, or None: the phases'
    ``%globaltimer`` ns (the first CTA's start, the last fit's end, the
    last consensus' end, the polish's end; the wrapper resets it).  Returns
    (samples, poses, pose, consensus, mse, ok, best, counts)."""
    if X.device.type == "cpu":
        return pnp_ransac_plain(X, xn, valid, depth, keys, thresh2, depth_tol, min_consensus,
                                iterations, f_mean2)
    dev, f32, i32 = X.device, torch.float32, torch.int32
    B, M, _ = X.shape
    if not PNP_SAMPLE <= M <= PNP_MAX_POINTS:
        raise ValueError(f"pnp_ransac: {M} correspondences, the kernel takes "
                         f"{PNP_SAMPLE}..{PNP_MAX_POINTS} (a draw takes {PNP_SAMPLE})")
    ptrs = [_check("X", X, (B, M, 3), f32, dev), _check("xn", xn, (B, M, 2), f32, dev),
            _check("valid", valid, (B, M), torch.bool, dev),
            None if depth is None else _check("depth", depth, (B, M), f32, dev)]
    H = keys.shape[1]
    keys_p = _check("keys", keys, (B, H, M), f32, dev)
    K = (2 if depth is None else 3) * H
    if K > PNP_MAX_HYPOTHESES:
        raise ValueError(f"pnp_ransac: {K} hypotheses, a vote holds {PNP_MAX_HYPOTHESES}")
    stamps_p = None
    if stamps is not None:
        stamps_p = _check("stamps", stamps, (B, 4), torch.int64, dev)
        stamps.copy_(_stamps_reset(dev).expand(B, 4))
    lib = _build.load()
    samples = torch.empty(B, H, PNP_SAMPLE, dtype=i32, device=dev)
    poses = torch.empty(B, K, 7, dtype=f32, device=dev)
    # pose, consensus, mse, ok, best, counts
    out = (torch.empty(B, 7, dtype=f32, device=dev), torch.empty(B, dtype=i32, device=dev),
           torch.empty(B, dtype=f32, device=dev), torch.empty(B, dtype=torch.bool, device=dev),
           torch.empty(B, dtype=i32, device=dev), torch.empty(B, K, dtype=i32, device=dev))
    err = lib.uz_pnp_ransac(*ptrs, keys_p, B, M, H, float(thresh2), float(depth_tol),
                            float(min_consensus), int(iterations), float(f_mean2),
                            samples.data_ptr(), poses.data_ptr(), *(t.data_ptr() for t in out),
                            stamps_p, _stream(dev))
    _raise_on(err, "pnp_ransac")
    launches["pnp"] += 1
    return (samples, poses, *out)


# ---------------------------------------------------------------------------
# K31-K33: the scope protocol's uid lookup, edge-key match and delta upsert
# ---------------------------------------------------------------------------

SCOPE_MAX_ROWS = 1024   # K31/K32 queries held in shared memory; K33's rows (one CTA)


def _scope_rows(name: str, n: int) -> None:
    if n > SCOPE_MAX_ROWS:
        raise ValueError(f"{name}: {n} rows, the kernel takes at most {SCOPE_MAX_ROWS}")


def uid_slots_plain(node_uid, node_valid, uids):
    """Plain version of K31, the reference's ``uid_to_slot``: each query uid
    -> the lowest slot with ``node_valid`` and that uid, else -1 (a (B, N)
    compare, ``any``, then the first hit).  Returns (B,) int32."""
    hit = (node_uid[None, :] == uids[:, None]) & node_valid[None, :] & (uids[:, None] >= 0)
    slot = torch.argmax(hit.to(torch.int8), dim=1)
    return torch.where(hit.any(1), slot, -1).to(torch.int32)


def uid_slots(node_uid, node_valid, uids):
    """K31: one grid-stride pass over the N table rows, the B query uids in
    shared memory; a matching live row does ``atomicMin`` of its slot into
    the query's output, which one fill sets to 0xFFFFFFFF (-1 as int32)
    beforehand.  Returns (B,) int32."""
    if node_uid.device.type == "cpu":
        return uid_slots_plain(node_uid, node_valid, uids)
    dev, i32 = node_uid.device, torch.int32
    N, B = node_uid.shape[0], uids.shape[0]
    _scope_rows("uid_slots", B)
    ptrs = [_check("node_uid", node_uid, (N,), i32, dev),
            _check("node_valid", node_valid, (N,), torch.bool, dev),
            _check("uids", uids, (B,), i32, dev)]
    lib = _build.load()
    out = torch.full((B,), -1, dtype=i32, device=dev)
    err = lib.uz_uid_slots(*ptrs[:2], N, ptrs[2], B, out.data_ptr(), _stream(dev))
    _raise_on(err, "uid_slots")
    launches["uid_slots"] += 1
    return out


def edge_key_match_plain(qa, qb, qt, row_a, row_b, row_t, num_rows=None, node_uid=None):
    """Plain version of K32: Q query keys (a, b, type) against the table's
    rows (``row_a``, ``row_b``, ``row_t``) (E,), the rows below ``num_rows``
    (a () tensor; all E when None), their endpoints mapped through
    ``node_uid`` when given (uid space, ``apply_ack``).  A query with a < 0
    matches nothing.  Returns (query_hit (Q,) bool: some row matches it,
    row_hit (E,) bool: some query matches it)."""
    E = row_a.shape[0]
    ra, rb = row_a, row_b
    if node_uid is not None:
        ra, rb = node_uid[row_a.long()], node_uid[row_b.long()]
    m = ((ra[None, :] == qa[:, None]) & (rb[None, :] == qb[:, None])
         & (row_t[None, :] == qt[:, None]) & (qa[:, None] >= 0))
    if num_rows is not None:
        m = m & (torch.arange(E, device=row_a.device) < num_rows)[None, :]
    return m.any(1), m.any(0)


def edge_key_match(qa, qb, qt, row_a, row_b, row_t, num_rows=None, node_uid=None):
    """K32: the Q query keys in shared memory, one grid-stride pass over the
    table's rows; the row count is read on the device (``num_rows``), so
    nothing is read on the host.  Each row writes its own flag; a matched
    query's flag is set by a plain byte store of 1 (every writer stores the
    same value) into a zeroed array.  Returns (query_hit, row_hit)."""
    if row_a.device.type == "cpu":
        return edge_key_match_plain(qa, qb, qt, row_a, row_b, row_t, num_rows, node_uid)
    dev, i32 = row_a.device, torch.int32
    Q, E = qa.shape[0], row_a.shape[0]
    _scope_rows("edge_key_match", Q)
    ptrs = [_check(n, t, (Q,), i32, dev) for n, t in (("qa", qa), ("qb", qb), ("qt", qt))]
    ptrs += [_check(n, t, (E,), i32, dev)
             for n, t in (("row_a", row_a), ("row_b", row_b), ("row_t", row_t))]
    rows_ptr = 0 if num_rows is None else _check("num_rows", num_rows, (), i32, dev)
    uid_ptr = 0 if node_uid is None else _check("node_uid", node_uid, (node_uid.shape[0],), i32,
                                                dev)
    lib = _build.load()
    query_hit = torch.zeros(Q, dtype=torch.bool, device=dev)
    row_hit = torch.empty(E, dtype=torch.bool, device=dev)
    err = lib.uz_edge_key_match(*ptrs[:3], Q, *ptrs[3:], E, rows_ptr, uid_ptr,
                                query_hit.data_ptr(), row_hit.data_ptr(), _stream(dev))
    _raise_on(err, "edge_key_match")
    launches["edge_key_match"] += 1
    return query_hit, row_hit


def delta_upsert_plain(g, delta, node_found, ef_found, et_found, table_dup,
                       first_occurrence: bool = True):
    """Plain version of K33's ``uz_delta_upsert``: the reference's
    ``apply_delta`` scans as a Python loop over the delta's rows that calls
    ``gstate.add_node`` / ``add_edge`` in its order.  ``node_found`` (Dn,)
    is each node row's slot before the delta (K31, or the caller's
    ``existing_slots``); with ``first_occurrence`` a row whose uid an
    earlier row of the delta inserted finds that row's slot, as the
    reference's scan looks it up again (without it every unknown row
    inserts, as the reference does with ``existing_slots``).  ``ef_found``
    / ``et_found`` (De,) are the edge endpoints' slots before the delta
    (K31): an endpoint not found there resolves to the first row of the
    delta that inserted its uid.  ``table_dup`` (De,) marks rows whose
    (from, to, type) the table already holds (K32).  Returns (graph,
    ack_node_uids (Dn,), ack_edge_from (De,))."""
    from uzliti_slam_tpu_torch.graph import state as gstate

    dev = g.device
    n_uid, found = delta.n_uid.tolist(), node_found.tolist()
    inserted: dict = {}
    ack_nodes = []
    for i, uid in enumerate(n_uid):
        existing = found[i]
        if existing < 0 and first_occurrence and uid >= 0:
            existing = inserted.get(uid, -1)
        applied = uid >= 0 and existing >= 0
        if uid >= 0 and existing < 0:
            g, slot = gstate.add_node(g, delta.n_pose[i], delta.n_odom_pose[i],
                                      delta.n_stamp[i], fixed=False,
                                      uncertainty=delta.n_uncertainty[i],
                                      uid=torch.full((), uid, dtype=torch.int32, device=dev))
            slot = int(slot)
            applied = slot >= 0
            if applied:
                inserted.setdefault(uid, slot)
        ack_nodes.append(uid if applied else -1)

    fu, tu, ty = delta.e_from_uid.tolist(), delta.e_to_uid.tolist(), delta.e_type.tolist()
    fs, ts, dup_t = ef_found.tolist(), et_found.tolist(), table_dup.tolist()

    def resolve(slot, uid):
        return slot if slot >= 0 or uid < 0 else inserted.get(uid, -1)

    eok, ack_from = [], []
    for i in range(len(ty)):
        a, b = resolve(fs[i], fu[i]), resolve(ts[i], tu[i])
        eok.append(a >= 0 and b >= 0 and ty[i] >= 0)
        dup = dup_t[i] or any(eok[j] and (fu[j], tu[j], ty[j]) == (fu[i], tu[i], ty[i])
                              for j in range(i))
        applied = eok[i] and dup
        if eok[i] and not dup:
            g, eslot = gstate.add_edge(g, a, b, delta.e_transform[i], delta.e_info[i],
                                       etype=ty[i], score=delta.e_score[i],
                                       valid=delta.e_valid[i])
            applied = int(eslot) >= 0
        ack_from.append(fu[i] if applied else -1)
    i32 = dict(dtype=torch.int32, device=dev)
    return g, torch.tensor(ack_nodes, **i32), torch.tensor(ack_from, **i32)


_NODE_FIELDS = ("pose", "odom_pose", "stamp", "uncertainty", "node_valid", "node_fixed",
                "node_uid", "num_nodes")
_EDGE_FIELDS = ("e_from", "e_to", "e_transform", "e_info", "e_type", "e_valid", "e_error",
                "e_age", "e_score", "num_edges")
_FIELD_DTYPE = {"pose": torch.float32, "odom_pose": torch.float32, "stamp": torch.float32,
                "uncertainty": torch.float32, "node_valid": torch.bool, "node_fixed": torch.bool,
                "node_uid": torch.int32, "num_nodes": torch.int32, "e_from": torch.int32,
                "e_to": torch.int32, "e_transform": torch.float32, "e_info": torch.float32,
                "e_type": torch.int32, "e_valid": torch.bool, "e_error": torch.float32,
                "e_age": torch.float32, "e_score": torch.float32, "num_edges": torch.int32}


def _table_copies(g, names, dev) -> dict:
    """Contiguous copies of the graph's fields ``names`` (checked), which
    K33 updates in place: the reference's functional update."""
    N, E = g.node_capacity, g.edge_capacity
    shape = {"pose": (N, 7), "odom_pose": (N, 7), "e_transform": (E, 7), "e_info": (E, 6, 6),
             "num_nodes": (), "num_edges": ()}
    out = {}
    for name in names:
        t = getattr(g, name)
        want = shape.get(name, (N,) if name in _NODE_FIELDS else (E,))
        c = t.clone(memory_format=torch.contiguous_format)
        _check(name, c, want, _FIELD_DTYPE[name], dev)
        out[name] = c
    return out


def delta_upsert(g, delta, node_found, ef_found, et_found, table_dup,
                 first_occurrence: bool = True):
    """K33, ``uz_delta_upsert``: one CTA, a thread a delta row.  Node rows:
    the first occurrence of each unknown uid (every unknown row without
    ``first_occurrence``), a block prefix sum for their slots (past capacity
    dropped), the rows written; edge rows: endpoints not found by K31
    resolved against the rows just inserted (shared memory), the in-delta
    dedup against earlier rows with resolved endpoints, a block prefix sum
    for the appended slots, the information masked by type; the ACK.  The
    node and edge tables are copied first (the functional update) and
    written in place.  Returns (graph, ack_node_uids, ack_edge_from)."""
    if g.device.type == "cpu":
        return delta_upsert_plain(g, delta, node_found, ef_found, et_found, table_dup,
                                  first_occurrence)
    dev, i32, f32, b8 = g.device, torch.int32, torch.float32, torch.bool
    Dn, De = delta.n_uid.shape[0], delta.e_type.shape[0]
    _scope_rows("delta_upsert", max(Dn, De))
    din = [_check("n_uid", delta.n_uid, (Dn,), i32, dev),
           _check("n_pose", delta.n_pose, (Dn, 7), f32, dev),
           _check("n_odom_pose", delta.n_odom_pose, (Dn, 7), f32, dev),
           _check("n_stamp", delta.n_stamp, (Dn,), f32, dev),
           _check("n_uncertainty", delta.n_uncertainty, (Dn,), f32, dev),
           _check("node_found", node_found, (Dn,), i32, dev),
           _check("e_from_uid", delta.e_from_uid, (De,), i32, dev),
           _check("e_to_uid", delta.e_to_uid, (De,), i32, dev),
           _check("e_type", delta.e_type, (De,), i32, dev),
           _check("e_transform", delta.e_transform, (De, 7), f32, dev),
           _check("e_info", delta.e_info, (De, 6, 6), f32, dev),
           _check("e_score", delta.e_score, (De,), f32, dev),
           _check("e_valid", delta.e_valid, (De,), b8, dev),
           _check("ef_found", ef_found, (De,), i32, dev),
           _check("et_found", et_found, (De,), i32, dev),
           _check("table_dup", table_dup, (De,), b8, dev)]
    t = _table_copies(g, _NODE_FIELDS + _EDGE_FIELDS, dev)
    lib = _build.load()
    ack_nodes = torch.empty(Dn, dtype=i32, device=dev)
    ack_from = torch.empty(De, dtype=i32, device=dev)
    err = lib.uz_delta_upsert(*(t[k].data_ptr() for k in _NODE_FIELDS), g.node_capacity,
                              *(t[k].data_ptr() for k in _EDGE_FIELDS), g.edge_capacity,
                              *din[:6], Dn, *din[6:], De, int(bool(first_occurrence)),
                              ack_nodes.data_ptr(), ack_from.data_ptr(), _stream(dev))
    _raise_on(err, "delta_upsert")
    launches["delta_upsert"] += 1
    return g.replace(**t), ack_nodes, ack_from


def scope_merge_plain(g, uid, pose, stamp, found):
    """Plain version of K33's ``uz_scope_merge``: the reference's
    ``apply_scope`` scan as a Python loop over the K reply rows.  A row
    whose uid is live (``found`` (K,), K31 before the reply, or an earlier
    row's insert) sets that node's pose and freezes it; an unknown uid >= 0
    is appended as a fixed node (the reply's pose as its odometry pose,
    uncertainty 0).  Returns the graph."""
    from uzliti_slam_tpu_torch.graph import state as gstate

    dev = g.device
    inserted: dict = {}
    for i, (u, s) in enumerate(zip(uid.tolist(), found.tolist())):
        if s < 0 and u >= 0:
            s = inserted.get(u, -1)
        if s >= 0:
            idx = torch.full((), s, dtype=torch.long, device=dev)
            yes = torch.ones((), dtype=torch.bool, device=dev)
            g = g.replace(pose=gstate.set_row(g.pose, idx, yes, pose[i]),
                          node_fixed=gstate.set_row(g.node_fixed, idx, yes, True))
        elif u >= 0:
            g, slot = gstate.add_node(g, pose[i], pose[i], stamp[i], fixed=True,
                                      uid=torch.full((), u, dtype=torch.int32, device=dev))
            if int(slot) >= 0:
                inserted[u] = int(slot)
    return g


def scope_merge(g, uid, pose, stamp, found):
    """K33, ``uz_scope_merge``: one CTA, a thread a reply row.  The first
    occurrence of each unknown uid >= 0 takes a slot by a block prefix sum
    (past capacity dropped) and writes its fixed node; the last row of each
    live or inserted uid writes the pose and freezes the node, as the
    reference's scan leaves it.  The node table is copied first and written
    in place.  Returns the graph."""
    if g.device.type == "cpu":
        return scope_merge_plain(g, uid, pose, stamp, found)
    dev, i32, f32 = g.device, torch.int32, torch.float32
    K = uid.shape[0]
    _scope_rows("scope_merge", K)
    rin = [_check("uid", uid, (K,), i32, dev), _check("pose", pose, (K, 7), f32, dev),
           _check("stamp", stamp, (K,), f32, dev), _check("found", found, (K,), i32, dev)]
    t = _table_copies(g, _NODE_FIELDS, dev)
    lib = _build.load()
    err = lib.uz_scope_merge(*(t[k].data_ptr() for k in _NODE_FIELDS), g.node_capacity,
                             *rin, K, _stream(dev))
    _raise_on(err, "scope_merge")
    launches["scope_merge"] += 1
    return g.replace(**t)
