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
residual_chi2  csrc/residual_chi2.cu   factors.batched_residuals +
                                       solver._robust_chi2_from_r
relax_min      csrc/relax_min.cu       graph/shortest_path.py:shortest_paths
cluster_labels csrc/cluster_labels.cu  graph/filter.py:_cluster_labels
ransac_rigid   csrc/ransac_rigid.cu    ops/ransac.py:ransac_rigid (+ kabsch,
                                       kabsch_quat)
components     csrc/components.cu      graph/solver.py:connected_components,
                                       gauge_fix_mask (two wrappers, one
                                       count)
chain_factor   csrc/chain_factor.cu    graph/tridiag.py:block_tridiag_factor
                                       (+ _inv3, _inv6, _pad_pow2,
                                       _dense_root_inverse)
pcg            csrc/pcg.cu             graph/solver.py:_pcg's vector updates
                                       (three wrappers, one count)
project_rays   csrc/occupancy.cu       mapping/occupancy.py:_project_rays +
                                       _mark_node_cells
fast_nms       csrc/fast_nms.cu        ops/features.py:fast_score + nms
grid_topk      csrc/grid_topk.cu       ops/features.py:select_topk_grid
orb_describe   csrc/orb_describe.cu    ops/features.py:_sep_blur +
                                       intensity_centroid_angles +
                                       brief_descriptors
scan_bins      csrc/scan_bins.cu       ops/scan.py:depth_to_scan's per-pixel
                                       part + _bin_min_max; second entry
                                       bin_min_max (own count): _bin_min_max
                                       of points_to_scan / cloud_to_scan
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
                                       feature_set_query
repository     csrc/repository.cu      recognizer.py:repository_add's search
                                       (repo_nearest) and repository_query
                                       (repo_votes); two wrappers, one count
bow_words      csrc/bow_words.cu       recognition/vocabulary.py:quantize and
                                       build_vocabulary's rounds (word_assign,
                                       word_majority); two wrappers, one count
bow_query      csrc/bow_query.cu       vocabulary.py:bow_query + bow_score
voxel_grid     csrc/voxel_grid.cu      ops/gicp.py:voxel_downsample
knn_normals    csrc/gicp.cu            ops/gicp.py:estimate_normals
gicp           csrc/gicp.cu            ops/gicp.py:gicp_6d (all iterations)
pnp            csrc/pnp.cu             ops/pnp.py:pnp_ransac (pnp_hypotheses:
                                       the draws and the _dlt_pose,
                                       _homography_pose and kabsch fits;
                                       pnp_refine: the consensus, argmax and
                                       Gauss-Newton polish); two wrappers,
                                       one count
=============  ======================  =======================================

What bounds each kernel on the card, and what its design does about it, is
written at the top of its source file.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from uzliti_slam_tpu_torch.graph import factors
from uzliti_slam_tpu_torch.kernels import _build

launches = {"linearize": 0, "hvp": 0, "chain_apply": 0, "residual_chi2": 0,
            "relax_min": 0, "cluster_labels": 0, "ransac_rigid": 0, "components": 0,
            "chain_factor": 0, "pcg": 0, "project_rays": 0, "fast_nms": 0, "grid_topk": 0,
            "orb_describe": 0, "scan_bins": 0, "hamming_top2": 0, "bilateral": 0, "icp": 0,
            "merge_pairs": 0, "calib_gn": 0, "bin_min_max": 0, "feature_votes": 0,
            "repository": 0, "bow_words": 0, "bow_query": 0, "voxel_grid": 0,
            "knn_normals": 0, "gicp": 0, "pnp": 0}

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


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t {err}")


# ---------------------------------------------------------------------------
# K1 linearize
# ---------------------------------------------------------------------------

def linearize_plain(r, adj_meas_inv, info, valid, e_from, e_to, free, both_free,
                    is_chain, huber_delta: float):
    """Plain version of K1: (Ji, Jj, W, grad, Hb, U).

    ``valid`` (E,), ``is_chain`` (E,) and ``free``/``both_free`` (N,) are
    float 0/1 masks; ``both_free[i]`` = node i and node i+1 both free.
    """
    n, E = free.shape[0], r.shape[0]
    W = factors.weighted_info(r, info, valid, huber_delta)
    Ji, Jj = factors.jacobians_from_residual(r, adj_meas_inv)
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
    return Ji, Jj, W, grad, Hb, U


def linearize(r, adj_meas_inv, info, valid, e_from, e_to, free, both_free,
              is_chain, huber_delta: float):
    """K1: fused per-edge Jacobians, robust weights and node-row sums."""
    if r.device.type == "cpu":
        return linearize_plain(r, adj_meas_inv, info, valid, e_from, e_to, free,
                               both_free, is_chain, huber_delta)
    dev, f32 = r.device, torch.float32
    E, n = r.shape[0], free.shape[0]
    ptrs = [
        _check("r", r, (E, 6), f32, dev),
        _check("adj_meas_inv", adj_meas_inv, (E, 6, 6), f32, dev),
        _check("info", info, (E, 6, 6), f32, dev),
        _check("valid", valid, (E,), f32, dev),
        _check("e_from", e_from, (E,), torch.int32, dev),
        _check("e_to", e_to, (E,), torch.int32, dev),
        _check("free", free, (n,), f32, dev),
        _check("both_free", both_free, (n,), f32, dev),
        _check("is_chain", is_chain, (E,), f32, dev),
    ]
    lib = _build.load()
    J = torch.empty(3, E, 6, 6, dtype=f32, device=dev)
    acc = torch.zeros(n * 78, dtype=f32, device=dev)
    grad = acc[: 6 * n].view(n, 6)
    Hb = acc[6 * n: 42 * n].view(n, 6, 6)
    U = acc[42 * n:].view(n, 6, 6)
    err = lib.uz_linearize(*ptrs, float(huber_delta), E, n,
                           J[0].data_ptr(), J[1].data_ptr(), J[2].data_ptr(),
                           grad.data_ptr(), Hb.data_ptr(), U.data_ptr(), _stream(dev))
    _raise_on(err, "linearize")
    launches["linearize"] += 1
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
    """Plain version of K3: solve A x = b (b (n, 6)) with a
    ``block_tridiag_factor`` result ``(levels, root_inv, n_orig)``."""
    levels, root_inv, n_orig = factor
    n2 = _pow2(n_orig)
    bk = torch.cat([b, b.new_zeros(n2 - n_orig, 6)])
    b_levels = []
    for Dinv_o, P1m, P2, G1, G2 in levels:
        be, bo = bk[0::2], bk[1::2]
        bo_m = torch.cat([bo.new_zeros(1, 6), bo[:-1]])
        b_levels.append(bo)
        bk = be - (P1m @ bo_m[..., None])[..., 0] - (P2 @ bo[..., None])[..., 0]
    x = (root_inv @ bk.reshape(-1)).reshape(-1, 6)
    for (Dinv_o, P1m, P2, G1, G2), bo in zip(reversed(levels), reversed(b_levels)):
        x_next = torch.cat([x[1:], x.new_zeros(1, 6)])
        x_o = ((Dinv_o @ bo[..., None]) - (G1 @ x[..., None])
               - (G2 @ x_next[..., None]))[..., 0]
        x = torch.stack([x, x_o], dim=1).reshape(-1, 6)
    return x[:n_orig]


def chain_apply(factor, b):
    """K3: the chain preconditioner's forward/back substitution and the
    root matvec."""
    if b.device.type == "cpu":
        return chain_apply_plain(factor, b)
    levels, root_inv, n_orig = factor
    dev, f32 = b.device, torch.float32
    _check("b", b, (n_orig, 6), f32, dev)
    lib = _build.load()
    stream = _stream(dev)
    bufs, valid_rows = [b], [n_orig]
    for li, (Dinv_o, P1m, P2, G1, G2) in enumerate(levels):
        half = Dinv_o.shape[0]
        if 2 * half < valid_rows[-1]:
            raise ValueError(f"chain_apply: level {li} holds {2 * half} rows "
                             f"< {valid_rows[-1]}")
        out = torch.empty(half, 6, dtype=f32, device=dev)
        err = lib.uz_chain_forward(
            bufs[-1].data_ptr(), valid_rows[-1],
            _check("P1m", P1m, (half, 6, 6), f32, dev),
            _check("P2", P2, (half, 6, 6), f32, dev), half, out.data_ptr(), stream)
        _raise_on(err, "chain_apply")
        bufs.append(out)
        valid_rows.append(half)
    # the root: m_root blocks, or the padded system when there is no level
    m_root = levels[-1][0].shape[0] if levels else _pow2(n_orig)
    root_rows = m_root if levels else n_orig
    x = torch.empty(root_rows, 6, dtype=f32, device=dev)
    err = lib.uz_chain_root(_check("root_inv", root_inv, (6 * m_root, 6 * m_root), f32, dev),
                            bufs[-1].data_ptr(), valid_rows[-1], 6 * m_root, x.data_ptr(),
                            root_rows, stream)
    _raise_on(err, "chain_apply")
    for li in reversed(range(len(levels))):
        Dinv_o, _, _, G1, G2 = levels[li]
        half = Dinv_o.shape[0]
        rows = n_orig if li == 0 else 2 * half
        out = torch.empty(rows, 6, dtype=f32, device=dev)
        err = lib.uz_chain_backward(
            bufs[li].data_ptr(), valid_rows[li], x.data_ptr(),
            _check("Dinv_o", Dinv_o, (half, 6, 6), f32, dev),
            _check("G1", G1, (half, 6, 6), f32, dev),
            _check("G2", G2, (half, 6, 6), f32, dev),
            half, out.data_ptr(), rows, stream)
        _raise_on(err, "chain_apply")
        x = out
    launches["chain_apply"] += 1
    return x


# ---------------------------------------------------------------------------
# K4 residual_chi2
# ---------------------------------------------------------------------------

def residual_chi2_plain(poses, e_from, e_to, meas, info, valid, huber_delta: float):
    """Plain version of K4: (r (E, 6), Σ ρ(rᵀΛr)·valid ())."""
    r = factors.batched_residuals(
        poses.index_select(0, e_from), poses.index_select(0, e_to), meas
    )
    return r, factors.robust_chi2(r, info, valid, huber_delta)


def residual_chi2(poses, e_from, e_to, meas, info, valid, huber_delta: float):
    """K4: edge residuals of ``poses`` and their robust χ²."""
    if poses.device.type == "cpu":
        return residual_chi2_plain(poses, e_from, e_to, meas, info, valid, huber_delta)
    dev, f32 = poses.device, torch.float32
    E, n = e_from.shape[0], poses.shape[0]
    ptrs = [
        _check("poses", poses, (n, 7), f32, dev),
        _check("e_from", e_from, (E,), torch.int32, dev),
        _check("e_to", e_to, (E,), torch.int32, dev),
        _check("meas", meas, (E, 7), f32, dev),
        _check("info", info, (E, 6, 6), f32, dev),
        _check("valid", valid, (E,), f32, dev),
    ]
    lib = _build.load()
    nb = -(-E // _THREADS)
    out = torch.empty(E * 6 + nb + 1, dtype=f32, device=dev)
    r = out[: E * 6].view(E, 6)
    chi2 = out[E * 6 + nb:].view(())
    err = lib.uz_residual_chi2(*ptrs, float(huber_delta), E, r.data_ptr(),
                               out[E * 6:].data_ptr(), chi2.data_ptr(), _stream(dev))
    _raise_on(err, "residual_chi2")
    launches["residual_chi2"] += 1
    return r, chi2


# ---------------------------------------------------------------------------
# K5 relax_min
# ---------------------------------------------------------------------------

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
    """K5: multi-source Bellman-Ford, one CTA per row of ``dist0``."""
    if dist0.device.type == "cpu":
        return relax_min_plain(dist0, e_from, e_to, w, n_iters)
    dev, f32 = dist0.device, torch.float32
    rows, n = dist0.shape
    E = e_from.shape[0]
    ptrs = [
        _check("dist0", dist0, (rows, n), f32, dev),
        _check("e_from", e_from, (E,), torch.int32, dev),
        _check("e_to", e_to, (E,), torch.int32, dev),
        _check("w", w, (E,), f32, dev),
    ]
    lib = _build.load()
    out = torch.empty(rows, n, dtype=f32, device=dev)
    scratch = None if 8 * n <= _SMEM_BYTES else torch.empty(2 * rows * n, dtype=f32, device=dev)
    err = lib.uz_relax_min(*ptrs, rows, n, E, int(n_iters), out.data_ptr(),
                           None if scratch is None else scratch.data_ptr(), _stream(dev))
    _raise_on(err, "relax_min")
    launches["relax_min"] += 1
    return out


# ---------------------------------------------------------------------------
# K6 cluster_labels
# ---------------------------------------------------------------------------

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
    """K6: spatio-temporal cluster labels of B candidates, one CTA."""
    if stamp_from.device.type == "cpu":
        return cluster_labels_plain(stamp_from, stamp_to, valid, max_dt, n_iters)
    dev, f32 = stamp_from.device, torch.float32
    b = stamp_from.shape[0]
    if 20 * b > _SMEM_BYTES:
        raise ValueError(f"cluster_labels: {b} candidates exceed one CTA's shared memory")
    ptrs = [
        _check("stamp_from", stamp_from, (b,), f32, dev),
        _check("stamp_to", stamp_to, (b,), f32, dev),
        _check("valid", valid, (b,), torch.bool, dev),
    ]
    lib = _build.load()
    labels = torch.empty(b, dtype=torch.int32, device=dev)
    err = lib.uz_cluster_labels(*ptrs, b, float(max_dt), int(n_iters), labels.data_ptr(),
                                _stream(dev))
    _raise_on(err, "cluster_labels")
    launches["cluster_labels"] += 1
    return labels


# ---------------------------------------------------------------------------
# K7 ransac_rigid
# ---------------------------------------------------------------------------

def ransac_hypotheses_plain(src, dst, valid, tri):
    """The hypothesis stage of K7's plain version: (clamped triplets (R, K,
    3), squared error of every point under every Horn fit (R, K, M))."""
    from uzliti_slam_tpu_torch.ops import lie, ransac

    R, M, _ = src.shape
    K = tri.shape[1]
    ti = tri.long().clamp(0, M - 1)            # gathers clamp, as in JAX
    flat = ti.reshape(R, K * 3)

    def pick(x):
        return torch.gather(x, 1, flat[..., None].expand(R, K * 3, 3)).reshape(R, K, 3, 3)

    w = torch.gather(valid.to(src.dtype), 1, flat).reshape(R, K, 3)
    hyp = ransac.kabsch_quat(pick(src), pick(dst), w)
    pred = lie.pose_apply(hyp[:, :, None, :], src[:, None])          # (R, K, M, 3)
    return ti, torch.sum((pred - dst[:, None]) ** 2, dim=-1)


def ransac_rigid_plain(src, dst, valid, tri, inlier_thresh: float, min_consensus: int,
                       min_sigma: float):
    """Plain version of K7 for R roots: src/dst (R, M, 3), valid (R, M),
    triplets tri (R, K, 3).  Returns (pose (R, 7), consensus (R,) int32,
    mse (R,), information (R, 6, 6), ok (R,), best (R,) int32, counts
    (R, K) int32), as ``uzliti_slam_tpu/ops/ransac.py:ransac_rigid``."""
    from uzliti_slam_tpu_torch.ops import lie, ransac

    R, M, _ = src.shape
    w = valid.to(src.dtype)
    ti, err2 = ransac_hypotheses_plain(src, dst, valid, tri)
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
    return refit, consensus, mse, information, ok, best.to(torch.int32), counts


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


def ransac_rigid(src, dst, valid, tri, inlier_thresh: float, min_consensus: int,
                 min_sigma: float):
    """K7: RANSAC rigid fits of R roots, one CTA per root.  ``src``/``dst``
    may be broadcast views of one (M, 3) table (root stride 0)."""
    if src.device.type == "cpu":
        return ransac_rigid_plain(src, dst, valid, tri, inlier_thresh, min_consensus, min_sigma)
    dev, f32, i32 = src.device, torch.float32, torch.int32
    R, M, _ = src.shape
    K = tri.shape[1]
    if not 0 < K <= 1024:
        raise ValueError(f"ransac_rigid: {K} hypotheses, the kernel takes 1..1024")
    src_p, src_s = _root_view("src", src, R, M, dev)
    dst_p, dst_s = _root_view("dst", dst, R, M, dev)
    valid_p = _check("valid", valid, (R, M), torch.bool, dev)
    tri_p = _check("tri", tri, (R, K, 3), i32, dev)
    lib = _build.load()
    pose = torch.empty(R, 7, dtype=f32, device=dev)
    consensus = torch.empty(R, dtype=i32, device=dev)
    mse = torch.empty(R, dtype=f32, device=dev)
    information = torch.empty(R, 6, 6, dtype=f32, device=dev)
    ok = torch.empty(R, dtype=torch.bool, device=dev)
    best = torch.empty(R, dtype=i32, device=dev)
    counts = torch.empty(R, K, dtype=i32, device=dev)
    err = lib.uz_ransac_rigid(
        src_p, src_s, dst_p, dst_s, valid_p, tri_p, R, M, K, float(inlier_thresh**2),
        int(min_consensus), float(min_sigma**2), pose.data_ptr(), consensus.data_ptr(),
        mse.data_ptr(), information.data_ptr(), ok.data_ptr(), best.data_ptr(),
        counts.data_ptr(), _stream(dev))
    _raise_on(err, "ransac_rigid")
    launches["ransac_rigid"] += 1
    return pose, consensus, mse, information, ok, best, counts


# ---------------------------------------------------------------------------
# K8 components (connected components + gauge fixing)
# ---------------------------------------------------------------------------

def components_plain(e_from, e_to, e_valid, n_nodes: int, n_iters: int):
    """Plain version of K8's labels: min-label propagation over valid edges
    with two pointer jumps per round; (N,) int32."""
    labels = torch.arange(n_nodes, dtype=torch.int32, device=e_from.device)
    ef, et = e_from.long(), e_to.long()
    big = torch.iinfo(torch.int32).max
    for _ in range(n_iters):
        upd = torch.where(e_valid, torch.minimum(labels[ef], labels[et]), big)
        labels = labels.scatter_reduce(0, ef, upd, "amin")
        labels = labels.scatter_reduce(0, et, upd, "amin")
        labels = labels[labels.long()]
        labels = labels[labels.long()]
    return labels


def components(e_from, e_to, e_valid, n_nodes: int, n_iters: int):
    """K8 labels: one CTA in shared memory while 12·N bytes fit, else one
    grid launch per pass."""
    if e_from.device.type == "cpu":
        return components_plain(e_from, e_to, e_valid, n_nodes, n_iters)
    dev, i32 = e_from.device, torch.int32
    E = e_from.shape[0]
    ptrs = [
        _check("e_from", e_from, (E,), i32, dev),
        _check("e_to", e_to, (E,), i32, dev),
        _check("e_valid", e_valid, (E,), torch.bool, dev),
    ]
    lib = _build.load()
    labels = torch.empty(n_nodes, dtype=i32, device=dev)
    scratch = (None if 12 * n_nodes <= _SMEM_BYTES
               else torch.empty(2 * n_nodes, dtype=i32, device=dev))
    err = lib.uz_components(*ptrs, E, n_nodes, int(n_iters), labels.data_ptr(),
                            None if scratch is None else scratch.data_ptr(), _stream(dev))
    _raise_on(err, "components")
    launches["components"] += 1
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


def gauge_fix(labels, node_valid, node_fixed, stamp):
    """K8 gauge pass: (N,) bool, from ``components`` labels."""
    if labels.device.type == "cpu":
        return gauge_fix_plain(labels, node_valid, node_fixed, stamp)
    dev = labels.device
    n = labels.shape[0]
    ptrs = [
        _check("labels", labels, (n,), torch.int32, dev),
        _check("node_valid", node_valid, (n,), torch.bool, dev),
        _check("node_fixed", node_fixed, (n,), torch.bool, dev),
        _check("stamp", stamp, (n,), torch.float32, dev),
    ]
    lib = _build.load()
    gauge = torch.empty(n, dtype=torch.bool, device=dev)
    scratch = (None if 12 * n <= _SMEM_BYTES
               else torch.empty(3 * n, dtype=torch.int32, device=dev))
    err = lib.uz_gauge_fix(*ptrs, n, gauge.data_ptr(),
                           None if scratch is None else scratch.data_ptr(), _stream(dev))
    _raise_on(err, "components")
    launches["components"] += 1
    return gauge


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
    """D padded with identity blocks and U with zero blocks to 2^k rows."""
    n = D.shape[0]
    n2 = _pow2(n)
    if n2 == n:
        return D, U
    pad = n2 - n
    eye = torch.eye(6, dtype=D.dtype, device=D.device).expand(pad, 6, 6)
    return torch.cat([D, eye]), torch.cat([U, U.new_zeros(pad, 6, 6)])


def root_matrix_plain(Dk: torch.Tensor, Uk: torch.Tensor) -> torch.Tensor:
    """The dense (6m, 6m) root system tridiag(Uᵀ, D, U) + 1e-8·I that the
    factor inverts (Uk[m-1] is not read)."""
    m = Dk.shape[0]
    dev, dt = Dk.device, Dk.dtype
    eye = torch.eye(m, dtype=dt, device=dev)
    sup = torch.diag(torch.ones(m - 1, dtype=dt, device=dev), 1)
    Us = torch.cat([Uk[: m - 1], Uk.new_zeros(1, 6, 6)])
    # A[i, :, j, :] = D[i] (i=j), U[i] (j=i+1), U[j]ᵀ (j=i-1)
    A = (
        torch.einsum("ij,iab->iajb", eye, Dk)
        + torch.einsum("ij,iab->iajb", sup, Us)
        + torch.einsum("ji,jba->iajb", sup, Us)
    ).reshape(m * 6, m * 6)
    return A + 1e-8 * torch.eye(m * 6, dtype=dt, device=dev)


def _dense_root_inverse(Dk: torch.Tensor, Uk: torch.Tensor) -> torch.Tensor:
    """Dense inverse of the remaining (m·6)×(m·6) block-tridiagonal system,
    by LU (``torch.linalg.inv_ex``: no error check, so no host sync), in
    row-major layout (the CUDA library returns it column-major)."""
    if Dk.shape[0] == 1:
        return _inv6(Dk[0])
    return torch.linalg.inv_ex(root_matrix_plain(Dk, Uk))[0].contiguous()


def chain_reduce_plain(D: torch.Tensor, U: torch.Tensor, dense_cutoff: int = 64,
                       work_dtype: torch.dtype = torch.float64):
    """The factor's reduction levels, computed in ``work_dtype`` and stored
    in D's dtype, and the root blocks (Dk, Uk) they leave, in
    ``work_dtype``.  Float64 by default, as K9 computes: each level's newD
    cancels, and a float32 reduction (the reference's) loses about a bit
    per level (2.6e-4 of the largest entry after 11 levels)."""
    out_dtype = D.dtype
    n_orig = D.shape[0]
    D, U = D.to(work_dtype), U.to(work_dtype).clone()
    U[n_orig - 1] = 0.0
    D, U = _pad_pow2(D, U)
    eye = torch.eye(6, dtype=D.dtype, device=D.device)
    levels = []
    Dk, Uk = D, U
    while Dk.shape[0] > max(dense_cutoff, 1):
        De, Do = Dk[0::2], Dk[1::2]
        Ueo = Uk[0::2]          # couples even j -> odd j+1
        Uoe = Uk[1::2]          # couples odd j+1 -> even j+2
        Dinv_o = _inv6(Do)
        Uoe_m = torch.cat([Uoe.new_zeros(1, 6, 6), Uoe[:-1]])
        Dinv_om = torch.cat([eye[None], Dinv_o[:-1]])

        P1m = Uoe_m.transpose(-1, -2) @ Dinv_om
        P2 = Ueo @ Dinv_o
        G1 = Dinv_o @ Ueo.transpose(-1, -2)
        G2 = Dinv_o @ Uoe

        t1 = P1m @ Uoe_m
        t2 = P2 @ Ueo.transpose(-1, -2)
        newD = De - t1 - t2
        newU = -(P2 @ Uoe)
        newU[-1] = 0.0
        levels.append(tuple(t.to(out_dtype) for t in (Dinv_o, P1m, P2, G1, G2)))
        Dk, Uk = newD, newU
    return tuple(levels), Dk, Uk


def chain_factor_plain(D: torch.Tensor, U: torch.Tensor, dense_cutoff: int = 64,
                       work_dtype: torch.dtype = torch.float64):
    """Plain version of K9: ``(levels, root_inv, n)`` of the symmetric
    block-tridiagonal matrix with diagonal blocks D (n, 6, 6) and U[i] =
    A[i, i+1] (U[n-1] is treated as zero); each level is
    ``(Dinv_o, P1m, P2, G1, G2)``.  Computed in ``work_dtype`` (float64, as
    K9 computes, where the reference computes in float32), returned in D's
    dtype."""
    levels, Dk, Uk = chain_reduce_plain(D, U, dense_cutoff, work_dtype)
    return levels, _dense_root_inverse(Dk, Uk).to(D.dtype), D.shape[0]


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
    for a, b in zip((t for lv in fresh[0] for t in lv), (t for lv in held[0] for t in lv)):
        b.copy_(torch.where(need, a, b))
    held[1].copy_(torch.where(need, fresh[1], held[1]))


def chain_factor(D, U, dense_cutoff: int = 64, held=None, need=None):
    """K9: the chain preconditioner's cyclic-reduction factor.

    Without ``held`` it builds a new factor.  With ``held`` (a factor of
    the same shapes) and ``need`` (a () bool device flag) it rebuilds
    ``held`` in place when ``need`` is set and leaves it as it is
    otherwise, and returns ``held``; the flag is read on the device (the
    kernels return at once when it is 0), never on the host.  On CPU
    tensors the plain version builds the factor and selects it into
    ``held`` with ``torch.where``.
    """
    n = D.shape[0]
    if D.device.type == "cpu":
        fresh = chain_factor_plain(D, U, dense_cutoff)
        builds = factor_builds(D.device)
        if held is None:
            builds.add_(1)
            return fresh
        builds.add_(need.to(builds.dtype))
        _select_factor_into(need, fresh, held)
        return held
    dev, f32 = D.device, torch.float32
    ptrs = [_check("D", D, (n, 6, 6), f32, dev), _check("U", U, (n, 6, 6), f32, dev)]
    halves, m_root = _factor_shapes(n, dense_cutoff)
    if m_root > 64:
        raise ValueError(f"chain_factor: a root of {m_root} blocks (dense_cutoff "
                         f"{dense_cutoff}); the root kernel takes at most 64")
    if held is None:
        if need is not None:
            raise ValueError("chain_factor: a refresh flag needs a held factor")
        levels = tuple(tuple(torch.empty(5, h, 6, 6, dtype=f32, device=dev).unbind(0))
                       for h in halves)
        root_inv = torch.empty(6 * m_root, 6 * m_root, dtype=f32, device=dev)
        need_ptr = None
    else:
        levels, root_inv, n_held = held
        if n_held != n or [lv[0].shape[0] for lv in levels] != halves:
            raise ValueError("chain_factor: the held factor has other shapes")
        for lv, h in zip(levels, halves):
            for name, t in zip(("Dinv_o", "P1m", "P2", "G1", "G2"), lv):
                _check(name, t, (h, 6, 6), f32, dev)
        _check("root_inv", root_inv, (6 * m_root, 6 * m_root), f32, dev)
        need_ptr = _check("need", need, (), torch.bool, dev)
    lib = _build.load()
    stream = _stream(dev)
    # float64 scratch: each level's newD, newU, and the root's work columns
    scratch = torch.empty(2 * 36 * sum(halves) + 36 * m_root * m_root, dtype=torch.float64,
                          device=dev)
    src_D, src_U, in_double, n_valid, off = ptrs[0], ptrs[1], 0, n, 0
    for lv, h in zip(levels, halves):
        newD, newU = scratch[off: off + 36 * h], scratch[off + 36 * h: off + 72 * h]
        err = lib.uz_chain_factor_level(src_D, src_U, in_double, n_valid, h,
                                        *(t.data_ptr() for t in lv),
                                        newD.data_ptr(), newU.data_ptr(), need_ptr, stream)
        _raise_on(err, "chain_factor")
        src_D, src_U, in_double, n_valid = newD.data_ptr(), newU.data_ptr(), 1, h
        off += 72 * h
    err = lib.uz_chain_factor_root(src_D, src_U, in_double, n_valid, m_root,
                                   root_inv.data_ptr(), scratch[off:].data_ptr(), need_ptr,
                                   factor_builds(dev).data_ptr(), stream)
    _raise_on(err, "chain_factor")
    launches["chain_factor"] += 1
    return levels, root_inv, n


# ---------------------------------------------------------------------------
# K10 pcg (the vector updates of solver._pcg)
# ---------------------------------------------------------------------------
# State: x, r, p (n, 6) and scal = [rz, b2, ok, ...] on the device, updated
# in place by the step functions (the kernel's scal has a fourth slot).

PCG_CTA_MAX = 32768   # floats: above this K10 takes its grid route (csrc/pcg.cu)
_PCG_CHUNK = 4096     # floats per CTA on the grid route


def pcg_init_plain(b, z):
    """Plain version of K10's first launch: (x, r, p, scal) from b and
    z0 = M⁻¹b."""
    x = torch.zeros_like(b)
    r = b.clone()
    p = z.clone()
    scal = torch.stack([torch.sum(r * z), torch.sum(b * b), torch.ones_like(b[0, 0])])
    return x, r, p, scal


def pcg_alpha_plain(p, Hp, x, r, scal, tol: float) -> None:
    """Plain version of K10 after Hp = H·p: the stall test and x, r in place."""
    rz, b2 = scal[0], scal[1]
    pHp = torch.sum(p * Hp)
    ok = (pHp > 1e-20) & (rz > tol * (b2 + 1e-30))
    alpha = torch.where(ok, rz / torch.where(pHp == 0, 1.0, pHp), 0.0)
    x.copy_(x + alpha * p)
    r.copy_(r - alpha * Hp)
    scal[2] = ok.to(scal.dtype)


def pcg_beta_plain(r, z, p, scal) -> None:
    """Plain version of K10 after z = M⁻¹r: p and rz in place."""
    rz, ok = scal[0], scal[2] > 0
    rz_new = torch.sum(r * z)
    beta = torch.where(ok, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
    p.copy_(torch.where(ok, z + beta * p, p))
    scal[0] = torch.where(ok, rz_new, rz)


def _pcg_checks(dev, n, **vectors):
    for name, t in vectors.items():
        _check(name, t, (n, 6), torch.float32, dev)


def _pcg_partials(n: int, dev):
    """Scratch of K10's grid route (None: the one-CTA route)."""
    if 6 * n <= PCG_CTA_MAX:
        return None
    return torch.empty(2 * -(-6 * n // _PCG_CHUNK), dtype=torch.float32, device=dev)


def _ptr(t):
    return None if t is None else t.data_ptr()


def pcg_init(b, z):
    """K10 before the loop: x = 0, r = b, p = z0, rz = rᵀz0, b2 = bᵀb."""
    if b.device.type == "cpu":
        return pcg_init_plain(b, z)
    dev, n = b.device, b.shape[0]
    _pcg_checks(dev, n, b=b, z=z)
    lib = _build.load()
    xrp = torch.empty(3, n, 6, dtype=torch.float32, device=dev)
    scal = torch.empty(4, dtype=torch.float32, device=dev)
    err = lib.uz_pcg_init(b.data_ptr(), z.data_ptr(), 6 * n, xrp[0].data_ptr(),
                          xrp[1].data_ptr(), xrp[2].data_ptr(), scal.data_ptr(),
                          _ptr(_pcg_partials(n, dev)), _stream(dev))
    _raise_on(err, "pcg")
    launches["pcg"] += 1
    return xrp[0], xrp[1], xrp[2], scal


def pcg_alpha(p, Hp, x, r, scal, tol: float) -> None:
    """K10 after Hp = H·p: pHp, the stall flag, α; x += α·p, r -= α·Hp."""
    if p.device.type == "cpu":
        return pcg_alpha_plain(p, Hp, x, r, scal, tol)
    dev, n = p.device, p.shape[0]
    _pcg_checks(dev, n, p=p, Hp=Hp, x=x, r=r)
    lib = _build.load()
    err = lib.uz_pcg_alpha(p.data_ptr(), Hp.data_ptr(), 6 * n, float(tol), x.data_ptr(),
                           r.data_ptr(), _check("scal", scal, (4,), torch.float32, dev),
                           _ptr(_pcg_partials(n, dev)), _stream(dev))
    _raise_on(err, "pcg")
    launches["pcg"] += 1


def pcg_beta(r, z, p, scal) -> None:
    """K10 after z = M⁻¹r: rz', β; p = z + β·p and rz = rz' where not stalled."""
    if r.device.type == "cpu":
        return pcg_beta_plain(r, z, p, scal)
    dev, n = r.device, r.shape[0]
    _pcg_checks(dev, n, r=r, z=z, p=p)
    lib = _build.load()
    err = lib.uz_pcg_beta(r.data_ptr(), z.data_ptr(), 6 * n, p.data_ptr(),
                          _check("scal", scal, (4,), torch.float32, dev),
                          _ptr(_pcg_partials(n, dev)), _stream(dev))
    _raise_on(err, "pcg")
    launches["pcg"] += 1


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


def project_rays_plain(logodds, cx, cy, kbin, scans, idx, count, D, bin0, Wray, res: float,
                       max_range: float, hit: float, miss: float, clamp: float, mark: bool):
    """Plain version of K11: (log-odds (size, size), per-cell sum of
    |node terms| (size, size) float64).

    For the ``count`` nodes ``idx[:count]`` (node slots into ``cx``, ``cy``,
    ``kbin``, ``scans``), every cell gathers the centre tables ``D``,
    ``bin0``, ``Wray`` (size², row-major) at (r - cy + c0, c - cx + c0) and
    the node's range at bin (bin0 - kbin) mod B, classifies itself free or
    occupied, and the terms are summed in float64 over nodes; then clip,
    and with ``mark`` the node footprint marks and a second clip.  Reads
    ``count`` on the host.
    """
    size, B = logodds.shape[0], scans.shape[1]
    dev, c0 = logodds.device, size // 2
    nodes = idx[: int(count)].long()
    rows = torch.arange(size, device=dev)
    acc = torch.zeros(size, size, dtype=torch.float64, device=dev)
    mag = torch.zeros(size, size, dtype=torch.float64, device=dev)
    for s in range(0, nodes.shape[0], _PROJECT_NODE_CHUNK):
        nd = nodes[s: s + _PROJECT_NODE_CHUNK]
        k = nd.shape[0]
        pr = rows[None, :] - cy[nd].long()[:, None] + c0            # (k, size)
        pc = rows[None, :] - cx[nd].long()[:, None] + c0
        inside = (((pr >= 0) & (pr < size))[:, :, None]
                  & ((pc >= 0) & (pc < size))[:, None, :])
        q = pr.clamp(0, size - 1)[:, :, None] * size + pc.clamp(0, size - 1)[:, None, :]
        d, w = D[q], Wray[q]
        bb = torch.remainder(bin0[q].long() - kbin[nd].long()[:, None, None], B)
        rng = torch.gather(scans[nd], 1, bb.reshape(k, -1)).reshape(k, size, size)
        rng = torch.where(torch.isfinite(rng), rng, BIG)
        has = rng < BIG * 0.5
        reach = torch.clamp(rng, max=max_range)
        free = has & (d < reach - res)
        occ = has & (rng <= max_range) & (torch.abs(d - rng) < 0.71 * res)
        E = torch.where(inside, w * (free * miss + occ * hit), 0.0)
        acc += E.double().sum(0)
        mag += E.abs().double().sum(0)
    out = torch.clamp(logodds + acc.to(logodds.dtype), -clamp, clamp)
    if mark:
        active = torch.zeros(cx.shape[0], dtype=torch.bool, device=dev).index_fill_(0, nodes, True)
        out = mark_cells_plain(out, cx, cy, active, 2.0 * miss, clamp)
    return out, mag


def project_rays(logodds, cx, cy, kbin, scans, idx, count, D, bin0, Wray, res: float,
                 max_range: float, hit: float, miss: float, clamp: float, mark: bool):
    """K11: the occupancy projection of the ``count`` (a () int32 device
    tensor) nodes ``idx[:count]`` onto ``logodds``; returns the new grid.
    The count is read by the kernel, never on the host."""
    if logodds.device.type == "cpu":
        return project_rays_plain(logodds, cx, cy, kbin, scans, idx, count, D, bin0, Wray,
                                  res, max_range, hit, miss, clamp, mark)[0]
    dev, f32, i32 = logodds.device, torch.float32, torch.int32
    size = logodds.shape[0]
    n, B = scans.shape
    ptrs = [
        _check("logodds", logodds, (size, size), f32, dev),
        _check("D", D, (size * size,), f32, dev),
        _check("bin0", bin0, (size * size,), i32, dev),
        _check("Wray", Wray, (size * size,), f32, dev),
        _check("scans", scans, (n, B), f32, dev),
    ]
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
    W) float32 images."""
    from uzliti_slam_tpu_torch.ops import features

    return features.nms(features.fast_score(img, threshold))


def fast_nms(img, threshold: float):
    """K12: FAST-9/16 scores with the border mask and the 3x3 NMS fused,
    (C, H, W) float32 -> (C, H, W) float32; one launch per pyramid level."""
    if img.device.type == "cpu":
        return fast_nms_plain(img, threshold)
    C, H, W = _images("img", img)
    ptr = _check("img", img, (C, H, W), torch.float32, img.device)
    lib = _build.load()
    out = torch.empty_like(img)
    err = lib.uz_fast_nms(ptr, C, H, W, float(threshold), out.data_ptr(), _stream(img.device))
    _raise_on(err, "fast_nms")
    launches["fast_nms"] += 1
    return out


# ---------------------------------------------------------------------------
# K13 grid_topk (per-cell top-k, then the global top-k or padding)
# ---------------------------------------------------------------------------

def _grid_shapes(H: int, W: int, k_total: int, grid: int) -> tuple[int, int, int, int]:
    """(cell height, cell width, k per cell, keypoints from the cells)."""
    k_cell = max(k_total // (grid * grid), 1)
    return H // grid, W // grid, k_cell, grid * grid * k_cell


def grid_topk_plain(score, k_total: int, grid: int):
    """Plain version of K13 on (C, H, W) scores: (uv (C, k_total, 2), resp
    (C, k_total), valid (C, k_total)).  A stable descending sort, so ties
    go to the lower index (row-major in the cell, then cell order), as
    XLA's top_k and approx_max_k do on the CPU; ``torch.topk`` does not
    promise that order.  With one keypoint per cell the tie goes to the
    higher index, as XLA's k = 1 form (a max reduction) does."""
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


def grid_topk(score, k_total: int, grid: int):
    """K13: the exact top-k of each (camera, cell), one CTA per cell, ties
    to the lower index; when the cells give more than ``k_total``, a second
    launch (one CTA per camera) keeps the global top ``k_total``; when
    fewer, the zero-initialised outputs are the padding."""
    if score.device.type == "cpu":
        return grid_topk_plain(score, k_total, grid)
    dev = score.device
    C, H, W = _images("score", score)
    ptr = _check("score", score, (C, H, W), torch.float32, dev)
    gh, gw, k_cell, n = _grid_shapes(H, W, k_total, grid)
    if gh * gw == 0 or k_cell > gh * gw:
        raise ValueError(f"grid_topk: {k_cell} per cell of {gh}x{gw} pixels")
    lib = _build.load()
    uv = torch.zeros(C, k_total, 2, dtype=torch.float32, device=dev)
    resp = torch.zeros(C, k_total, dtype=torch.float32, device=dev)
    valid = torch.zeros(C, k_total, dtype=torch.bool, device=dev)
    # the cells' candidates go to scratch when a global top-k follows
    scratch = torch.empty(C, n, 3, dtype=torch.float32, device=dev) if n > k_total else None
    err = lib.uz_grid_topk(ptr, C, H, W, grid, k_cell, k_total, _ptr(scratch), uv.data_ptr(),
                           resp.data_ptr(), valid.data_ptr(), _stream(dev))
    _raise_on(err, "grid_topk")
    launches["grid_topk"] += 1
    return uv, resp, valid


# ---------------------------------------------------------------------------
# K14 orb_describe (box blur, intensity-centroid angle, steered descriptor)
# ---------------------------------------------------------------------------

def orb_describe_plain(img, uv, pattern, angles=None):
    """Plain version of K14 on (C, H, W) images and (C, K, 2) keypoints:
    (angles (C, K), descriptors (C, K, 32) uint8).  Given ``angles`` are
    used as they are (the GIST's roll)."""
    from uzliti_slam_tpu_torch.ops import features

    if angles is None:
        angles = features.intensity_centroid_angles(img, uv)
    return angles, features.brief_descriptors(img, uv, angles, pattern)


def orb_describe(img, uv, pattern, angles=None):
    """K14: a separable 5x5 box blur of each image (one launch), then one
    warp per keypoint: the intensity-centroid angle on the unblurred image
    (or the given angle), the pattern rotated by it, 256 nearest-pixel
    tests on the blurred image packed by ``__ballot_sync``."""
    if img.device.type == "cpu":
        return orb_describe_plain(img, uv, pattern, angles)
    dev, f32 = img.device, torch.float32
    C, H, W = _images("img", img)
    K = uv.shape[1]
    ptrs = [_check("img", img, (C, H, W), f32, dev), _check("uv", uv, (C, K, 2), f32, dev),
            _check("pattern", pattern, (256, 2, 2), f32, dev)]
    if angles is not None:
        _check("angles", angles, (C, K), f32, dev)
    lib = _build.load()
    blurred = torch.empty(C, H, W, dtype=f32, device=dev)
    ang = angles if angles is not None else torch.empty(C, K, dtype=f32, device=dev)
    desc = torch.empty(C, K, 32, dtype=torch.uint8, device=dev)
    err = lib.uz_orb_describe(*ptrs, C, H, W, K, int(angles is not None), blurred.data_ptr(),
                              ang.data_ptr(), desc.data_ptr(), _stream(dev))
    _raise_on(err, "orb_describe")
    launches["orb_describe"] += 1
    return ang, desc


# ---------------------------------------------------------------------------
# K15 scan_bins (depth -> per-bin near/far range)
# ---------------------------------------------------------------------------

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
    from uzliti_slam_tpu_torch.ops import scan

    rng, ok, bins = scan_pixels_plain(depth, cam, xf, n_bins, angle_min, angle_max,
                                      height_band, max_range, min_range)
    near, far = bin_min_max_plain(rng, ok, bins, n_bins, max_range)
    return near, torch.where(torch.isfinite(far), far, torch.inf)


def bin_min_max_plain(rng, ok, bins, n_bins: int, max_range: float):
    """Plain version of K15's ``bin_min_max`` entry: per-bin (near, far) of
    (..., P) ranges, flags and bins (leading dimensions: one scan each),
    from the 21-bit quantised ranges of the ``ok`` entries by
    ``scatter_reduce``; +inf / -inf for an empty bin.  The write-back is
    q · fl(1 / scale): the compiled form of the reference's ``q / scale``."""
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


def bin_min_max(rng, ok, bins, n_bins: int, max_range: float):
    """K15's second entry point: one CTA per scan, atomicMin / atomicMax of
    the 21-bit quantised ranges on int32 bins in shared memory (exact and
    order-free), then q · fl(1/scale) or ±inf.  Returns (near, far)."""
    if rng.device.type == "cpu":
        return bin_min_max_plain(rng, ok, bins, n_bins, max_range)
    from uzliti_slam_tpu_torch.ops import scan

    dev, f32 = rng.device, torch.float32
    lead, P = tuple(rng.shape[:-1]), rng.shape[-1]
    B = math.prod(lead)
    if not 0 < n_bins <= 1023:
        raise ValueError(f"bin_min_max: {n_bins} bins, the kernel takes 1..1023")
    ptrs = [_check("rng", rng, lead + (P,), f32, dev),
            _check("ok", ok, lead + (P,), torch.bool, dev),
            _check("bins", bins, lead + (P,), torch.int32, dev)]
    lib = _build.load()
    out = torch.empty(2, B, n_bins, dtype=f32, device=dev)
    scale = scan.range_scale(max_range)
    err = lib.uz_bin_min_max(*ptrs, B, P, n_bins, scale, scan.f32_reciprocal(scale),
                             out.data_ptr(), _stream(dev))
    _raise_on(err, "bin_min_max")
    launches["bin_min_max"] += 1
    return out[0].reshape(lead + (n_bins,)), out[1].reshape(lead + (n_bins,))


def scan_bins(depth, cam, xf, n_bins: int, angle_min: float, angle_max: float,
              height_band, max_range: float, min_range: float):
    """K15: one thread per pixel (backprojection, extrinsic, band, range,
    bearing, bin), per-bin atomicMin/atomicMax of the 21-bit quantised
    range in shared memory, then into a (C, 2, B) table, then a finalize
    launch writes q / scale (or +inf)."""
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
    table = torch.empty(C, 2, n_bins, dtype=torch.int32, device=dev)
    out = torch.empty(2, C, n_bins, dtype=f32, device=dev)
    scale = scan.range_scale(max_range)
    err = lib.uz_scan_bins(*ptrs, C, H, W, float(cam.fx), float(cam.fy), float(cam.cx),
                           float(cam.cy), n_bins, float(angle_min), float(angle_max),
                           scan.bin_factor(n_bins, angle_min, angle_max), float(height_band[0]),
                           float(height_band[1]), float(min_range), float(max_range), scale,
                           scan.f32_reciprocal(scale), table.data_ptr(), out.data_ptr(),
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
    """K16: all candidates' matching in one launch, a CTA per (query block,
    candidate), the candidate's stored descriptors gathered by slot into
    shared memory, a running best and second per query in registers."""
    if query.device.type == "cpu":
        return hamming_top2_plain(query, bank, bank_valid, cslot, valid_a, ratio, max_dist)
    dev, u8 = query.device, torch.uint8
    Na, (N, F, _), C = query.shape[0], bank.shape, cslot.shape[0]
    _smem_check("hamming_top2", 33 * F)
    ptrs = [_check("query", query, (Na, 32), u8, dev), _check("bank", bank, (N, F, 32), u8, dev),
            _check("bank_valid", bank_valid, (N, F), torch.bool, dev),
            _check("cslot", cslot, (C,), torch.int32, dev),
            _check("valid_a", valid_a, (Na,), torch.bool, dev)]
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
    """K16's GIST entry: one CTA, the bank's distances in shared memory, k
    rounds of a block-wide (distance, index) minimum."""
    if query.device.type == "cpu":
        return gist_topk_plain(query, bank, stamp, valid, q_stamp, k, min_dt, max_dist)
    dev, N = query.device, bank.shape[0]
    if not 0 < k <= N:
        raise ValueError(f"gist_topk: k = {k} of a {N}-entry bank")
    _smem_check("gist_topk", 4 * N)
    ptrs = [_check("query", query, (32,), torch.uint8, dev),
            _check("bank", bank, (N, 32), torch.uint8, dev),
            _check("stamp", stamp, (N,), torch.float32, dev),
            _check("valid", valid, (N,), torch.bool, dev),
            _check("q_stamp", q_stamp, (), torch.float32, dev)]
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


def bilateral(depth, guide):
    """K17: one thread per pixel over a shared-memory tile with a halo of 2,
    cameras on the grid; (C, H, W) float32 -> (C, H, W) float32."""
    if depth.device.type == "cpu":
        return bilateral_plain(depth, guide)
    dev, f32 = depth.device, torch.float32
    C, H, W = _images("depth", depth)
    ptrs = [_check("depth", depth, (C, H, W), f32, dev), _check("guide", guide, (C, H, W), f32, dev)]
    lib = _build.load()
    out = torch.empty_like(depth)
    table = (ctypes.c_float * len(bilateral_taps()))(*bilateral_spatial())
    err = lib.uz_bilateral(*ptrs, C, H, W, ctypes.addressof(table), NEG_INV_2SC2, out.data_ptr(),
                           _stream(dev))
    _raise_on(err, "bilateral")
    launches["bilateral"] += 1
    return out


# ---------------------------------------------------------------------------
# K18 icp (point-to-line ICP, all iterations in one launch)
# ---------------------------------------------------------------------------

ICP_MAX_POINTS = 8192   # target points one CTA's shared memory holds with the reductions


def lu_solve_plain(A, b):
    """x with A x = b for (..., n, n) and b (..., n) or (..., n, r):
    Gaussian elimination with partial pivoting (the first largest pivot),
    multipliers by division, the right-hand sides eliminated alongside, then
    back substitution (the kernels' 3x3 and 6x6 solves, K18's, K27's and
    K28's; no ``torch.linalg``)."""
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
    """K18: one CTA per problem, the target scan in shared memory, every
    iteration, the audit, the covariance and the gates in one launch."""
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


def merge_pairs(pose, stamp, eligible, dist_thresh: float, angle_thresh_deg: float,
                max_pairs: int):
    """K19: a warp per row i keeps the row's 2·max_pairs - 1 smallest keys
    (float bits of dt << 32 | i·N + j) of its close pairs; one CTA then runs
    the greedy rounds over that short list.  Returns (keep, absorb, ok)."""
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
    cand = torch.empty(n, 2 * max_pairs - 1, dtype=torch.int64, device=dev)
    keep = torch.empty(max_pairs, dtype=torch.int32, device=dev)
    absorb = torch.empty(max_pairs, dtype=torch.int32, device=dev)
    ok = torch.empty(max_pairs, dtype=torch.bool, device=dev)
    err = lib.uz_merge_pairs(*ptrs, n, float(dist_thresh), float(angle_thresh_deg), max_pairs,
                             cand.data_ptr(), keep.data_ptr(), absorb.data_ptr(), ok.data_ptr(),
                             _stream(dev))
    _raise_on(err, "merge_pairs")
    launches["merge_pairs"] += 1
    return keep, absorb, ok


# ---------------------------------------------------------------------------
# K20 calib_gn (the calibration's Gauss-Newton steps)
# ---------------------------------------------------------------------------

CALIB_SENSORS = (1, 2)   # sensor counts the kernel is built for (6·S + 3 parameters)
CALIB_THREADS = 256      # kCalibThreads in csrc/calib_gn.cu
CALIB_MAX_BLOCKS = 64    # CTAs of the edge pass: partial sums per CTA, reduced in order


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
    """K20: per step an edge-parallel pass (each edge's sensor and odometry
    residuals in forward-mode dual numbers with 6S + 3 tangents, JᵀJ, Jᵀr
    and ½‖r‖² summed in float64 in a fixed order) and a one-CTA pass (the
    priors, the damping, a pivoted solve, the update of θ on the device);
    all steps in one call, no host read.  Returns (theta, cost history)."""
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
    nb = max(1, min(CALIB_MAX_BLOCKS, -(-E // CALIB_THREADS)))
    partials = torch.empty(nb, P * (P + 1) // 2 + P + 1, dtype=torch.float64, device=dev)
    theta = torch.empty(P, dtype=f32, device=dev)
    hist = torch.empty(iterations + 1, dtype=f32, device=dev)
    err = lib.uz_calib_gn(*ptrs, E, S, int(iterations), calib_sqrt_prior(prior_weight),
                          float(damping), nb, partials.data_ptr(), theta.data_ptr(),
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


def feature_votes(query, qvalid, bank, bank_valid, stamp, valid, q_stamp, k: int,
                  thresh: float, min_sim: float, min_dt: float):
    """K21: a CTA per node (the query in shared memory), a running minimum
    per query descriptor by XOR and popcount, the votes summed in the CTA,
    ineligible nodes skipped; then a one-CTA top-k over the node sims."""
    if query.device.type == "cpu":
        return feature_votes_plain(query, qvalid, bank, bank_valid, stamp, valid, q_stamp, k,
                                   thresh, min_sim, min_dt)
    dev, u8 = query.device, torch.uint8
    Fq, (N, Fb, _) = query.shape[0], bank.shape
    _topk_check("feature_votes", k, N)
    _smem_check("feature_votes", 33 * (Fq + Fb))
    ptrs = [_check("query", query, (Fq, 32), u8, dev),
            _check("qvalid", qvalid, (Fq,), torch.bool, dev),
            _check("bank", bank, (N, Fb, 32), u8, dev),
            _check("bank_valid", bank_valid, (N, Fb), torch.bool, dev),
            _check("stamp", stamp, (N,), torch.float32, dev),
            _check("valid", valid, (N,), torch.bool, dev),
            _check("q_stamp", q_stamp, (), torch.float32, dev)]
    lib = _build.load()
    sims = torch.empty(N, dtype=torch.float32, device=dev)
    slots = torch.empty(k, dtype=torch.int32, device=dev)
    top = torch.empty(k, dtype=torch.float32, device=dev)
    ok = torch.empty(k, dtype=torch.bool, device=dev)
    err = lib.uz_feature_votes(*ptrs, Fq, Fb, N, k, float(thresh), float(min_sim), float(min_dt),
                               sims.data_ptr(), slots.data_ptr(), top.data_ptr(), ok.data_ptr(),
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
    """K22's search: a CTA per (query, chunk of the bank), the minimum of
    (distance << 32 | index) keys reduced in the CTA and by a 64-bit
    ``atomicMin`` across CTAs (the first index among equal distances), then
    a one-CTA pass decoding the keys and testing the F x F duplicates."""
    if query.device.type == "cpu":
        return repo_nearest_plain(query, qvalid, bank, bank_valid, thresh)
    dev, u8 = query.device, torch.uint8
    F, D = query.shape[0], bank.shape[0]
    _smem_check("repo_nearest", 33 * F)
    ptrs = [_check("query", query, (F, 32), u8, dev),
            _check("qvalid", qvalid, (F,), torch.bool, dev),
            _check("bank", bank, (D, 32), u8, dev),
            _check("bank_valid", bank_valid, (D,), torch.bool, dev)]
    lib = _build.load()
    keys = torch.full((F,), -1, dtype=torch.int64, device=dev)    # all ones: no candidate
    nn_dist = torch.empty(F, dtype=torch.float32, device=dev)
    nn_idx = torch.empty(F, dtype=torch.int32, device=dev)
    dup = torch.empty(F, dtype=torch.bool, device=dev)
    err = lib.uz_repo_nearest(*ptrs, F, D, float(thresh), keys.data_ptr(), nn_dist.data_ptr(),
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
    """K22's query: a thread per stored descriptor (the queries in shared
    memory) tests for a hit and adds its valid links' votes with integer
    ``atomicAdd`` (exact in any order); then a one-CTA gated top-k."""
    if query.device.type == "cpu":
        return repo_votes_plain(query, qvalid, bank, bank_valid, links, link_valid, node_stamp,
                                node_valid, q_stamp, k, thresh, min_votes, min_dt)
    dev, u8 = query.device, torch.uint8
    F, (D, L), N = query.shape[0], links.shape, node_stamp.shape[0]
    _topk_check("repo_votes", k, N)
    _smem_check("repo_votes", 33 * F)
    ptrs = [_check("query", query, (F, 32), u8, dev),
            _check("qvalid", qvalid, (F,), torch.bool, dev),
            _check("bank", bank, (D, 32), u8, dev),
            _check("bank_valid", bank_valid, (D,), torch.bool, dev),
            _check("links", links, (D, L), torch.int32, dev),
            _check("link_valid", link_valid, (D, L), torch.bool, dev),
            _check("node_stamp", node_stamp, (N,), torch.float32, dev),
            _check("node_valid", node_valid, (N,), torch.bool, dev),
            _check("q_stamp", q_stamp, (), torch.float32, dev)]
    lib = _build.load()
    votes = torch.zeros(N, dtype=torch.int32, device=dev)
    slots = torch.empty(k, dtype=torch.int32, device=dev)
    top = torch.empty(k, dtype=torch.int32, device=dev)
    ok = torch.empty(k, dtype=torch.bool, device=dev)
    err = lib.uz_repo_votes(*ptrs, F, D, L, N, k, float(thresh), float(min_votes), float(min_dt),
                            votes.data_ptr(), slots.data_ptr(), top.data_ptr(), ok.data_ptr(),
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

GICP_MAX_POINTS = 2048   # target points one CTA's shared memory holds with the reductions


def _gicp_pairs(moved, dst):
    d = moved[..., :, None, :] - dst[..., None, :, :]
    return sum_sq_fma(d[..., 0], d[..., 1], d[..., 2])


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
         max_corr2: float, color_weight: float, min_fraction: float, max_t: float, max_r: float):
    """K27: one CTA per target cloud, the target (points, Lab, normals) in
    shared memory, one thread per source point, every iteration, the audit
    and the gates in one launch."""
    if src.device.type == "cpu":
        return gicp_plain(src, src_lab, src_valid, dst, dst_lab, dst_valid, normals, init,
                          iterations, max_corr2, color_weight, min_fraction, max_t, max_r)
    dev, f32 = src.device, torch.float32
    M, (B, N, _) = src.shape[0], dst.shape
    if not 0 < N <= GICP_MAX_POINTS:
        raise ValueError(f"gicp: {N} target points, the kernel takes 1..{GICP_MAX_POINTS}")
    _smem_check("gicp", 37 * N + 27 * 4 * 256)
    ptrs = [_check("src", src, (M, 3), f32, dev), _check("src_lab", src_lab, (M, 3), f32, dev),
            _check("src_valid", src_valid, (M,), torch.bool, dev),
            _check("dst", dst, (B, N, 3), f32, dev), _check("dst_lab", dst_lab, (B, N, 3), f32, dev),
            _check("dst_valid", dst_valid, (B, N), torch.bool, dev),
            _check("normals", normals, (B, N, 3), f32, dev), _check("init", init, (B, 7), f32, dev)]
    lib = _build.load()
    pose = torch.empty(B, 7, dtype=f32, device=dev)
    fraction = torch.empty(B, dtype=f32, device=dev)
    mse = torch.empty(B, dtype=f32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    err = lib.uz_gicp(*ptrs, B, M, N, int(iterations), float(max_corr2), float(color_weight),
                      float(min_fraction), float(max_t), float(max_r), pose.data_ptr(),
                      fraction.data_ptr(), mse.data_ptr(), ok.data_ptr(), _stream(dev))
    _raise_on(err, "gicp")
    launches["gicp"] += 1
    return pose, fraction, mse, ok


# ---------------------------------------------------------------------------
# K28 pnp (the PnP RANSAC: hypotheses, then consensus and refinement)
# ---------------------------------------------------------------------------

PNP_SAMPLE = 6          # correspondences a hypothesis is fitted to
SVD_SWEEPS = 12         # one-sided Jacobi sweeps at most (kSvdSweeps in csrc/pnp.cu)
SVD_TOL = 1e-7          # a pair is rotated where |a_p·a_q| > SVD_TOL·|a_p||a_q|
PNP_MAX_POINTS = 2048   # correspondences one CTA's shared memory holds


def jacobi_svd_plain(A, sweeps: int = SVD_SWEEPS):
    """One-sided (Hestenes) cyclic Jacobi on (..., m, n): column pairs (p, q)
    in row-major order are rotated, with V, until they are orthogonal
    (|γ| ≤ SVD_TOL·√(αβ)), at most ``sweeps`` times; a sweep that rotates
    no pair of any matrix ends it (the kernels stop each matrix at its own
    such sweep, which changes nothing after).  Returns (A·V (..., m, n), V
    (..., n, n), σ (..., n) the column norms of A·V, unsorted)."""
    m, n = A.shape[-2:]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape[:-2] + (n, n))
    AV = torch.cat([A, eye], dim=-2)          # A's rows over V's: one rotation for both
    for _ in range(sweeps):
        rotated = False
        for p in range(n - 1):
            for q in range(p + 1, n):
                cp, cq = AV[..., :, p], AV[..., :, q]
                ap, aq = cp[..., :m], cq[..., :m]
                alpha, beta, gamma = (ap * ap).sum(-1), (aq * aq).sum(-1), (ap * aq).sum(-1)
                rot = gamma.abs() > SVD_TOL * torch.sqrt(alpha * beta)
                rotated = rotated or bool(rot.any())
                zeta = (beta - alpha) / (2.0 * torch.where(rot, gamma, torch.ones_like(gamma)))
                t = (torch.where(zeta >= 0, 1.0, -1.0)
                     / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta)))
                t = torch.where(rot, t, 0.0)
                c = 1.0 / torch.sqrt(1.0 + t * t)
                s = (c * t)[..., None]
                c = c[..., None]
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


def null_vector_plain(A):
    """The right singular vector of the smallest singular value of (..., m,
    n) matrices (the first on a tie), by ``jacobi_svd_plain``."""
    _, V, sig = jacobi_svd_plain(A)
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


def dlt_pose_plain(X, xn, w):
    """``uzliti_slam_tpu/ops/pnp.py:_dlt_pose`` on (..., n, ·) samples: the
    (2n, 12) system, its null vector, the det(M₃) sign folded into M, the
    proper polar factor of M₃ and t = M₄ / max(Σσ/3, 1e-12)."""
    from uzliti_slam_tpu_torch.ops import lie

    A = dlt_system_plain(X, xn, w)
    M = null_vector_plain(A).reshape(A.shape[:-2] + (3, 4))
    M = M * torch.where(_det3(M[..., :3]) < 0, -1.0, 1.0)[..., None, None]
    R, ssum = proper_rotation_plain(M[..., :3])
    t = M[..., 3] / torch.clamp(ssum / 3.0, min=1e-12)[..., None]
    return lie.make_pose(t, lie.matrix_to_quat(R))


def _norm3(v):
    return torch.sqrt((v * v).sum(-1))


def homography_pose_plain(X, xn, w):
    """``uzliti_slam_tpu/ops/pnp.py:_homography_pose`` on (..., n, ·)
    samples: the weighted centroid, the plane's two largest singular
    directions (one-sided Jacobi of the 6x3 spread), the (2n, 9) system's
    null vector H, σ = sgn(H₂₂), Gram-Schmidt of the scaled columns, and
    the world-to-camera rotation completed through the plane normal."""
    from uzliti_slam_tpu_torch.ops import lie

    wsum = torch.clamp(w.sum(-1), min=1e-6)
    c0 = (X * w[..., None]).sum(-2) / wsum[..., None]
    _, V, sig = jacobi_svd_plain((X - c0[..., None, :]) * w[..., None])
    order = torch.sort(sig, dim=-1, descending=True, stable=True).indices

    def col(i):
        return torch.gather(V, -1, order[..., i, None, None].expand(V.shape[:-1] + (1,)))[..., 0]

    e1, e2 = col(0), col(1)
    d = X - c0[..., None, :]
    px, py = (d * e1[..., None, :]).sum(-1), (d * e2[..., None, :]).sum(-1)
    x, y = xn[..., 0], xn[..., 1]
    z0, o = torch.zeros_like(px), torch.ones_like(px)
    r1 = torch.stack([px, py, o, z0, z0, z0, -x * px, -x * py, -x], dim=-1)
    r2 = torch.stack([z0, z0, z0, px, py, o, -y * px, -y * py, -y], dim=-1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    H = null_vector_plain(A).reshape(A.shape[:-2] + (3, 3))
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


def pnp_hypotheses_plain(X, xn, valid, depth, keys):
    """Plain version of K28's first entry point: per candidate b and draw h
    the 6 largest keys over the valid correspondences (−1e9 elsewhere, ties
    to the lower index), then the DLT, homography and (with ``depth``)
    Kabsch hypotheses of those 6.  X (B, M, 3), xn (B, M, 2), valid (B, M),
    depth (B, M) or None, keys (B, H, M).  Returns (samples (B, H, 6)
    int32, poses (B, F·H, 7), family-major, F = 3 with depth, else 2)."""
    scores = torch.where(valid[:, None, :], keys, -1e9)
    samples = largest_k(scores, PNP_SAMPLE)[1]

    def pick(t):
        return pnp_pick(t, samples)

    Xs, xs, ws = pick(X), pick(xn), pick(valid).to(X.dtype)
    poses = [dlt_pose_plain(Xs, xs, ws), homography_pose_plain(Xs, xs, ws)]
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
    """Plain version of K28's second entry point (``pnp_ransac`` after its
    hypotheses): the (B, K, M) consensus, −1 where a sample holds an
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


def _pnp_inputs(name: str, X, xn, valid, depth, dev):
    B, M, _ = X.shape
    if not 0 < M <= PNP_MAX_POINTS:
        raise ValueError(f"{name}: {M} correspondences, the kernel takes 1..{PNP_MAX_POINTS}")
    ptrs = [_check("X", X, (B, M, 3), torch.float32, dev),
            _check("xn", xn, (B, M, 2), torch.float32, dev),
            _check("valid", valid, (B, M), torch.bool, dev),
            None if depth is None else _check("depth", depth, (B, M), torch.float32, dev)]
    return B, M, ptrs


def pnp_hypotheses(X, xn, valid, depth, keys):
    """K28, first entry: one warp per (candidate, draw): the top 6 keys by
    warp-wide selection, the DLT (12x12), plane (6x3) and homography (12x9)
    systems by one-sided Jacobi with rows on lanes, the 3x3 polar and
    Kabsch rotations in registers."""
    if X.device.type == "cpu":
        return pnp_hypotheses_plain(X, xn, valid, depth, keys)
    dev = X.device
    B, M, ptrs = _pnp_inputs("pnp_hypotheses", X, xn, valid, depth, dev)
    if M < PNP_SAMPLE:
        raise ValueError(f"pnp_hypotheses: {M} correspondences, a draw takes {PNP_SAMPLE}")
    H = keys.shape[1]
    keys_p = _check("keys", keys, (B, H, M), torch.float32, dev)
    F = 2 if depth is None else 3
    lib = _build.load()
    samples = torch.empty(B, H, PNP_SAMPLE, dtype=torch.int32, device=dev)
    poses = torch.empty(B, F * H, 7, dtype=torch.float32, device=dev)
    err = lib.uz_pnp_hypotheses(*ptrs, keys_p, B, M, H, samples.data_ptr(), poses.data_ptr(),
                                _stream(dev))
    _raise_on(err, "pnp_hypotheses")
    launches["pnp"] += 1
    return samples, poses


def pnp_refine(X, xn, valid, depth, samples, poses, thresh2: float, depth_tol: float,
               min_consensus: float, iterations: int, f_mean2: float):
    """K28, second entry: one CTA per candidate: the K x M consensus a warp
    per hypothesis, the first argmax, the Gauss-Newton steps with the
    Jacobian in forward-mode dual numbers, JᵀJ and Jᵀr reduced in a fixed
    tree order, a pivoted 6x6 solve by one thread; the final audit."""
    if X.device.type == "cpu":
        return pnp_refine_plain(X, xn, valid, depth, samples, poses, thresh2, depth_tol,
                                min_consensus, iterations, f_mean2)
    dev, i32 = X.device, torch.int32
    B, M, ptrs = _pnp_inputs("pnp_refine", X, xn, valid, depth, dev)
    H, K = samples.shape[1], poses.shape[1]
    if K % H or K // H != (2 if depth is None else 3):
        raise ValueError(f"pnp_refine: {K} hypotheses for {H} draws")
    _smem_check("pnp_refine", 26 * M + 4 * K + 27 * 4 * 256)
    ptrs += [_check("samples", samples, (B, H, PNP_SAMPLE), i32, dev),
             _check("poses", poses, (B, K, 7), torch.float32, dev)]
    lib = _build.load()
    pose = torch.empty(B, 7, dtype=torch.float32, device=dev)
    consensus = torch.empty(B, dtype=i32, device=dev)
    mse = torch.empty(B, dtype=torch.float32, device=dev)
    ok = torch.empty(B, dtype=torch.bool, device=dev)
    best = torch.empty(B, dtype=i32, device=dev)
    counts = torch.empty(B, K, dtype=i32, device=dev)
    err = lib.uz_pnp_refine(*ptrs, B, M, H, K, float(thresh2), float(depth_tol),
                            float(min_consensus), int(iterations), float(f_mean2),
                            pose.data_ptr(), consensus.data_ptr(), mse.data_ptr(), ok.data_ptr(),
                            best.data_ptr(), counts.data_ptr(), _stream(dev))
    _raise_on(err, "pnp_refine")
    launches["pnp"] += 1
    return pose, consensus, mse, ok, best, counts
