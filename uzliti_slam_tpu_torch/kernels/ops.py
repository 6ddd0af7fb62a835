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
                                       part + _bin_min_max
hamming_top2   csrc/hamming_top2.cu    ops/matching.py:hamming_matrix +
                                       knn_match + ratio_test (match_descriptors)
                                       and recognizer.py:gist_query (two
                                       wrappers, one count)
bilateral      csrc/bilateral.cu       ops/depth.py:joint_bilateral_filter
icp            csrc/icp.cu             ops/icp.py:_correspondences inside
                                       icp_point_to_line (all iterations)
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
            "orb_describe": 0, "scan_bins": 0, "hamming_top2": 0, "bilateral": 0, "icp": 0}

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
    near, far = scan._bin_min_max(rng, ok, bins, n_bins, max_range)
    return near, torch.where(torch.isfinite(far), far, torch.inf)


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


def lu3(A: torch.Tensor):
    """LU with partial pivoting of (..., 3, 3) matrices, the first largest
    pivot, multipliers by division (K18's ``lu3``).  Returns (LU, perm
    (..., 3) long: the original row at each position)."""
    A = A.clone()
    batch = A.shape[:-2]
    ar = torch.arange(3, device=A.device)
    perm = ar.expand(batch + (3,)).clone()
    for k in range(3):
        p = (k + torch.argmax(A[..., k:, k].abs(), dim=-1))[..., None]          # first max
        swap = torch.where(ar == k, p, torch.where(ar == p, k, ar))
        A = torch.gather(A, -2, swap[..., None].expand(A.shape))
        perm = torch.gather(perm, -1, swap)
        for i in range(k + 1, 3):
            li = A[..., i, k] / A[..., k, k]
            A[..., i, k] = li
            for j in range(k + 1, 3):
                A[..., i, j] = A[..., i, j] - li * A[..., k, j]
    return A, perm


def lu3_solve(lu: torch.Tensor, perm: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b from ``lu3``'s factors; b (..., 3)."""
    pb = torch.gather(b, -1, perm)
    y = [pb[..., 0]]
    for i in (1, 2):
        s = pb[..., i]
        for j in range(i):
            s = s - lu[..., i, j] * y[j]
        y.append(s)
    x = [None, None, None]
    for i in (2, 1, 0):
        s = y[i]
        for j in range(i + 1, 3):
            s = s - lu[..., i, j] * x[j]
        x[i] = s / lu[..., i, i]
    return torch.stack(x, dim=-1)


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., 3, 3) matrices by ``lu3`` (no host read)."""
    lu, perm = lu3(A)
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    return torch.stack([lu3_solve(lu, perm, eye[..., c]) for c in range(3)], dim=-1)


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
        lu, perm = lu3(H)
        pose = pose + -lu3_solve(lu, perm, b)
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
