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
=============  ======================  =======================================

What bounds each kernel on the card, and what its design does about it, is
written at the top of its source file.
"""

from __future__ import annotations

import torch

from uzliti_slam_tpu_torch.graph import factors
from uzliti_slam_tpu_torch.kernels import _build

launches = {"linearize": 0, "hvp": 0, "chain_apply": 0, "residual_chi2": 0,
            "relax_min": 0, "cluster_labels": 0, "ransac_rigid": 0, "components": 0}

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
    """K3: the chain preconditioner's forward/back substitution."""
    if b.device.type == "cpu":
        return chain_apply_plain(factor, b)
    levels, root_inv, n_orig = factor
    dev, f32 = b.device, torch.float32
    _check("b", b, (n_orig, 6), f32, dev)
    if not levels:
        # no reduction level: the root covers the (padded) system alone
        n2 = _pow2(n_orig)
        bk = torch.cat([b, b.new_zeros(n2 - n_orig, 6)])
        return (root_inv @ bk.reshape(-1)).reshape(-1, 6)[:n_orig]
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
    m_root = bufs[-1].shape[0]
    if tuple(root_inv.shape) != (6 * m_root, 6 * m_root):   # a torch.matmul operand
        raise ValueError(f"root_inv: shape {tuple(root_inv.shape)}, expected "
                         f"{(6 * m_root, 6 * m_root)}")
    x =(root_inv @ bufs[-1].reshape(-1)).reshape(m_root, 6)
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
