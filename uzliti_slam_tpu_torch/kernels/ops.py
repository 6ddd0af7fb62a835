"""The solve's four hand-written CUDA kernels, their wrappers and plain twins.

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
=============  ======================  =======================================

What bounds each kernel on the card, and what its design does about it, is
written at the top of its source file.
"""

from __future__ import annotations

import torch

from uzliti_slam_tpu_torch.graph import factors
from uzliti_slam_tpu_torch.kernels import _build

launches = {"linearize": 0, "hvp": 0, "chain_apply": 0, "residual_chi2": 0}

_THREADS = 256  # kThreads in csrc/lie.cuh: K4's partial sums, one per block


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
