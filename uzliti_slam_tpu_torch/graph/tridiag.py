"""Block-tridiagonal solves via cyclic reduction — the chain preconditioner.

PyTorch counterpart of ``uzliti_slam_tpu/graph/tridiag.py``.  PCG on a
trajectory graph is preconditioned by the exact solve of the Hessian's
tridiagonal part (diagonal blocks + consecutive-pose couplings), factored by
block cyclic reduction: log2(N) levels of batched closed-form 6x6 inverses
and products, then one dense inverse of the root once ≤ ``dense_cutoff``
blocks remain.  The factor is plain PyTorch (it runs once per
``precond_refresh`` LM iterations); the apply, once per PCG step, is the
hand-written kernel K3 (``kernels/ops.chain_apply``).
"""

from __future__ import annotations

import torch

from uzliti_slam_tpu_torch.kernels import ops as kops


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


def _pad_pow2(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor):
    n = D.shape[0]
    n2 = 1 << max((n - 1).bit_length(), 0)
    if n2 == n:
        return D, U, b, n
    pad = n2 - n
    eye = torch.eye(6, dtype=D.dtype, device=D.device).expand(pad, 6, 6)
    D = torch.cat([D, eye])
    U = torch.cat([U, U.new_zeros(pad, 6, 6)])[:n2]
    b = torch.cat([b, b.new_zeros((pad,) + tuple(b.shape[1:]))])
    return D, U, b, n


def _dense_root_inverse(Dk: torch.Tensor, Uk: torch.Tensor) -> torch.Tensor:
    """Dense inverse of the remaining (m·6)×(m·6) block-tridiagonal system,
    by LU (``torch.linalg.inv_ex``: no error check, so no host sync)."""
    m = Dk.shape[0]
    if m == 1:
        return _inv6(Dk[0])
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
    A = A + 1e-8 * torch.eye(m * 6, dtype=dt, device=dev)
    return torch.linalg.inv_ex(A)[0]


def block_tridiag_factor(D: torch.Tensor, U: torch.Tensor, dense_cutoff: int = 64):
    """Cyclic-reduction 'factorization' of a symmetric block-tridiagonal A.

    D: (n, 6, 6) diagonal blocks; U: (n, 6, 6) with U[i] = A[i, i+1]
    (U[n-1] is zeroed here).  Returns ``(levels, root_inv, n)`` where each
    level is ``(Dinv_o, P1m, P2, G1, G2)``: the apply-side products are
    precomputed once per factor, so each substitution level is two matvecs
    and a shift.
    """
    n_orig = D.shape[0]
    U = U.clone()
    U[n_orig - 1] = 0.0
    D, U, _, _ = _pad_pow2(D, U, D.new_zeros(n_orig, 6))
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
        levels.append((Dinv_o, P1m, P2, G1, G2))
        Dk, Uk = newD, newU

    return tuple(levels), _dense_root_inverse(Dk, Uk), n_orig


def block_tridiag_apply(factor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b (b (n, 6)) with a ``block_tridiag_factor`` result,
    through kernel K3 on CUDA tensors."""
    return kops.chain_apply(factor, b)


def block_tridiag_solve(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One-shot solve A x = b (factor + apply)."""
    return block_tridiag_apply(block_tridiag_factor(D, U), b)
