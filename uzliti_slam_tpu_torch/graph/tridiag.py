"""Block-tridiagonal solves via cyclic reduction — the chain preconditioner.

PyTorch counterpart of ``uzliti_slam_tpu/graph/tridiag.py``.  PCG on a
trajectory graph is preconditioned by the exact solve of the Hessian's
tridiagonal part (diagonal blocks + consecutive-pose couplings), factored by
block cyclic reduction: log2(N) levels of batched closed-form 6x6 inverses
and products, then one dense inverse of the root once ≤ ``dense_cutoff``
blocks remain.  The factor is the hand-written kernel K9
(``kernels/ops.chain_factor``, one launch per preconditioner refresh); the apply
is kernel K3 (``kernels/ops.chain_apply``), and inside a single solve's PCG
step kernel K34 (``kernels/ops.pcg_chain_step``, which takes the factor).
"""

from __future__ import annotations

import torch

from uzliti_slam_tpu_torch.kernels import ops as kops


def block_tridiag_factor(D: torch.Tensor, U: torch.Tensor, dense_cutoff: int = 64,
                         batch: int = 1, held=None, need: torch.Tensor | None = None,
                         damp=None, free=None, lift=None):
    """Cyclic-reduction 'factorization' of ``batch`` symmetric
    block-tridiagonal matrices stacked in D, U (kernel K9 on CUDA tensors).

    D: (B·n, 6, 6) diagonal blocks; U: (B·n, 6, 6) with U[i] = A[i, i+1]
    (each chain's last U is treated as zero).  Returns ``(levels, root_inv,
    n)`` where each level is ``(Dinv_o, P1m, P2, G1, G2)``, each (B, half,
    6, 6): the apply-side products are precomputed once per factor, so each
    substitution level is two matvecs and a shift.  With ``held`` (a factor
    this function made) it is rebuilt in place and returned; with the (B,)
    bool device flag ``need`` too, only the chains whose flag is set.  With
    ``damp`` (B·n, 6) and ``free`` (B·n,), D is the Hessian's diagonal blocks
    and the factored blocks are free ? D + diag(damp) : I, plus diag(lift)
    (the planar solve's) when given.
    """
    return kops.chain_factor(D, U, dense_cutoff, batch, held=held, need=need, damp=damp,
                             free=free, lift=lift)


def block_tridiag_apply(factor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b (b (B·n, 6)) with a ``block_tridiag_factor`` result,
    through kernel K3 on CUDA tensors."""
    return kops.chain_apply(factor, b)


def block_tridiag_solve(D: torch.Tensor, U: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One-shot solve A x = b of one chain (factor + apply)."""
    return block_tridiag_apply(block_tridiag_factor(D, U), b)
