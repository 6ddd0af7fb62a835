"""Batched SE(3) relative-pose factors: residuals, Jacobians, robust weights.

PyTorch counterpart of ``uzliti_slam_tpu/graph/factors.py``.  All functions
broadcast over a leading edge dimension, so the batched forms are the
functions themselves.  The robust χ² and the weighted information live here
too, so the solver and the kernels' plain versions share one definition.
"""

from __future__ import annotations

import torch

from uzliti_slam_tpu_torch.ops import lie


def edge_residual(pose_i: torch.Tensor, pose_j: torch.Tensor,
                  meas: torch.Tensor) -> torch.Tensor:
    """r = log(T_meas^-1 · (X_i^-1 · X_j)) ∈ R^6."""
    pred = lie.pose_relative(pose_i, pose_j)
    return lie.se3_log(lie.pose_compose(lie.pose_inverse(meas), pred))


batched_residuals = edge_residual


def edge_residual_jacobians(pose_i, pose_j, meas):
    """Residual plus analytic 6x6 Jacobians wrt right-perturbations.

    For r = log(M⁻¹·A) with A = Xᵢ⁻¹Xⱼ:  Jⱼ = Jr⁻¹(r),
    Jᵢ = -Jr⁻¹(r)·Ad_{A⁻¹}.  The pose form, used by the oracle.
    """
    pred = lie.pose_relative(pose_i, pose_j)
    r = lie.se3_log(lie.pose_compose(lie.pose_inverse(meas), pred))
    Jj = lie.se3_right_jacobian_inv(r)
    Ji = -(Jj @ lie.se3_adjoint(lie.pose_inverse(pred)))
    return r, Ji, Jj


def jacobians_from_residual(r: torch.Tensor, adj_meas_inv: torch.Tensor):
    """Jacobians from the residual twist alone (batched, (E, 6...)).

    Since pred = meas·exp(r), Ad_{pred⁻¹} = Ad_{exp(-r)}·Ad_{meas⁻¹}, with
    Ad_{meas⁻¹} hoisted out of the LM loop (measurements are constant).
    """
    Jj = lie.se3_right_jacobian_inv(r)
    adj = lie.se3_adjoint(lie.se3_exp(-r))
    Ji = -(Jj @ (adj @ adj_meas_inv))
    return Ji, Jj


def huber_weight(chi2: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    """Huber reweighting on the Mahalanobis norm (g2o RobustKernelHuber,
    ``g2o_optimizer.cpp:292-294``): 1 inside, delta/||r|| outside."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(e <= delta, torch.ones_like(e), delta / e)


def edge_chi2(r: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """chi2 = r^T Λ r per edge (batched)."""
    return torch.einsum("...i,...ij,...j->...", r, info, r)


def weighted_info(r: torch.Tensor, info: torch.Tensor, valid: torch.Tensor,
                  huber_delta: float) -> torch.Tensor:
    """Per-edge robustly-weighted information, zeroed for invalid edges."""
    w = huber_weight(edge_chi2(r, info), huber_delta) * valid
    return info * w[:, None, None]


def robust_chi2(r: torch.Tensor, info: torch.Tensor, valid: torch.Tensor,
                huber_delta: float) -> torch.Tensor:
    """Σ ρ(rᵀΛr) over valid edges — the Huber-robust total cost, as g2o's
    activeRobustChi2."""
    chi2 = edge_chi2(r, info)
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    rho = torch.where(e <= huber_delta, chi2, 2.0 * huber_delta * e - huber_delta**2)
    return torch.sum(rho * valid)
