"""Batched RANSAC rigid-transform estimation.

PyTorch counterpart of ``uzliti_slam_tpu/ops/ransac.py`` for what the
loop-closure filter (uniform sampling over the valid entries) and the
keyframe step (quality-biased sampling, soft PROSAC) run; optional
per-correspondence ``weights`` multiply the validity mask in the fits, as
the reference's ``weights * valid``.  ``ransac_rigid_batch`` takes the
hypothesis triplets ``tri`` when given (a test hands both packages the
JAX draws), else draws uniforms from a ``torch.Generator`` (one
``torch.rand``) and maps them to triplets in the same launch as the fits:
the draw, fits, consensus, argmax and refit of every root are kernel K7 on
a CUDA device, and the result reports the triplets.  ``kabsch`` and
``kabsch_quat`` broadcast over leading batch dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie


class RansacResult(NamedTuple):
    pose: torch.Tensor         # (..., 7) estimated rigid transform dst <- src
    consensus: torch.Tensor    # (...) int32 inlier count
    mse: torch.Tensor          # (...) mean squared inlier error
    information: torch.Tensor  # (..., 6, 6) edge information matrix
    ok: torch.Tensor           # (...) bool — consensus/valid gates passed
    tri: torch.Tensor          # (..., K, 3) int32 hypothesis triplets, drawn or given


def _weighted_means(src, dst, weights):
    w = torch.clamp(weights, min=0.0)
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)[..., None]
    mu_s = torch.sum(src * w[..., None], dim=-2) / wsum
    mu_d = torch.sum(dst * w[..., None], dim=-2) / wsum
    cs = src - mu_s[..., None, :]
    cd = dst - mu_d[..., None, :]
    return w, wsum[..., None], mu_s, mu_d, cs, cd


def kabsch(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted rigid alignment by SVD: pose p with dst ≈ p·src.

    src, dst: (..., M, 3); weights: (..., M) ≥ 0.
    """
    w, wsum, mu_s, mu_d, cs, cd = _weighted_means(src, dst, weights)
    cov = (cd * w[..., None]).transpose(-1, -2) @ cs / wsum
    u, _, vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    one = torch.ones_like(d)
    R = u @ torch.diag_embed(torch.stack([one, one, d], dim=-1)) @ vt
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return lie.make_pose(t, lie.matrix_to_quat(R))


def kabsch_quat(src: torch.Tensor, dst: torch.Tensor, weights: torch.Tensor,
                iters: int = 30) -> torch.Tensor:
    """Horn's quaternion absolute orientation, the max eigenvector of the
    4×4 profile matrix by shifted power iteration (the hypothesis fit)."""
    w, wsum, mu_s, mu_d, cs, cd = _weighted_means(src, dst, weights)
    S = (cs * w[..., None]).transpose(-1, -2) @ cd / wsum  # S_ab = Σ w·cs_a·cd_b
    Sxx, Sxy, Sxz = S[..., 0, 0], S[..., 0, 1], S[..., 0, 2]
    Syx, Syy, Syz = S[..., 1, 0], S[..., 1, 1], S[..., 1, 2]
    Szx, Szy, Szz = S[..., 2, 0], S[..., 2, 1], S[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], dim=-1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], dim=-1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], dim=-1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], dim=-1),
    ], dim=-2)
    c = torch.sqrt(torch.sum(N * N, dim=(-2, -1))) + 1e-6  # Frobenius shift
    A = N + c[..., None, None] * torch.eye(4, dtype=N.dtype, device=N.device)
    q = torch.full(N.shape[:-1], 0.5, dtype=N.dtype, device=N.device)
    for _ in range(iters):
        q = (A @ q[..., None])[..., 0]
        q = q / torch.clamp(torch.linalg.vector_norm(q, dim=-1), min=1e-12)[..., None]
    R = lie.quat_to_matrix(q)
    t = mu_d - (R @ mu_s[..., None])[..., 0]
    return lie.make_pose(t, q)


def draw_uniforms(generator: torch.Generator | None, k_hyp: int,
                  valid: torch.Tensor) -> torch.Tensor:
    """The draw's uniforms: (..., k_hyp·3) float32 in [0, 1) from one
    ``torch.rand`` on ``generator``, on ``valid``'s device.  The draws
    cannot be the JAX package's: ``jax.random`` streams do not exist in
    PyTorch."""
    return torch.rand(valid.shape[:-1] + (k_hyp * 3,), generator=generator, device=valid.device)


def draw_weights(valid: torch.Tensor, quality: torch.Tensor | None = None,
                 beta: float = 4.0) -> torch.Tensor:
    """Each entry's draw weight (..., M) float32: valid as 0/1 without
    ``quality``; with it exp(β·(q − q_min)/span − β) over the valid entries
    (span = max(q_max − q_min, 1e-6)), 0 elsewhere.  The largest weight is
    1, so the running sum cannot overflow."""
    if quality is None:
        return valid.to(torch.float32)
    q = quality.to(torch.float32)
    qmax = torch.where(valid, q, -torch.inf).amax(-1, keepdim=True)
    qmin = torch.where(valid, q, torch.inf).amin(-1, keepdim=True)
    span = torch.clamp(qmax - qmin, min=1e-6)
    logit = beta * (torch.where(valid, q, qmin) - qmin) / span
    return torch.where(valid, torch.exp(logit - beta), 0.0)


def triplets_from_uniforms(u: torch.Tensor, valid: torch.Tensor,
                           quality: torch.Tensor | None = None, beta: float = 4.0) -> torch.Tensor:
    """(..., k_hyp, 3) int32 indices among each row's valid entries of
    ``valid`` (..., M), from the uniforms ``u`` (..., k_hyp·3): K7's draw,
    and its plain version.

    Without ``quality`` the draw is uniform over the valid entries; with
    it, entry i is drawn with probability ∝ exp(β·(q_i − q_min)/span) over
    the valid entries (span = max(q_max − q_min, 1e-6)), the reference's
    soft PROSAC.  Each uniform is mapped through the row's running sum of
    weights (``searchsorted``), so no ``nonzero`` synchronises the host.  A
    row with no valid entry draws index 0 (its results are discarded by the
    sample-validity gate), where the JAX package draws uniformly over all.
    """
    batch, m = valid.shape[:-1], valid.shape[-1]
    cum = torch.cumsum(draw_weights(valid, quality, beta), dim=-1)       # (..., M)
    total = cum[..., -1:]
    # a draw in [0, total): rounding may not reach the last positive weight
    target = torch.minimum(u * total, torch.nextafter(total, torch.zeros_like(total)))
    idx = torch.searchsorted(cum.contiguous(), target.contiguous(), right=True)
    idx = torch.where((idx < m) & (total > 0), idx, 0)
    return idx.to(torch.int32).reshape(batch + (u.shape[-1] // 3, 3))


def _valid_sample(generator: torch.Generator, k_hyp: int, valid: torch.Tensor,
                  quality: torch.Tensor | None = None, beta: float = 4.0) -> torch.Tensor:
    """(..., k_hyp, 3) int32 triplets drawn among each row's valid entries:
    ``draw_uniforms`` then ``triplets_from_uniforms``."""
    return triplets_from_uniforms(draw_uniforms(generator, k_hyp, valid), valid, quality, beta)


def ransac_rigid_batch(
    src: torch.Tensor,
    dst: torch.Tensor,
    valid: torch.Tensor,
    n_hypotheses: int = 128,
    inlier_thresh: float = 0.05,
    min_consensus: int = 12,
    min_sigma: float = 0.01,
    tri: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    quality: torch.Tensor | None = None,
    weights: torch.Tensor | None = None,
) -> RansacResult:
    """Robust rigid fit per root: src, dst (R, M, 3) (broadcast views of one
    table allowed), valid (R, M).  ``tri`` (R, n_hypotheses, 3) int gives
    the hypothesis triplets; without it they are drawn from ``generator``,
    biased toward high ``quality`` (R, M) where given (soft PROSAC): one
    ``torch.rand`` of uniforms, mapped to triplets inside K7's launch.
    ``weights`` (R, M), where given, multiply ``valid`` in the hypothesis
    fits and the refit (the inlier tests and the consensus read ``valid``).
    ``inlier_thresh`` and ``min_sigma`` are squared as given: the keyframe
    step passes its float32 gates, whose squares round as the reference's.
    The result's ``tri`` holds the triplets drawn (or given).

    K hypotheses evaluated unconditionally (no early exit), as
    ``uzliti_slam_tpu/ops/ransac.py:ransac_rigid`` vmapped over roots.
    """
    u = None
    if tri is None:
        if quality is not None:
            quality = quality.to(torch.float32).contiguous()
        u = draw_uniforms(generator, n_hypotheses, valid)
    else:
        tri = tri.to(device=src.device, dtype=torch.int32).contiguous()
    pose, consensus, mse, information, ok, _, _, tri = kops.ransac_rigid(
        src, dst, valid, tri, inlier_thresh, min_consensus, min_sigma,
        None if weights is None else weights.to(torch.float32).contiguous(),
        uniforms=u, quality=quality)
    return RansacResult(pose, consensus, mse, information, ok, tri)


def ransac_rigid(src, dst, valid, n_hypotheses: int = 128, inlier_thresh: float = 0.05,
                 min_consensus: int = 12, min_sigma: float = 0.01,
                 tri: torch.Tensor | None = None,
                 generator: torch.Generator | None = None,
                 weights: torch.Tensor | None = None) -> RansacResult:
    """One problem: src, dst (M, 3), valid (M,), ``tri`` (K, 3), optional
    ``weights`` (M,)."""
    res = ransac_rigid_batch(src[None], dst[None], valid[None], n_hypotheses, inlier_thresh,
                             min_consensus, min_sigma,
                             None if tri is None else tri[None], generator,
                             weights=None if weights is None else weights[None])
    return RansacResult(*(x[0] for x in res))
