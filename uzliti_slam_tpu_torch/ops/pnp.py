"""Batched RANSAC PnP: camera pose from 2D-3D correspondences.

PyTorch counterpart of ``uzliti_slam_tpu/ops/pnp.py`` (the reference's
EPnP-variant feature estimator): per hypothesis 6 distinct valid
correspondences drawn by random keys + top-6, fitted by three families — the
6-point DLT, the planar homography decomposition and, where depth is
measured, Kabsch against the back-projected observations — then the
reprojection (and depth) consensus of every hypothesis, the first best, and
a Gauss-Newton polish on its inliers.  On a CUDA device all of it is one
launch of K28 (``kops.pnp_ransac``); on CPU tensors its plain version runs.

The keys are the reference's ``jax.random.uniform(key, (K, M))``: drawn here
from a ``torch.Generator``, or injected (``keys=``), so that a test can hand
both packages the same keys and get the same samples.  ``pnp_ransac`` takes
a batch of B problems that may share the observations.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uzliti_slam_tpu_torch.kernels import ops as kops


class PnpResult(NamedTuple):
    pose: torch.Tensor        # (..., 7) camera-from-world: x_cam = T · X_world
    consensus: torch.Tensor   # (...) int32
    reproj_mse: torch.Tensor  # (...) px² mean over inliers
    ok: torch.Tensor          # (...) bool


def _dlt_pose(X: torch.Tensor, xn: torch.Tensor, w: torch.Tensor,
              order: str = "parallel") -> torch.Tensor:
    """6+-point DLT of (..., n, 3) world points, (..., n, 2) normalized
    coordinates and (..., n) weights -> pose (..., 7); the null vector by
    one-sided Jacobi in ``order`` (K28's parallel rounds, or "cyclic")."""
    return kops.dlt_pose_plain(X, xn, w, order)


def _homography_pose(X: torch.Tensor, xn: torch.Tensor, w: torch.Tensor,
                     order: str = "parallel") -> torch.Tensor:
    """Planar pose recovery from a fitted plane and a homography."""
    return kops.homography_pose_plain(X, xn, w, order)


def _project_norm(pose: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return kops.project_norm_plain(pose, X)[0]


def thresholds(fx: float, fy: float, reproj_thresh_px: float) -> tuple[float, float]:
    """(squared reprojection threshold in normalized units, f_mean²) in
    float32 arithmetic, as the keyframe step's traced float32 camera and
    gate give them."""
    f = np.float32
    f_mean = f(0.5) * (f(fx) + f(fy))
    thresh_n = f(reproj_thresh_px) / f_mean
    return float(thresh_n * thresh_n), float(f_mean * f_mean)


def pnp_ransac(X: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor, fx: float, fy: float,
               cx: float, cy: float, n_hypotheses: int = 64, reproj_thresh_px: float = 3.0,
               min_consensus: float = 15, refine_iters: int = 8,
               depth: torch.Tensor | None = None, depth_tol: float = 0.04,
               keys: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> PnpResult:
    """Robust camera pose from M 2D-3D correspondences.

    X: (M, 3) or (B, M, 3) points in the reference frame; uv: (M, 2) or
    (B, M, 2) pixel observations in the current camera; valid: (M,) or
    (B, M); depth: optional measured camera-frame depth of each observation
    (≤ 0.05 = unknown), (M,) or (B, M): where it is measured an inlier must
    also agree with it within ``depth_tol`` (relative), which breaks the
    planar two-fold ambiguity.  ``keys`` (…, n_hypotheses, M) are the
    uniform draws; without them they come from ``generator``."""
    one = X.dim() == 2
    if one:
        X, valid = X[None], valid[None]
    B, M, _ = X.shape
    uv = uv.expand(B, M, 2) if uv.dim() == 3 else uv[None].expand(B, M, 2)
    xn = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], dim=-1).contiguous()
    if depth is not None:
        depth = (depth if depth.dim() == 2 else depth[None]).expand(B, M).contiguous()
    if keys is None:
        keys = torch.rand((B, n_hypotheses, M), generator=generator, device=X.device)
    keys = keys.reshape(B, n_hypotheses, M).to(torch.float32).contiguous()
    X, valid = X.contiguous(), valid.contiguous()
    thresh2, f_mean2 = thresholds(fx, fy, reproj_thresh_px)
    _, _, pose, consensus, mse, ok, _, _ = kops.pnp_ransac(
        X, xn, valid, depth, keys, thresh2, float(np.float32(depth_tol)), float(min_consensus),
        refine_iters, f_mean2)
    res = PnpResult(pose=pose, consensus=consensus, reproj_mse=mse, ok=ok)
    return PnpResult(*(x[0] for x in res)) if one else res
