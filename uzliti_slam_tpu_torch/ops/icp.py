"""Planar point-to-line ICP (scan matching) for the keyframe step's laser
edges.

The port's counterpart of ``uzliti_slam_tpu/ops/icp.py``: a fixed number
of Gauss-Newton iterations on point-to-line residuals against the two
nearest target points, a final correspondence audit (valid fraction,
mse), a Censi-style covariance σ²(JᵀJ)⁻¹ and the reference's gates.  The
whole matcher, every problem of a batch, is kernel K18 (``icp``); a
leading batch dimension takes the place of the reference's ``icp_batch``
vmap.  The 3x3 solve and inverse are LU with partial pivoting, as the
reference's ``solve`` and ``inv``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie


class IcpResult(NamedTuple):
    pose2: torch.Tensor           # (..., 3) [x, y, theta] dst <- src
    valid_fraction: torch.Tensor  # (...) share of valid source points matched
    mse: torch.Tensor             # (...) mean squared point-to-line residual
    cov3: torch.Tensor            # (..., 3, 3) covariance over (x, y, theta)
    ok: torch.Tensor              # (...) bool: the gates passed


def icp_point_to_line(src: torch.Tensor, src_valid: torch.Tensor, dst: torch.Tensor,
                      dst_valid: torch.Tensor, init: torch.Tensor, iterations: int = 20,
                      max_corr_dist: float = 0.5, min_valid_fraction: float = 0.25,
                      max_correction: tuple[float, float] = (1.5, 0.8),
                      sigma: float = 0.02) -> IcpResult:
    """Align ``src`` (..., M, 2) onto ``dst`` (..., N, 2) from ``init``
    (..., 3) [x, y, theta].  Gates: a valid fraction of at least
    ``min_valid_fraction``, a correction below ``max_correction`` (metres,
    radians) and a finite pose.  ``max_corr_dist`` is squared as given (a
    float32 gate squares in float32: pass it rounded to float32)."""
    batch = init.shape[:-1]
    M, N = src.shape[-2], dst.shape[-2]
    f32 = torch.float32
    pose, fraction, mse, cov, ok = kops.icp(
        src.reshape(-1, M, 2).to(f32).contiguous(), src_valid.reshape(-1, M).contiguous(),
        dst.reshape(-1, N, 2).to(f32).contiguous(), dst_valid.reshape(-1, N).contiguous(),
        init.reshape(-1, 3).to(f32).contiguous(), int(iterations),
        float(max_corr_dist) ** 2, float(min_valid_fraction), float(max_correction[0]),
        float(max_correction[1]), float(sigma) ** 2)
    return IcpResult(pose.reshape(batch + (3,)), fraction.reshape(batch), mse.reshape(batch),
                     cov.reshape(batch + (3, 3)), ok.reshape(batch))


def icp_information_6d(cov3: torch.Tensor, target_trace: float = 1e4) -> torch.Tensor:
    """The (x, y, theta) covariance as a 6x6 information matrix: its
    inverse rescaled to trace ``target_trace``, placed at x, y and yaw."""
    eye = torch.eye(3, dtype=cov3.dtype, device=cov3.device)
    info3 = kops.inv3(cov3 + 1e-12 * eye)
    trace = info3[..., 0, 0] + info3[..., 1, 1] + info3[..., 2, 2]
    info3 = info3 * (target_trace / torch.clamp(trace, min=1e-12))[..., None, None]
    out = torch.zeros(cov3.shape[:-2] + (6, 6), dtype=cov3.dtype, device=cov3.device)
    sel = [0, 1, 5]
    for a in range(3):
        for b in range(3):
            out[..., sel[a], sel[b]] = info3[..., a, b]
    return out


def icp_edge_pose(pose2: torch.Tensor) -> torch.Tensor:
    """ICP's planar result -> the SE(3) edge transform."""
    return lie.pose2_to_pose(pose2)
