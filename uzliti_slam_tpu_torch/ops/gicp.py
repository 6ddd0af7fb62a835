"""Dense colored-cloud registration: voxel downsample + 6-D (XYZ+Lab) ICP.

PyTorch counterpart of ``uzliti_slam_tpu/ops/gicp.py`` (the reference's
``CloudTransformationEstimator``: 5 cm voxel clouds aligned by GICP6D, whose
correspondence search runs in XYZ + CIELAB; acceptance gates fraction > 0.3,
correction ≤ 1 m / 30°; a fixed information matrix).  The voxel grid is
kernel K25, the k-NN normals K26 and the 20 iterations of the 6-D ICP K27 on
a CUDA device; on CPU tensors their plain versions run.  ``gicp_6d`` takes
one source cloud against one target cloud, or against a batch of B target
clouds (B, V, 3) with B initial poses: the keyframe step registers every
candidate in one launch.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from uzliti_slam_tpu_torch.config import f32
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie


class GicpResult(NamedTuple):
    pose: torch.Tensor         # (..., 7) dst <- src
    fraction: torch.Tensor     # (...) matched-correspondence fraction
    mse: torch.Tensor          # (...)
    information: torch.Tensor  # (..., 6, 6) the fixed model
    ok: torch.Tensor           # (...) bool


_RGB_TO_XYZ = ((0.4124564, 0.3575761, 0.1804375),
               (0.2126729, 0.7151522, 0.0721750),
               (0.0193339, 0.1191920, 0.9503041))
_WHITE = (0.95047, 1.0, 1.08883)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [0, 1] -> CIELAB (D65), as the reference's
    PointXYZLAB conversion."""
    rgb = torch.clamp(rgb, 0.0, 1.0)
    lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4, rgb / 12.92)
    # constants as Python numbers: a tensor made on the host would be a
    # host-to-device copy in the keyframe step
    r, g, b = lin.unbind(-1)
    t = torch.stack([(r * m[0] + g * m[1] + b * m[2]) / w
                     for m, w in zip(_RGB_TO_XYZ, _WHITE)], dim=-1)
    f = torch.where(t > 0.008856, t ** (1.0 / 3.0), 7.787 * t + 16.0 / 116.0)
    L = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return torch.stack([L, a, b], dim=-1)


def voxel_downsample(points: torch.Tensor, colors: torch.Tensor, valid: torch.Tensor,
                     voxel_size: float = 0.05, max_out: int = 1024):
    """Voxel-grid mean reduction with static output capacity (K25): the
    ``max_out`` smallest voxel ids of the spatial hash, ascending.  The
    voxel index is floor(p · fl32(1/voxel)), the form XLA compiles the
    reference's division into.  Returns (points (V, 3), colors (V, 3),
    valid (V,))."""
    inv = f32(1.0 / f32(voxel_size))
    return kops.voxel_grid(points.contiguous(), colors.contiguous(), valid.contiguous(), inv,
                           max_out)


def estimate_normals(points: torch.Tensor, valid: torch.Tensor, k: int = 8) -> torch.Tensor:
    """Per-point normals from k-NN PCA (K26) of (M, 3) or (B, M, 3) clouds;
    a normal's sign is arbitrary."""
    one = points.dim() == 2
    n = kops.knn_normals(points[None].contiguous() if one else points.contiguous(),
                         valid[None].contiguous() if one else valid.contiguous(), k)
    return n[0] if one else n


def gicp_6d(src_pts: torch.Tensor, src_lab: torch.Tensor, src_valid: torch.Tensor,
            dst_pts: torch.Tensor, dst_lab: torch.Tensor, dst_valid: torch.Tensor,
            init_pose: torch.Tensor | None = None, iterations: int = 20,
            max_corr_dist: float = 0.2, color_weight: float = 0.002,
            min_fraction: float = 0.3,
            max_correction: tuple[float, float] = (1.0, math.pi / 6)) -> GicpResult:
    """Align src (M, 3) onto dst with color-augmented correspondences.

    ``dst_*`` may carry a batch axis (B, V, ·), with ``init_pose`` (B, 7):
    every problem shares the source cloud.  ``color_weight`` scales the Lab
    distance into metric units; 20 iterations and the 0.2 m correspondence
    radius are the reference's.  The thresholds compare as the reference's
    float32 constants do (``fl32(max_corr_dist²)``)."""
    one = dst_pts.dim() == 2
    if one:
        dst_pts, dst_lab, dst_valid = dst_pts[None], dst_lab[None], dst_valid[None]
    B = dst_pts.shape[0]
    if init_pose is None:
        init_pose = lie.pose_identity((B,), src_pts.device)
    init = init_pose.reshape(B, 7).to(torch.float32).contiguous()
    normals = estimate_normals(dst_pts, dst_valid)
    pose, fraction, mse, ok = kops.gicp(
        src_pts.contiguous(), src_lab.contiguous(), src_valid.contiguous(),
        dst_pts.contiguous(), dst_lab.contiguous(), dst_valid.contiguous(), normals, init,
        iterations, f32(max_corr_dist ** 2), f32(color_weight), f32(min_fraction),
        f32(max_correction[0]), f32(max_correction[1]))
    info = torch.diag_embed(torch.cat([torch.full((B, 3), 100.0, device=src_pts.device),
                                       torch.full((B, 3), 400.0, device=src_pts.device)], dim=-1))
    res = GicpResult(pose=pose, fraction=fraction, mse=mse, information=info, ok=ok)
    return GicpResult(*(x[0] for x in res)) if one else res


def register_clouds(src_pts, src_rgb, src_valid, dst_pts, dst_rgb, dst_valid,
                    voxel_size: float = 0.05, max_voxels: int = 512,
                    **gicp_kwargs) -> GicpResult:
    """The full dense path: both clouds voxel-gridded, then the 6-D ICP
    (the reference's ``register_clouds`` less its unused key)."""
    sp, sc, sv = voxel_downsample(src_pts, rgb_to_lab(src_rgb), src_valid, voxel_size, max_voxels)
    dp, dc, dv = voxel_downsample(dst_pts, rgb_to_lab(dst_rgb), dst_valid, voxel_size, max_voxels)
    return gicp_6d(sp, sc, sv, dp, dc, dv, **gicp_kwargs)
