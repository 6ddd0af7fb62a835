"""Depth-map refinement: the joint bilateral filter guided by intensity.

The port's counterpart of ``uzliti_slam_tpu/ops/depth.py``'s
``joint_bilateral_filter`` (radius 2, σs 1.5, σc 10), which the keyframe
front-end runs on each camera's depth, guided by its (rectified) image,
when ``FeatureExtractionConfig.use_depth_refinement`` is set (the
default).  It is kernel K17 (``bilateral``).  The reference's
``joint_nearest_filter`` is not on the keyframe path and is not ported.
"""

from __future__ import annotations

import torch

from uzliti_slam_tpu_torch.kernels import ops as kops


def joint_bilateral_filter(depth: torch.Tensor, guide: torch.Tensor) -> torch.Tensor:
    """Smooth depth (H, W) or (C, H, W) in metres with weights from spatial
    distance × guide similarity × depth validity; invalid (<= 0 or
    non-finite) depths are filled from valid neighbours where any weight
    exists, else 0."""
    d = depth if depth.dim() == 3 else depth[None]
    g = guide if guide.dim() == 3 else guide[None]
    out = kops.bilateral(d.to(torch.float32).contiguous(), g.to(torch.float32).contiguous())
    return out if depth.dim() == 3 else out[0]
