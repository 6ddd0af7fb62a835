"""Virtual 2-D laser scans from depth images, and scan merging.

PyTorch counterpart of ``uzliti_slam_tpu/ops/scan.py``: back-project the
depth, apply the camera's extrinsic, keep a height band, and per bearing
bin the nearest range (obstacle) and the farthest (free-space evidence).
Ranges are reduced as the reference reduces them, as 21-bit quantised
integers ``q = int(clip(range · scale, 0, 2²¹ - 1))`` with ``scale = (2²¹ -
1) / (max_range · 1.001)`` (float32), and written back as ``q / scale``,
so the scans are the reference's scans bit for bit.  ``depth_to_scan``
runs kernel K15 (``scan_bins``, one fused per-pixel pass) through
``kernels/ops.py``; ``cloud_to_scan`` and ``points_to_scan`` (node
merging's re-binning, a batch of scans at once) are K15's second entry
point, ``bin_min_max``, which takes the points: their ranges (``_hypot``),
bearings, gates (``_planar_ok``, the height band) and bins (``bin_index``)
are computed in the same launch as the reduction (``_bin_min_max``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie

Q_MAX = 2**21 - 1


class Scan(NamedTuple):
    ranges: torch.Tensor      # (..., B) nearest range per bearing; inf if empty
    far_ranges: torch.Tensor  # (..., B) farthest range; inf if empty
    angle_min: float
    angle_max: float

    @property
    def n_bins(self) -> int:
        return self.ranges.shape[-1]

    def angles(self) -> torch.Tensor:
        b = self.ranges.shape[-1]
        i = torch.arange(b, dtype=torch.float32, device=self.ranges.device)
        return self.angle_min + (self.angle_max - self.angle_min) * (i + 0.5) / b


@functools.lru_cache(maxsize=None)
def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def range_scale(max_range: float) -> float:
    """The quantisation scale, rounded to float32 as the reference's weak
    Python float meets float32 ranges."""
    return _f32((2.0**21 - 1.0) / (max_range * 1.001))


@functools.lru_cache(maxsize=None)
def f32_reciprocal(x: float) -> float:
    """1 / x in float32, of a float32 x."""
    return float(torch.tensor(1.0, dtype=torch.float32) / torch.tensor(x, dtype=torch.float32))


@functools.lru_cache(maxsize=None)
def bin_factor(n_bins: int, angle_min: float, angle_max: float) -> float:
    """The float32 factor from (bearing - angle_min) to a bin.  The
    reference is compiled: XLA turns its ``/ (angle_max - angle_min) *
    n_bins`` by constants into one multiplication by fl(fl(1 / span) ·
    n_bins); this follows the compiled form (an eager call divides, and
    moves a bearing near a bin edge)."""
    return _f32(f32_reciprocal(_f32(angle_max - angle_min)) * _f32(float(n_bins)))


def bin_index(bearing: torch.Tensor, n_bins: int, angle_min: float, angle_max: float) -> torch.Tensor:
    """Bearing bin of each angle, clipped to [0, n_bins - 1]."""
    binf = (bearing - angle_min) * bin_factor(n_bins, angle_min, angle_max)
    return torch.clamp(binf.to(torch.int32), 0, n_bins - 1)


def _bin_min_max(rng_flat: torch.Tensor, ok_flat: torch.Tensor, bins_flat: torch.Tensor,
                 n_bins: int, max_range: float):
    """Per-bin (near, far) range of flat (P,) entries, from the 21-bit
    quantised ranges of the ``ok`` entries; +inf / -inf for an empty bin:
    the reference's ``_bin_min_max``, the core of K15's plain versions
    (``kernels/ops.bin_reduce_plain``).  Leading dimensions of the inputs
    are batch dimensions (one scan each)."""
    if n_bins > 1023:
        raise ValueError("n_bins must fit 10 bits alongside 21-bit ranges")
    return kops.bin_reduce_plain(rng_flat, ok_flat, bins_flat, n_bins, max_range)


def _hypot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """√(x² + y²) as the reference's ``jnp.hypot`` computes it, compiled:
    a·√(1 + (b/a)²) with a = max(|x|, |y|), b = min, the 1 + t² fused into
    one multiply-add, the square root correctly rounded."""
    ax, ay = torch.abs(x), torch.abs(y)
    a, b = torch.maximum(ax, ay), torch.minimum(ax, ay)
    t = b / torch.where(a == 0, torch.ones_like(a), a)
    root = torch.sqrt(kops.fma_plain(t, t, torch.ones_like(t)).double()).to(torch.float32)
    r = torch.where(a == 0, a, a * root)
    return torch.where(torch.isinf(ax) | torch.isinf(ay), math.inf, r)


def _planar_ok(rng, bearing, valid, angle_min, angle_max, max_range, min_range):
    return (valid & (rng >= min_range) & (rng <= max_range)
            & (bearing >= angle_min) & (bearing < angle_max))


def cloud_to_scan(points: torch.Tensor, valid: torch.Tensor, n_bins: int = 360,
                  angle_min: float = -math.pi, angle_max: float = math.pi,
                  height_band: tuple[float, float] = (0.1, 1.0), max_range: float = 6.0,
                  min_range: float = 0.3) -> Scan:
    """A 3-D cloud (N, 3) in the robot base frame (z up) -> a virtual scan
    (K15's ``bin_min_max`` entry, one launch)."""
    near, far = kops.bin_min_max(points.to(torch.float32).reshape(1, -1, 3).contiguous(),
                                 valid.reshape(1, -1).contiguous(), n_bins, angle_min, angle_max,
                                 max_range, min_range, height_band)
    return Scan(near[0], far[0], float(angle_min), float(angle_max))


def depth_camera_transform(cam_pose: torch.Tensor) -> torch.Tensor:
    """(..., 12) float32 [R row-major, t] of camera-to-base poses (..., 7)."""
    R = lie.quat_to_matrix(lie.pose_q(cam_pose))
    return torch.cat([R.reshape(R.shape[:-2] + (9,)), lie.pose_t(cam_pose)], dim=-1)


def depth_to_scan(depth: torch.Tensor, cam, cam_pose: torch.Tensor, n_bins: int = 360,
                  angle_min: float = -math.pi, angle_max: float = math.pi,
                  height_band: tuple[float, float] = (0.1, 1.0), max_range: float = 6.0,
                  min_range: float = 0.3) -> Scan:
    """Depth images (C, H, W) or (H, W) in metres -> virtual scans (C, B)
    or (B,) (kernel K15).  ``cam_pose`` (C, 7) or (7,) maps each camera
    frame to the robot base frame (the extrinsic, applied before the
    height-band filter)."""
    deps = depth if depth.dim() == 3 else depth[None]
    poses = cam_pose if cam_pose.dim() == 2 else cam_pose[None]
    xf = depth_camera_transform(poses).to(torch.float32).contiguous()
    near, far = kops.scan_bins(deps.to(torch.float32).contiguous(), cam, xf, n_bins,
                               angle_min, angle_max, height_band, max_range, min_range)
    if depth.dim() == 2:
        near, far = near[0], far[0]
    return Scan(near, far, float(angle_min), float(angle_max))


def points_to_scan(points2d: torch.Tensor, valid: torch.Tensor, n_bins: int = 360,
                   angle_min: float = -math.pi, angle_max: float = math.pi,
                   max_range: float = 6.0, min_range: float = 0.05) -> Scan:
    """Re-bin 2-D points (..., N, 2) in the scan frame into virtual scans
    (..., n_bins): leading dimensions are a batch of scans (K15's
    ``bin_min_max`` entry, one launch for the batch)."""
    near, far = kops.bin_min_max(points2d.to(torch.float32).contiguous(), valid.contiguous(),
                                 n_bins, angle_min, angle_max, max_range, min_range)
    return Scan(near, far, float(angle_min), float(angle_max))


def merge_scans(a: Scan, b: Scan, close_thresh: float = 0.2, prefer_b: bool = True) -> Scan:
    """Merge two scans over the same bearing grid: the mean where both have
    a range and they agree within ``close_thresh``, else the preferred
    (newest) scan where it has data."""
    ra, rb = a.ranges, b.ranges
    both = torch.isfinite(ra) & torch.isfinite(rb)
    close = both & (torch.abs(ra - rb) < close_thresh)
    pref, other = (rb, ra) if prefer_b else (ra, rb)
    merged = torch.where(close, 0.5 * (ra + rb), torch.where(torch.isfinite(pref), pref, other))
    far = torch.where(both, torch.maximum(a.far_ranges, b.far_ranges),
                      torch.where(torch.isfinite(rb), b.far_ranges, a.far_ranges))
    return Scan(merged, far, a.angle_min, a.angle_max)


def scan_points(scan: Scan, use_far: bool = False):
    """Scan -> 2-D points (B, 2) + validity in the scan frame."""
    r = scan.far_ranges if use_far else scan.ranges
    ang = scan.angles()
    ok = torch.isfinite(r)
    rr = torch.where(ok, r, 0.0)
    return torch.stack([rr * torch.cos(ang), rr * torch.sin(ang)], dim=-1), ok


def scan_center(scan: Scan) -> torch.Tensor:
    """Mean of the valid scan points (2,)."""
    pts, ok = scan_points(scan)
    w = ok.to(torch.float32)
    return torch.sum(pts * w[..., None], dim=-2) / torch.clamp(torch.sum(w, dim=-1), min=1.0)[..., None]
