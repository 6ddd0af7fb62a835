"""Pinhole camera model with Brown-Conrady distortion.

PyTorch counterpart of ``uzliti_slam_tpu/frontend/camera.py``: the same
functions, names and arithmetic.  The intrinsics are Python floats, so a
camera serves tensors on any device; every function broadcasts over
leading dimensions, and the image functions take (..., H, W).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PinholeCamera(NamedTuple):
    """Pinhole intrinsics + Brown-Conrady distortion (plumb_bob).  Zero
    coefficients = ideal pinhole; the projective helpers assume a
    RECTIFIED image (``rectify_image``/``undistort_points`` first)."""
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0


def default_kinect() -> PinholeCamera:
    """Kinect-like VGA intrinsics (the reference's sensor)."""
    return PinholeCamera(fx=525.0, fy=525.0, cx=319.5, cy=239.5, width=640, height=480)


def backproject(cam: PinholeCamera, u: torch.Tensor, v: torch.Tensor,
                depth: torch.Tensor) -> torch.Tensor:
    """(u, v) pixel coords + depth -> 3-D camera-frame points (..., 3)."""
    x = (u - cam.cx) / cam.fx * depth
    y = (v - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def project(cam: PinholeCamera, pts: torch.Tensor):
    """3-D camera-frame points (..., 3) -> (u, v, z)."""
    z = pts[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = pts[..., 0] / zs * cam.fx + cam.cx
    v = pts[..., 1] / zs * cam.fy + cam.cy
    return u, v, z


def distort_normalized(cam: PinholeCamera, xn: torch.Tensor, yn: torch.Tensor):
    """Ideal normalized coords -> distorted normalized coords (radial k1, k2
    + tangential p1, p2)."""
    r2 = xn * xn + yn * yn
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2
    xd = xn * radial + 2.0 * cam.p1 * xn * yn + cam.p2 * (r2 + 2.0 * xn * xn)
    yd = yn * radial + cam.p1 * (r2 + 2.0 * yn * yn) + 2.0 * cam.p2 * xn * yn
    return xd, yd


def undistort_points(cam: PinholeCamera, u: torch.Tensor, v: torch.Tensor,
                     iterations: int = 5):
    """Distorted pixel coords -> ideal (rectified) pixel coords by a fixed
    count of fixed-point steps on the distortion model."""
    xd = (u - cam.cx) / cam.fx
    yd = (v - cam.cy) / cam.fy
    x, y = xd, yd
    for _ in range(iterations):
        ddx, ddy = distort_normalized(cam, x, y)
        x, y = x + (xd - ddx), y + (yd - ddy)
    return x * cam.fx + cam.cx, y * cam.fy + cam.cy


def _pixel_grid(h: int, w: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    vv = torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
    uu = torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
    return vv, uu


def rectify_image(cam: PinholeCamera, img: torch.Tensor, nearest: bool = False) -> torch.Tensor:
    """Undistort (..., H, W) images: each rectified pixel samples the raw
    image at its distorted location, bilinearly, or at the nearest pixel
    with ``nearest=True`` (depth: no blending across discontinuities)."""
    h, w = img.shape[-2:]
    vv, uu = _pixel_grid(h, w, img.device)
    xn = (uu - cam.cx) / cam.fx
    yn = (vv - cam.cy) / cam.fy
    xd, yd = distort_normalized(cam, xn, yn)
    us = xd * cam.fx + cam.cx
    vs = yd * cam.fy + cam.cy
    if nearest:
        ui = torch.clamp(torch.round(us), 0, w - 1).long()
        vi = torch.clamp(torch.round(vs), 0, h - 1).long()
        return img[..., vi, ui]
    u0f = torch.clamp(torch.floor(us), 0, w - 2)
    v0f = torch.clamp(torch.floor(vs), 0, h - 2)
    du = torch.clamp(us - u0f, 0.0, 1.0)
    dv = torch.clamp(vs - v0f, 0.0, 1.0)
    u0, v0 = u0f.long(), v0f.long()
    i00 = img[..., v0, u0]
    i01 = img[..., v0, u0 + 1]
    i10 = img[..., v0 + 1, u0]
    i11 = img[..., v0 + 1, u0 + 1]
    return (i00 * (1 - du) * (1 - dv) + i01 * du * (1 - dv)
            + i10 * (1 - du) * dv + i11 * du * dv)


def backproject_image(cam: PinholeCamera, depth: torch.Tensor) -> torch.Tensor:
    """Dense depth images (..., H, W) -> clouds (..., H, W, 3) in the
    camera frame."""
    vv, uu = _pixel_grid(*depth.shape[-2:], depth.device)
    return backproject(cam, uu, vv, depth)
