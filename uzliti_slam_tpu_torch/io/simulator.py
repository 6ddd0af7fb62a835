"""Synthetic RGB-D world: a textured wall rendered through a pinhole camera.

The port's own copy of ``uzliti_slam_tpu/io/simulator.py`` (``WallWorld``,
``cam_extrinsic``, ``out_and_back_trajectory``, ``simulate_sequence``): the
same numpy rendering from the same seed, so both packages see the same
frames.  A robot drives past an infinite textured wall; each frame is the
wall texture and its metric depth in the Kinect wire format (uint8 mono
image, uint16 millimetre depth), with drifting odometry.  Frames are host
(numpy) arrays, as a live sensor feed delivers them.
"""

from __future__ import annotations

import numpy as np
import torch

from uzliti_slam_tpu_torch import _device
from uzliti_slam_tpu_torch.frontend import camera as cam_mod
from uzliti_slam_tpu_torch.ops import lie

# Camera optical frame -> robot base frame: z_cam = +x_base (forward),
# x_cam = -y_base (right), y_cam = -z_base (down).
CAM_IN_BASE_R = np.array([
    [0.0, 0.0, 1.0],
    [-1.0, 0.0, 0.0],
    [0.0, -1.0, 0.0],
])


def cam_extrinsic(height: float = 0.5, device=None) -> torch.Tensor:
    """(7,) camera-to-base pose of the forward camera at ``height`` metres,
    on ``device`` (default: the CUDA card)."""
    device = _device.resolve(device)
    R = torch.tensor(CAM_IN_BASE_R, dtype=torch.float32, device=device)
    t = torch.tensor([0.0, 0.0, height], dtype=torch.float32, device=device)
    return lie.make_pose(t, lie.matrix_to_quat(R))


class WallWorld:
    """A textured wall at world x = ``wall_x``; the robot moves in the
    x-y plane facing +x.  Texture = random bright blobs (FAST-friendly)."""

    def __init__(self, wall_x: float = 3.0, tex_size: int = 4096,
                 px_per_m: float = 120.0, seed: int = 0,
                 img_h: int = 120, img_w: int = 160, f: float = 130.0):
        rng = np.random.default_rng(seed)
        tex = np.full((tex_size, tex_size), 40.0, dtype=np.float32)
        n_blobs = (tex_size // 24) ** 2
        ys = rng.integers(0, tex_size - 30, n_blobs)
        xs = rng.integers(0, tex_size - 30, n_blobs)
        for y, x in zip(ys, xs):
            h = rng.integers(6, 24)
            w = rng.integers(6, 24)
            tex[y:y + h, x:x + w] = rng.uniform(120, 250)
        self.tex = tex
        self.tex_size = tex_size
        self.px_per_m = px_per_m
        self.wall_x = wall_x
        self.cam = cam_mod.PinholeCamera(
            fx=float(np.float32(f)), fy=float(np.float32(f)),
            cx=float(np.float32(img_w / 2)), cy=float(np.float32(img_h / 2)),
            width=img_w, height=img_h,
        )
        self.img_h = img_h
        self.img_w = img_w
        self.cam_height = 0.5

    def render(self, tx: float, ty: float) -> tuple[np.ndarray, np.ndarray]:
        """Render (uint8 image, uint16 depth in mm) for a robot at (tx, ty),
        heading +x."""
        h, w = self.img_h, self.img_w
        f, cx, cy = self.cam.fx, self.cam.cx, self.cam.cy
        z = self.wall_x - tx                       # wall distance (optical z)
        uu, vv = np.meshgrid(np.arange(w), np.arange(h))
        # world coordinates of the wall point each pixel sees:
        # cam x (right) = -y_base  -> wall y = ty - (u-cx)/f*z
        # cam y (down)  = -z_base  -> wall height = cam_h - (v-cy)/f*z
        wy = ty - (uu - cx) / f * z
        wz = self.cam_height - (vv - cy) / f * z
        tu = np.mod(wy * self.px_per_m, self.tex_size - 1)
        tv = np.mod(-wz * self.px_per_m, self.tex_size - 1)
        # bilinear sample
        t0u = np.floor(tu).astype(int)
        t0v = np.floor(tv).astype(int)
        fu = tu - t0u
        fv = tv - t0v
        t1u = np.minimum(t0u + 1, self.tex_size - 1)
        t1v = np.minimum(t0v + 1, self.tex_size - 1)
        img = (
            self.tex[t0v, t0u] * (1 - fu) * (1 - fv)
            + self.tex[t0v, t1u] * fu * (1 - fv)
            + self.tex[t1v, t0u] * (1 - fu) * fv
            + self.tex[t1v, t1u] * fu * fv
        )
        depth = np.full((h, w), round(z * 1000.0), dtype=np.uint16)
        return np.clip(img, 0, 255).astype(np.uint8), depth


def out_and_back_trajectory(n: int, length: float = 6.0):
    """Ground-truth (tx, ty) waypoints: drive +y for n/2 frames, return."""
    half = n // 2
    fwd = np.linspace(0.0, length, half)
    back = np.linspace(length, 0.0, n - half)
    ty = np.concatenate([fwd, back])
    tx = np.zeros(n)
    return tx, ty


def _planar_pose(x: float, y: float) -> np.ndarray:
    """(7,) float32 pose at (x, y, 0) with the identity rotation."""
    return np.array([x, y, 0.0, 1.0, 0.0, 0.0, 0.0], dtype=np.float32)


def simulate_sequence(world: WallWorld, n_frames: int = 30, odom_drift: float = 0.01,
                      seed: int = 0, length: float = 6.0):
    """(image, depth, noisy odometry pose, ground-truth pose, stamp) frames
    as dicts of host arrays.  Odometry accumulates a per-step bias
    (systematic drift)."""
    rng = np.random.default_rng(seed)
    tx, ty = out_and_back_trajectory(n_frames, length)
    bias = rng.normal(0, odom_drift, 2)
    odom = np.zeros(2)
    prev = np.array([tx[0], ty[0]])
    frames = []
    for i in range(n_frames):
        gt_xy = np.array([tx[i], ty[i]])
        step = gt_xy - prev
        noise = rng.normal(0, odom_drift / 2, 2)
        odom = odom + step + (bias + noise) * np.linalg.norm(step)
        prev = gt_xy
        img, dep = world.render(tx[i], ty[i])
        frames.append(dict(image=img, depth=dep, odom_pose=_planar_pose(odom[0], odom[1]),
                           gt_pose=_planar_pose(gt_xy[0], gt_xy[1]), stamp=float(i)))
    return frames
