"""ORB-style feature detection and description, and the binary GIST.

PyTorch counterpart of ``uzliti_slam_tpu/ops/features.py``:
tunable-threshold FAST-9/16 with 3x3 non-maximum suppression, a
grid-adapted top-K per pyramid level, intensity-centroid orientation, and
either a steered 256-test binary descriptor on a box-blurred image, packed
LSB first, or the float "sift" family (4x4 cells x 8 orientation bins of a
steered 16x16 gradient grid, 128 float32).  Shapes are static: K keypoints
with validity masks.

Every image function takes a camera batch: (C, H, W), or (H, W) for one
camera.  ``detect_and_describe``, ``detect_describe_gist``,
``select_topk_grid`` and ``binary_gist`` run the hand-written kernels K12
(``fast_nms``) and K13 (``grid_topk``), each on all pyramid levels in one
launch, and K14 (``orb_describe_levels``: every level, all cameras, and with
``detect_describe_gist`` the GIST, in one launch) through
``kernels/ops.py``: on CPU tensors those
wrappers run their plain versions, which are built from ``fast_score``,
``nms``, ``_sep_blur``, ``intensity_centroid_angles`` and
``brief_descriptors`` here.  The "sift" family takes K12 and K13, then
K29 (``sift_describe``: the angle and ``sift_descriptors``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import _patterns, matching, resize

# FAST circle of radius 3 (Bresenham), 16 (dy, dx) offsets in clockwise order.
_FAST_OFFSETS = (
    (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
)
# Keypoints closer than this to a border are suppressed: the rotated
# pattern reaches 13·√2 ≈ 18.4 px, plus the blur radius.
BORDER = 21


class Keypoints(NamedTuple):
    uv: torch.Tensor        # (..., K, 2) float32 pixel coords (u=x, v=y)
    response: torch.Tensor  # (..., K)
    angle: torch.Tensor     # (..., K) orientation in radians
    scale: torch.Tensor     # (..., K) pyramid scale factor applied to uv
    valid: torch.Tensor     # (..., K) bool


def _batched(img: torch.Tensor) -> torch.Tensor:
    return img if img.dim() == 3 else img[None]


def _shift2d(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = img[..., y + dy, x + dx], zero outside."""
    h, w = img.shape[-2:]
    out = torch.zeros_like(img)
    out[..., max(-dy, 0): h + min(-dy, 0), max(-dx, 0): w + min(-dx, 0)] = \
        img[..., max(dy, 0): h + min(dy, 0), max(dx, 0): w + min(dx, 0)]
    return out


def fast_score(img: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """FAST-9/16 corner response of (..., H, W) float32 images: ≥ 9
    contiguous circle pixels all brighter (or all darker) than the centre ±
    threshold; score = the larger of the brighter and darker sums of
    |difference| - threshold; 0 within ``BORDER`` of an edge."""
    ring = torch.stack([_shift2d(img, -dy, -dx) for dy, dx in _FAST_OFFSETS], dim=-3)
    diff = ring - img[..., None, :, :]
    brighter = diff > threshold
    darker = diff < -threshold

    def contiguous9(mask):
        # a run of 9 with wrap-around: AND-doubling along the ring axis
        a = mask & torch.roll(mask, -1, dims=-3)
        a = a & torch.roll(a, -2, dims=-3)
        a = a & torch.roll(a, -4, dims=-3)
        return torch.any(a & torch.roll(mask, -8, dims=-3), dim=-3)

    is_corner = contiguous9(brighter) | contiguous9(darker)
    # summed in ring order, as K12 sums (the reference's order may differ
    # off level 0, where the scores of a uint8 image are exact integers)
    score_b = score_d = torch.zeros_like(img)
    for i in range(len(_FAST_OFFSETS)):
        d = diff[..., i, :, :]
        score_b = score_b + torch.where(brighter[..., i, :, :], d - threshold, 0.0)
        score_d = score_d + torch.where(darker[..., i, :, :], -d - threshold, 0.0)
    score = torch.maximum(score_b, score_d)
    h, w = img.shape[-2:]
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    b = BORDER
    interior = (yy >= b) & (yy < h - b) & (xx >= b) & (xx < w - b)
    return torch.where(is_corner & interior, score, 0.0)


def nms(score: torch.Tensor, radius: int = 1) -> torch.Tensor:
    """(2r+1)² non-maximum suppression of (..., H, W) scores: a score is
    kept where it equals its window's maximum (ties all kept) and is > 0."""
    k = 2 * radius + 1
    flat = score.reshape(-1, 1, *score.shape[-2:])
    pooled = torch.nn.functional.max_pool2d(flat, k, stride=1, padding=radius)
    pooled = pooled.reshape(score.shape)
    return torch.where((score == pooled) & (score > 0), score, 0.0)


def select_topk_grid(score: torch.Tensor, k_total: int, grid: int = 4):
    """Grid-adapted top-K of (C, H, W) or (H, W) scores (kernel K13, one
    level): the exact top ⌊k_total / grid²⌋ (at least 1) of each cell of a
    grid × grid split, ties to the lower row-major index in the cell, then
    the global top ``k_total`` if that is more, or zero padding if fewer.
    Returns (uv (..., K, 2) float32, response (..., K), valid (..., K))."""
    uv, resp, valid = kops.grid_topk(_batched(score).contiguous(), k_total, grid)
    if score.dim() == 2:
        return uv[0], resp[0], valid[0]
    return uv, resp, valid


def _sep_blur(img: torch.Tensor, radius: int = 2) -> torch.Tensor:
    """Separable box blur of (..., H, W) with zero padding: a row sum, then
    a column sum, left to right as ``reduce_window`` adds, then × 1/k²."""
    k = 2 * radius + 1
    h, w = img.shape[-2:]
    pad = torch.nn.functional.pad(img, (radius, radius))
    s = pad[..., 0:w]
    for i in range(1, k):
        s = s + pad[..., i: i + w]
    pad = torch.nn.functional.pad(s, (0, 0, radius, radius))
    t = pad[..., 0:h, :]
    for i in range(1, k):
        t = t + pad[..., i: i + h, :]
    return t * (1.0 / (k * k))


def intensity_centroid_angles(img: torch.Tensor, uv: torch.Tensor, radius: int = 7) -> torch.Tensor:
    """Orientation of keypoints uv (C, K, 2) on images (C, H, W) by the
    intensity centroid: atan2(m01, m10) over the (2r+1)² patch whose origin
    is the keypoint's pixel less r, clipped into the image, masked to the
    disc of radius r about the patch centre."""
    k = 2 * radius + 1
    dev = img.device
    d = torch.arange(k, dtype=torch.float32, device=dev) - radius
    dy, dx = d[:, None].expand(k, k), d[None, :].expand(k, k)
    circ = (dx * dx + dy * dy) <= radius * radius
    C, h, w = img.shape
    y0 = torch.clamp(uv[..., 1].to(torch.int32) - radius, 0, h - k).long()
    x0 = torch.clamp(uv[..., 0].to(torch.int32) - radius, 0, w - k).long()
    ar = torch.arange(k, device=dev)
    flat = (y0[..., None, None] + ar[:, None]) * w + (x0[..., None, None] + ar[None, :])
    patches = torch.gather(img.reshape(C, -1), 1, flat.reshape(C, -1)).reshape(flat.shape)
    patches = patches * circ
    m01 = torch.sum(dy * patches, dim=(-2, -1))
    m10 = torch.sum(dx * patches, dim=(-2, -1))
    return torch.atan2(m01, m10)


def brief_descriptors(img: torch.Tensor, uv: torch.Tensor, angles: torch.Tensor,
                      pattern: torch.Tensor) -> torch.Tensor:
    """Steered binary descriptors of keypoints uv (C, K, 2) with angles
    (C, K) on images (C, H, W): the (256, 2, 2) pattern rotated by each
    angle, both points of each test sampled on the box-blurred image at the
    nearest pixel (round half to even, clipped), bit = a < b; (C, K, 32)
    uint8, LSB first."""
    sm = _sep_blur(img, 2)
    C, h, w = img.shape
    ca, sa = torch.cos(angles), torch.sin(angles)
    px, py = pattern[None, None, :, :, 0], pattern[None, None, :, :, 1]
    rx = ca[..., None, None] * px - sa[..., None, None] * py
    ry = sa[..., None, None] * px + ca[..., None, None] * py
    sx = uv[..., None, None, 0] + rx
    sy = uv[..., None, None, 1] + ry
    xi = torch.clamp(torch.round(sx), 0, w - 1).long()
    yi = torch.clamp(torch.round(sy), 0, h - 1).long()
    flat = (yi * w + xi).reshape(C, -1)
    vals = torch.gather(sm.reshape(C, -1), 1, flat).reshape(xi.shape)
    bits = vals[..., 0] < vals[..., 1]
    return matching.pack_bits(bits)


def sift_descriptors(img: torch.Tensor, uv: torch.Tensor, angles: torch.Tensor,
                     patch_radius: float = 8.0, window: torch.Tensor | None = None) -> torch.Tensor:
    """SIFT-family float descriptors of keypoints uv (C, K, 2) with angles
    (C, K) on images (C, H, W): the 18x18 grid of spacing 2·r/16 rotated by
    each angle, sampled at the nearest pixel (clipped, then rounded half to
    even) of the radius-1 box blur; central differences inside the rotated
    frame; magnitudes times the 16x16 Gaussian window (``window``, default
    ``kops.sift_window``) voted softly into 8 orientation bins (linear
    between bins) of 4x4 cells; unit L2, a clip at 0.2, unit L2 again.
    Returns (C, K, 128) float32 (cells row-major, bins innermost)."""
    G = kops.SIFT_GRID
    sm = _sep_blur(img.to(torch.float32), 1)
    C, h, w = img.shape
    dev = img.device
    step = 2.0 * patch_radius / G
    g = (torch.arange(G + 2, dtype=torch.float32, device=dev) - (G + 1) / 2.0) * step
    dyy, dxx = g[:, None].expand(G + 2, G + 2), g[None, :].expand(G + 2, G + 2)
    ca, sa = torch.cos(angles)[..., None, None], torch.sin(angles)[..., None, None]
    rx = ca * dxx - sa * dyy
    ry = sa * dxx + ca * dyy
    sx = torch.clamp(uv[..., None, None, 0] + rx, 0, w - 1)
    sy = torch.clamp(uv[..., None, None, 1] + ry, 0, h - 1)
    flat = (torch.round(sy).long() * w + torch.round(sx).long()).reshape(C, -1)
    patch = torch.gather(sm.reshape(C, -1), 1, flat).reshape(sx.shape)   # (C, K, 18, 18)
    gx = 0.5 * (patch[..., 1:-1, 2:] - patch[..., 1:-1, :-2])
    gy = 0.5 * (patch[..., 2:, 1:-1] - patch[..., :-2, 1:-1])
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    ori = torch.atan2(gy, gx)
    wg = kops.sift_window(dev) if window is None else window
    mag = mag * wg
    nb = 8
    t = (ori + math.pi) * (nb / (2.0 * math.pi))
    ft = torch.floor(t)
    b0 = ft.long() % nb
    frac = t - ft
    hist = torch.zeros(*mag.shape, nb, dtype=torch.float32, device=dev)
    hist.scatter_add_(-1, b0[..., None], ((1.0 - frac) * mag)[..., None])
    hist.scatter_add_(-1, ((b0 + 1) % nb)[..., None], (frac * mag)[..., None])
    K = uv.shape[1]
    desc = hist.reshape(C, K, 4, 4, 4, 4, nb).sum(dim=(3, 5)).reshape(C, K, 128)
    desc = desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)
    desc = torch.clamp(desc, max=0.2)
    return desc / (torch.linalg.vector_norm(desc, dim=-1, keepdim=True) + 1e-8)


def brisk_pattern(n_bits: int = 256, patch_radius: int = 13) -> np.ndarray:
    """BRISK-style deterministic pattern: points on concentric staggered
    rings, paired by short distance (ties by index); (n_bits, 2, 2)."""
    rings = [(0.0, 1), (0.25, 8), (0.45, 12), (0.7, 16), (1.0, 20)]
    pts = []
    for ri, (rfrac, n) in enumerate(rings):
        r = rfrac * patch_radius
        for i in range(n):
            th = 2.0 * np.pi * i / n + (np.pi / n) * (ri % 2)
            pts.append((r * np.cos(th), r * np.sin(th)))
    pts = np.asarray(pts, dtype=np.float32)  # (57, 2)
    ii, jj = np.triu_indices(len(pts), k=1)
    d = np.linalg.norm(pts[ii] - pts[jj], axis=-1)
    sel = np.argsort(d, kind="stable")[:n_bits]
    return np.stack([pts[ii[sel]], pts[jj[sel]]], axis=-2)


def freak_pattern(n_bits: int = 256, patch_radius: int = 13) -> np.ndarray:
    """FREAK-style retinal pattern: rings of geometrically growing radius,
    paired longest distance first (ties by index); (n_bits, 2, 2)."""
    n_rings = 7
    pts = [(0.0, 0.0)]  # fovea centre
    for ri in range(n_rings):
        r = patch_radius * (2.0 ** (ri + 1) - 1.0) / (2.0 ** n_rings - 1.0)
        n = 6
        for i in range(n):
            th = 2.0 * np.pi * i / n + (np.pi / n) * (ri % 2)
            pts.append((r * np.cos(th), r * np.sin(th)))
    pts = np.asarray(pts, dtype=np.float32)  # (43, 2)
    ii, jj = np.triu_indices(len(pts), k=1)
    d = np.linalg.norm(pts[ii] - pts[jj], axis=-1)
    sel = np.argsort(-d, kind="stable")[:n_bits]
    return np.stack([pts[ii[sel]], pts[jj[sel]]], axis=-2)


def _as_pattern(rows) -> np.ndarray:
    return np.asarray(rows, dtype=np.float32).reshape(-1, 2, 2)


_PATTERNS_NP = {
    "brief": _as_pattern(_patterns.BRIEF_13),
    "brisk": brisk_pattern(),
    "freak": freak_pattern(),
    "gist": _as_pattern(_patterns.GIST_25),
}
_pattern_cache: dict = {}


def pattern(name: str, device) -> torch.Tensor:
    """The (256, 2, 2) float32 sampling pattern ``name`` ("brief", "brisk",
    "freak" or "gist") on ``device``, cached."""
    key = (name, torch.device(device))
    if key not in _pattern_cache:
        _pattern_cache[key] = torch.from_numpy(_PATTERNS_NP[name]).to(device)
    return _pattern_cache[key]


def pyramid_shapes(h: int, w: int, n_levels: int, scale_factor: float):
    """[(scale, (h, w))] of each pyramid level: level l is the image resized
    by 1/scale_factor^l (scale as a double product), at least 32 px a side."""
    out, scale = [], 1.0
    for lvl in range(n_levels):
        out.append((scale, (h, w) if lvl == 0 else
                    (max(int(round(h / scale)), 32), max(int(round(w / scale)), 32))))
        scale *= scale_factor
    return out


def _detect_describe(imgs: torch.Tensor, max_keypoints: int, threshold: float, grid: int,
                     n_levels: int, scale_factor: float, descriptor: str, gist=None):
    """``detect_and_describe`` on (C, H, W) float32 images, with the
    ``gist_row`` ``gist`` (a block of its own) added to the binary families'
    one K14 call; returns (Keypoints, descriptors, the GIST's (1, 1, 32)
    descriptor or None)."""
    if descriptor not in ("brief", "brisk", "freak", "sift"):
        raise ValueError(f"unknown descriptor family {descriptor!r}")
    C, H, W = imgs.shape
    k_level = max(max_keypoints // n_levels, 1)
    # every level's resize, then K12 once and K13 once for all levels, then
    # the descriptors of every level (the keypoints stay level-major)
    shapes = pyramid_shapes(H, W, n_levels, scale_factor)
    curs = [imgs if (h, w) == (H, W) else resize.resize_linear(imgs, (h, w)).contiguous()
            for _, (h, w) in shapes]
    uvs, resp, valid = kops.grid_topk(kops.fast_nms(curs, threshold), k_level,
                                      grid)                      # (levels, C, k_level, ...)
    gist_desc = None
    if descriptor == "sift":
        window = kops.sift_window(imgs.device)
        described = [kops.sift_describe(cur, uv.contiguous(), window)
                     for cur, uv in zip(curs, uvs)]
        ang, desc = (torch.cat([d[i] for d in described], dim=1) for i in range(2))
    else:
        # K14 once: every level, all cameras (one block, written side by
        # side), and the GIST
        pat = pattern(descriptor, imgs.device)
        levels = [kops.DescribeRow(cur, uv, pat) for cur, uv in zip(curs, uvs)]
        blocks = [levels] + ([[gist]] if gist is not None else [])
        (ang, desc), *rest = kops.orb_describe_levels(blocks)
        gist_desc = rest[0][1] if rest else None
    uv = torch.cat([uv * scale for (scale, _), uv in zip(shapes, uvs)], dim=1)
    scl = torch.cat([torch.full_like(ang[:, :k_level], scale) for scale, _ in shapes], dim=1)
    resp, valid = (t.transpose(0, 1).reshape(C, -1) for t in (resp, valid))
    short = max_keypoints - desc.shape[1]
    if short > 0:
        def pad(t, value):
            return torch.cat([t, t.new_full((C, short) + t.shape[2:], value)], dim=1)
        uv, resp, ang = pad(uv, 0.0), pad(resp, 0.0), pad(ang, 0.0)
        scl, valid, desc = pad(scl, 1.0), pad(valid, False), pad(desc, 0)
    return Keypoints(uv=uv, response=resp, angle=ang, scale=scl, valid=valid), desc, gist_desc


def detect_and_describe(img: torch.Tensor, max_keypoints: int = 300, threshold: float = 20.0,
                        grid: int = 4, n_levels: int = 4, scale_factor: float = 1.2,
                        descriptor: str = "brief"):
    """FAST + NMS (K12) and grid top-K (K13), each one launch for all
    levels, and orientation + descriptors over an image pyramid of (C, H,
    W) or (H, W) images.

    Returns (Keypoints, descriptors) with K == max_keypoints exactly: each
    level takes ⌊max_keypoints / n_levels⌋ (at least 1) and the remainder
    is padded with invalid slots (descriptor rows of zeros).  Keypoint uv
    are in level-0 pixels.  ``descriptor`` is "brief", "brisk" or "freak"
    (K14, one call for every level and camera, three patterns: (..., K, 32)
    uint8), or "sift" (K29, a call a level: (..., K, 128) float32, matched
    by L2).
    """
    imgs = _batched(img).to(torch.float32).contiguous()
    kps, desc, _ = _detect_describe(imgs, max_keypoints, threshold, grid, n_levels,
                                    scale_factor, descriptor)
    if img.dim() == 2:
        return Keypoints(*(t[0] for t in kps)), desc[0]
    return kps, desc


GIST_SIZE = 63


def gist_row(img: torch.Tensor, roll_angle=0.0):
    """The K14 row of the whole-image binary GIST of (C, H, W) images: the
    frame resized to 63×63, one keypoint at the centre, the radius-25
    pattern, the angle the robot's roll (a float or a tensor of the batch's
    shape)."""
    imgs = img.to(torch.float32)
    C = imgs.shape[0]
    small = resize.resize_linear(imgs, (GIST_SIZE, GIST_SIZE)).contiguous()
    centre = torch.full((C, 1, 2), float(GIST_SIZE // 2), device=imgs.device)
    ang = torch.as_tensor(roll_angle, dtype=torch.float32, device=imgs.device)
    ang = ang.reshape(-1, 1).expand(C, 1).contiguous()
    return kops.DescribeRow(small, centre, pattern("gist", imgs.device), ang)


def binary_gist(img: torch.Tensor, roll_angle=0.0) -> torch.Tensor:
    """Whole-image binary GIST of (H, W) or (C, H, W) images (``gist_row``,
    K14 on its one row).  Returns (32,) or (C, 32) uint8."""
    (_, desc), = kops.orb_describe_levels([[gist_row(_batched(img), roll_angle)]])
    return desc[0, 0] if img.dim() == 2 else desc[:, 0]


def detect_describe_gist(img: torch.Tensor, roll_angle=0.0, max_keypoints: int = 300,
                         threshold: float = 20.0, grid: int = 4, n_levels: int = 4,
                         scale_factor: float = 1.2, descriptor: str = "brief"):
    """``detect_and_describe`` of (C, H, W) or (H, W) images for a binary
    family, and camera 0's ``binary_gist`` as the last row of the same K14
    call: one launch for a keyframe's descriptors.  Returns (Keypoints,
    descriptors, GIST (32,) uint8), the first two shaped as
    ``detect_and_describe``'s."""
    if descriptor == "sift":
        raise ValueError("detect_describe_gist: the GIST row joins a binary family's K14 call")
    imgs = _batched(img).to(torch.float32).contiguous()
    kps, desc, gist = _detect_describe(imgs, max_keypoints, threshold, grid, n_levels,
                                       scale_factor, descriptor,
                                       gist=gist_row(imgs[:1], roll_angle))
    if img.dim() == 2:
        return Keypoints(*(t[0] for t in kps)), desc[0], gist[0, 0]
    return kps, desc, gist[0, 0]
