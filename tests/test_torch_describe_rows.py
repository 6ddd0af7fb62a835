"""K14 as one call for a keyframe (``kops.orb_describe_levels``: every
pyramid level, all cameras, and the GIST) on the CPU, against the per-level
plain calls and the JAX package's ``detect_and_describe`` /
``brief_descriptors`` / ``binary_gist``; and a numpy emulation of the
kernel's windowed blur (``csrc/orb_describe.cu``: the pattern's reach, the
window of the unblurred image about the keypoint's clamped pixel, the 5x5
sums in the kernel's order) against ``_sep_blur``-then-sample, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.io import simulator as jsim
from uzliti_slam_tpu.ops import features as JF
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import features as TF
from uzliti_slam_tpu_torch.ops import matching as TM
from uzliti_slam_tpu_torch.ops import resize as TR

ANGLE_ATOL = 1e-5      # rad: moments summed in another order off level 0
F32 = np.float32
# csrc/orb_describe.cu: the blur radius and the window's rows and row pitch
BLUR_R, WIN_H, WIN_P = 2, 72, 76


@pytest.fixture(scope="module")
def frame():
    img, _ = jsim.WallWorld(img_h=120, img_w=160).render(0.7, 1.3)
    return img


def _levels(imgs: torch.Tensor, k_level: int = 16):
    """Each pyramid level's image and keypoints, as ``detect_and_describe``
    makes them: [(scale, image (C, h, w), uv (C, k_level, 2))]."""
    shapes = TF.pyramid_shapes(imgs.shape[1], imgs.shape[2], 4, 1.2)
    curs = [imgs if (h, w) == tuple(imgs.shape[1:]) else TR.resize_linear(imgs, (h, w)).contiguous()
            for _, (h, w) in shapes]
    uvs = kops.grid_topk([kops.fast_nms(c, 20.0) for c in curs], k_level, 4)[0]
    return [(s, c, u) for (s, _), c, u in zip(shapes, curs, uvs)]


def window_descriptors(img, uv, angles, pattern):
    """The kernel's arithmetic in numpy float32: per keypoint the pattern's
    reach (``kops.describe_reach``), the window of the unblurred image about
    floor(u) clamped into the image, clipped to [-2, W+1] x [-2, H+1] with
    zeros outside the image, its left edge aligned down to 4 where W is a
    multiple of 4, within the kernel's rows x floats; each rotated, rounded
    and clipped sample's 5x5 sum (rows left to right, then the column top
    to bottom, x fl(1/25)) from the window, which must hold it.  The cosine
    and sine are torch's (the plain version's).  Returns (C, K, 32) uint8."""
    img = np.asarray(img, F32)
    C, H, W = img.shape
    pat = np.asarray(pattern, F32).reshape(256, 4)
    reach = kops.describe_reach(torch.from_numpy(pat.reshape(256, 2, 2)))
    ang = torch.as_tensor(np.asarray(angles, F32))
    cos, sin = torch.cos(ang).numpy(), torch.sin(ang).numpy()
    offs = np.arange(-BLUR_R, BLUR_R + 1)
    out = np.zeros(uv.shape[:2] + (256,), bool)
    for c in range(C):
        for k in range(uv.shape[1]):
            u, v = F32(uv[c, k, 0]), F32(uv[c, k, 1])
            u0 = int(min(max(np.floor(u), 0), W - 1))
            v0 = int(min(max(np.floor(v), 0), H - 1))
            x0, x1 = max(u0 - reach, -BLUR_R), min(u0 + reach, W - 1 + BLUR_R)
            y0, y1 = max(v0 - reach, -BLUR_R), min(v0 + reach, H - 1 + BLUR_R)
            vec = W % 4 == 0
            lx0 = x0 & ~3 if vec else x0
            wid = x1 - lx0 + 1
            wid = (wid + 3) & ~3 if vec else wid
            hgt = y1 - y0 + 1
            assert 0 < hgt <= WIN_H and 0 < wid <= WIN_P
            ys, xs = np.arange(y0, y0 + hgt), np.arange(lx0, lx0 + wid)
            inside = ((ys >= 0) & (ys < H))[:, None] & ((xs >= 0) & (xs < W))[None, :]
            win = np.where(inside, img[c][np.clip(ys, 0, H - 1)][:, np.clip(xs, 0, W - 1)], F32(0))
            ca, sa = cos[c, k], sin[c, k]
            vals = []
            for px, py in ((pat[:, 0], pat[:, 1]), (pat[:, 2], pat[:, 3])):
                rx = ca * px - sa * py
                ry = sa * px + ca * py
                xi = np.clip(np.rint(u + rx), 0, W - 1).astype(int)
                yi = np.clip(np.rint(v + ry), 0, H - 1).astype(int)
                lx, ly = xi - lx0, yi - y0
                assert ((lx >= BLUR_R) & (lx + BLUR_R < wid) & (ly >= BLUR_R)
                        & (ly + BLUR_R < hgt)).all(), "a sample's 5x5 leaves the window"
                p = win[(ly[:, None] + offs)[:, :, None], (lx[:, None] + offs)[:, None, :]]
                rows = [p[:, r, 0] for r in range(5)]
                for r in range(5):
                    for i in range(1, 5):
                        rows[r] = rows[r] + p[:, r, i]
                t = rows[0]
                for r in range(1, 5):
                    t = t + rows[r]
                vals.append(t * F32(1.0 / 25.0))
            out[c, k] = vals[0] < vals[1]
    return TM.pack_bits(torch.from_numpy(out)).numpy()


def _border_keypoints(H: int, W: int):
    """Keypoints on all four corners and edges, one pixel in, a few
    off-grid and a few off the image: (1, n, 2) float32."""
    pts = [(0, 0), (W - 1, 0), (0, H - 1), (W - 1, H - 1), (W // 2, 0), (0, H // 2),
           (W - 1, H // 2), (W // 2, H - 1), (1, 1), (W - 2, H - 2), (2.5, H - 3.5),
           (W - 0.25, 7.75), (W // 3, H // 3), (18.0, 20.0)]
    # and off the image: samples clip to its edge
    pts += [(-30.5, -4.0), (W + 40.0, H // 2), (W // 2, H + 0.5), (-1e6, 3e7)]
    return torch.tensor([pts], dtype=torch.float32)


@pytest.mark.parametrize("name", ["brief", "brisk", "freak", "gist"])
def test_windowed_blur_equals_sep_blur_then_sample(frame, name):
    """The kernel's windowed 5x5 sums give the blurred image's values bit
    for bit, at every corner and edge and off the image, for all three
    binary patterns and the GIST row (its 63x63 resize, the centre and the
    radius-25 pattern), each sample's 5x5 inside its keypoint's window."""
    rng = np.random.default_rng(11)
    pat = TF.pattern(name, "cpu")
    if name == "gist":
        row = TF.gist_row(torch.from_numpy(frame)[None], 0.3)
        img = row.img
        uv = torch.cat([row.uv, _border_keypoints(63, 63)], dim=1)
    else:
        img = torch.from_numpy(np.stack([frame, frame[::-1]]).astype(F32))
        uv = _border_keypoints(120, 160).expand(2, -1, -1).contiguous()
    ang = torch.from_numpy(rng.uniform(-np.pi, np.pi, uv.shape[:2]).astype(F32))
    ref = TF.brief_descriptors(img, uv, ang, pat).numpy()
    got = window_descriptors(img.numpy(), uv.numpy(), ang.numpy(), pat.numpy())
    np.testing.assert_array_equal(got, ref)
    # and the JAX package's descriptors, given the same angles
    fn = jax.jit(JF.brief_descriptors)
    for c in range(img.shape[0]):
        ref_j = np.asarray(fn(img[c].numpy(), uv[c].numpy(), ang[c].numpy(), pat.numpy()))
        np.testing.assert_array_equal(got[c], ref_j)


def test_describe_reach_and_window_of_each_pattern():
    """The reach is the pattern's largest point norm (a rotation keeps it,
    not the per-axis bound: BRIEF's points lie within ±13 per axis and
    reach 16.4), + 1 for the rounding and + 2 for the blur; every binary
    pattern's window fits the kernel on a VGA frame, the GIST's on its
    63x63 image only."""
    reach = {name: kops.describe_reach(TF.pattern(name, "cpu"))
             for name in ("brief", "brisk", "freak", "gist")}
    norms = {name: float(np.linalg.norm(TF.pattern(name, "cpu").numpy().reshape(-1, 2),
                                        axis=-1).max()) for name in reach}
    assert float(TF.pattern("brief", "cpu").abs().max()) <= 13.0 < norms["brief"]
    assert all(reach[n] == int(np.ceil(norms[n])) + 1 + BLUR_R for n in reach)
    assert reach == {"brief": 20, "brisk": 16, "freak": 16, "gist": 39}
    assert (WIN_H, WIN_P) == kops.ORB_DESCRIBE_WINDOW
    for n in ("brief", "brisk", "freak"):
        rows, floats = kops.describe_window(reach[n], 480, 640)
        assert rows <= WIN_H and floats <= WIN_P
    rows, floats = kops.describe_window(reach["gist"], 63, 63)
    assert rows <= WIN_H and floats <= WIN_P
    assert kops.describe_window(reach["gist"], 480, 640) == (79, 82)


def test_describe_reach_is_read_once_per_pattern_tensor():
    """``describe_reach`` reads a pattern on the host once, and again after
    an in-place change; a point that is not finite raises."""
    pat = TF.pattern("brief", "cpu").clone()
    assert kops.describe_reach(pat) == 20
    pat.mul_(3.0)
    assert kops.describe_reach(pat) == int(np.ceil(3 * 16.40122)) + 3
    assert kops.describe_reach(TF.pattern("freak", "cpu")) == 16
    bad = pat.clone()
    bad[0, 0, 0] = float("nan")
    with pytest.raises(ValueError, match="not finite"):
        kops.describe_reach(bad)


@pytest.mark.parametrize("n_cams", [1, 2])
def test_one_call_equals_the_per_level_plain_calls_and_jax(frame, n_cams):
    """The multi-row plain entry (a block of every level on all cameras,
    then a block of the GIST) equals ``orb_describe_plain`` row by row,
    side by side along the keypoints, and the JAX package's
    intensity-centroid angles (within ANGLE_ATOL) and ``brief_descriptors``
    given the angles (exact) on the same level images; the GIST row equals
    JAX's ``binary_gist``."""
    imgs = [frame, frame[:, ::-1]][:n_cams]
    x = torch.from_numpy(np.stack(imgs).astype(F32))
    levels = _levels(x)
    pat = TF.pattern("brief", "cpu")
    gist = TF.gist_row(x[:1], 0.3)
    rows = [kops.DescribeRow(c, u, pat) for _, c, u in levels]
    (ang, desc), (g_ang, g_desc) = kops.orb_describe_levels([rows, [gist]])
    assert ang.shape == (n_cams, 4 * 16) and desc.shape == (n_cams, 4 * 16, 32)
    assert torch.equal(g_ang, gist.angles)
    angles_j = jax.jit(JF.intensity_centroid_angles)
    describe_j = jax.jit(JF.brief_descriptors)
    for lvl, (row, (_, cur, uv)) in enumerate(zip(rows, levels)):
        cols = slice(16 * lvl, 16 * (lvl + 1))
        ref_ang, ref_desc = kops.orb_describe_plain(*row)
        assert torch.equal(ang[:, cols], ref_ang) and torch.equal(desc[:, cols], ref_desc)
        for c in range(n_cams):
            a_j = np.asarray(angles_j(cur[c].numpy(), uv[c].numpy()))
            np.testing.assert_allclose(ang[c, cols].numpy(), a_j, rtol=0, atol=ANGLE_ATOL)
            d_j = describe_j(cur[c].numpy(), uv[c].numpy(), ang[c, cols].numpy(), pat.numpy())
            np.testing.assert_array_equal(desc[c, cols].numpy(), np.asarray(d_j))
    ref_gist = jax.jit(JF.binary_gist)(frame.astype(F32), jnp.float32(0.3))
    np.testing.assert_array_equal(g_desc[0, 0].numpy(), np.asarray(ref_gist))


def test_detect_describe_gist_is_detect_and_describe_plus_binary_gist(frame):
    """The keyframe's one K14 call gives ``detect_and_describe``'s keypoints
    and descriptors and ``binary_gist``'s GIST, bit for bit, and the JAX
    package's level-0 descriptors and GIST."""
    for imgs in (frame, np.stack([frame, frame[::-1].copy()])):
        x = torch.from_numpy(imgs)
        kps, desc, gist = TF.detect_describe_gist(x, roll_angle=-0.4, max_keypoints=64)
        k_ref, d_ref = TF.detect_and_describe(x, max_keypoints=64)
        assert all(torch.equal(a, b) for a, b in zip(kps, k_ref)) and torch.equal(desc, d_ref)
        g_ref = TF.binary_gist(x if x.dim() == 2 else x[0], -0.4)
        assert torch.equal(gist, g_ref)
    kj, dj = jax.jit(lambda im: JF.detect_and_describe(im, max_keypoints=64))(frame)
    k1, d1, g1 = TF.detect_describe_gist(torch.from_numpy(frame), roll_angle=-0.4,
                                         max_keypoints=64)
    np.testing.assert_array_equal(k1.uv.numpy(), np.asarray(kj.uv))
    np.testing.assert_array_equal(d1[:16].numpy(), np.asarray(dj)[:16])
    np.testing.assert_array_equal(
        g1.numpy(), np.asarray(jax.jit(JF.binary_gist)(frame.astype(F32), jnp.float32(-0.4))))
    with pytest.raises(ValueError, match="binary family"):
        TF.detect_describe_gist(torch.from_numpy(frame), descriptor="sift")
