"""The port's virtual scans (``ops/scan.py``) against the JAX package's,
compiled, on the CPU (``depth_to_scan`` through K15's plain version).

Both reduce the same 21-bit quantised ranges, so the scans are held equal,
bin for bin, except for bins that a bearing lying within an ulp of a bin
edge moves: torch's atan2 and XLA's differ by an ulp now and then.  Those
are counted and bounded at one per scan.  Merging and the centre are
held within 1e-6, the scan's points within 1e-6 of their range.
``points_to_scan`` and ``cloud_to_scan`` are K15's second entry point
(``kernels/ops.bin_min_max``), whose plain version runs here: held to JAX's
under the same one-moved-bin bound, and exactly where every bearing is one
that both atan2s return exactly (0, ±π/2, ±π: bin edges and the window's
ends).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.io import simulator as jsim
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu.ops import scan as jscan
from uzliti_slam_tpu_torch.io import simulator as tsim
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import scan as tscan

MAX_MOVED_BINS = 1    # per scan


def _moved(ref, got) -> int:
    ref, got = np.asarray(ref), got.numpy()
    same = (ref == got) | (np.isinf(ref) & np.isinf(got) & (np.sign(ref) == np.sign(got)))
    return int((~same).sum())


def _assert_scans(ref, got):
    moved = _moved(ref.ranges, got.ranges) + _moved(ref.far_ranges, got.far_ranges)
    assert moved <= MAX_MOVED_BINS, moved
    assert got.angle_min == pytest.approx(float(ref.angle_min))
    assert got.angle_max == pytest.approx(float(ref.angle_max))


def _poses():
    front = jsim.cam_extrinsic()
    rear = jlie.pose_compose(jlie.pose2_to_pose(jnp.array([0.0, 0.0, np.pi])), front)
    q = jnp.array([1.0, 0.03, -0.04, 0.25]) / jnp.linalg.norm(jnp.array([1.0, 0.03, -0.04, 0.25]))
    tilt = jlie.make_pose(jnp.array([0.1, 0.2, 0.5]), jlie.matrix_to_quat(
        jlie.quat_to_matrix(q) @ jnp.asarray(jsim.CAM_IN_BASE_R, jnp.float32)))
    return {"front": front, "rear": rear, "tilted": tilt}


def test_bin_min_max_is_exact():
    rng = np.random.default_rng(0)
    r = rng.uniform(0.0, 7.0, 5000).astype(np.float32)
    ok = rng.random(5000) < 0.7
    bins = rng.integers(0, 90, 5000).astype(np.int32)
    bins[:50] = 17                                   # a crowded bin
    ok[bins == 89] = False                           # an empty one
    ref = jax.jit(lambda a, b, c: jscan._bin_min_max(a, b, c, 90, 6.0))(r, ok, bins)
    got = tscan._bin_min_max(torch.from_numpy(r), torch.from_numpy(ok), torch.from_numpy(bins),
                             90, 6.0)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert math.isinf(float(got[0][89])) and float(got[1][89]) == -math.inf


@pytest.mark.parametrize("pose", ["front", "rear", "tilted"])
@pytest.mark.parametrize("n_bins", [90, 360])
def test_depth_to_scan_matches_jax(pose, n_bins):
    jw, tw = jsim.WallWorld(img_h=96, img_w=128), tsim.WallWorld(img_h=96, img_w=128)
    _, dep = jw.render(0.7, 1.3)
    noise = 1 + 0.3 * np.random.default_rng(1).random(dep.shape).astype(np.float32)
    depth = dep.astype(np.float32) * np.float32(1e-3) * noise
    depth[5, 7] = 0.0
    depth[8, 9] = np.inf
    p = _poses()[pose]
    kw = dict(n_bins=n_bins, height_band=(-0.4, 0.6), max_range=6.0)
    ref = jax.jit(lambda d, cam, cp: jscan.depth_to_scan(d, cam, cp, **kw))(depth, jw.cam, p)
    got = tscan.depth_to_scan(torch.from_numpy(depth), tw.cam, torch.from_numpy(np.array(p)), **kw)
    assert np.isfinite(np.asarray(ref.ranges)).sum() >= n_bins // 12
    _assert_scans(ref, got)
    # a camera batch scans each camera alike
    both = tscan.depth_to_scan(torch.from_numpy(np.stack([depth, depth])), tw.cam,
                               torch.from_numpy(np.stack([np.asarray(p)] * 2)), **kw)
    assert torch.equal(both.ranges[1], got.ranges)


def test_cloud_and_points_to_scan_match_jax():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-7, 7, (4000, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-0.2, 1.2, 4000)
    valid = rng.random(4000) < 0.9
    ref = jax.jit(lambda a, b: jscan.cloud_to_scan(a, b, n_bins=180))(pts, valid)
    got = tscan.cloud_to_scan(torch.from_numpy(pts), torch.from_numpy(valid), n_bins=180)
    _assert_scans(ref, got)
    ref = jax.jit(lambda a, b: jscan.points_to_scan(a, b, n_bins=360))(pts[:, :2], valid)
    got = tscan.points_to_scan(torch.from_numpy(pts[:, :2]), torch.from_numpy(valid), n_bins=360)
    _assert_scans(ref, got)


def _scan_pair():
    rng = np.random.default_rng(3)
    a = (1 + 4 * rng.random((2, 72))).astype(np.float32)
    far = a + rng.random((2, 72)).astype(np.float32)
    a[0, :10] = np.inf
    a[1, 5:20] = np.inf
    a[1, 30:40] = a[0, 30:40] + 0.1                     # agree within 0.2: averaged
    far = np.where(np.isinf(a), np.inf, far)
    j = [jscan.Scan(a[i], far[i], jnp.float32(-np.pi), jnp.float32(np.pi)) for i in range(2)]
    t = [tscan.Scan(torch.from_numpy(a[i]), torch.from_numpy(far[i]), -math.pi, math.pi)
         for i in range(2)]
    return j, t


def test_merge_points_and_centre_match_jax():
    (ja, jb), (ta, tb) = _scan_pair()
    for prefer_b in (True, False):
        ref = jax.jit(lambda x, y: jscan.merge_scans(x, y, prefer_b=prefer_b))(ja, jb)
        got = tscan.merge_scans(ta, tb, prefer_b=prefer_b)
        np.testing.assert_allclose(got.ranges.numpy(), np.asarray(ref.ranges), rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.far_ranges.numpy(), np.asarray(ref.far_ranges), rtol=0,
                                   atol=1e-6)
    for use_far in (False, True):
        pj, okj = jax.jit(lambda s: jscan.scan_points(s, use_far=use_far))(ja)
        pt, okt = tscan.scan_points(ta, use_far=use_far)
        # r·cos θ with r up to 6 m: torch's and XLA's cos differ by an ulp
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=0, atol=6e-6)
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(tscan.scan_center(ta).numpy(),
                               np.asarray(jax.jit(jscan.scan_center)(ja)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ta.angles().numpy(), np.asarray(ja.angles()), rtol=0, atol=1e-6)


def _special_points(rng, n=3000):
    """Points on half the circle (the other half's bins stay empty), with
    NaN and ±inf coordinates, points on the range limits, on bin edges at
    bearings 0, ±π/2 and ±π, and heights on the band's limits."""
    r = rng.uniform(0.0, 7.0, n).astype(np.float32)
    th = rng.uniform(-np.pi, 0.0, n).astype(np.float32)
    pts = np.stack([r * np.cos(th), r * np.sin(th), rng.uniform(-0.2, 1.2, n)], -1)
    pts = pts.astype(np.float32)
    special = np.array([
        [np.nan, 1.0, 0.5], [1.0, np.nan, 0.5], [2.0, 1.0, np.nan],
        [np.inf, 0.0, 0.5], [0.0, -np.inf, 0.5], [np.inf, np.inf, 0.5], [-np.inf, 3.0, 0.5],
        [6.0, 0.0, 0.5], [0.05, 0.0, 0.5], [0.3, 0.0, 0.5], [0.0, 6.0, 0.5],
        [-6.0, 0.0, 0.5], [-2.0, -0.0, 0.5], [0.0, -2.5, 0.5], [4.0, 0.0, 0.5],
        [5.0, 0.0, 0.1], [5.5, 0.0, 1.0], [1.5, 0.0, 0.0999], [1.25, 0.0, 1.0001],
        [0.0, 0.0, 0.5], [6.0000005, 0.0, 0.5]], np.float32)
    pts[: len(special)] = special
    valid = rng.random(n) < 0.9
    valid[: len(special)] = True
    return pts, valid


@pytest.mark.parametrize("n_bins", [90, 360])
def test_points_entry_matches_jax_on_special_points(n_bins):
    rng = np.random.default_rng(5 + n_bins)
    pts, valid = _special_points(rng)
    ref = jax.jit(lambda a, b: jscan.points_to_scan(a, b, n_bins=n_bins))(pts[:, :2], valid)
    got = tscan.points_to_scan(torch.from_numpy(pts[:, :2]), torch.from_numpy(valid),
                               n_bins=n_bins)
    _assert_scans(ref, got)
    assert np.isinf(got.ranges.numpy()[n_bins // 2 + 2:]).any()      # empty bins: +inf
    assert np.isinf(got.far_ranges.numpy()).sum() == np.isinf(got.ranges.numpy()).sum()
    ref = jax.jit(lambda a, b: jscan.cloud_to_scan(a, b, n_bins=n_bins))(pts, valid)
    got = tscan.cloud_to_scan(torch.from_numpy(pts), torch.from_numpy(valid), n_bins=n_bins)
    _assert_scans(ref, got)
    # only the special points, whose bearings both atan2s give exactly: equal
    sp = slice(0, 21)
    for fn_j, fn_t, x in ((jscan.points_to_scan, tscan.points_to_scan, pts[sp, :2]),
                          (jscan.cloud_to_scan, tscan.cloud_to_scan, pts[sp])):
        ref = jax.jit(lambda a, b: fn_j(a, b, n_bins=n_bins))(x, valid[sp])
        got = fn_t(torch.from_numpy(x), torch.from_numpy(valid[sp]), n_bins=n_bins)
        assert _moved(ref.ranges, got.ranges) + _moved(ref.far_ranges, got.far_ranges) == 0
        assert np.isfinite(np.asarray(ref.ranges)).sum() >= 4


def test_points_entry_is_the_composition_and_batches_scans():
    """K15's points entry on CPU tensors is its plain version; a batch of
    scans gives, row for row, each scan alone; a scan with no valid point is
    +inf throughout (near and far)."""
    rng = np.random.default_rng(9)
    pts = torch.from_numpy(rng.uniform(-6, 6, (3, 200, 2)).astype(np.float32))
    valid = torch.from_numpy(rng.random((3, 200)) < 0.8)
    valid[2] = False
    near, far = kops.bin_min_max(pts, valid, 180, -math.pi, math.pi, 6.0, 0.05)
    ref = kops.bin_min_max_plain(pts, valid, 180, -math.pi, math.pi, 6.0, 0.05)
    assert torch.equal(near, ref[0]) and torch.equal(far, ref[1])
    batch = tscan.points_to_scan(pts, valid, n_bins=180)
    for b in range(3):
        one = tscan.points_to_scan(pts[b], valid[b], n_bins=180)
        assert torch.equal(batch.ranges[b], one.ranges)
        assert torch.equal(batch.far_ranges[b], one.far_ranges)
    assert torch.isinf(near[2]).all() and torch.isinf(far[2]).all() and (far[2] > 0).all()
