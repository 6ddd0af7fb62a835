"""K12's levels in one call and K17's colour paths, on the CPU.

``kops.fast_nms`` takes every pyramid level of a keyframe in one call (one
launch on the card); on CPU tensors it runs its plain version level by
level, which is held here against JAX's ``nms(fast_score(·))`` compiled
under ``jax.jit`` on the same float32 levels of a seeded VGA pyramid (two
cameras: the JAX bench's WallWorld frame and uint8 noise).  Level 0 of a
uint8 image is exact; on the resized levels the corners are the same and
the scores agree within 1e-4 (the port sums the ring in ring order, the
reference's compiled reduction may not), as ``test_torch_features``'
``test_fast_nms_on_a_resized_level`` holds one level.

The kernel's early rejection rests on a fact about the ring, enumerated
here over all 2^16 masks: any run of 9 contiguous positions (with
wrap-around) holds at least two of the compass positions {0, 4, 8, 12}.
K17's path rule (``kops.bilateral_tile_paths_plain``) and its colour table
(256 floats by |g' - g|, the same expression as the per-tap weight) are
checked against direct computations.
"""

import jax
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.ops import features as JF
from uzliti_slam_tpu_torch.io import simulator as tsim
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import features as TF
from uzliti_slam_tpu_torch.ops import resize as TR

THRESHOLD = 20.0
RESIZED_ATOL = 1e-4     # scores of the resized levels, 0-255 scale
COMPASS = (0, 4, 8, 12)


@pytest.fixture(scope="module")
def pyramid():
    """The four levels (2, h, w) of a VGA pair: the WallWorld frame and
    seeded uint8 noise, resized by the port's ``resize_linear``."""
    img, _ = tsim.WallWorld(img_h=480, img_w=640).render(0.7, 1.3)
    noise = np.random.default_rng(0).integers(0, 256, (480, 640))
    imgs = torch.from_numpy(np.stack([img, noise]).astype(np.float32))
    return [imgs if lvl == 0 else TR.resize_linear(imgs, hw).contiguous()
            for lvl, (_, hw) in enumerate(TF.pyramid_shapes(480, 640, 4, 1.2))]


@pytest.fixture(scope="module")
def jax_maps(pyramid):
    fn = jax.jit(lambda x: JF.nms(JF.fast_score(x, THRESHOLD)))
    return [np.stack([np.asarray(fn(level[c].numpy())) for c in range(2)]) for level in pyramid]


def test_levels_in_one_call_equal_the_plain_version_level_by_level(pyramid):
    kops.reset_launches()
    got = kops.fast_nms(pyramid, THRESHOLD)
    assert kops.launches["fast_nms"] == 0          # CPU tensors: the plain version
    assert [tuple(g.shape) for g in got] == [tuple(lv.shape) for lv in pyramid]
    for g, lv in zip(got, pyramid):
        assert torch.equal(g, kops.fast_nms_plain(lv, THRESHOLD))
        assert torch.equal(g, kops.fast_nms(lv, THRESHOLD))


@pytest.mark.parametrize("level", range(4))
def test_levels_match_compiled_jax(pyramid, jax_maps, level):
    got = kops.fast_nms(pyramid, THRESHOLD)[level].numpy()
    ref = jax_maps[level]
    assert (ref > 0).sum(axis=(1, 2)).min() > 50
    np.testing.assert_array_equal(got > 0, ref > 0)
    if level == 0:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=RESIZED_ATOL)


def _runs_of_9(masks: np.ndarray) -> np.ndarray:
    """Which 16-bit ring masks hold 9 contiguous set positions (wrapping)."""
    bits = (masks[:, None] >> np.arange(16)) & 1
    return np.stack([bits[:, (s + np.arange(9)) % 16].all(axis=1)
                     for s in range(16)], axis=1).any(axis=1)


def test_a_run_of_9_holds_two_compass_positions():
    masks = np.arange(1 << 16, dtype=np.int64)
    runs = _runs_of_9(masks)
    compass = sum((masks >> c) & 1 for c in COMPASS)
    assert runs.sum() > 0 and compass[runs].min() == 2
    # the kernel's AND-doubling on the mask doubled onto itself agrees
    d = masks | (masks << 16)
    a = d & (d >> 1)
    a &= a >> 2
    a &= a >> 4
    a &= d >> 8
    np.testing.assert_array_equal((a & 0xFFFF) != 0, runs)


def test_early_rejection_keeps_every_score(pyramid):
    """The compass test on the plain version's ring differences rejects no
    pixel with a nonzero score (it rejects 47-73 % of the WallWorld frame's
    pixels by level, 4-26 % of the noise's)."""
    for level in pyramid:
        score = TF.fast_score(level, THRESHOLD)
        ring = [TF._shift2d(level, -dy, -dx) - level
                for i, (dy, dx) in enumerate(TF._FAST_OFFSETS) if i in COMPASS]
        nb = sum((d > THRESHOLD).int() for d in ring)
        nd = sum((d < -THRESHOLD).int() for d in ring)
        rejected = (nb < 2) & (nd < 2)
        assert not bool((rejected & (score > 0)).any())
        assert bool(rejected[0].any()) and bool((score[1] > 0).any())


def test_bilateral_tile_paths_follow_the_guide():
    rng = np.random.default_rng(3)
    guide = torch.from_numpy(rng.integers(0, 256, (2, 50, 70)).astype(np.float32))
    assert bool((kops.bilateral_tile_paths_plain(guide) == 1).all())
    # 16 x 32 tiles, each read with a halo of 2
    guide[0, 3, 40] = 0.5            # tile (0, 1) of camera 0
    guide[0, 30, 31] = -1.0          # tiles (1, 0), (1, 1) and, through the halo, (2, 0), (2, 1)
    guide[1, 49, 69] = float("nan")  # tile (3, 2) and, through the halo, (2, 2)
    guide[1, 17, 2] = 256.0          # tile (1, 0) and, through the halo, (0, 0)
    paths = kops.bilateral_tile_paths_plain(guide)
    expect = np.ones((2, 4, 3), np.int32)
    expect[0, 0, 1] = 0
    expect[0, 1:3, :2] = 0
    expect[1, 2:, 2] = 0
    expect[1, :2, 0] = 0
    np.testing.assert_array_equal(paths.numpy(), expect)
    depth = torch.from_numpy(rng.uniform(0.5, 4.0, (2, 50, 70)).astype(np.float32))
    out, got = kops.bilateral(depth, guide, tile_paths=True)
    assert torch.equal(out, kops.bilateral_plain(depth, guide)) and torch.equal(got, paths)


def test_colour_table_holds_the_per_tap_weights():
    """The table's entry |t| is the float the per-tap path computes for every
    integer difference t in -255..255."""
    k = torch.arange(256, dtype=torch.float32)
    table = torch.exp((k * k) * kops.NEG_INV_2SC2)
    t = torch.arange(-255, 256, dtype=torch.float32)
    assert torch.equal(table[t.abs().long()], torch.exp((t * t) * kops.NEG_INV_2SC2))
