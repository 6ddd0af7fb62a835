"""The port's feature front-end (``ops/features.py``, ``ops/resize.py``,
``ops/matching.py`` packing, ``ops/_patterns.py``) against the JAX
package's compiled functions, on the CPU through the kernels' plain
versions.

Level 0 of a uint8 image is held exactly: FAST scores, moments and blur
sums are exact integers in float32 there, and the port follows the
compiled reference's tie rules (see ``kernels/ops.grid_topk_plain``).  The
resized levels 1-3 are held within stated gaps: the reference's compiled
resize normalises its weights only to ~1e-6 (its weight columns sum to
1 ± 1e-6), so a resized pixel differs by up to ~3e-4 on a 0-255 image, and
a FAST score or a descriptor test sitting on that edge can move.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.io import simulator as jsim
from uzliti_slam_tpu.ops import features as JF
from uzliti_slam_tpu.ops import matching as JM
from uzliti_slam_tpu_torch.io import simulator as tsim
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import features as TF
from uzliti_slam_tpu_torch.ops import matching as TM
from uzliti_slam_tpu_torch.ops import resize as TR

# the reference's compiled resize normalises its weights to ~1e-6 relative
RESIZE_ATOL = 4e-4            # 0-255 scale
ANGLE_ATOL = 1e-5             # rad, level 0
MIN_EQUAL_BITS = 0.995        # of valid keypoints' descriptor bits, all levels


@pytest.fixture(scope="module")
def frame():
    """A 120x160 WallWorld render (uint8), the same from both packages."""
    img, _ = jsim.WallWorld(img_h=120, img_w=160).render(0.7, 1.3)
    img_t, _ = tsim.WallWorld(img_h=120, img_w=160).render(0.7, 1.3)
    assert np.array_equal(img, img_t)
    return img


@pytest.fixture(scope="module")
def fast_jit():
    return jax.jit(lambda x: JF.nms(JF.fast_score(x, 20.0)))


def test_fast_nms_exact_on_uint8_images(frame, fast_jit):
    rng = np.random.default_rng(0)
    noise = rng.integers(0, 256, (96, 128)).astype(np.uint8)
    for img in (frame, noise):
        x = img.astype(np.float32)
        ref = np.asarray(fast_jit(x))
        got = kops.fast_nms(torch.from_numpy(x)[None], 20.0)[0].numpy()
        assert (ref > 0).sum() > 10
        np.testing.assert_array_equal(got, ref)


def test_fast_nms_on_a_resized_level(frame, fast_jit):
    level = np.array(jax.jit(lambda x: jax.image.resize(x, (100, 133), "linear"))(
        frame.astype(np.float32)))
    ref = np.asarray(fast_jit(level))
    got = kops.fast_nms(torch.from_numpy(level)[None], 20.0)[0].numpy()
    # the same level: the same corners; scores summed in ring order
    np.testing.assert_array_equal(got > 0, ref > 0)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def _tie_scores():
    """(2, 48, 64) scores full of ties: integers 0-3 on plateaus, one
    all-zero camera row band."""
    rng = np.random.default_rng(1)
    s = rng.integers(0, 4, (2, 12, 16)).astype(np.float32).repeat(4, 1).repeat(4, 2)
    s[1, :12] = 0.0
    return s


@pytest.mark.parametrize("k_total", [64, 16, 8, 70],
                         ids=["cells_equal_k", "one_per_cell", "cells_above_k", "cells_below_k"])
def test_select_topk_grid_exact_with_ties(k_total):
    scores = _tie_scores()
    fn = jax.jit(lambda s: JF.select_topk_grid(s, k_total, 4))
    uv_t, resp_t, valid_t = TF.select_topk_grid(torch.from_numpy(scores), k_total, 4)
    for c in range(2):
        uv_j, resp_j, valid_j = (np.asarray(a) for a in fn(scores[c]))
        np.testing.assert_array_equal(uv_t[c].numpy(), uv_j)
        np.testing.assert_array_equal(resp_t[c].numpy(), resp_j)
        np.testing.assert_array_equal(valid_t[c].numpy(), valid_j)
    one = TF.select_topk_grid(torch.from_numpy(scores[0]), k_total, 4)
    assert torch.equal(one[0], uv_t[0])


def _plateau_levels():
    """Four pyramid levels of (2, H, W) scores on plateaus: integers 0-2 in
    3x3 blocks, cell (0, 0) of every level one flat value, and camera 1's
    level 2 all zero."""
    rng = np.random.default_rng(4)
    out = []
    for h, w in ((48, 64), (40, 53), (33, 44), (28, 37)):
        s = rng.integers(0, 3, (2, h // 3 + 1, w // 3 + 1)).astype(np.float32)
        s = s.repeat(3, 1).repeat(3, 2)[:, :h, :w].copy()
        s[:, : h // 4, : w // 4] = 2.0
        out.append(s)
    out[2][1] = 0.0
    return out


@pytest.mark.parametrize("k_total", [16, 64, 8, 70],
                         ids=["one_per_cell_plateau", "four_per_cell", "global_branch", "padding"])
def test_grid_topk_levels_plain_matches_jax(k_total):
    """K13's plain twin, level by level and in its all-levels form, against
    JAX's ``select_topk_grid`` on each camera of each level; with one
    keypoint a cell, a flat cell gives its last row-major pixel."""
    levels = _plateau_levels()
    fn = jax.jit(lambda x: JF.select_topk_grid(x, k_total, 4))
    together = kops.grid_topk_plain([torch.from_numpy(s) for s in levels], k_total, 4)
    assert [tuple(t.shape[:3]) for t in together] == [(4, 2, k_total)] * 3
    for lvl, s in enumerate(levels):
        got = [t[lvl] for t in together]
        alone = kops.grid_topk_level_plain(torch.from_numpy(s), k_total, 4)
        for a, b in zip(got, alone):
            assert torch.equal(a, b)
        for c in range(2):
            for a, b in zip(got, fn(s[c])):
                np.testing.assert_array_equal(a[c].numpy(), np.asarray(b))
        if k_total == 16:
            h, w = s.shape[1] // 4, s.shape[2] // 4
            np.testing.assert_array_equal(got[0][0, 0].numpy(), [w - 1, h - 1])


def test_detect_and_describe_levels_in_one_grid_call(frame, fast_jit):
    """The keypoints and descriptors of ``detect_and_describe`` (every
    level's K12, then one K13 call, then the descriptors) equal the
    level-at-a-time composition, bit for bit, on one camera and on a rig of
    two; its keypoints equal JAX's and its level-0 descriptors too."""
    imgs = np.stack([frame, frame[:, ::-1].copy()])
    kt, dt = TF.detect_and_describe(torch.from_numpy(imgs), max_keypoints=256)
    x = torch.from_numpy(imgs).to(torch.float32)
    uv, resp, desc = [], [], []
    for scale, (h, w) in TF.pyramid_shapes(120, 160, 4, 1.2):
        cur = x if (h, w) == (120, 160) else TR.resize_linear(x, (h, w)).contiguous()
        u, r, _ = TF.select_topk_grid(kops.fast_nms(cur, 20.0), 64, 4)
        uv.append(u * scale)
        resp.append(r)
        desc.append(kops.orb_describe_plain(cur, u, TF.pattern("brief", "cpu"))[1])
    assert torch.equal(kt.uv, torch.cat(uv, 1)) and torch.equal(kt.response, torch.cat(resp, 1))
    assert torch.equal(dt, torch.cat(desc, 1))
    k1, d1 = TF.detect_and_describe(torch.from_numpy(frame), max_keypoints=256)
    assert torch.equal(k1.uv, kt.uv[0]) and torch.equal(d1, dt[0])
    kj, dj = jax.jit(lambda im: JF.detect_and_describe(im, max_keypoints=256))(frame)
    np.testing.assert_array_equal(k1.uv.numpy(), np.asarray(kj.uv))
    np.testing.assert_array_equal(k1.valid.numpy(), np.asarray(kj.valid))
    np.testing.assert_array_equal(d1[:64].numpy(), np.asarray(dj)[:64])


@pytest.mark.parametrize("shape", [(400, 533), (333, 444), (278, 370), (63, 63)])
def test_resize_matches_jax(shape):
    img, _ = tsim.WallWorld(img_h=480, img_w=640, f=525.0, tex_size=1024).render(0.7, 1.3)
    x = img.astype(np.float32)
    ref = np.asarray(jax.jit(lambda a: jax.image.resize(a, shape, "linear"))(x))
    got = TR.resize_linear(torch.from_numpy(x), shape).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=RESIZE_ATOL)
    # a batch resizes each image alike; an unchanged shape is the identity
    both = TR.resize_linear(torch.from_numpy(np.stack([x, x])), shape)
    assert torch.equal(both[1], torch.from_numpy(got))
    assert torch.equal(TR.resize_linear(torch.from_numpy(x), (480, 640)), torch.from_numpy(x))


def test_angles_and_descriptors_at_level_0(frame, fast_jit):
    x = frame.astype(np.float32)
    uv = jax.jit(lambda s: JF.select_topk_grid(s, 64, 4))(fast_jit(x))[0]
    ang_j = np.asarray(jax.jit(JF.intensity_centroid_angles)(x, uv))
    uv_t = torch.from_numpy(np.asarray(uv))[None]
    ang_t = TF.intensity_centroid_angles(torch.from_numpy(x)[None], uv_t)[0].numpy()
    np.testing.assert_allclose(ang_t, ang_j, rtol=0, atol=ANGLE_ATOL)
    for name, pat in (("brief", None), ("brisk", JF.brisk_pattern()), ("freak", JF.freak_pattern())):
        d_j = np.asarray(jax.jit(JF.brief_descriptors)(x, uv, ang_j, pat))
        (_, d_t), = kops.orb_describe_levels([[kops.DescribeRow(
            torch.from_numpy(x)[None].contiguous(), uv_t, TF.pattern(name, "cpu"),
            torch.from_numpy(ang_j)[None].contiguous())]])
        np.testing.assert_array_equal(d_t[0].numpy(), d_j, err_msg=name)


def test_patterns_are_the_reference_arrays():
    np.testing.assert_array_equal(TF.pattern("brief", "cpu").numpy(), np.asarray(JF.brief_pattern()))
    np.testing.assert_array_equal(TF.pattern("gist", "cpu").numpy(),
                                  np.asarray(JF.brief_pattern(patch_radius=25, seed=4321)))
    np.testing.assert_array_equal(TF.pattern("brisk", "cpu").numpy(), np.asarray(JF.brisk_pattern()))
    np.testing.assert_array_equal(TF.pattern("freak", "cpu").numpy(), np.asarray(JF.freak_pattern()))


def test_pack_and_unpack_bits_match_jax():
    bits = np.random.default_rng(2).integers(0, 2, (5, 256)).astype(np.uint8)
    packed_j = np.asarray(JM.pack_bits(bits))
    packed_t = TM.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(packed_t.numpy(), packed_j)
    np.testing.assert_array_equal(TM.unpack_bits(packed_t).numpy(), np.asarray(JM.unpack_bits(packed_j)))
    np.testing.assert_array_equal(TM.unpack_bits(packed_t).numpy(), bits.astype(np.float32))


@pytest.mark.parametrize("descriptor", ["brief", "brisk", "freak"])
def test_detect_and_describe_matches_jax(frame, descriptor):
    k = 64
    kj, dj = jax.jit(lambda x: JF.detect_and_describe(x, max_keypoints=k, descriptor=descriptor))(frame)
    kt, dt = TF.detect_and_describe(torch.from_numpy(frame), max_keypoints=k, descriptor=descriptor)
    per = k // 4
    l0 = slice(0, per)
    np.testing.assert_array_equal(kt.uv[l0].numpy(), np.asarray(kj.uv)[l0])
    np.testing.assert_array_equal(kt.response[l0].numpy(), np.asarray(kj.response)[l0])
    np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
    np.testing.assert_array_equal(kt.scale.numpy(), np.asarray(kj.scale))
    valid = np.asarray(kj.valid)
    assert valid[l0].sum() >= per // 2
    diff_bits = np.unpackbits(dt.numpy() ^ np.asarray(dj), axis=-1)
    np.testing.assert_array_equal(diff_bits[l0][valid[l0]], 0)      # level 0: exact
    assert 1.0 - diff_bits[valid].mean() >= MIN_EQUAL_BITS
    # levels 1-3 on this frame (recorded gap): keypoints where the reference
    # keeps them, responses within 3e-3, 0-19 of 10,240 valid bits apart
    np.testing.assert_allclose(kt.uv.numpy(), np.asarray(kj.uv), rtol=0, atol=0)
    np.testing.assert_allclose(kt.response.numpy(), np.asarray(kj.response), rtol=0, atol=3e-3)
    assert int(diff_bits[per:][valid[per:]].sum()) <= 40


def test_binary_gist_matches_jax(frame):
    fn = jax.jit(JF.binary_gist)
    for roll in (0.0, -np.pi / 2, 0.3):
        ref = np.asarray(fn(frame.astype(np.float32), jnp.float32(roll)))
        got = TF.binary_gist(torch.from_numpy(frame), roll)
        np.testing.assert_array_equal(got.numpy(), ref)
    pair = TF.binary_gist(torch.from_numpy(np.stack([frame, frame[::-1].copy()])),
                          torch.tensor([0.3, 0.3]))
    assert torch.equal(pair[0], TF.binary_gist(torch.from_numpy(frame), 0.3))


def test_detect_and_describe_pads_the_budget_and_rejects_sift(frame):
    kps, desc = TF.detect_and_describe(torch.from_numpy(frame), max_keypoints=66)
    assert desc.shape == (66, 32) and kps.uv.shape == (66, 2)
    assert not kps.valid[64:].any() and torch.equal(kps.scale[64:], torch.ones(2))
    # the "sift" family is ported (K29): the same keypoints, float rows, zero padding
    kf, df = TF.detect_and_describe(torch.from_numpy(frame), max_keypoints=66, descriptor="sift")
    assert df.shape == (66, 128) and df.dtype == torch.float32 and not df[64:].any()
    assert torch.equal(kf.uv, kps.uv) and torch.equal(kf.angle, kps.angle)
    with pytest.raises(ValueError, match="unknown descriptor"):
        TF.detect_and_describe(torch.from_numpy(frame), descriptor="orb")


@pytest.mark.parametrize("n_levels", [9, 10])
def test_detect_describe_gist_beyond_8_levels_matches_jax(frame, n_levels):
    """More pyramid levels than K12 and K13 take in one launch (the card
    makes ⌈L/8⌉ launches of each): the last levels sit at the 32-px floor,
    where the reference's 21-px border leaves no corner."""
    k = 160
    shapes = TF.pyramid_shapes(120, 160, n_levels, 1.2)
    assert shapes[-1][1][0] == 32
    kj, dj = jax.jit(lambda x: JF.detect_and_describe(x, max_keypoints=k, n_levels=n_levels))(
        frame)
    gj = np.asarray(jax.jit(JF.binary_gist)(frame.astype(np.float32), jnp.float32(0.3)))
    kt, dt, gt = TF.detect_describe_gist(torch.from_numpy(frame), 0.3, max_keypoints=k,
                                         n_levels=n_levels)
    per = k // n_levels
    valid = np.asarray(kj.valid)
    np.testing.assert_array_equal(kt.valid.numpy(), valid)
    np.testing.assert_array_equal(kt.scale.numpy(), np.asarray(kj.scale))
    np.testing.assert_array_equal(kt.uv.numpy(), np.asarray(kj.uv))
    np.testing.assert_allclose(kt.response.numpy(), np.asarray(kj.response), rtol=0, atol=3e-3)
    assert valid[:per].sum() >= per // 2 and not valid[(n_levels - 1) * per:].any()
    diff_bits = np.unpackbits(dt.numpy() ^ np.asarray(dj), axis=-1)
    np.testing.assert_array_equal(diff_bits[:per][valid[:per]], 0)      # level 0: exact
    assert 1.0 - diff_bits[valid].mean() >= MIN_EQUAL_BITS
    np.testing.assert_array_equal(gt.numpy(), gj)
