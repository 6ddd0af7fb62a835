"""The port's float-descriptor path (``ops/features.sift_descriptors``,
``detect_and_describe(descriptor="sift")``, ``ops/matching.l2_matrix`` and
``match_descriptors_l2``) against the JAX package's compiled functions, on
the CPU through kernels K29 and K30's plain versions.

Tolerances, with their reasons:
- keypoints (uv, valid) of a uint8 frame over 4 levels: exactly (level 0's
  FAST scores and moments are exact integers in float32, and on this frame
  the resized levels' keypoints agree too; the port follows the compiled
  reference's tie rules).
- angles: 1e-5 rad (as tests/test_torch_features.py): the resized levels'
  moments are float sums, added in another order.
- descriptors: 1e-5 absolute on unit-norm rows.  The sample grid rounds
  the same (the rotation is not contracted into a multiply-add on either
  side), so what differs is the order of the 4x4 cell sums and the norms,
  ~1e-7; an orientation exactly on a bin edge could move one vote, which
  the 1e-5 would show.
- L2 2-NN: the same index unless the two best squared distances of the
  row lie within 1e-5 relative of each other (the dot products are summed
  in another order), best distances within 1e-5 absolute (unit rows: the
  distances are O(1)), the ratio-test flag the same unless best lies within
  1e-5 relative of ratio²·second.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_frontend import blob_image
from uzliti_slam_tpu.io import simulator as jsim
from uzliti_slam_tpu.ops import features as JF
from uzliti_slam_tpu.ops import matching as JM
from uzliti_slam_tpu_torch.io import simulator as tsim
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import features as TF
from uzliti_slam_tpu_torch.ops import matching as TM

DESC_ATOL = 1e-5
ANGLE_ATOL = 1e-5
NEAR_TIE_REL = 1e-5


@pytest.fixture(scope="module")
def frame():
    """A 96x128 WallWorld render (uint8), the same from both packages."""
    img, _ = jsim.WallWorld(img_h=96, img_w=128).render(0.4, 1.1)
    img_t, _ = tsim.WallWorld(img_h=96, img_w=128).render(0.4, 1.1)
    assert np.array_equal(img, img_t)
    return img


@pytest.fixture(scope="module")
def jax_sift():
    return jax.jit(lambda x: JF.detect_and_describe(x, 64, descriptor="sift"))


def test_window_is_the_references():
    G = 16
    yy = jnp.arange(G, dtype=jnp.float32) - (G - 1) / 2.0
    ref = jax.jit(lambda y: jnp.exp(-(y[:, None] ** 2 + y[None, :] ** 2)
                                    / (2.0 * (G / 2.0) ** 2)))(yy)
    np.testing.assert_allclose(kops.sift_window("cpu").numpy(), np.asarray(ref), rtol=2e-7)


def test_sift_descriptors_match_jax(frame):
    rng = np.random.default_rng(3)
    img = frame.astype(np.float32)
    uv = np.stack([rng.uniform(0, 127, 64), rng.uniform(0, 95, 64)], -1).astype(np.float32)
    uv[:4] = [[0, 0], [127, 95], [63.5, 47.5], [10.25, 90.5]]   # clipped grids, .5 samples
    ang = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    ang[4:8] = [0.0, np.pi / 2, -np.pi, np.pi / 4]
    ref = np.asarray(jax.jit(JF.sift_descriptors)(jnp.asarray(img), jnp.asarray(uv),
                                                  jnp.asarray(ang)))
    got = TF.sift_descriptors(torch.from_numpy(img)[None], torch.from_numpy(uv)[None],
                              torch.from_numpy(ang)[None])[0].numpy()
    assert got.shape == (64, 128) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=DESC_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


def test_detect_and_describe_sift_matches_jax(frame, jax_sift):
    kj, dj = jax_sift(jnp.asarray(frame))
    kt, dt = TF.detect_and_describe(torch.from_numpy(frame), 64, descriptor="sift")
    assert dt.shape == (64, 128) and dt.dtype == torch.float32
    np.testing.assert_array_equal(kt.valid.numpy(), np.asarray(kj.valid))
    np.testing.assert_array_equal(kt.uv.numpy(), np.asarray(kj.uv))
    assert int(kt.valid.sum()) >= 24
    np.testing.assert_allclose(kt.angle.numpy(), np.asarray(kj.angle), rtol=0, atol=ANGLE_ATOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=0, atol=DESC_ATOL)


def test_detect_and_describe_sift_pads_and_batches_cameras(frame):
    """The K == max_keypoints contract with zero padding rows (66 over 4
    levels: 16 a level and two padding slots), and a camera batch."""
    kps, desc = TF.detect_and_describe(torch.from_numpy(frame), 66, descriptor="sift")
    assert desc.shape == (66, 128) and not kps.valid[64:].any()
    assert not desc[64:].any() and torch.equal(kps.scale[64:], torch.ones(2))
    pair = np.stack([frame, frame[:, ::-1].copy()])
    kb, db = TF.detect_and_describe(torch.from_numpy(pair), 66, descriptor="sift")
    assert db.shape == (2, 66, 128)
    torch.testing.assert_close(db[0], desc, rtol=0, atol=0)
    torch.testing.assert_close(kb.uv[0], kps.uv, rtol=0, atol=0)


def _match(img1, img2, k, ratio):
    k1, d1 = TF.detect_and_describe(torch.from_numpy(np.array(img1)), k, n_levels=1,
                                    descriptor="sift")
    k2, d2 = TF.detect_and_describe(torch.from_numpy(np.array(img2)), k, n_levels=1,
                                    descriptor="sift")
    mi, ok, _ = TM.match_descriptors_l2(d1, d2, valid_a=k1.valid, valid_b=k2.valid, ratio=ratio)
    return k1, k2, mi.long(), ok


def test_sift_descriptors_match_under_shift():
    """tests/test_frontend.py:311-323 on the port."""
    img = np.asarray(blob_image())
    k1, k2, mi, ok = _match(img, np.roll(img, 3, axis=1), 64, 0.9)
    assert int(ok.sum()) >= 10
    du = k2.uv[mi][:, 0] - k1.uv[:, 0]
    assert abs(float(torch.median(du[ok])) - 3.0) < 1.5


def test_rotation_steering():
    """tests/test_frontend.py:325-342 on the port: descriptors of the same
    keypoints are stable under a global 90° rotation."""
    img = np.asarray(blob_image(160, 160, 20, seed=5))
    k1, k2, mi, ok = _match(img, np.rot90(img).copy(), 48, 0.85)
    okn = ok.numpy()
    assert okn.sum() >= 8
    h, w = img.shape
    uv1 = k1.uv.numpy()[okn]
    uv2 = k2.uv.numpy()[mi.numpy()[okn]]
    pred = np.stack([uv1[:, 1], (w - 1) - uv1[:, 0]], axis=-1)
    assert np.median(np.linalg.norm(pred - uv2, axis=-1)) < 2.0


def _unit_rows(rng, n, d=128):
    x = np.abs(rng.normal(size=(n, d))).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def test_l2_matrix_matches_jax():
    rng = np.random.default_rng(0)
    a, b = rng.normal(size=(17, 128)).astype(np.float32), rng.normal(size=(23, 128)).astype(np.float32)
    ref = np.asarray(jax.jit(JM.l2_matrix)(jnp.asarray(a), jnp.asarray(b)))
    got = TM.l2_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)
    same = TM.l2_matrix(torch.from_numpy(a), torch.from_numpy(a)).numpy()
    assert (same >= 0).all() and np.abs(np.diag(same)).max() < 1e-3   # clamped at 0


@pytest.mark.parametrize("case", ["masked", "unmasked", "max_dist", "near_duplicates"])
def test_match_descriptors_l2_matches_jax(case):
    rng = np.random.default_rng({"masked": 1, "unmasked": 2, "max_dist": 3,
                                 "near_duplicates": 4}[case])
    a, b = _unit_rows(rng, 60), _unit_rows(rng, 80)
    b[:40] = a[:40] + rng.normal(0, 0.02, (40, 128)).astype(np.float32)   # 40 true matches
    if case == "near_duplicates":   # a stored twin: the ratio test must reject
        b[40:50] = b[:10] + rng.normal(0, 1e-3, (10, 128)).astype(np.float32)
    va = rng.random(60) < 0.9 if case == "masked" else np.ones(60, bool)
    vb = rng.random(80) < 0.9 if case == "masked" else np.ones(80, bool)
    max_dist = 0.3 if case == "max_dist" else None
    jfn = jax.jit(lambda x, y, p, q: JM.match_descriptors_l2(x, y, p, q, 0.8, max_dist))
    ri, rok, rbest = (np.asarray(t) for t in jfn(a, b, va, vb))
    gi, gok, gbest = TM.match_descriptors_l2(torch.from_numpy(a), torch.from_numpy(b),
                                             torch.from_numpy(va), torch.from_numpy(vb), 0.8,
                                             max_dist)
    gi, gok, gbest = gi.numpy(), gok.numpy(), gbest.numpy()
    assert gi.dtype == np.int32 and gok.dtype == bool
    d = np.asarray(jax.jit(JM.l2_matrix)(a, b))
    d = np.where(vb[None] & va[:, None], d, 1e9)
    two = np.sort(d, axis=1)[:, :2]
    tie = (two[:, 1] - two[:, 0]) <= NEAR_TIE_REL * np.maximum(two[:, 0], 1e-30)
    np.testing.assert_array_equal(gi[~tie], ri[~tie])
    np.testing.assert_allclose(gbest, rbest, rtol=0, atol=1e-5)
    edge = np.abs(rbest - np.float32(0.64) * two[:, 1]) <= NEAR_TIE_REL * two[:, 1]
    np.testing.assert_array_equal(gok[~edge], rok[~edge])
    assert int(gok.sum()) >= (20 if case == "max_dist" else 25)
    if case == "near_duplicates":
        assert not gok[:10].any()
