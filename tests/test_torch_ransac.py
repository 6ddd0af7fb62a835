"""Port parity: uzliti_slam_tpu_torch.ops.ransac and the lie additions
against JAX.

Tolerances, with their reasons:
- ``matrix_to_quat``, ``make_pose``, ``pose_apply``: 1e-6 absolute, the same
  float32 formulas in another summation order.
- ``kabsch`` and ``kabsch_quat``: poses within 1e-5; two SVD (LAPACK)
  calls, or 30 power steps, on the same float32 covariance.
- ``ransac_rigid_batch`` with the JAX-drawn triplets injected: the same
  consensus, ok flag and best hypothesis per root (test points keep at
  least 1e-4 relative away from the inlier radius), refit poses within
  1e-4, mse within 1e-3 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu.ops import ransac as jransac
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie as tlie
from uzliti_slam_tpu_torch.ops import ransac as transac


def _rotations(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return np.asarray(jlie.quat_to_matrix(jnp.asarray(q / np.linalg.norm(q, axis=1, keepdims=True))))


def test_matrix_to_quat_takes_every_shepperd_branch_as_jax():
    rng = np.random.default_rng(0)
    # 180° turns about x, y, z force the x, y and z pivots; random ones add w
    flips = np.stack([np.diag([1.0, -1, -1]), np.diag([-1.0, 1, -1]), np.diag([-1.0, -1, 1])])
    R = np.concatenate([flips.astype(np.float32), _rotations(rng, 61)])
    pivots = np.stack([1 + np.trace(R, axis1=1, axis2=2), 1 + R[:, 0, 0] - R[:, 1, 1] - R[:, 2, 2],
                       1 - R[:, 0, 0] + R[:, 1, 1] - R[:, 2, 2],
                       1 - R[:, 0, 0] - R[:, 1, 1] + R[:, 2, 2]], axis=1)
    assert set(np.argmax(pivots, axis=1)) == {0, 1, 2, 3}
    ref = np.asarray(jlie.matrix_to_quat(jnp.asarray(R)))
    got = tlie.matrix_to_quat(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_make_pose_and_pose_apply_match_jax():
    rng = np.random.default_rng(1)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    pts = rng.normal(size=(5, 9, 3)).astype(np.float32)
    p_j = jlie.make_pose(jnp.asarray(t), jnp.asarray(q))
    p_t = tlie.make_pose(torch.from_numpy(t), torch.from_numpy(q))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6)
    ref = np.asarray(jax.vmap(jlie.pose_apply)(p_j, jnp.asarray(pts)))
    got = tlie.pose_apply(p_t[:, None], torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)


def _correspondences(rng, m, outliers=0, planar=False):
    src = rng.uniform(-3, 3, size=(m, 3)).astype(np.float32)
    if planar:
        src[:, 2] = 0.0
    true = jlie.make_pose(jnp.asarray(rng.normal(0, 1, 3), jnp.float32),
                          jnp.asarray(rng.normal(size=4), jnp.float32))
    dst = np.asarray(jlie.pose_apply(true, jnp.asarray(src)))
    dst = dst + rng.normal(0, 0.01, size=dst.shape).astype(np.float32)
    dst[:outliers] += rng.uniform(2, 4, size=(outliers, 3)).astype(np.float32)
    return src, dst.astype(np.float32)


@pytest.mark.parametrize("planar", [False, True], ids=["spread", "planar"])
def test_kabsch_and_kabsch_quat_match_jax(planar):
    rng = np.random.default_rng(2 + planar)
    src, dst = _correspondences(rng, 40, planar=planar)
    w = (rng.random(40) < 0.8).astype(np.float32)
    for jfn, tfn in ((jransac.kabsch, transac.kabsch), (jransac.kabsch_quat, transac.kabsch_quat)):
        ref = np.asarray(jfn(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w)))
        got = tfn(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5)
    # three-point hypothesis fits, batched as the kernel's plain version runs them
    tri = rng.integers(0, 40, (6, 3))
    ref = np.stack([np.asarray(jransac.kabsch_quat(src[i], dst[i], w[i])) for i in tri])
    got = transac.kabsch_quat(torch.from_numpy(src[tri]), torch.from_numpy(dst[tri]),
                              torch.from_numpy(w[tri])).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)


def _jax_triplets(key, member, k_hyp):
    keys = jax.random.split(key, member.shape[0])
    return np.array(jax.vmap(lambda k, v: jransac._valid_sample(k, k_hyp, v))(
        keys, jnp.asarray(member)))


def test_ransac_rigid_batch_with_injected_jax_triplets_matches_jax():
    rng = np.random.default_rng(4)
    R, M, K = 4, 48, 64
    src, dst = _correspondences(rng, M, outliers=10, planar=True)
    member = np.zeros((R, M), bool)
    member[0, :30] = True                 # 10 outliers among 30
    member[1, 5:48] = True
    member[2, ::3] = True
    member[3, :2] = True                  # too few: not ok
    key = jax.random.PRNGKey(9)
    tri = _jax_triplets(key, member, K)
    thresh, min_cons = 0.1, 5
    ref = jransac.ransac_rigid_batch(
        jax.random.split(key, R), jnp.broadcast_to(src, (R, M, 3)),
        jnp.broadcast_to(dst, (R, M, 3)), jnp.asarray(member), K, thresh, min_cons)
    # no point within 1e-4 relative of the inlier radius under the refits
    err2 = np.sum((np.asarray(jax.vmap(lambda p: jlie.pose_apply(p, src))(ref.pose)) - dst) ** 2, -1)
    assert (np.abs(err2 / thresh**2 - 1.0) > 1e-4).all()

    s = torch.from_numpy(src)[None].expand(R, M, 3)
    d = torch.from_numpy(dst)[None].expand(R, M, 3)
    got = transac.ransac_rigid_batch(s, d, torch.from_numpy(member), K, thresh, min_cons,
                                     tri=torch.from_numpy(tri))
    np.testing.assert_array_equal(got.consensus.numpy(), np.asarray(ref.consensus))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    assert got.ok.numpy().tolist() == [True, True, True, False]
    live = np.asarray(ref.ok)
    np.testing.assert_allclose(got.pose.numpy()[live], np.asarray(ref.pose)[live], atol=1e-4)
    np.testing.assert_allclose(got.mse.numpy(), np.asarray(ref.mse), rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(got.information.numpy()[live], np.asarray(ref.information)[live],
                               rtol=1e-3)
    one = transac.ransac_rigid(s[0], d[0], torch.from_numpy(member[0]), K, thresh, min_cons,
                               tri=torch.from_numpy(tri[0]))
    for a, b in zip(one, got):
        torch.testing.assert_close(a, b[0], rtol=0, atol=0)

    # the best hypothesis is JAX's first argmax of the per-hypothesis counts
    _, _, _, _, _, best, counts = kops.ransac_rigid_plain(
        s, d, torch.from_numpy(member), torch.from_numpy(tri), thresh, min_cons, 0.01)
    src_j, dst_j = jnp.asarray(src), jnp.asarray(dst)
    for r in range(R):
        w_r = jnp.asarray(member[r], jnp.float32)
        fits = jax.vmap(lambda i3: jransac.kabsch_quat(src_j[i3], dst_j[i3], w_r[i3]))(tri[r])
        e2 = np.sum((np.asarray(jax.vmap(lambda p: jlie.pose_apply(p, src))(fits)) - dst) ** 2, -1)
        c = ((e2 < thresh**2) & member[r]).sum(-1)
        distinct = (tri[r, :, 0] != tri[r, :, 1]) & (tri[r, :, 1] != tri[r, :, 2]) & (
            tri[r, :, 0] != tri[r, :, 2])
        c = np.where(member[r][tri[r]].all(-1) & distinct, c, -1)
        np.testing.assert_array_equal(counts[r].numpy(), c)
        assert int(best[r]) == int(np.argmax(c))


def test_valid_sample_draws_uniformly_among_valid_entries():
    gen = torch.Generator().manual_seed(0)
    valid = torch.zeros(3, 50, dtype=torch.bool)
    valid[0, ::5] = True
    valid[1, 7] = valid[1, 8] = True
    tri = transac._valid_sample(gen, 4000, valid)
    assert tri.shape == (3, 4000, 3) and tri.dtype == torch.int32
    assert valid[0][tri[0].long()].all() and valid[1][tri[1].long()].all()
    assert (tri[2] == 0).all()                       # no valid entry: index 0
    freq = np.bincount(tri[0].numpy().ravel(), minlength=50)[::5] / 12000
    np.testing.assert_allclose(freq, 0.1, atol=0.02)


def test_quality_biased_sample_follows_the_categorical_probabilities():
    """Soft PROSAC (the keyframe step's draws, ``quality = -Hamming``): entry
    i of a row with probability ∝ exp(β·(q_i − q_min)/span) over the valid
    entries, β = 4 (uzliti_slam_tpu/ops/ransac.py:_valid_sample).  JAX's
    ``jax.random.categorical`` cannot be replayed, so the frequencies of
    36,000 draws a row are held to the probabilities within five standard
    errors."""
    rng = np.random.default_rng(3)
    m = 40
    quality = torch.from_numpy(-rng.integers(0, 65, (4, m)).astype(np.float32))
    valid = torch.from_numpy(rng.random((4, m)) < 0.6)
    valid[2] = False
    valid[3] = False
    valid[3, 9] = True                               # one valid entry: always drawn
    quality[1, valid[1]] = -7.0                      # equal quality: uniform (span floor)
    n_hyp = 12_000
    tri = transac._valid_sample(torch.Generator().manual_seed(1), n_hyp, valid, quality)
    assert tri.shape == (4, n_hyp, 3) and tri.dtype == torch.int32
    for r in (0, 1):
        q, v = quality[r].double(), valid[r]
        qmin, qmax = q[v].min(), q[v].max()
        logit = 4.0 * (q - qmin) / torch.clamp(qmax - qmin, min=1e-6)
        p = torch.where(v, torch.exp(logit), 0.0)
        p = (p / p.sum()).numpy()
        freq = np.bincount(tri[r].numpy().ravel(), minlength=m) / (3 * n_hyp)
        assert freq[~v.numpy()].sum() == 0
        np.testing.assert_array_less(np.abs(freq - p), 5 * np.sqrt(p * (1 - p) / (3 * n_hyp)) + 1e-9)
    assert (tri[2] == 0).all() and (tri[3] == 9).all()
    # the bias is real: the best-quality entries are drawn most
    best = int(torch.argmax(torch.where(valid[0], quality[0], -torch.inf)))
    assert np.bincount(tri[0].numpy().ravel(), minlength=m).argmax() == best
