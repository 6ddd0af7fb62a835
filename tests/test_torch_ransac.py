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
  1e-4, mse within 1e-3 relative.  The same for K7's plain version with
  the draw folded in, fed JAX's draws through ``tri=``.
- The split sampler (``draw_uniforms``, then ``triplets_from_uniforms``,
  the draw K7 makes inside its launch) against the one-function sampler
  it replaced: bit for bit, the same float operations on the same
  generator stream.
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
    _, _, _, _, _, best, counts, _ = kops.ransac_rigid_plain(
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


def test_ransac_rigid_weights_match_jax_with_injected_triplets():
    """``weights`` multiply ``valid`` in the hypothesis fits and the refit
    (uzliti_slam_tpu/ops/ransac.py:131, 146); unit weights give the
    unweighted results exactly."""
    rng = np.random.default_rng(7)
    R, M, K = 3, 40, 48
    src, dst = _correspondences(rng, M, outliers=8)
    member = np.ones((R, M), bool)
    member[1, ::4] = False
    member[2, 20:] = False
    w = rng.uniform(0.2, 2.0, (R, M)).astype(np.float32)
    w[0, 8:16] = 0.0                      # zero-weight inliers: in the consensus, not the fits
    key = jax.random.PRNGKey(11)
    tri = _jax_triplets(key, member, K)
    thresh, min_cons = 0.1, 5

    def one(k, v, wt):
        return jransac.ransac_rigid(k, jnp.asarray(src), jnp.asarray(dst), v, K, thresh, min_cons,
                                    weights=wt)

    ref = jax.vmap(one)(jax.random.split(key, R), jnp.asarray(member), jnp.asarray(w))
    s = torch.from_numpy(src)[None].expand(R, M, 3)
    d = torch.from_numpy(dst)[None].expand(R, M, 3)
    got = transac.ransac_rigid_batch(s, d, torch.from_numpy(member), K, thresh, min_cons,
                                     tri=torch.from_numpy(tri), weights=torch.from_numpy(w))
    np.testing.assert_array_equal(got.consensus.numpy(), np.asarray(ref.consensus))
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    assert bool(got.ok.all())
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=1e-4)
    np.testing.assert_allclose(got.mse.numpy(), np.asarray(ref.mse), rtol=1e-3, atol=1e-9)
    plain = transac.ransac_rigid_batch(s, d, torch.from_numpy(member), K, thresh, min_cons,
                                       tri=torch.from_numpy(tri))
    assert not torch.equal(plain.pose, got.pose)
    unit = transac.ransac_rigid_batch(s, d, torch.from_numpy(member), K, thresh, min_cons,
                                      tri=torch.from_numpy(tri), weights=torch.ones(R, M))
    for a, b in zip(unit, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    single = transac.ransac_rigid(s[0], d[0], torch.from_numpy(member[0]), K, thresh, min_cons,
                                  tri=torch.from_numpy(tri[0]), weights=torch.from_numpy(w[0]))
    for a, b in zip(single, got):
        torch.testing.assert_close(a, b[0], rtol=0, atol=0)


def _sample_before_split(generator, k_hyp, valid, quality=None, beta=4.0):
    """``ops/ransac.py:_valid_sample`` as one function, before the draw was
    split into its uniforms and their mapping (K7 maps them inside its
    launch): the bit-for-bit reference of the split sampler."""
    batch, m = valid.shape[:-1], valid.shape[-1]
    if quality is None:
        weight = valid.to(torch.float32)
    else:
        q = quality.to(torch.float32)
        qmax = torch.where(valid, q, -torch.inf).amax(-1, keepdim=True)
        qmin = torch.where(valid, q, torch.inf).amin(-1, keepdim=True)
        span = torch.clamp(qmax - qmin, min=1e-6)
        logit = beta * (torch.where(valid, q, qmin) - qmin) / span
        weight = torch.where(valid, torch.exp(logit - beta), 0.0)
    cum = torch.cumsum(weight, dim=-1)
    total = cum[..., -1:]
    u = torch.rand(batch + (k_hyp * 3,), generator=generator, device=valid.device)
    target = torch.minimum(u * total, torch.nextafter(total, torch.zeros_like(total)))
    idx = torch.searchsorted(cum.contiguous(), target.contiguous(), right=True)
    idx = torch.where((idx < m) & (total > 0), idx, 0)
    return idx.to(torch.int32).reshape(batch + (k_hyp, 3))


def _sampler_rows(rng, R=6, m=45):
    valid = torch.from_numpy(rng.random((R, m)) < 0.6)
    valid[2] = False                         # no valid entry: index 0
    valid[3] = False
    valid[3, 44] = True                      # one valid entry, the last
    valid[4] = False
    valid[4, [0, 17]] = True                 # fewer than three
    quality = torch.from_numpy(-rng.integers(0, 65, (R, m)).astype(np.float32))
    quality[5] = -7.0                        # equal qualities: the span floor
    return valid, quality


@pytest.mark.parametrize("with_quality", [False, True], ids=["uniform", "soft_prosac"])
def test_split_sampler_gives_the_one_function_triplets_bit_for_bit(with_quality):
    rng = np.random.default_rng(12)
    valid, quality = _sampler_rows(rng)
    q = quality if with_quality else None
    K = 96
    ref = _sample_before_split(torch.Generator().manual_seed(5), K, valid, q)
    u = transac.draw_uniforms(torch.Generator().manual_seed(5), K, valid)
    assert u.shape == (6, 3 * K) and u.dtype == torch.float32
    got = transac.triplets_from_uniforms(u, valid, q)
    assert got.dtype == torch.int32 and torch.equal(got, ref)
    assert torch.equal(transac._valid_sample(torch.Generator().manual_seed(5), K, valid, q), ref)
    assert (ref[2] == 0).all() and (ref[3] == 44).all()
    assert set(ref[4].unique().tolist()) <= {0, 17}
    # the draw folded into K7's plain version, through ransac_rigid_batch:
    # the same triplets, reported in the result, from the same stream
    pts = torch.from_numpy(rng.normal(size=(45, 3)).astype(np.float32))
    s = pts[None].expand(6, 45, 3)
    res = transac.ransac_rigid_batch(s, s + 0.01, valid, K, 0.1, 3,
                                     generator=torch.Generator().manual_seed(5), quality=q)
    assert torch.equal(res.tri, ref)
    # a later draw of the same generator continues the stream as before
    g_old, g_new = torch.Generator().manual_seed(6), torch.Generator().manual_seed(6)
    _sample_before_split(g_old, K, valid, q)
    transac.ransac_rigid_batch(s, s + 0.01, valid, K, 0.1, 3, generator=g_new, quality=q)
    assert torch.equal(torch.rand(4, generator=g_old), torch.rand(4, generator=g_new))


@pytest.mark.parametrize("with_quality", [False, True], ids=["uniform", "soft_prosac"])
def test_folded_plain_k7_with_jax_draws_matches_jax(with_quality):
    """K7's plain version (``kops.ransac_rigid_plain``) given JAX's own draws
    through ``tri=`` against ``ransac_rigid`` under ``jax.vmap``, K = 32 (the
    estimation runs' setting), M = 37 (not a multiple of the kernel's 8
    lanes): a root with no valid entry, one with two, one with equal
    qualities; then the folded draw (``uniforms=``) against the same plain
    version handed ``triplets_from_uniforms`` of those uniforms, exactly."""
    rng = np.random.default_rng(21)
    R, M, K = 6, 37, 32
    src, dst = _correspondences(rng, M, outliers=7)
    member = np.zeros((R, M), bool)
    member[0, :30] = True                 # 7 outliers among 30
    member[2, 10:12] = True               # fewer than three valid: not ok
    member[3, ::2] = True
    member[4] = True
    member[5, 3:] = True
    quality = -rng.integers(0, 65, (R, M)).astype(np.float32)
    quality[5] = -3.0                     # equal qualities
    key = jax.random.PRNGKey(17)
    keys = jax.random.split(key, R)
    q = quality if with_quality else None
    thresh, min_cons = 0.1, 5

    def one(k, v, qq):
        return jransac.ransac_rigid(k, jnp.asarray(src), jnp.asarray(dst), v, K, thresh,
                                    min_cons, quality=qq)

    ref = jax.vmap(one)(keys, jnp.asarray(member), None if q is None else jnp.asarray(q))
    tri = np.array(jax.vmap(lambda k, v, qq: jransac._valid_sample(k, K, v, qq))(
        keys, jnp.asarray(member), jnp.asarray(quality)) if with_quality else
        _jax_triplets(key, member, K))
    err2 = np.sum((np.asarray(jax.vmap(lambda p: jlie.pose_apply(p, src))(ref.pose)) - dst) ** 2,
                  -1)
    assert (np.abs(err2 / thresh**2 - 1.0) > 1e-4).all()
    s = torch.from_numpy(src)[None].expand(R, M, 3)
    d = torch.from_numpy(dst)[None].expand(R, M, 3)
    mem = torch.from_numpy(member)
    pose, cons, mse, info, ok, best, counts, tri_out = kops.ransac_rigid_plain(
        s, d, mem, torch.from_numpy(tri), thresh, min_cons, 0.01)
    np.testing.assert_array_equal(cons.numpy(), np.asarray(ref.consensus))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref.ok))
    assert ok.numpy().tolist() == [True, False, False, True, True, True]
    live = np.asarray(ref.ok)
    np.testing.assert_allclose(pose.numpy()[live], np.asarray(ref.pose)[live], atol=1e-4)
    np.testing.assert_allclose(mse.numpy(), np.asarray(ref.mse), rtol=1e-3, atol=1e-9)
    np.testing.assert_allclose(info.numpy()[live], np.asarray(ref.information)[live], rtol=1e-3)
    assert torch.equal(tri_out, torch.from_numpy(tri).to(torch.int32))
    assert (counts[1] == -1).all() and (counts[2] == -1).all()
    # the folded draw: uniforms in, the triplets they map to out
    qt = None if q is None else torch.from_numpy(q)
    u = transac.draw_uniforms(torch.Generator().manual_seed(3), K, mem)
    folded = kops.ransac_rigid_plain(s, d, mem, None, thresh, min_cons, 0.01, uniforms=u,
                                     quality=qt)
    split = kops.ransac_rigid_plain(s, d, mem, transac.triplets_from_uniforms(u, mem, qt),
                                    thresh, min_cons, 0.01)
    for a, b in zip(folded, split):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
