"""The port's PnP RANSAC (``ops/pnp.py``) against the JAX package's, on the
CPU, with ``tests/test_pnp.py``'s problems.  JAX's uniform keys
(``jax.random.uniform(key, (K, M))``) are injected (``keys=``), so both
draw the same samples; JAX runs under ``jax.jit`` with a float32 camera, as
the keyframe step runs it.  Held, with their reasons:

- the draws exactly (the 6 largest keys over the valid entries, ties to the
  lower index);
- ``_dlt_pose`` and ``_homography_pose`` per draw on non-planar problems,
  with the one-sided Jacobi's column pairs in either order (K28's parallel
  rounds, the port's default, or cyclic): the median draw within 1e-5 and
  every draw within 1e-3 (a noisy 6-point system's two smallest singular
  values can lie close, and LAPACK's float32 SVD and the port's one-sided
  Jacobi then split them differently);
- ``pnp_ransac`` with and without depth: consensus and ok exactly, the pose
  within 1e-4 (8 Gauss-Newton steps whose 6x6 solves LAPACK and the port's
  LU round differently), the mse within 1e-4 relative, and test_pnp.py's
  bars on the port's result; the draws and best hypothesis the same with
  either Jacobi order, and the pose within the same 1e-4;
- on a wall (every draw coplanar) the DLT's null space has more than one
  dimension and its pose is arbitrary on both sides: a draw whose DLT poses
  differ must have its 12x12 system's two smallest singular values both
  below 1e-4 of the largest (JAX's SVD: two null directions at rounding
  level, so their order is rounding's); the homography family, which the
  wall does not degrade, and the chosen pose still agree.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_pnp as jtests
import torch

from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu.ops import pnp as jpnp
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie as tlie
from uzliti_slam_tpu_torch.ops import pnp as tpnp

FX, CX, CY = jtests.FX, jtests.CX, jtests.CY
_jit = partial(jax.jit, static_argnames=("n_hypotheses", "refine_iters"))(jpnp.pnp_ransac)


def t(x):
    return torch.from_numpy(np.array(x))


def _problem(case: int):
    """(X, uv, valid, key, n_hypotheses, true pose or None) of test_pnp.py's
    four problems."""
    if case == 0:
        pose, X, uv = jtests.make_problem(jtests.KEY)
        return X, uv, jnp.ones(X.shape[0], bool), jax.random.PRNGKey(1), 64, pose
    if case == 1:
        pose, X, uv = jtests.make_problem(jtests.KEY, outlier_frac=0.3)
        return X, uv, jnp.ones(X.shape[0], bool), jax.random.PRNGKey(2), 128, pose
    if case == 2:
        k1, k2 = jax.random.split(jtests.KEY)
        X = jax.random.normal(k1, (60, 3)) * 3 + jnp.array([0, 0, 5.0])
        uv = jax.random.uniform(k2, (60, 2), minval=0, maxval=640)
        return X, uv, jnp.ones(60, bool), jax.random.PRNGKey(3), 64, None
    pose, X, uv = jtests.make_problem(jtests.KEY)
    uv = uv.at[40:].set(0.0)
    return X, uv, jnp.arange(80) < 40, jax.random.PRNGKey(4), 64, pose


def _xn(uv):
    uv = np.asarray(uv, np.float32)
    return np.stack([(uv[:, 0] - np.float32(CX)) / np.float32(FX),
                     (uv[:, 1] - np.float32(CY)) / np.float32(FX)], -1)


def _samples(key, valid, H, m):
    keys = jax.random.uniform(key, (H, m))
    return np.asarray(keys), np.asarray(jax.lax.top_k(jnp.where(valid[None], keys, -1e9), 6)[1])


@pytest.mark.parametrize("depth", [False, True], ids=["no_depth", "depth"])
@pytest.mark.parametrize("case", range(4), ids=["recovers", "outliers", "garbage", "mask"])
def test_pnp_ransac_matches_jax(case, depth):
    X, uv, valid, key, H, true_pose = _problem(case)
    m = X.shape[0]
    d = None
    if depth:
        ref_pose = true_pose if true_pose is not None else jlie.pose_identity()
        d = jlie.pose_apply(ref_pose[None], X)[:, 2]
    f = jnp.float32
    rj = _jit(key, X, uv, valid, f(FX), f(FX), f(CX), f(CY), n_hypotheses=H, depth=d)
    keys, samples_j = _samples(key, valid, H, m)
    tv = t(valid)
    td = None if d is None else t(d)
    samples_t, _ = kops.pnp_hypotheses_plain(t(X)[None], t(_xn(uv))[None], tv[None],
                                             None if td is None else td[None], t(keys)[None])
    np.testing.assert_array_equal(samples_t[0].numpy(), samples_j)
    rt = tpnp.pnp_ransac(t(X), t(uv), tv, FX, FX, CX, CY, n_hypotheses=H, depth=td,
                         keys=t(keys))
    assert int(rt.consensus) == int(rj.consensus) and bool(rt.ok) == bool(rj.ok)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=1e-4)
    np.testing.assert_allclose(float(rt.reproj_mse), float(rj.reproj_mse), rtol=1e-4)
    if true_pose is not None:   # test_pnp.py's bars
        dt, dr = tlie.pose_distance(rt.pose, t(true_pose))
        assert bool(rt.ok) and float(dt) < 0.03 and float(dr) < 0.015
    if case == 1:
        assert int(rt.consensus) >= 50
    if case == 2:
        assert not bool(rt.ok)
    if case == 3:
        assert int(rt.consensus) <= 40


def _per_draw(X, uv, valid, key, H, order="parallel"):
    xn = _xn(uv)
    _, samples = _samples(key, valid, H, X.shape[0])
    X, vw = np.asarray(X), np.asarray(valid, np.float32)
    jd = np.stack([np.asarray(jpnp._dlt_pose(X[s], xn[s], vw[s])) for s in samples])
    jh = np.stack([np.asarray(jpnp._homography_pose(X[s], xn[s], vw[s])) for s in samples])
    args = (t(X[samples]), t(xn[samples]), t(vw[samples]))
    return (samples, xn, jd, jh, tpnp._dlt_pose(*args, order=order).numpy(),
            tpnp._homography_pose(*args, order=order).numpy())


@pytest.mark.parametrize("order", ["cyclic", "parallel"])
@pytest.mark.parametrize("case", [0, 1], ids=["recovers", "outliers"])
def test_dlt_and_homography_per_draw_match_jax(case, order):
    X, uv, valid, key, H, _ = _problem(case)
    _, _, jd, jh, td, th = _per_draw(X, uv, valid, key, 32, order)
    for ref, got in ((jd, td), (jh, th)):
        err = np.abs(ref - got).max(axis=1)
        assert np.median(err) <= 1e-5 and err.max() <= 1e-3, err
    # the DLT of a non-planar draw recovers the true pose on noise-free data
    pose, Xc, uvc = jtests.make_problem(jtests.KEY, noise_px=0.0)
    xn = _xn(uvc)
    got = tpnp._dlt_pose(t(np.asarray(Xc)[:6]), t(xn[:6]), torch.ones(6), order=order).numpy()
    np.testing.assert_allclose(got, np.asarray(pose), atol=2e-3)


def test_round_robin_rounds_cover_every_pair_once():
    """K28's parallel order: each round's pairs disjoint, every pair of the
    n columns in one round of a sweep (11 rounds of 6 for the DLT's 12, 9 of
    4 for the homography's 9)."""
    for n, rounds, per in ((12, 11, 6), (9, 9, 4), (3, 3, 1)):
        rr = kops.round_robin_pairs(n)
        assert len(rr) == rounds and all(len(r) == per for r in rr)
        for r in rr:
            cols = [c for pq in r for c in pq]
            assert len(set(cols)) == len(cols) and all(p < q < n for p, q in r)
        assert sorted(pq for r in rr for pq in r) == [(p, q) for p in range(n)
                                                       for q in range(p + 1, n)]


@pytest.mark.parametrize("order", ["cyclic", "parallel"])
def test_pnp_ransac_either_jacobi_order_matches_jax(order):
    """``pnp_ransac`` on CPU tensors (K28's plain version) with either
    Jacobi order: the same draws and best hypothesis as the other order,
    and the pose within the module's 1e-4 of JAX's."""
    X, uv, valid, key, H, _ = _problem(1)
    d = jlie.pose_apply(_problem(1)[5][None], X)[:, 2]
    f = jnp.float32
    rj = _jit(key, X, uv, valid, f(FX), f(FX), f(CX), f(CY), n_hypotheses=H, depth=d)
    keys = t(_samples(key, valid, H, X.shape[0])[0])[None]
    thresh2, f_mean2 = tpnp.thresholds(FX, FX, 3.0)
    args = (t(X)[None], t(_xn(uv))[None], t(valid)[None], t(d)[None], keys, thresh2,
            float(np.float32(0.04)), 15.0, 8, f_mean2)
    got = kops.pnp_ransac_plain(*args, order=order)
    other = kops.pnp_ransac_plain(*args, order="parallel" if order == "cyclic" else "cyclic")
    assert torch.equal(got[0], other[0]) and int(got[6]) == int(other[6])
    assert int(got[3]) == int(rj.consensus) and bool(got[5]) == bool(rj.ok)
    np.testing.assert_allclose(got[2][0].numpy(), np.asarray(rj.pose), atol=1e-4)


def test_coplanar_draws_name_the_degenerate_dlt():
    """A wall: every draw is coplanar.  Where the two sides' DLT poses
    differ, JAX's 12x12 system has two singular values at rounding level
    (both below 1e-4 of the largest); the homography and the pose both
    sides choose agree."""
    k1, k2 = jax.random.split(jax.random.PRNGKey(7))
    m = 80
    X = jnp.concatenate([jax.random.uniform(k1, (m, 2), minval=-2, maxval=2),
                         jnp.full((m, 1), 5.0)], axis=-1)
    true_pose = jlie.se3_exp(jnp.array([0.1, -0.05, 0.2, 0.05, -0.1, 0.1]))
    Xc = jlie.pose_apply(true_pose[None], X)
    uv = jnp.stack([Xc[:, 0] / Xc[:, 2] * FX + CX, Xc[:, 1] / Xc[:, 2] * FX + CY], -1)
    uv = uv + 0.3 * jax.random.normal(k2, (m, 2))
    valid = jnp.ones(m, bool)
    key = jax.random.PRNGKey(11)
    samples, xn, jd, jh, td, th = _per_draw(X, uv, valid, key, 32)
    Xn = np.asarray(X)
    degenerate = []
    for s in samples:
        Xh = np.concatenate([Xn[s], np.ones((6, 1), np.float32)], -1)
        z = np.zeros_like(Xh)
        A = np.concatenate([np.concatenate([Xh, z, -xn[s, :1] * Xh], -1),
                            np.concatenate([z, Xh, -xn[s, 1:] * Xh], -1)])
        sv = np.asarray(jnp.linalg.svd(jnp.asarray(A), compute_uv=False))
        degenerate.append(sv[-2] <= 1e-4 * sv[0])
    degenerate = np.array(degenerate)
    differ = np.abs(jd - td).max(axis=1) > 1e-3
    assert degenerate.all(), degenerate        # every draw on the wall leaves the DLT free
    assert differ.any()                        # and the two sides' arbitrary picks differ
    assert not (differ & ~degenerate).any(), (differ, degenerate)
    np.testing.assert_allclose(th, jh, atol=1e-3)
    d = Xc[:, 2]
    f = jnp.float32
    rj = _jit(key, X, uv, valid, f(FX), f(FX), f(CX), f(CY), n_hypotheses=32, depth=d)
    rt = tpnp.pnp_ransac(t(X), t(uv), t(valid), FX, FX, CX, CY, n_hypotheses=32, depth=t(d),
                         keys=t(jax.random.uniform(key, (32, m))))
    assert bool(rt.ok) and bool(rj.ok)
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=1e-4)
