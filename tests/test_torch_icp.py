"""Port parity: uzliti_slam_tpu_torch.ops.icp against JAX's compiled
``icp_point_to_line``, on every case of tests/test_icp.py.

Inputs are made with numpy from a seed (a 6 x 4 m room seen from the
origin, 5 mm noise) and given to both.  Held, with their reasons:
- the ``ok`` flag exactly (no case sits near a gate);
- the pose within 1e-4 (m, rad): the reference's compiled form contracts
  multiply-adds and its LAPACK LU scales by a reciprocal pivot, the port
  does neither; 10-25 Gauss-Newton steps reach the same fixed point;
- the valid fraction exactly where it is not near a correspondence's
  max_corr edge, here always (counts of the same matches);
- the covariance within 1e-3 relative of its largest entry (the inverse of
  sums of the same terms in another order), mse within 1e-6 absolute;
- the case's own assertions on the port's result.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.ops import icp as jicp
from uzliti_slam_tpu_torch.ops import icp as ticp

POSE_ATOL, COV_RTOL, MSE_ATOL = 1e-4, 1e-3, 1e-6


def room_scan(seed=0, n=180, noise=0.005):
    """Points on the walls x = ±3, y = ±2 of a room, as seen from the origin."""
    th = np.linspace(-np.pi, np.pi, n, endpoint=False)
    c, s = np.cos(th), np.sin(th)
    with np.errstate(divide="ignore"):
        tx = np.where(np.abs(c) > 1e-6, np.where(c > 0, 3.0, -3.0) / c, np.inf)
        ty = np.where(np.abs(s) > 1e-6, np.where(s > 0, 2.0, -2.0) / s, np.inf)
    t = np.minimum(tx, ty)
    pts = np.stack([t * c, t * s], axis=-1)
    pts = pts + noise * np.random.default_rng(seed).normal(size=pts.shape)
    return pts.astype(np.float32)


def observed_from(dst, xyt):
    """src = T(xyt)^-1 dst: the same points seen from pose xyt."""
    c, s = np.cos(xyt[2]), np.sin(xyt[2])
    R = np.array([[c, -s], [s, c]])
    return ((dst - xyt[:2]) @ R).astype(np.float32)


def _cases():
    dst = room_scan()
    n = dst.shape[0]
    ones = np.ones(n, bool)
    rng = np.random.default_rng(1)
    off = np.array([0.15, -0.1, 0.08])
    big = np.array([0.9, 0.5, 0.3])
    return {
        "recovers_known_offset": (observed_from(dst, off), ones, dst, ones, np.zeros(3), 25, off),
        "uses_initial_guess": (observed_from(dst, big), ones, dst, ones,
                               big + np.array([0.1, -0.08, 0.05]), 25, big),
        "rejects_unrelated_scans": ((3.0 * rng.normal(size=(120, 2))).astype(np.float32),
                                    np.ones(120, bool),
                                    (3.0 * rng.normal(size=(120, 2)) + 50.0).astype(np.float32),
                                    np.ones(120, bool), np.zeros(3), 15, None),
        "correction_bound_gate": (dst, ones, dst, ones, np.array([10.0, 10.0, 2.0]), 25, None),
        "covariance_shape_and_information": (dst, ones, dst, ones, np.zeros(3), 10, np.zeros(3)),
        "partial_overlap_masks": (dst, np.arange(n) < 90, dst, ones, np.zeros(3), 10, np.zeros(3)),
    }


def _jax(src, sv, dst, dv, init, iters):
    f = jax.jit(lambda a, b, c, d, e: jicp.icp_point_to_line(a, b, c, d, e, iterations=iters))
    return f(jnp.asarray(src), jnp.asarray(sv), jnp.asarray(dst), jnp.asarray(dv),
             jnp.asarray(init, jnp.float32))


def _port(src, sv, dst, dv, init, iters):
    t = torch.from_numpy
    return ticp.icp_point_to_line(t(src), t(sv), t(dst), t(dv), t(np.asarray(init, np.float32)),
                                  iterations=iters)


def _assert_matches(got, ref):
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    ok = np.asarray(ref.ok)
    np.testing.assert_allclose(got.pose2.numpy()[ok], np.asarray(ref.pose2)[ok], atol=POSE_ATOL)
    np.testing.assert_array_equal(got.valid_fraction.numpy()[ok], np.asarray(ref.valid_fraction)[ok])
    np.testing.assert_allclose(got.mse.numpy()[ok], np.asarray(ref.mse)[ok], atol=MSE_ATOL)
    cov_j = np.asarray(ref.cov3)[ok]
    np.testing.assert_allclose(got.cov3.numpy()[ok], cov_j, rtol=0,
                               atol=COV_RTOL * np.abs(cov_j).max(initial=0.0))


@pytest.mark.parametrize("name", list(_cases()))
def test_icp_matches_jax(name):
    src, sv, dst, dv, init, iters, truth = _cases()[name]
    got, ref = _port(src, sv, dst, dv, init, iters), _jax(src, sv, dst, dv, init, iters)
    _assert_matches(got, ref)
    if truth is None:
        assert not bool(got.ok)
    else:
        assert bool(got.ok)
        np.testing.assert_allclose(got.pose2.numpy(), truth, atol=0.03 if name == "uses_initial_guess"
                                   else 0.02)
    if name == "recovers_known_offset":
        assert float(got.valid_fraction) > 0.9
    if name == "covariance_shape_and_information":
        cov = got.cov3.numpy()
        np.testing.assert_allclose(cov, cov.T, atol=1e-8)
        assert np.all(np.linalg.eigvalsh(cov.astype(np.float64)) > 0)


def test_icp_information_6d_matches_jax():
    src, sv, dst, dv, init, iters, _ = _cases()["covariance_shape_and_information"]
    got = ticp.icp_information_6d(_port(src, sv, dst, dv, init, iters).cov3).numpy()
    ref = np.asarray(jicp.icp_information_6d(_jax(src, sv, dst, dv, init, iters).cov3))
    np.testing.assert_allclose(got, ref, rtol=0, atol=COV_RTOL * np.abs(ref).max())
    np.testing.assert_allclose(np.trace(got), 1e4, rtol=1e-3)
    assert got[2, 2] == 0 and got[3, 3] == 0 and got[4, 4] == 0
    assert set(zip(*np.nonzero(got))) <= {(a, b) for a in (0, 1, 5) for b in (0, 1, 5)}


def test_icp_batched_matches_jax_batch():
    dst = room_scan()
    ones = np.ones(dst.shape[0], bool)
    offs = np.array([[0.1, 0.05, 0.03], [-0.1, 0.02, -0.05], [0.0, 0.2, 0.1]])
    src = np.stack([observed_from(dst, o) for o in offs])
    B = len(offs)
    rep = lambda x: np.broadcast_to(x, (B,) + x.shape).copy()  # noqa: E731
    ref = jax.jit(lambda *a: jicp.icp_batch(*a, 25, 0.5, 0.25, (1.5, 0.8), 0.02))(
        jnp.asarray(src), jnp.asarray(rep(ones)), jnp.asarray(rep(dst)), jnp.asarray(rep(ones)),
        jnp.zeros((B, 3)))
    t = torch.from_numpy
    got = ticp.icp_point_to_line(t(src), t(rep(ones)), t(rep(dst)), t(rep(ones)), torch.zeros(B, 3),
                                 iterations=25)
    assert got.pose2.shape == (B, 3) and got.cov3.shape == (B, 3, 3)
    _assert_matches(got, ref)
    assert bool(got.ok.all())
    np.testing.assert_allclose(got.pose2.numpy(), offs, atol=0.03)


def test_icp_edge_pose_is_planar():
    p = ticp.icp_edge_pose(torch.tensor([0.5, -0.2, 0.3]))
    np.testing.assert_allclose(p.numpy(), [0.5, -0.2, 0.0, np.cos(0.15), 0, 0, np.sin(0.15)],
                               atol=1e-7)
