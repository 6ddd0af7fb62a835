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


def _jax(src, sv, dst, dv, init, iters, **kw):
    f = jax.jit(lambda a, b, c, d, e: jicp.icp_point_to_line(a, b, c, d, e, iterations=iters,
                                                             **kw))
    return f(jnp.asarray(src), jnp.asarray(sv), jnp.asarray(dst), jnp.asarray(dv),
             jnp.asarray(init, jnp.float32))


def _port(src, sv, dst, dv, init, iters, **kw):
    t = torch.from_numpy
    return ticp.icp_point_to_line(t(src), t(sv), t(dst), t(dv), t(np.asarray(init, np.float32)),
                                  iterations=iters, **kw)


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


def _assert_all_fields(got, ref):
    """Every output held, ``ok`` or not: the flag exactly, the pose within
    POSE_ATOL, the valid fraction exactly, mse within MSE_ATOL and the
    covariance within COV_RTOL of its largest entry."""
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(ref.ok))
    np.testing.assert_allclose(got.pose2.numpy(), np.asarray(ref.pose2), atol=POSE_ATOL)
    np.testing.assert_array_equal(got.valid_fraction.numpy(), np.asarray(ref.valid_fraction))
    np.testing.assert_allclose(got.mse.numpy(), np.asarray(ref.mse), atol=MSE_ATOL)
    cov_j = np.asarray(ref.cov3)
    np.testing.assert_allclose(got.cov3.numpy(), cov_j, rtol=0,
                               atol=COV_RTOL * np.abs(cov_j).max(initial=0.0))


def _few_valid_case(n_valid):
    """A 40-point room-scan source against 24 targets of which ``n_valid``
    are valid: none, one (its pair's second is the lowest invalid target,
    +inf), or two on the axis-aligned line x = 1 (its normal exact, so the
    unobservable y update is exactly 0 on both sides)."""
    rng = np.random.default_rng(5)
    src = np.stack([np.full(40, 1.05), np.linspace(-0.5, 0.5, 40)], -1).astype(np.float32)
    dst = rng.normal(size=(24, 2)).astype(np.float32)
    dv = np.zeros(24, bool)
    valid_at = [7, 15][:n_valid]
    dst[valid_at] = np.array([[1.0, -0.2], [1.0, 0.3]], np.float32)[:n_valid]
    dv[valid_at] = True
    return src, np.ones(40, bool), dst, dv


@pytest.mark.parametrize("n_valid", [0, 1, 2], ids=["no_valid_target", "one_valid_target",
                                                     "two_valid_targets"])
def test_icp_few_valid_targets_match_jax(n_valid):
    src, sv, dst, dv = _few_valid_case(n_valid)
    init = np.array([0.02, 0.0, 0.01], np.float32)
    got, ref = _port(src, sv, dst, dv, init, 10), _jax(src, sv, dst, dv, init, 10)
    _assert_all_fields(got, ref)
    if n_valid < 2:
        # no correspondence has two finite neighbours: nothing moves
        assert float(got.valid_fraction) == 0.0 and not bool(got.ok)
        np.testing.assert_array_equal(got.pose2.numpy(), init)
    else:
        assert bool(got.ok) and float(got.valid_fraction) == 1.0
        np.testing.assert_allclose(got.pose2.numpy()[[0, 2]], [-0.05, 0.0], atol=1e-4)


def _lattice_case():
    """Targets on an integer lattice in shuffled index order, sources at the
    cells' centres: four targets tie at exactly 0.5 (inside max_corr_dist
    1), and the two of lowest index make each point's line."""
    rng = np.random.default_rng(6)
    gy, gx = np.mgrid[0:6, 0:6]
    dst = np.stack([gx.ravel(), gy.ravel()], -1).astype(np.float32)[rng.permutation(36)]
    cy, cx = np.mgrid[0:5, 0:5]
    src = (np.stack([cx.ravel(), cy.ravel()], -1) + 0.5).astype(np.float32)
    return src, np.ones(25, bool), dst, np.ones(36, bool)


@pytest.mark.parametrize("iters", [0, 1], ids=["audit_only", "one_step"])
def test_icp_equal_distances_tie_to_the_lower_index(iters):
    src, sv, dst, dv = _lattice_case()
    got = _port(src, sv, dst, dv, np.zeros(3), iters, max_corr_dist=1.0)
    _assert_all_fields(got, _jax(src, sv, dst, dv, np.zeros(3), iters, max_corr_dist=1.0))
    if iters == 0:
        # the lower-index pair of each cell's four corners gives the line
        d2 = ((src[:, None] - dst[None]) ** 2).sum(-1)
        lines = []
        for i in range(len(src)):
            a, b = np.flatnonzero(d2[i] == d2[i].min())[:2]
            seg = dst[b] - dst[a]
            n = np.array([-seg[1], seg[0]]) / np.linalg.norm(seg)
            lines.append(float(np.dot(src[i] - dst[a], n)) ** 2)
        assert float(got.mse) == pytest.approx(np.mean(lines), rel=1e-6)


def test_icp_duplicated_targets_match_jax():
    """Every target twice (the copy n places on): each nearest pair is a
    point and its twin at the same distance, a zero segment whose normal is
    clamped; a third of the points once more, shuffled."""
    dst = room_scan(seed=3, n=120)
    dup = np.concatenate([dst, dst, dst[::3]])[np.random.default_rng(7).permutation(280)]
    src = observed_from(room_scan(seed=4, n=120), np.array([0.05, -0.03, 0.02]))
    ones = np.ones(120, bool)
    for d in (dst, dup):
        dv = np.ones(len(d), bool)
        _assert_all_fields(_port(src, ones, d, dv, np.zeros(3), 15),
                           _jax(src, ones, d, dv, np.zeros(3), 15))


def test_icp_invalid_sources_and_unequal_sizes_match_jax():
    """Scattered invalid source points (at the origin, as ``scan_points``
    leaves them), M = 150 source points against N = 240 targets with
    invalid ones, and the reverse."""
    rng = np.random.default_rng(8)
    truth = np.array([0.12, 0.04, -0.06])
    for m, n in ((150, 240), (240, 150)):
        dst = room_scan(seed=9, n=n)
        src = observed_from(room_scan(seed=10, n=m), truth)
        sv, dv = rng.random(m) > 0.3, rng.random(n) > 0.2
        src[~sv] = 0.0
        dst[~dv] = 0.0
        got, ref = _port(src, sv, dst, dv, np.zeros(3), 20), _jax(src, sv, dst, dv, np.zeros(3), 20)
        _assert_all_fields(got, ref)
        assert bool(got.ok)
        np.testing.assert_allclose(got.pose2.numpy(), truth, atol=0.03)


def test_icp_batch_at_the_reregistration_shapes_matches_jax():
    """Batch 4, M = N = 360 (the scan bins of ``scan_reregistration``'s
    k_targets = 4 problems), each problem its own offset and invalid bins
    (at 0), against JAX's ``icp_batch``."""
    rng = np.random.default_rng(11)
    B, n = 4, 360
    offs = np.array([[0.1, 0.05, 0.03], [-0.08, 0.02, -0.05], [0.0, 0.15, 0.08], [0.3, -0.2, 0.2]])
    dst = np.stack([room_scan(seed=20 + b, n=n) for b in range(B)])
    src = np.stack([observed_from(room_scan(seed=30 + b, n=n), offs[b]) for b in range(B)])
    sv, dv = rng.random((B, n)) > 0.25, rng.random((B, n)) > 0.25
    dv[3, 100:] = False     # a target scan with few valid bins
    src[~sv], dst[~dv] = 0.0, 0.0
    ref = jax.jit(lambda *a: jicp.icp_batch(*a, 20, 0.5, 0.25, (1.5, 0.8), 0.02))(
        jnp.asarray(src), jnp.asarray(sv), jnp.asarray(dst), jnp.asarray(dv), jnp.zeros((B, 3)))
    t = torch.from_numpy
    got = ticp.icp_point_to_line(t(src), t(sv), t(dst), t(dv), torch.zeros(B, 3), iterations=20)
    _assert_all_fields(got, ref)
    assert bool(got.ok[:3].all())
