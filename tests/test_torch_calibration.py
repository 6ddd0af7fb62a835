"""The port's calibration against JAX's, on the CPU.

``graph/calibration.py`` (the drift model and the Gauss-Newton solve, on
the CPU the plain version of kernel K20: ``torch.func.jacfwd`` and
``torch.linalg.solve``), the solver's ``use_odometry_calibration`` and the
``Slam`` shell's calibration epoch, on the problems of
``tests/test_calibration.py`` (its problem generators, imported from it,
on the JAX package's own ops).  Held, with their reasons:

- the drift model within 1e-6 (the same float32 formulas);
- the calibrated extrinsics and drift parameters within 1e-4, the cost
  history within 1e-3 relative plus 1e-6 of the initial cost (float32
  Jacobians and normal equations summed in another order; the fixed point
  is the same, and a converged cost is float noise);
- the solve with the drift model: χ² histories within ``rtol=1e-3`` plus
  ``atol=1e-6·χ²₀`` and poses within 1e-4 (the solver tests' rule), the
  raw measurements restored exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_calibration import build_biased_odometry_slam, build_calib_problem

from uzliti_slam_tpu.graph import calibration as jcal
from uzliti_slam_tpu.graph import solver as jsolver
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu_torch import pipeline as tpipe
from uzliti_slam_tpu_torch.config import SlamConfig as TCfg
from uzliti_slam_tpu_torch.graph import calibration as tcal
from uzliti_slam_tpu_torch.graph import solver as tsolver
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import synthetic as tsyn

P_TRUE = np.array([1.04, 0.05, 0.03], np.float32)


def _to_port(g):
    return tstate.from_numpy({k: np.asarray(v) for k, v in g._asdict().items()}, device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_history(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-3, atol=1e-6 * ref[0])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def biased():
    """``build_biased_odometry_slam`` (50 nodes) and its ground truth."""
    return build_biased_odometry_slam(jnp.asarray(P_TRUE))


@pytest.fixture(scope="module")
def biased_at_truth(biased):
    """The biased graph with its poses at the truth (a well-optimized graph,
    as the live cadence calibrates after epochs) and JAX's calibration of
    it: what JAX's ``Slam.calibrate`` runs there (one identity extrinsic, no
    sensor factor, 20 steps)."""
    g, gt = biased
    g = g._replace(pose=g.pose.at[:gt.shape[0]].set(gt))
    e_s = jnp.full((g.edge_capacity,), -1, jnp.int32)
    return g, e_s, jcal.calibrate(g, jlie.pose_identity((1,)), e_s, e_s, iterations=20)


@pytest.fixture(scope="module")
def sensor_problem():
    twist = jnp.array([0.08, -0.05, 0.1, 0.04, -0.06, 0.09])
    g, true_L, e_sf, e_st = build_calib_problem(twist)
    return g, true_L, e_sf, e_st


def test_odometry_drift_correct_matches_jax():
    rng = np.random.default_rng(0)
    xyt = rng.normal(size=(64, 3)).astype(np.float32)
    meas = np.array(jlie.pose2_to_pose(jnp.asarray(xyt)))
    meas[:8, 2] = rng.normal(size=8)   # off-plane translation
    for p in (P_TRUE, np.array([0.9, -0.1, 0.07], np.float32), np.array([1, 0, 0], np.float32)):
        ref = np.asarray(jcal.odometry_drift_correct(jnp.asarray(meas), jnp.asarray(p)))
        got = tcal.odometry_drift_correct(_t(meas), _t(p)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-6)


def test_calibrate_sensor_edges_matches_jax(sensor_problem):
    g, true_L, e_sf, e_st = sensor_problem
    init = jlie.pose_identity((1,))
    ref = jcal.calibrate(g, init, e_sf, e_st, iterations=15, prior_weight=1e-4)
    got = tcal.calibrate(_to_port(g), _t(init), _t(e_sf), _t(e_st), iterations=15,
                         prior_weight=1e-4)
    np.testing.assert_allclose(got.sensor_transforms.numpy(),
                               np.asarray(ref.sensor_transforms), atol=1e-4)
    np.testing.assert_allclose(got.odom_params.numpy(), np.asarray(ref.odom_params), atol=1e-4)
    _assert_history(got.cost_history.numpy(), ref.cost_history)
    assert float(got.final_cost) == float(got.cost_history[-1])
    dt = np.linalg.norm(got.sensor_transforms[0, :3].numpy() - np.asarray(true_L[:3]))
    assert dt < 0.01


def test_calibrate_biased_odometry_matches_jax(biased_at_truth):
    g, e_s, ref = biased_at_truth
    got = tcal.calibrate(_to_port(g), _t(jlie.pose_identity((1,))), _t(e_s), _t(e_s),
                         iterations=20)
    np.testing.assert_allclose(got.odom_params.numpy(), np.asarray(ref.odom_params), atol=1e-4)
    np.testing.assert_allclose(got.sensor_transforms.numpy(), np.asarray(ref.sensor_transforms),
                               atol=1e-4)
    _assert_history(got.cost_history.numpy(), ref.cost_history)
    np.testing.assert_allclose(got.odom_params.numpy(), P_TRUE, atol=2e-2)


@pytest.mark.parametrize("restart", [False, True])
def test_optimize_with_odometry_calibration_matches_jax(biased, restart):
    g, gt = biased
    g = g._replace(odom_params=jnp.asarray(P_TRUE))
    kw = dict(iterations=15, use_odometry_calibration=True, odometry_restart=restart)
    g_ref, st_ref = jsolver.optimize(g, jsolver.SolverConfig(**kw))
    gp = _to_port(g)
    g_got, st_got = tsolver.optimize(gp, tsolver.SolverConfig(**kw))
    _assert_history(st_got.chi2_history.numpy(), st_ref.chi2_history)
    np.testing.assert_allclose(g_got.pose.numpy(), np.asarray(g_ref.pose), atol=1e-4)
    assert torch.equal(g_got.e_transform, gp.e_transform)   # the raw measurements stay
    # calibrated against uncalibrated, as tests/test_calibration.py
    _, st_off = tsolver.optimize(gp, tsolver.SolverConfig(iterations=15, odometry_restart=restart))
    assert float(st_got.chi2_history[-1]) < 0.2 * float(st_off.chi2_history[-1])


def test_slam_calibrate_recovers_params_and_runs_on_schedule(biased_at_truth):
    g, _, ref = biased_at_truth
    cfg = TCfg(node_capacity=64, edge_capacity=256, feats_per_node=16, scan_bins=16,
               calibrate_every=2, project_map=False)
    slam = tpipe.Slam(cfg, device="cpu")
    slam.state = slam.state.replace(graph=_to_port(g))
    res = slam.calibrate()
    p = slam.state.graph.odom_params.numpy()
    np.testing.assert_allclose(p, P_TRUE, atol=2e-2)
    np.testing.assert_allclose(p, np.asarray(ref.odom_params), atol=1e-4)
    _assert_history(res.cost_history.numpy(), ref.cost_history)
    assert float(res.final_cost) < float(res.cost_history[0])
    # calibrate_every = 2: the epochs' calibration runs after the 2nd and 4th
    ran = []
    real = slam.calibrate
    slam.calibrate = lambda: ran.append(slam._epochs_since_calib) or real(iterations=2)
    slam.state = slam.state.replace(graph=slam.state.graph.replace(
        odom_params=torch.tensor([1.0, 0.0, 0.0])))
    for epoch in range(1, 5):
        slam.optimize()
        assert len(ran) == epoch // 2
    assert ran == [2, 2] and slam._epochs_since_calib == 0


def test_slam_calibrate_updates_extrinsics():
    """``update_extrinsics=True``: the closures are sensor factors of camera
    0, and the refined extrinsic becomes ``cam_pose`` (one camera and the
    rig's two)."""
    g, _ = tsyn.biased_odometry_graph(P_TRUE, 30, device="cpu")
    cp = np.array([0.1, 0, 0.2, 1.0, 0, 0, 0], np.float32)
    for cam_pose in (cp, np.stack([cp, cp])):
        slam = tpipe.Slam(TCfg(node_capacity=32, edge_capacity=128, feats_per_node=16,
                               scan_bins=16), cam_pose=cam_pose, device="cpu")
        slam.state = slam.state.replace(graph=g)
        cams = 1 if cam_pose.ndim == 1 else 2
        before = slam.cam_pose.clone()
        res = slam.calibrate(update_extrinsics=True, iterations=3)
        assert tuple(slam.cam_pose.shape) == tuple(before.shape)
        assert torch.equal(slam.cam_pose.reshape(-1, 7), res.sensor_transforms)
        assert tuple(res.sensor_transforms.shape) == (cams, 7)
        assert not torch.equal(slam.cam_pose, before)


def _kernel_args(g, init, e_sf, e_st, **kw):
    """``kops.calib_gn``'s arguments as ``calibration.calibrate`` makes them."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    calls, real = [], kops.calib_gn
    kops.calib_gn = lambda *a: calls.append(a) or real(*a)
    try:
        tcal.calibrate(_to_port(g), _t(init), _t(e_sf), _t(e_st), **kw)
    finally:
        kops.calib_gn = real
    return calls[0]


def tile_order_calibrate(Xi, Xj, meas, is_sensor, is_odom, sf, st, L0, iterations,
                         prior_weight, damping):
    """The plain version's steps summed as kernel K20 sums them, in float64
    on the CPU: the Jacobian rows of ``torch.func.jacfwd`` (float32); each
    CTA's residual groups (the edges e ≡ rank mod CTAs, a sensor group
    before an odometry group) in passes of at most CALIB_THREADS units (a
    unit a block of 3 tangents that can be nonzero: 1 an odometry group, 2
    or 4 a sensor group) that end on a group's first unit; each pass's rows
    dealt to the row slices in turn, the products added in row order into
    each entry of [J r]ᵀ[J r], the slices in order, the CTAs in rank order;
    then the priors, the cost, the damping, Gauss-Jordan elimination with
    the kernel's pivot (the largest, of two within 4 bits of the mantissa
    the first) in float64, and θ updated in float32.  Returns
    (theta, cost history) as numpy arrays."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    S, E = L0.shape[0], Xi.shape[0]
    P, ctas = 6 * S + 3, kops.CALIB_CLUSTER_CTAS
    W = P + 1
    slices = kops.CALIB_THREADS // (W * (W + 1) // 2)
    sp = kops.calib_sqrt_prior(prior_weight)
    on = np.stack([is_sensor.numpy(), is_odom.numpy()], 1)
    sfc, stc = sf.clamp(0, S - 1).numpy(), st.clamp(0, S - 1).numpy()

    def units(e, grp):
        return 1 if grp == 1 else (2 if sfc[e] == stc[e] else 4)

    passes = []   # every CTA's passes: lists of (edge, group)
    for c in range(ctas):
        groups = [(e, grp) for e in range(c, E, ctas) for grp in (0, 1) if on[e, grp]]
        cta, cur, n_units = [], [], 0
        for e, grp in groups:
            if n_units + units(e, grp) > kops.CALIB_THREADS:
                cta.append(cur)
                cur, n_units = [], 0
            cur.append((e, grp))
            n_units += units(e, grp)
        passes.append(cta + ([cur] if cur else []))

    def res(th):
        return kops.calib_residuals(th, Xi, Xj, meas, is_sensor, is_odom, sf, st, L0, sp)

    theta = np.zeros(P, np.float32)
    theta[6 * S] = 1.0
    hist = []
    for step in range(iterations + 1):
        th = torch.from_numpy(theta)
        aug = torch.cat([torch.func.jacfwd(res)(th), res(th)[:, None]], 1).double().numpy()
        tot = np.zeros((W, W))
        for cta in passes:
            acc = np.zeros((slices, W, W))
            for items in cta:
                rows = [aug[6 * (e + grp * E) + k] for e, grp in items for k in range(6)]
                for q, row in enumerate(rows):
                    acc[q % slices] += np.outer(row, row)
            part = acc[0].copy()
            for s in range(1, slices):
                part += acc[s]
            tot = tot + part
        A = np.concatenate([tot[:P, :P], tot[:P, P:]], 1)
        cost = 0.5 * tot[P, P]
        for k in range(P):
            jac = np.float32(sp) if k < 6 * S else np.float32(0.01)
            r = (np.float32(sp) * theta[k] if k < 6 * S
                 else np.float32(0.01) * (theta[k] - np.float32(k == 6 * S)))
            A[k, k] += float(jac) * float(jac)
            A[k, P] += float(jac) * float(r)
            cost += 0.5 * float(r) * float(r)
        hist.append(np.float32(cost))
        if step == iterations:
            break
        A[np.arange(P), np.arange(P)] += float(np.float32(damping))
        for c in range(P):
            # the largest, the first of two within 4 bits of the mantissa
            keys = (np.abs(A[c:, c]).view(np.uint64) & ~np.uint64(0xF)) | (
                np.uint64(15) - np.arange(c, P, dtype=np.uint64))
            piv = 15 - int(keys.max() & np.uint64(0xF))
            A[[c, piv], c:] = A[[piv, c], c:]
            for r in range(P):
                if r != c:
                    A[r, c:] -= A[r, c] / A[c, c] * A[c, c:]
        x = A[:, P] / np.diag(A)
        theta = (theta - x.astype(np.float32)).astype(np.float32)
    return theta, np.array(hist, np.float32)


@pytest.mark.parametrize("problem", ["biased_at_truth", "sensor_problem"])
def test_kernel_tile_order_matches_jax(problem, request):
    """K20's summation order and float64 solve, replayed on the plain
    version's Jacobian rows, against JAX's ``calibrate``: θ within
    CALIB_THETA_ATOL and the cost history within CALIB_HIST_RTOL, the bars
    that hold the kernel to its plain version on the card."""
    from chip_smoke import CALIB_HIST_RTOL, CALIB_THETA_ATOL

    if problem == "biased_at_truth":
        g, e_s, ref = request.getfixturevalue(problem)
        init, e_sf, e_st, kw = jlie.pose_identity((1,)), e_s, e_s, dict(iterations=20)
    else:
        g, _, e_sf, e_st = request.getfixturevalue(problem)
        init, kw = jlie.pose_identity((1,)), dict(iterations=15, prior_weight=1e-4)
        ref = jcal.calibrate(g, init, e_sf, e_st, **kw)
    args = _kernel_args(g, init, e_sf, e_st, **kw)
    theta, hist = tile_order_calibrate(*args)
    S = args[7].shape[0]
    L = tcal.lie.pose_retract(args[7], torch.from_numpy(theta[:6 * S]).reshape(S, 6)).numpy()
    np.testing.assert_allclose(theta[6 * S:], np.asarray(ref.odom_params),
                               atol=CALIB_THETA_ATOL, rtol=0)
    np.testing.assert_allclose(L, np.asarray(ref.sensor_transforms), atol=CALIB_THETA_ATOL, rtol=0)
    np.testing.assert_allclose(hist, np.asarray(ref.cost_history), rtol=CALIB_HIST_RTOL, atol=0)
