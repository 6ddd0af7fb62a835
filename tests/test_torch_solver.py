"""Port parity: uzliti_slam_tpu_torch.graph.solver against the JAX solver.

Graphs come from the JAX generator (``PRNGKey``, pow2 capacities as the
suite's conftest sets) and cross to the port field by field through
``from_numpy``; both packages run on the CPU, the port through its
kernels' plain versions.

Tolerances, with their reasons:
- χ² histories: ``rtol=1e-3`` plus ``atol=1e-6·χ²₀``.  The two packages sum
  in different orders, and JAX against JAX already differs by 5.9e-5
  relative at a converged χ² of 0.03 (tests/test_solver.py's fast-vs-generic
  case); 12 PCG steps do not converge the linear solve, so the gap grows
  along the history, and an LM accept test can turn on a near-tie.
- poses ``atol=1e-3``; per-edge errors ``rtol=1e-2`` plus ``atol=1e-4``
  (residuals of poses that agree to 1e-3, weighted by information ~1e3).
- per-step accept flags and the edge ages: exactly.
- single linearization / Hv outputs: ``1e-4`` of each array's largest
  entry (float32 sums of up to four edges' 6x6 products).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import factors as jfactors
from uzliti_slam_tpu.graph import oracle as joracle
from uzliti_slam_tpu.graph import solver as jsolver
from uzliti_slam_tpu.graph import state as jstate
from uzliti_slam_tpu.io import synthetic as jsynthetic
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu_torch.graph import oracle as toracle
from uzliti_slam_tpu_torch.graph import solver as tsolver
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.kernels import ops as kops

HEADLINE = dict(iterations=20, pcg_iterations=12, preconditioner="chain",
                precond_refresh=5, early_exit=False)


def _to_port(g):
    return tstate.from_numpy({k: np.asarray(v) for k, v in g._asdict().items()}, device="cpu")


@pytest.fixture(scope="module")
def graph128():
    g, _ = jsynthetic.make_pose_graph(jax.random.PRNGKey(4), 128, loop_closure_every=8)
    return g


def _close_rel(actual, desired, frac=1e-4):
    desired = np.asarray(desired)
    np.testing.assert_allclose(actual, desired, atol=frac * np.abs(desired).max())


def _two_component_graph():
    """Nodes 0-5 and 6-11 form two chains, 12-13 a pair, 14-15 are invalid;
    node 9 is pre-fixed, so the second chain keeps it as its only anchor."""
    g = jstate.empty_graph(16, 16)
    edges = [(0, 1), (1, 2), (2, 3), (3, 4), (4, 5), (6, 7), (7, 8), (8, 9),
             (9, 10), (10, 11), (13, 12)]
    ef = np.zeros(16, np.int32)
    et = np.zeros(16, np.int32)
    ev = np.zeros(16, bool)
    for k, (a, b) in enumerate(edges):
        ef[k], et[k], ev[k] = a, b, True
    valid = np.arange(16) < 14
    stamp = np.array([5, 4, 3, 2, 1, 0, 9, 8, 7, 6, 5, 4, 3, 3, 0, 0], np.float32)
    return g._replace(
        node_valid=jnp.asarray(valid), node_fixed=jnp.asarray(np.arange(16) == 9),
        stamp=jnp.asarray(stamp), e_from=jnp.asarray(ef), e_to=jnp.asarray(et),
        e_valid=jnp.asarray(ev), num_nodes=jnp.asarray(14, jnp.int32),
        num_edges=jnp.asarray(len(edges), jnp.int32),
    )


def test_connected_components_and_gauge_fix_mask():
    g = _two_component_graph()
    gt = _to_port(g)
    lab_j = np.asarray(jsolver.connected_components(g))
    lab_t = tsolver.connected_components(gt)
    np.testing.assert_array_equal(lab_t.numpy(), lab_j)
    assert lab_j[5] == 0 and lab_j[11] == 6 and lab_j[13] == 12
    gauge_j = np.asarray(jsolver.gauge_fix_mask(g, jnp.asarray(lab_j)))
    gauge_t = tsolver.gauge_fix_mask(gt, lab_t).numpy()
    np.testing.assert_array_equal(gauge_t, gauge_j)
    # oldest of chain one (node 5), the pre-fixed node 9, and the tie of
    # the pair (stamps 3, 3) broken to the smaller slot 12
    assert np.flatnonzero(gauge_t).tolist() == [5, 9, 12]


def _linearization_inputs(g):
    """Free mask, Ad(meas⁻¹) and the residual at perturbed poses (so that
    Huber weights below 1 appear), on the JAX side."""
    labels = jsolver.connected_components(g)
    free = (g.node_valid & ~jsolver.gauge_fix_mask(g, labels)).astype(jnp.float32)
    rng = np.random.default_rng(0)
    dx = jnp.asarray(0.05 * rng.normal(size=(g.node_capacity, 6)).astype(np.float32))
    poses = jlie.pose_retract(g.pose, dx)
    r = jfactors.batched_residuals(poses[g.e_from], poses[g.e_to], g.e_transform)
    adj = jax.vmap(lambda m: jlie.se3_adjoint(jlie.pose_inverse(m)))(g.e_transform)
    return free, adj, r


def test_fused_linearize_and_hvp_match_jax(graph128):
    g = graph128
    free, adj, r = _linearization_inputs(g)
    cfg = jsolver.SolverConfig(**HEADLINE)
    Ji, Jj, W, grad, Hb, U = jsolver._make_fused_linearize(g, free, cfg, adj)(r)

    gt = _to_port(g)
    p = tsolver._Problem(gt, torch.from_numpy(np.array(free)), tsolver.SolverConfig(**HEADLINE))
    r_t = torch.from_numpy(np.array(r))
    p.adj_meas_inv = torch.from_numpy(np.array(adj))
    out = p.linearize(r_t)
    w_t = out[2].numpy()
    assert (np.asarray(W) < np.asarray(g.e_info) - 1e-3).any(), "no Huber-weighted edge"
    for name, a, b in zip(("Ji", "Jj", "W", "grad", "Hb", "U"), out,
                          (Ji, Jj, W, grad, Hb, U)):
        _close_rel(a.numpy(), b, 1e-4 if name != "W" else 1e-5)
    assert np.abs(np.asarray(U)).max() > 0 and w_t.shape == (g.edge_capacity, 6, 6)

    rng = np.random.default_rng(1)
    v = rng.normal(size=(g.node_capacity, 6)).astype(np.float32)
    damp = (1e-3 * np.abs(rng.normal(size=(g.node_capacity, 6)))).astype(np.float32)
    y_j = jsolver._make_hvp(g, Ji, Jj, W, jnp.asarray(damp), free)(jnp.asarray(v))
    y_t = kops.hvp(out[0], out[1], out[2], gt.e_from, gt.e_to, torch.from_numpy(v),
                   torch.from_numpy(damp), p.free)
    _close_rel(y_t.numpy(), y_j)


@pytest.mark.parametrize("config", ["headline_fixed20", "default_early_exit"])
def test_optimize_matches_jax(graph128, config):
    kw = HEADLINE if config == "headline_fixed20" else {}
    g = graph128
    g_j, st_j = jsolver.optimize(g, jsolver.SolverConfig(**kw))
    g_t, st_t = tsolver.optimize(_to_port(g), tsolver.SolverConfig(**kw))

    hist_j = np.asarray(st_j.chi2_history)
    np.testing.assert_allclose(st_t.chi2_history.numpy(), hist_j, rtol=1e-3,
                               atol=1e-6 * hist_j[0])
    assert hist_j[-1] < 1e-2 * hist_j[0]
    np.testing.assert_array_equal(st_t.accepted.numpy(), np.asarray(st_j.accepted))
    np.testing.assert_allclose(g_t.pose.numpy(), np.asarray(g_j.pose), atol=1e-3)
    np.testing.assert_allclose(g_t.e_error.numpy(), np.asarray(g_j.e_error),
                               rtol=1e-2, atol=1e-4)
    np.testing.assert_array_equal(g_t.e_age.numpy(), np.asarray(g_j.e_age))
    assert int(st_t.num_gauge_fixed) == int(st_j.num_gauge_fixed) == 1
    np.testing.assert_allclose(float(st_t.final_lambda), float(st_j.final_lambda),
                               rtol=1e-6)


def test_early_exit_stops_with_a_flat_tail(graph128):
    # a tolerance this loose ends the solve after its first relaxed step;
    # every later entry is a no-op: the same χ², not accepted
    kw = dict(early_exit_tol=0.5, lambda_init=1e-2)
    g_j, st_j = jsolver.optimize(graph128, jsolver.SolverConfig(**kw))
    g_t, st_t = tsolver.optimize(_to_port(graph128), tsolver.SolverConfig(**kw))
    acc = st_t.accepted.numpy()
    np.testing.assert_array_equal(acc, np.asarray(st_j.accepted))
    last = int(np.flatnonzero(acc).max())
    assert last < 19
    hist = st_t.chi2_history.numpy()
    assert np.all(hist[last + 1:] == hist[last + 1])
    np.testing.assert_allclose(hist, np.asarray(st_j.chi2_history), rtol=1e-3)


def test_sparse_oracle_matches_jax_oracle():
    g, _ = jsynthetic.make_pose_graph(jax.random.PRNGKey(7), 64, loop_closure_every=8)
    ref = joracle.sparse_gn_oracle(g, iters=6)
    chi2_j = float(jsolver.total_chi2(g, ref, 1.0))
    gt = _to_port(g)
    poses = toracle.sparse_gn_oracle(gt, iters=6)
    chi2_t = float(tsolver.total_chi2(gt, poses, 1.0))
    np.testing.assert_allclose(poses.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(chi2_t, chi2_j, rtol=1e-3)


@pytest.mark.parametrize("option", [
    dict(mode="pcg"), dict(mode="direct"), dict(preconditioner="woodbury"),
    dict(preconditioner="jacobi"), dict(dense_gathers=True), dict(chain_root_ns=True),
    dict(preconditioner="none"), dict(use_odometry_calibration=True),
    dict(optimize_xy_only=True),
])
def test_unsupported_options_raise(option, graph128):
    cfg = dataclasses.replace(tsolver.SolverConfig(), **option)
    name = next(iter(option))
    with pytest.raises(NotImplementedError, match=name):
        tsolver.optimize(_to_port(graph128), cfg)
