"""The port's planar solve (``SolverConfig.optimize_xy_only``, the
reference's ``g2o_optimizer.cpp:164-170``) against the JAX package's, on
the CPU through the kernels' plain versions: each of the reference's two
forms held to its own twin.

- the fast loop (``mode="auto"``, early exit and fixed): K1's Jacobian
  columns masked, the factor's masked diagonal lifted, the poses
  flattened first; the restart's odometry start flattened too;
- the generic loop (``mode="pcg"``): the operator, preconditioner and
  gradient wrapped, the poses flattened first;
- the fleet (the reference's ``vmap`` of ``optimize``).

The graphs are tests/test_constraints.py's (``_chain``: a 40-node circle,
z perturbed by 0.2·N(0, 1); a 60-node one with more odometry noise for the
ATE bar), generated under ``jax.jit`` and crossed as arrays.

Tolerances, with their reasons: χ² histories at ``rtol=1e-3`` plus
``atol=1e-6·χ²₀`` and poses at 1e-3, as tests/test_torch_solver.py and
tests/test_torch_fleet.py hold the unprojected solve; accept flags exactly
over the steps before JAX's χ² first falls by less than ``NEAR_TIE``
relative: the planar χ² reaches its floor (the z residuals the plane
cannot absorb) by step 6, and past it a candidate differs from the
current χ² by ~1e-6 relative, below the packages' summation-order noise,
so either accept is right; the JAX tests' own bars (z within 1e-5 of 0,
roll and pitch within 1e-4, ATE below half the start's) on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import solver as jsolver
from uzliti_slam_tpu.io import synthetic as jsynthetic
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu_torch.graph import solver as tsolver
from uzliti_slam_tpu_torch.graph import state as tstate

PLANAR = dict(iterations=12, optimize_xy_only=True)
NEAR_TIE = 1e-5


def _to_port(g):
    return tstate.from_numpy({k: np.asarray(v) for k, v in g._asdict().items()}, device="cpu")


def _chain(n, **kw):
    """tests/test_constraints.py's ``_chain`` (key 0, 128 edge slots)."""
    return jax.jit(lambda k: jsynthetic.make_pose_graph(k, n, edge_capacity=128, **kw))(
        jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def lifted():
    """tests/test_constraints.py:172-177: the 40-node chain with z perturbed."""
    g, _ = _chain(40, loop_closure_every=8)
    dz = 0.2 * jax.random.normal(jax.random.PRNGKey(3), (g.node_capacity,))
    return g._replace(pose=g.pose.at[:, 2].add(dz))


def _held(got, st_t, ref, st_j):
    hist_j = np.asarray(st_j.chi2_history)
    np.testing.assert_allclose(st_t.chi2_history.numpy(), hist_j, rtol=1e-3,
                               atol=1e-6 * hist_j[0])
    gain = (hist_j[:-1] - hist_j[1:]) / hist_j[:-1]
    decided = int(np.argmax(gain < NEAR_TIE)) if (gain < NEAR_TIE).any() else len(gain)
    assert decided >= 4
    np.testing.assert_array_equal(st_t.accepted.numpy()[:decided],
                                  np.asarray(st_j.accepted)[:decided])
    np.testing.assert_allclose(got.pose.numpy(), np.asarray(ref.pose), atol=1e-3)


def _planar_bars(pose, n):
    """tests/test_constraints.py:178-183 on the port's poses."""
    p = pose[:n]
    assert np.allclose(p[:, 2], 0.0, atol=1e-5)           # z
    assert np.allclose(p[:, 4:6], 0.0, atol=1e-4)         # roll, pitch: quaternion x, y


@pytest.mark.parametrize("early_exit", [True, False], ids=["early_exit", "fixed"])
def test_fast_loop_matches_jax(lifted, early_exit):
    kw = dict(PLANAR, early_exit=early_exit)
    g_j, st_j = jsolver.optimize(lifted, jsolver.SolverConfig(**kw))
    g_t, st_t = tsolver.optimize(_to_port(lifted), tsolver.SolverConfig(**kw))
    _held(g_t, st_t, g_j, st_j)
    _planar_bars(g_t.pose.numpy(), 40)
    assert np.isfinite(float(st_t.chi2_history[-1]))
    assert float(st_t.chi2_history[-1]) < float(st_t.chi2_history[0])


def test_generic_loop_matches_jax(lifted):
    kw = dict(PLANAR, mode="pcg")
    g_j, st_j = jsolver.optimize(lifted, jsolver.SolverConfig(**kw))
    g_t, st_t = tsolver.optimize(_to_port(lifted), tsolver.SolverConfig(**kw))
    _held(g_t, st_t, g_j, st_j)
    _planar_bars(g_t.pose.numpy(), 40)
    # the two forms are the reference's two loops, not one: their
    # preconditioners differ (masked factor against wrapped full factor)
    _, st_f = tsolver.optimize(_to_port(lifted),
                               tsolver.SolverConfig(**PLANAR, early_exit=False))
    assert not torch.equal(st_t.chi2_history, st_f.chi2_history)


@pytest.mark.parametrize("margin, need", [(0.0, True), (1e9, False)],
                         ids=["need_forced_true", "need_forced_false"])
def test_restart_matches_jax(lifted, margin, need, monkeypatch):
    """The restart's odometry start is flattened too (``solver.py:1260-1261``);
    as tests/test_torch_pipeline.py holds the unprojected restart."""
    kw = dict(PLANAR, odometry_restart=True, restart_chi2_margin=margin, iterations=10)
    g_j, st_j = jsolver.optimize(lifted, jsolver.SolverConfig(**kw))
    decisions, host_decision = [], tsolver._host_decision

    def record(flag):
        decisions.append(host_decision(flag))
        return decisions[-1]

    monkeypatch.setattr(tsolver, "_host_decision", record)
    g_t, st_t = tsolver.optimize(_to_port(lifted), tsolver.SolverConfig(**kw))
    assert decisions == [need]
    _held(g_t, st_t, g_j, st_j)
    _planar_bars(g_t.pose.numpy(), 40)


def test_fleet_matches_jax(lifted):
    """Four instances (the lifted chain and three others from keys 1-3)
    against JAX's ``vmap`` of ``optimize`` at the same explicit cutoff."""
    graphs = [lifted] + [
        jax.jit(lambda k: jsynthetic.make_pose_graph(k, 40, loop_closure_every=8,
                                                     edge_capacity=128)[0])(
            jax.random.PRNGKey(s)) for s in (1, 2, 3)]
    batched = jax.tree.map(lambda *xs: jnp.stack(xs), *graphs)
    kw = dict(PLANAR, iterations=5, pcg_iterations=8, chain_dense_cutoff=16, early_exit=False)
    g_j, st_j = jax.jit(jax.vmap(lambda g: jsolver.optimize(g, jsolver.SolverConfig(**kw))))(
        batched)
    fleet = tstate.stack_graphs([_to_port(g) for g in graphs])
    g_t, st_t = tsolver.optimize_batched(fleet, tsolver.SolverConfig(**kw))
    hist_j = np.asarray(st_j.chi2_history)
    excess = (np.abs(st_t.chi2_history.numpy() - hist_j)
              / (1e-3 * np.abs(hist_j) + 1e-6 * hist_j[:, :1]))
    assert excess.max() <= 1.0
    np.testing.assert_allclose(g_t.pose.numpy(), np.asarray(g_j.pose), atol=1e-3)
    for b in range(4):
        _planar_bars(g_t.pose[b].numpy(), 40)


def test_planar_solve_still_converges_xy():
    """tests/test_constraints.py:186-193's bar on the port, beside JAX's."""
    g, gt = _chain(60, odom_noise=0.05, rot_noise=0.01, loop_closure_every=5)
    ate0 = float(jsynthetic.ate_rmse(g.pose[:60], gt))
    cfg = dict(iterations=20, optimize_xy_only=True)
    g_t, st_t = tsolver.optimize(_to_port(g), tsolver.SolverConfig(**cfg))
    ate1 = float(jsynthetic.ate_rmse(jnp.asarray(g_t.pose.numpy()[:60]), gt))
    assert ate1 < 0.5 * ate0
    g_j, st_j = jsolver.optimize(g, jsolver.SolverConfig(**cfg))
    hist_j = np.asarray(st_j.chi2_history)
    np.testing.assert_allclose(st_t.chi2_history.numpy(), hist_j, rtol=1e-3,
                               atol=1e-6 * hist_j[0])


def test_fast_loop_needs_no_wraps(lifted):
    """With K1's columns masked and the factor's masked diagonal lifted, the
    generic loop's wraps (``solver.py:911-915``) change nothing: the masked
    coordinates decouple in H, U and the factor, so every PCG vector keeps
    exact zeros there.  One LM step with and without the wraps, bit for
    bit, from a perturbed start (so that every coordinate has a residual)."""
    g = _to_port(lifted)
    g = g.replace(pose=tsolver.flatten_planar(g.pose, g.node_valid))
    rng = np.random.default_rng(0)
    dx = torch.from_numpy(0.05 * rng.normal(size=(g.node_capacity, 6)).astype(np.float32))
    g = g.replace(pose=tsolver.lie.pose_retract(g.pose, dx))
    free = (g.node_valid & ~tsolver.gauge_fix_mask(g, tsolver.connected_components(g))).float()
    cfg = tsolver.SolverConfig(**PLANAR)
    outs = []
    for wrapped in (False, True):
        p = tsolver._Problem(g, free, cfg)
        p.generic = wrapped          # the wraps on top of the masked K1 and factor
        r, _ = p.residuals(g.pose)
        Ji, Jj, W, grad, Hb, U = p.linearize(r)
        damp = p.damp(torch.full((1,), cfg.lambda_init), Hb)
        pack = p.build_pack(Hb, U, damp)
        outs.append(p.step(g.pose, pack, Ji, Jj, W, grad, damp))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][2], outs[1][2])
    assert not torch.equal(outs[0][0], g.pose)


def test_config_and_pose_flattening():
    cfg = dataclasses.replace(tsolver.SolverConfig(), optimize_xy_only=True)
    tsolver.check_supported(cfg)
    tsolver.check_supported(dataclasses.replace(cfg, mode="pcg"))
    p = torch.tensor([[1.0, 2.0, 3.0, 0.9, 0.1, 0.2, 0.3], [4.0, 5.0, 6.0, 1.0, 0.0, 0.0, 0.0]])
    p[0, 3:] = p[0, 3:] / p[0, 3:].norm()
    out = tsolver.flatten_planar(p, torch.tensor([True, False]))
    assert torch.equal(out[1], p[1])
    assert out[0, 2] == 0 and out[0, 4] == 0 and out[0, 5] == 0 and out[0, :2].tolist() == [1, 2]
    ref = np.asarray(jlie.pose2_to_pose(jlie.pose_to_pose2(jnp.asarray(p[0].numpy()))))
    np.testing.assert_allclose(out[0].numpy(), ref, atol=1e-6)
