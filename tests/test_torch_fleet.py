"""The port's fleet solve (``parallel/sharded.optimize_batch``,
``graph/solver.optimize_batched``, the batched ``GraphState`` and
generator) against the JAX package's ``optimize_batch`` (the ``vmap`` of
``solver.optimize``), on the CPU through the kernels' plain versions.

The fleets are 4 instances of 24 nodes from the port's generator (pow2
capacities, as the suite's conftest sets for JAX's: 32 node and 32 edge
slots), crossed to JAX as arrays (JAX's generator compiles for seconds a
call here).

Tolerances, with their reasons:
- χ² histories: ``rtol=1e-3`` plus ``atol=1e-6·χ²₀``, as tests/
  test_torch_solver.py holds the single solve.
- poses after 5 iterations at the fleet rung's 8 PCG steps: 1e-3.  The
  float32 PCG on these 24-node graphs loses orthogonality after ~3 steps
  (rᵀz rises again), so summation order alone moves the poses by more
  than 1e-4: the JAX package's own vmapped solve and its own single solves
  of the same instances differ by 4.3e-4 (fixed) and 5.6e-4 (early exit)
  here, and the port's fleet lands 4.2e-4 from JAX's (``PYTHONPATH=.
  python tests/test_torch_fleet.py`` prints these gaps).  With 4 PCG steps, before
  that happens, the poses are held at 1e-4 against JAX and against the
  port's single solves.
- against the reference's default override, whose fleet root is a
  Newton-Schulz approximation (``chain_root_ns``; the port keeps its exact
  root): the reference's own exact-root single solve lands 0.2 m from its
  override fleet after 5 iterations, so no pose bar can hold; each
  instance's final χ² is held to at most the reference's (+1e-3 relative).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from uzliti_slam_tpu.graph import solver as jsolver
from uzliti_slam_tpu.graph import state as jstate
from uzliti_slam_tpu.parallel import sharded as jsharded
from uzliti_slam_tpu_torch.graph import solver as tsolver
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import synthetic as tsynthetic
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.parallel import sharded as tsharded

B, N_NODES = 4, 24


def _fleet():
    """(JAX graphs, the JAX batch, the port's fleet)."""
    port, _ = tsynthetic.make_pose_graph_batch(
        B, N_NODES, loop_closure_every=8, generator=torch.Generator().manual_seed(0),
        capacity_rounding="pow2", device="cpu")
    arrays = tstate.to_numpy(port)
    batched = jstate.GraphState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    graphs = [jax.tree.map(lambda x, b=b: x[b], batched) for b in range(B)]
    return graphs, batched, port


@pytest.fixture(scope="module")
def fleet():
    return _fleet()


def _mesh():
    return Mesh(np.array(jax.devices()[:B]), ("batch",))


def _hist_close(got, ref):
    ref = np.asarray(ref)
    excess = np.abs(got - ref) / (1e-3 * np.abs(ref) + 1e-6 * ref[:, :1])
    assert excess.max() <= 1.0, f"χ² histories apart by {excess.max():.3g}x the tolerance"


@pytest.mark.parametrize("early_exit", [False, True], ids=["fixed", "early_exit"])
def test_fleet_matches_jax_with_explicit_cutoff(fleet, early_exit):
    graphs, batched, port = fleet
    kw = dict(iterations=5, pcg_iterations=8, chain_dense_cutoff=16, early_exit=early_exit)
    jcfg = jsolver.SolverConfig(**kw)
    # with the cutoff given, the reference's optimize_batch is this vmap
    ref, ref_stats = jax.jit(jax.vmap(lambda g: jsolver.optimize(g, jcfg)))(batched)
    out, stats = tsolver.optimize_batched(port, tsolver.SolverConfig(**kw))
    assert out.pose.shape == (B, 32, 7) and stats.chi2_history.shape == (B, 6)
    _hist_close(stats.chi2_history.numpy(), ref_stats.chi2_history)
    np.testing.assert_array_equal(stats.accepted.numpy(), np.asarray(ref_stats.accepted))
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(ref.pose), atol=1e-3)
    np.testing.assert_array_equal(out.e_age.numpy(), np.asarray(ref.e_age))
    np.testing.assert_allclose(out.e_error.numpy(), np.asarray(ref.e_error), rtol=1e-2,
                               atol=1e-4)
    np.testing.assert_array_equal(stats.num_gauge_fixed.numpy(),
                                  np.asarray(ref_stats.num_gauge_fixed))
    # optimize_batch with the cutoff given is that solve
    torch.testing.assert_close(tsharded.optimize_batch(port, tsolver.SolverConfig(**kw)).pose,
                               out.pose, rtol=0, atol=0)


def test_fleet_matches_jax_and_single_solves_before_pcg_amplifies(fleet):
    graphs, batched, port = fleet
    kw = dict(iterations=5, pcg_iterations=4, chain_dense_cutoff=16, early_exit=False)
    ref = jsharded.optimize_batch(batched, _mesh(), "batch", jsolver.SolverConfig(**kw))
    cfg = tsolver.SolverConfig(**kw)
    out, stats = tsolver.optimize_batched(port, cfg)
    np.testing.assert_allclose(out.pose.numpy(), np.asarray(ref.pose), atol=1e-4)
    for b in range(B):
        single, st = tsolver.optimize(tstate.graph_of(port, b), cfg)
        np.testing.assert_allclose(out.pose[b].numpy(), single.pose.numpy(), atol=1e-4)
        _hist_close(stats.chi2_history[b:b + 1].numpy(), st.chi2_history[None].numpy())
        torch.testing.assert_close(out.e_age[b], single.e_age, rtol=0, atol=0)


def test_fleet_default_config_against_the_reference_override(fleet):
    graphs, batched, port = fleet
    jcfg = jsolver.SolverConfig(iterations=5)
    ref = jsharded.optimize_batch(batched, _mesh(), "batch", jcfg)
    cfg = tsolver.SolverConfig(iterations=5)
    assert tsharded.fleet_config(cfg).chain_dense_cutoff == 16
    assert tsharded.fleet_config(dataclasses.replace(cfg, chain_dense_cutoff=32)) \
        .chain_dense_cutoff == 32
    out = tsharded.optimize_batch(port, cfg)
    for b in range(B):
        chi2_0 = float(jsolver.total_chi2(graphs[b], graphs[b].pose, 1.0))
        chi2_ref = float(jsolver.total_chi2(graphs[b], ref.pose[b], 1.0))
        chi2 = float(tsolver.total_chi2(tstate.graph_of(port, b), out.pose[b], 1.0))
        assert chi2 <= chi2_ref * (1 + 1e-3) + 1e-6 * chi2_0, (b, chi2, chi2_ref)


def test_flattened_fleet_decouples_its_instances(fleet):
    """K8 finds each instance's components and gauge node on the flattened
    table with one instance's rounds, and the chain coupling block is zero
    at every instance boundary (both_free's roll, is_chain)."""
    _, _, port = fleet
    g = tsolver._flatten_fleet(port)
    n = port.node_capacity
    assert g.e_from.shape == (B * port.edge_capacity,) and int(g.e_to.max()) < B * n
    labels = kops.components(g.e_from, g.e_to, g.e_valid, B * n, tsolver.component_iterations(n))
    gauge = tsolver.gauge_fix_mask(g, labels)
    for b in range(B):
        one = tstate.graph_of(port, b)
        lab1 = tsolver.connected_components(one)
        torch.testing.assert_close(labels[b * n:(b + 1) * n], lab1 + b * n, rtol=0, atol=0)
        torch.testing.assert_close(gauge[b * n:(b + 1) * n], tsolver.gauge_fix_mask(one, lab1),
                                   rtol=0, atol=0)
    free = (g.node_valid & ~gauge).float()
    p = tsolver._Problem(g, free, tsolver.SolverConfig(), batch=B)
    r, chi2 = p.residuals(g.pose)
    *_, Hb, U = p.linearize(r)
    assert chi2.shape == (B,)
    assert not U.view(B, n, 6, 6)[:, -1].any()
    assert float(U.abs().max()) > 0


@pytest.mark.parametrize("option", ["odometry_restart", "use_odometry_calibration"])
def test_fleet_refuses_what_is_not_ported(fleet, option):
    _, _, port = fleet
    with pytest.raises(NotImplementedError, match=option):
        tsharded.optimize_batch(port, tsolver.SolverConfig(**{option: True}))


def test_batched_generator_is_the_single_generator_per_instance():
    gen = torch.Generator().manual_seed(3)
    odom = torch.randn(3, 39, 6, generator=gen)
    loop = torch.randn(3, 3, 6, generator=gen)
    fl, gt = tsynthetic.make_pose_graph_batch(3, 40, loop_closure_every=8, odom_draws=odom,
                                              loop_draws=loop, capacity_rounding="pow2",
                                              device="cpu")
    assert fl.pose.shape[0] == 3 and fl.node_capacity == 64 and fl.edge_capacity == 64
    for b in range(3):
        one, gt1 = tsynthetic.make_pose_graph(40, loop_closure_every=8, odom_draws=odom[b],
                                              loop_draws=loop[b], capacity_rounding="pow2",
                                              device="cpu")
        got = tstate.graph_of(fl, b)
        for k in tstate._FIELDS:
            torch.testing.assert_close(getattr(got, k), getattr(one, k), rtol=1e-6, atol=1e-6,
                                       msg=k)
        torch.testing.assert_close(gt, gt1, rtol=0, atol=0)
    stacked = tstate.stack_graphs([tstate.graph_of(fl, b) for b in range(3)])
    for k in tstate._FIELDS:
        assert torch.equal(getattr(stacked, k), getattr(fl, k)), k


def pose_gaps(pcg_iterations: int, early_exit: bool) -> dict:
    """Largest pose gaps after 5 iterations on the 4 x 24-node fleet: JAX's
    vmapped solve against JAX's single solves, and the port's fleet
    against JAX's vmapped solve and against the port's single solves."""
    _, batched, port = _fleet()
    kw = dict(iterations=5, pcg_iterations=pcg_iterations, chain_dense_cutoff=16,
              early_exit=early_exit)
    jcfg, cfg = jsolver.SolverConfig(**kw), tsolver.SolverConfig(**kw)
    vmapped = np.asarray(jax.jit(jax.vmap(lambda g: jsolver.optimize(g, jcfg)))(batched)[0].pose)
    one = jax.jit(lambda g: jsolver.optimize(g, jcfg))
    singles = np.stack([np.asarray(one(jax.tree.map(lambda x, b=b: x[b], batched))[0].pose)
                        for b in range(B)])
    out = tsolver.optimize_batched(port, cfg)[0].pose.numpy()
    port_singles = np.stack([tsolver.optimize(tstate.graph_of(port, b), cfg)[0].pose.numpy()
                             for b in range(B)])
    return {"jax_vmap_vs_jax_single": float(np.abs(vmapped - singles).max()),
            "port_fleet_vs_jax_vmap": float(np.abs(out - vmapped).max()),
            "port_fleet_vs_port_single": float(np.abs(out - port_singles).max())}


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    for pcg_iterations in (4, 8):
        for early_exit in (False, True):
            print(f"pcg_iterations={pcg_iterations} early_exit={early_exit}: "
                  f"{pose_gaps(pcg_iterations, early_exit)}", flush=True)
