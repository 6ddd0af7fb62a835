"""Port parity: graph state, the synthetic generator and SolverConfig.

Node and edge insertion agree exactly (the same masked writes).

Tolerances: the generated graphs agree to ``atol=1e-4`` — both integrate
the same noisy odometry in float32, the JAX package sequentially and the
port as a log-depth prefix product, so rounding accumulates along
different trees over the 128-node trajectory.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import solver as jsolver
from uzliti_slam_tpu.graph import state as jstate
from uzliti_slam_tpu.io import synthetic as jsynthetic
from uzliti_slam_tpu_torch.graph import solver as tsolver
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import synthetic as tsynthetic


def _jax_arrays(g):
    return {k: np.asarray(v) for k, v in g._asdict().items()}


def test_from_numpy_to_numpy_round_trip():
    g, _ = jsynthetic.make_pose_graph(jax.random.PRNGKey(0), 48, loop_closure_every=8)
    arrays = _jax_arrays(g)
    gt = tstate.from_numpy(arrays, device="cpu")
    assert gt.node_capacity == g.node_capacity and gt.edge_capacity == g.edge_capacity
    assert gt.e_from.dtype == torch.int32 and gt.e_valid.dtype == torch.bool
    assert gt.pose.dtype == torch.float32
    back = tstate.to_numpy(gt)
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_from_numpy_names_missing_fields():
    arrays = _jax_arrays(jstate.empty_graph(8, 8))
    del arrays["e_info"]
    with pytest.raises(KeyError, match="e_info"):
        tstate.from_numpy(arrays, device="cpu")


def test_empty_graph_matches_jax():
    ref = _jax_arrays(jstate.empty_graph(8, 16))
    got = tstate.to_numpy(tstate.empty_graph(8, 16, device="cpu"))
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_info_for_edge_type_and_odometry_information_match():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(10, 6, 6)).astype(np.float32)
    types = np.array([1, 2, 3, 4, 5, 6, 7, 104, 105, 0], np.int32)
    ref = np.asarray(jstate.info_for_edge_type(types, base))
    got = tstate.info_for_edge_type(torch.from_numpy(types), torch.from_numpy(base))
    np.testing.assert_array_equal(got.numpy(), ref)
    g, _ = jsynthetic.make_pose_graph(jax.random.PRNGKey(1), 32)
    rel = np.array(g.e_transform[:31])
    np.testing.assert_allclose(
        tstate.odometry_information(torch.from_numpy(rel)).numpy(),
        np.asarray(jstate.odometry_information(rel)), rtol=1e-4)


def _jax_draws(key, n_nodes, n_loops):
    """The standard-normal draws of uzliti_slam_tpu.io.synthetic, in order."""
    k1, k2 = jax.random.split(key)
    odom = np.concatenate([jax.random.normal(k1, (n_nodes - 1, 3)),
                           jax.random.normal(k2, (n_nodes - 1, 3))], axis=1)
    k3, k4 = jax.random.split(k2)
    loop = np.concatenate([jax.random.normal(k3, (n_loops, 3)),
                           jax.random.normal(k4, (n_loops, 3))], axis=1)
    return torch.from_numpy(odom), torch.from_numpy(loop)


def test_make_pose_graph_with_injected_noise_matches_jax():
    key, n = jax.random.PRNGKey(3), 128
    g, gt_j = jsynthetic.make_pose_graph(key, n, loop_closure_every=8)
    n_loops = int(g.num_edges) - (n - 1)
    odom, loop = _jax_draws(key, n, n_loops)
    gt, gt_t = tsynthetic.make_pose_graph(n, loop_closure_every=8, odom_draws=odom,
                                          loop_draws=loop, capacity_rounding="pow2",
                                          device="cpu")
    ref = _jax_arrays(g)
    got = tstate.to_numpy(gt)
    np.testing.assert_allclose(gt_t.numpy(), np.asarray(gt_j), atol=1e-4)
    for k, v in ref.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if v.dtype == np.float32:
            np.testing.assert_allclose(got[k], v, atol=1e-4, rtol=1e-4, err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_make_pose_graph_from_a_generator_is_seeded():
    a, _ = tsynthetic.make_pose_graph(40, loop_closure_every=5, device="cpu",
                                      generator=torch.Generator().manual_seed(3))
    b, _ = tsynthetic.make_pose_graph(40, loop_closure_every=5, device="cpu",
                                      generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(a.pose, b.pose, rtol=0, atol=0)
    assert a.node_capacity == 40 and int(a.num_edges) == 39 + 4


def test_ate_rmse_matches_jax():
    g, gt = jsynthetic.make_pose_graph(jax.random.PRNGKey(2), 64)
    for align in (True, False):
        ref = float(jsynthetic.ate_rmse(g.pose, gt, align=align))
        got = float(tsynthetic.ate_rmse(torch.from_numpy(np.array(g.pose)),
                                        torch.from_numpy(np.array(gt)), align=align))
        np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_solver_config_fields_and_defaults_match_jax():
    ref = {f.name: f.default for f in dataclasses.fields(jsolver.SolverConfig)}
    got = {f.name: f.default for f in dataclasses.fields(tsolver.SolverConfig)}
    assert got == ref


@pytest.mark.parametrize("option", ["split_hv_threshold", "unroll_lm", "unroll_pcg"])
def test_layout_only_options_are_accepted(option):
    cfg = dataclasses.replace(tsolver.SolverConfig(), **{option: 2})
    tsolver.check_supported(cfg)


def test_constructors_target_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card, nothing to raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstate.empty_graph(4, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsynthetic.circle_trajectory(8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tsynthetic.make_pose_graph(8)


def _node_args(rng, k):
    pose = np.concatenate([rng.normal(size=3), [1.0, 0, 0, 0]]).astype(np.float32)
    return pose, (pose + 0.1).astype(np.float32), np.float32(0.5 * k)


def test_add_node_and_add_edge_match_jax_including_dropped_writes():
    """Capacity 3 nodes / 3 edges: the fourth node and edge are dropped
    (slot -1), an edge with endpoint -1 is dropped, and the edge type masks
    the information matrix at insertion."""
    rng = np.random.default_rng(5)
    gj, gt = jstate.empty_graph(3, 3), tstate.empty_graph(3, 3, device="cpu")
    for k in range(4):
        pose, odom, stamp = _node_args(rng, k)
        gj, sj = jstate.add_node(gj, pose, odom, stamp, fixed=(k == 1), uncertainty=0.25 * k)
        gt, st = tstate.add_node(gt, torch.from_numpy(pose), torch.from_numpy(odom),
                                 float(stamp), fixed=(k == 1), uncertainty=0.25 * k)
        assert int(st) == int(sj) == (k if k < 3 else -1)
    info = rng.normal(size=(6, 6)).astype(np.float32)
    edges = [(0, 1, 1, 2.0, True), (1, 2, 105, 0.5, False), (2, -1, 1, 1.0, True),
             (2, 0, 7, 3.0, True), (0, 2, 1, 1.0, True)]
    for f, t, et, score, valid in edges:
        T = _node_args(rng, 0)[0]
        gj, sj = jstate.add_edge(gj, jnp.asarray(f, jnp.int32), jnp.asarray(t, jnp.int32), T,
                                 info, etype=et, score=score, valid=valid)
        gt, st = tstate.add_edge(gt, f, t, torch.from_numpy(T), torch.from_numpy(info),
                                 etype=et, score=score, valid=valid)
        assert int(st) == int(sj)
    ref, got = _jax_arrays(gj), tstate.to_numpy(gt)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert int(gt.num_nodes) == 3 and int(gt.num_edges) == 3


def test_add_edges_equals_add_edge_in_order():
    """The keyframe step's batched write: the result of B add_edge calls in
    order, with -1 endpoints and the edges past capacity dropped."""
    rng = np.random.default_rng(11)
    g0 = tstate.empty_graph(8, 6, device="cpu")
    g0 = g0.replace(num_edges=torch.tensor(2, dtype=torch.int32))
    B = 6
    frm = torch.tensor([0, -1, 2, 3, 4, 5], dtype=torch.int32)
    to = torch.tensor([1, 1, -1, 5, 6, 7], dtype=torch.int32)
    T = torch.from_numpy(rng.normal(size=(B, 7)).astype(np.float32))
    info = torch.from_numpy(rng.normal(size=(B, 6, 6)).astype(np.float32))
    et = torch.tensor([104, 105, 1, 1, 3, 1], dtype=torch.int32)
    score = torch.arange(B, dtype=torch.float32)
    valid = torch.tensor([True, False, False, True, False, True])
    g_seq, slots = g0, []
    for i in range(B):
        g_seq, s = tstate.add_edge(g_seq, frm[i], to[i], T[i], info[i], etype=int(et[i]),
                                   score=score[i], valid=bool(valid[i]))
        slots.append(int(s))
    g_bat, s_bat = tstate.add_edges(g0, frm, to, T, info, et, score, valid)
    assert s_bat.tolist() == slots == [2, -1, -1, 3, 4, 5]
    for k, v in tstate.to_numpy(g_bat).items():
        np.testing.assert_array_equal(v, tstate.to_numpy(g_seq)[k], err_msg=k)
    g_full, s_full = tstate.add_edges(g_bat, frm, to, T, info, et, score, valid)
    assert (s_full == -1).all() and int(g_full.num_edges) == 6
