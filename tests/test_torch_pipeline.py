"""Port parity: uzliti_slam_tpu_torch.pipeline.optimize_epoch and the
solver's odometry restart against JAX.

The epoch graph is the 60-node laser graph of tests/test_filter.py
(TestLaserEdgeRouting): consecutive laser edges entering invalid, one bad
laser edge planted on a revisit.  RANSAC triplets are JAX's draws for the
epoch's filter key, injected into the port (see test_torch_filter.py).

Tolerances, with their reasons:
- edge validity after the filter: exactly (discrete);
- χ² histories: ``rtol=1e-3`` plus ``atol=1e-6·χ²₀``, the solver tests'
  rule (summation order; unconverged 12-step PCG; the early exit's no-op
  tail can start one step apart at a near-tie, so accept flags are not
  compared for the epoch);
- poses, ``diff_transform`` and uncertainty ``atol=1e-3``: poses from two
  solves that agree to that, and path lengths over such poses;
- the occupancy grid projected after the epoch: the origin (the centre of
  the poses' bounding box) ``atol=1e-3``, as the poses; node cells and
  bearing shifts exactly (counted first: the poses of the two solves
  differ by at most 1.8e-4 m here, and no node lies that close to a cell
  edge or a rounding tie of its bin), then log-odds ``atol=1e-4``, as
  tests/test_torch_occupancy.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu import config as jconfig
from uzliti_slam_tpu import pipeline as jpipeline
from uzliti_slam_tpu.graph import solver as jsolver
from uzliti_slam_tpu.graph import state as jstate
from uzliti_slam_tpu.io import synthetic as jsynthetic
from uzliti_slam_tpu.mapping import occupancy as jocc
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu.ops import ransac as jransac
from uzliti_slam_tpu_torch import config as tconfig
from uzliti_slam_tpu_torch import pipeline as tpipeline
from uzliti_slam_tpu_torch.graph import solver as tsolver
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.mapping import occupancy as tocc
from uzliti_slam_tpu_torch.ops import lie as tlie

KEY = jax.random.PRNGKey(0)


def _graph_arrays(g):
    return {k: np.asarray(v) for k, v in g._asdict().items()}


def _laser_state():
    # the capacities and shape parameters of test_filter's epoch, so the
    # compiled JAX optimize_epoch is shared with it
    cfg = jconfig.SlamConfig(node_capacity=64, edge_capacity=256, feats_per_node=96,
                             scan_bins=180)
    g, gt = jsynthetic.make_pose_graph(KEY, 60, odom_noise=0.01, rot_noise=0.002,
                                       loop_closure_every=1, node_capacity=64,
                                       edge_capacity=256, radius=2.0)
    rel = jlie.pose_relative(g.pose[:59], g.pose[1:60])
    info = 50.0 * jnp.eye(6)
    for i in range(59):
        g, _ = jstate.add_edge(g, jnp.asarray(i, jnp.int32), jnp.asarray(i + 1, jnp.int32),
                               rel[i], info, etype=jstate.EDGE_TYPE_2D_LASER, valid=False)
    bad_T = jlie.make_pose(jnp.array([4.0, -3.0, 1.0]), jnp.array([1.0, 0, 0, 0]))
    g, bad_slot = jstate.add_edge(g, jnp.asarray(5, jnp.int32), jnp.asarray(35, jnp.int32),
                                  bad_T, info, etype=jstate.EDGE_TYPE_2D_LASER, valid=False)
    return cfg, jpipeline.init_state(cfg)._replace(graph=g), int(bad_slot), gt


@pytest.fixture(scope="module")
def epoch_pair():
    cfg_j, state_j, bad_slot, gt = _laser_state()
    state_t = tpipeline.state_from_numpy({"graph": _graph_arrays(state_j.graph)}, device="cpu")
    cfg_t = tconfig.SlamConfig(node_capacity=64, edge_capacity=256)
    member = tpipeline.epoch_ransac_members(state_t, cfg_t).numpy()
    key = jax.random.split(state_j.prng)[0]                   # the epoch's filter key
    keys = jax.random.split(key, member.shape[0])
    tri = np.array(jax.vmap(lambda k, v: jransac._valid_sample(
        k, cfg_t.filter.ransac_hypotheses, v))(keys, jnp.asarray(member)))
    out_j = jpipeline.optimize_epoch(state_j, cfg_j)
    out_t = tpipeline.optimize_epoch(state_t, cfg_t, tri=torch.from_numpy(tri))
    return out_j, out_t, bad_slot, gt


def test_optimize_epoch_validity_matches_jax(epoch_pair):
    (s_j, _), (s_t, _), bad_slot, _ = epoch_pair
    ev_j, ev_t = np.asarray(s_j.graph.e_valid), s_t.graph.e_valid.numpy()
    np.testing.assert_array_equal(ev_t, ev_j)
    assert not ev_t[bad_slot]
    laser = s_t.graph.e_type.numpy() == tstate.EDGE_TYPE_2D_LASER
    laser[bad_slot] = False
    assert ev_t[laser].sum() >= 5


def test_optimize_epoch_solve_matches_jax(epoch_pair):
    (s_j, st_j), (s_t, st_t), _, gt = epoch_pair
    hist_j = np.asarray(st_j.chi2_history)
    hist_t = st_t.chi2_history.numpy()
    np.testing.assert_allclose(hist_t, hist_j, rtol=1e-3, atol=1e-6 * hist_j[0])
    assert hist_t[-1] < hist_t[0]
    np.testing.assert_allclose(s_t.graph.pose.numpy(), np.asarray(s_j.graph.pose), atol=1e-3)
    np.testing.assert_allclose(s_t.graph.uncertainty.numpy(), np.asarray(s_j.graph.uncertainty),
                               atol=1e-3)
    np.testing.assert_allclose(s_t.graph.diff_transform.numpy(),
                               np.asarray(s_j.graph.diff_transform), atol=1e-3)
    np.testing.assert_array_equal(s_t.graph.e_age.numpy(), np.asarray(s_j.graph.e_age))
    assert int(st_t.num_gauge_fixed) == int(st_j.num_gauge_fixed)
    ate = float(jsynthetic.ate_rmse(jnp.asarray(s_t.graph.pose.numpy()[:60]), gt))
    assert ate < 0.15


def test_optimize_epoch_does_not_modify_its_input():
    _, state_j, _, _ = _laser_state()
    state_t = tpipeline.state_from_numpy({"graph": _graph_arrays(state_j.graph)}, device="cpu")
    before = tstate.to_numpy(state_t.graph)
    tpipeline.optimize_epoch(state_t, tconfig.SlamConfig(node_capacity=64, edge_capacity=256))
    for k, v in tstate.to_numpy(state_t.graph).items():
        np.testing.assert_array_equal(v, before[k], err_msg=k)


@pytest.fixture(scope="module")
def restart_graph():
    g, _ = jsynthetic.make_pose_graph(jax.random.PRNGKey(5), 64, loop_closure_every=8)
    return g


@pytest.mark.parametrize("margin, need", [(0.0, True), (1e9, False)],
                         ids=["need_forced_true", "need_forced_false"])
def test_odometry_restart_matches_jax(restart_graph, margin, need, monkeypatch):
    """``need`` forced true: the first solve starts from poses in a poor
    basin (as in tests/test_demo_regression.py) and the restart from the
    odometry prior must win.  Forced false: one solve from the odometry
    start.  (Two unconverged solves from a poor basin drift apart by more
    than the χ² tolerance, JAX against the port, so the compared result is
    always a solve from the odometry start.)"""
    g = restart_graph
    if need:
        noise = 0.3 * jax.random.normal(jax.random.PRNGKey(6), (g.node_capacity, 6))
        g = g._replace(pose=jax.vmap(jlie.pose_retract)(g.pose, noise))
    kw = dict(odometry_restart=True, restart_chi2_margin=margin, iterations=10)
    g_j, st_j = jsolver.optimize(g, jsolver.SolverConfig(**kw))
    decisions, host_decision = [], tsolver._host_decision

    def record(flag):
        decisions.append(host_decision(flag))
        return decisions[-1]

    monkeypatch.setattr(tsolver, "_host_decision", record)
    g_t, st_t = tsolver.optimize(
        tstate.from_numpy(_graph_arrays(g), device="cpu"), tsolver.SolverConfig(**kw))
    assert decisions == [need]
    hist_j = np.asarray(st_j.chi2_history)
    np.testing.assert_allclose(st_t.chi2_history.numpy(), hist_j, rtol=1e-3,
                               atol=1e-6 * hist_j[0])
    np.testing.assert_allclose(g_t.pose.numpy(), np.asarray(g_j.pose), atol=1e-3)
    np.testing.assert_allclose(float(st_t.final_lambda), float(st_j.final_lambda), rtol=1e-6)
    if need:   # the restart won: far below the solve from the poor basin alone
        _, st_a = tsolver.optimize(tstate.from_numpy(_graph_arrays(g), device="cpu"),
                                   tsolver.SolverConfig(iterations=10))
        assert st_t.chi2_history[-1] < 0.5 * st_a.chi2_history[-1]


def test_project_map_after_epoch_matches_jax(epoch_pair):
    """Slam.optimize's tick: optimize_epoch, then project_map (a full
    rebuild into a fresh grid), against JAX's epoch then occupancy.project."""
    (s_j, _), (s_t, _), _, _ = epoch_pair
    n = s_t.graph.node_capacity
    scans = (2.0 + 3.0 * np.random.default_rng(7).random((n, 180))).astype(np.float32)
    sv = s_t.graph.node_valid.numpy().copy()
    cfg_t = tconfig.SlamConfig(node_capacity=64, edge_capacity=256, scan_bins=180)
    grid_t = tpipeline.project_map(
        s_t.replace(scans=torch.from_numpy(scans), scan_valid=torch.from_numpy(sv)), cfg_t)
    cfg_j = jocc.GridConfig()
    grid_j = jocc.project(jocc.grid_init(s_j.graph, cfg_j), s_j.graph, jnp.asarray(scans),
                          jnp.asarray(sv), cfg_j, force_full=True)
    np.testing.assert_allclose(grid_t.origin.numpy(), np.asarray(grid_j.origin), atol=1e-3)
    # same node cells and bearing shifts on both sides, counted before the grid
    cx_t, cy_t = tocc._node_cells(s_t.graph.pose, grid_t.origin, cfg_j.resolution)
    inv = np.float32(1.0) / np.float32(cfg_j.resolution)
    cell_j = np.floor((np.asarray(s_j.graph.pose)[:, :2] - np.asarray(grid_j.origin)) * inv)
    yaw_j = np.asarray(jlie.yaw_of(jlie.pose_q(s_j.graph.pose)))
    yaw_t = tlie.yaw_of(tlie.pose_q(s_t.graph.pose)).numpy()
    assert int((cell_j[:, 0] != cx_t.numpy()).sum() + (cell_j[:, 1] != cy_t.numpy()).sum()) == 0
    assert int((np.round(yaw_j * 180 / (2 * np.pi)) != np.round(yaw_t * 180 / (2 * np.pi))).sum()) == 0
    np.testing.assert_allclose(grid_t.logodds.numpy(), np.asarray(grid_j.logodds), atol=1e-4,
                               rtol=0)
    assert int(grid_t.last_projected) == int(grid_j.last_projected) == 60
    np.testing.assert_array_equal(tpipeline.map_ternary(grid_t).numpy(),
                                  np.asarray(jocc.to_ternary(grid_j)))
    p = tpipeline.map_probability(grid_t).numpy()
    assert p.min() >= 0 and p.max() <= 1 and (p > 0.65).sum() > 0 and (p < 0.35).sum() > 0


def test_slam_config_fields_and_defaults_match_jax():
    assert {"scan_bins", "grid", "project_map"} <= {
        f.name for f in dataclasses.fields(tconfig.SlamConfig)}
    for t_cls, j_cls in ((tconfig.SlamConfig, jconfig.SlamConfig),
                         (tconfig.ScopeConfig, jconfig.ScopeConfig),
                         (tocc.GridConfig, jocc.GridConfig)):
        ref = {f.name: f.default for f in dataclasses.fields(j_cls)}
        for f in dataclasses.fields(t_cls):
            if dataclasses.is_dataclass(f.default):
                got, want = dataclasses.asdict(f.default), dataclasses.asdict(ref[f.name])
                # the knobs of the other estimators come with their paths
                # (ROADMAP.md A25); every recognizer's are here
                unported = set(want) - set(got) if f.name == "estimation" else set()
                assert all(k.startswith(("gicp_", "pnp_"))
                           or k in tconfig.UNPORTED_GATES for k in unported), unported
                assert got == {k: v for k, v in want.items() if k not in unported}, f.name
            else:
                assert f.default == ref[f.name], f.name
    assert tconfig.SlamConfig().solver.odometry_restart
    ref = jconfig.tunables_from_config(jconfig.SlamConfig())._asdict()
    got = dataclasses.asdict(tconfig.tunables_from_config(tconfig.SlamConfig()))
    assert set(got) | set(tconfig.UNPORTED_GATES) == set(ref)
    assert set(tconfig.UNPORTED_GATES) == {"gicp_max_corr", "pnp_reproj_px"}
    assert got == {k: float(v) for k, v in ref.items() if k in got}


def test_init_state_and_state_from_numpy():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is the card, nothing to raise")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipeline.init_state()
    st = tpipeline.init_state(tconfig.SlamConfig(node_capacity=16, edge_capacity=32),
                              seed=3, device="cpu")
    assert st.graph.node_capacity == 16 and st.graph.edge_capacity == 32
    assert st.generator.device.type == "cpu"
    # scans as JAX's init_state makes them: +inf ranges, none valid
    st_j = jpipeline.init_state(jconfig.SlamConfig(node_capacity=16, edge_capacity=32))
    np.testing.assert_array_equal(st.scans.numpy(), np.asarray(st_j.scans))
    np.testing.assert_array_equal(st.scan_valid.numpy(), np.asarray(st_j.scan_valid))
    scans = np.arange(16 * 360, dtype=np.float32).reshape(16, 360)
    st2 = tpipeline.state_from_numpy({"graph": _graph_arrays(jstate.empty_graph(16, 32)),
                                      "scans": scans, "scan_valid": np.arange(16) < 3},
                                     device="cpu")
    np.testing.assert_array_equal(st2.scans.numpy(), scans)
    assert st2.scan_valid.numpy().tolist() == [True] * 3 + [False] * 13
    arrays = _graph_arrays(jstate.empty_graph(16, 32))
    back = tstate.to_numpy(tpipeline.state_from_numpy({"graph": arrays}, device="cpu").graph)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)
