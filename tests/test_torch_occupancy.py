"""Port parity: uzliti_slam_tpu_torch.mapping.occupancy against the JAX
package's occupancy projection, on the CPU (the port through K11's plain
version).

Every case of tests/test_occupancy.py runs through both packages on the
same inputs, plus a 64-node graph from the JAX generator with numpy-seeded
scans (a full rebuild, then an incremental pass over 8 new nodes).

JAX's functions run compiled (``project`` compiles its branches under
``lax.cond``; ``_project_rays`` and ``_mark_node_cells`` are called under
``jax.jit`` here), as the JAX pipeline runs them: compiled, the division
of a node position by the constant resolution becomes a multiplication by
its reciprocal, which puts nodes on a cell edge into the neighbouring cell.

Tolerances, with their reasons:
- log-odds ``atol=1e-4``: JAX sums a cell's node terms in float32 chunks of
  64 nodes, the port in float64 over the nodes in slot order, and the terms
  reach ~57 near a node, so float32 rounding of the sums differs by ~1e-5;
- node cells, bearing shifts, origins, ``last_projected``, ``ref_poses`` and
  the ternary classes: exactly (the same float32 operations, and the seeds
  hold no yaw within 1e-4 bins of a rounding tie, which the tests count).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import state as jstate
from uzliti_slam_tpu.io import synthetic as jsynthetic
from uzliti_slam_tpu.mapping import occupancy as jocc
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.mapping import occupancy as tocc
from uzliti_slam_tpu_torch.ops import lie as tlie

CFG_J = jocc.GridConfig(size=128, resolution=0.1, max_range=6.0)
CFG_T = tocc.GridConfig(size=128, resolution=0.1, max_range=6.0)


def _to_port(g):
    return tstate.from_numpy({k: np.asarray(v) for k, v in g._asdict().items()}, device="cpu")


def _assert_grids_match(grid_t, grid_j):
    np.testing.assert_allclose(grid_t.logodds.numpy(), np.asarray(grid_j.logodds), atol=1e-4,
                               rtol=0)
    np.testing.assert_array_equal(grid_t.origin.numpy(), np.asarray(grid_j.origin))
    assert int(grid_t.last_projected) == int(grid_j.last_projected)
    np.testing.assert_array_equal(grid_t.ref_poses.numpy(), np.asarray(grid_j.ref_poses))


def _kbin_ties(poses: np.ndarray, bins: int) -> int:
    yaw = np.asarray(jlie.yaw_of(jlie.pose_q(jnp.asarray(poses))), np.float64)
    frac = np.abs(np.mod(yaw * bins / (2 * np.pi), 1.0) - 0.5)
    return int((frac < 1e-4).sum())


def graph_with_scan(pose_xyt=(0.0, 0.0, 0.0), wall_dist=2.0, bins=180):
    """tests/test_occupancy.py's one-node graph: a wall straight ahead
    within ±30°; the JAX graph, scans and scan_valid."""
    g = jstate.empty_graph(8, 8)
    p = jlie.pose2_to_pose(jnp.asarray(pose_xyt, jnp.float32))
    g, _ = jstate.add_node(g, p, p, jnp.asarray(0.0))
    ang = -np.pi + 2 * np.pi * (np.arange(bins) + 0.5) / bins
    ranges = np.full(bins, np.inf, np.float32)
    sel = np.abs(ang) < np.pi / 6
    ranges[sel] = wall_dist / np.cos(ang[sel])
    scans = np.zeros((8, bins), np.float32)
    scans[0] = ranges
    sv = np.zeros(8, bool)
    sv[0] = True
    return g, scans, sv


def _both(g, scans, sv, grid_j=None, grid_t=None, force_full=False):
    grid_j = jocc.grid_init(g, CFG_J) if grid_j is None else grid_j
    grid_t = tocc.grid_init(_to_port(g), CFG_T) if grid_t is None else grid_t
    out_j = jocc.project(grid_j, g, jnp.asarray(scans), jnp.asarray(sv), CFG_J,
                         force_full=force_full)
    out_t = tocc.project(grid_t, _to_port(g), torch.from_numpy(scans), torch.from_numpy(sv),
                         CFG_T, force_full=force_full)
    return out_j, out_t


def world_to_cell(grid, xy, res=0.1):
    ox, oy = (float(v) for v in grid.origin)
    return int(np.floor((xy[1] - oy) / res)), int(np.floor((xy[0] - ox) / res))


def test_wall_marked_occupied_path_free():
    out_j, out_t = _both(*graph_with_scan())
    _assert_grids_match(out_t, out_j)
    lo = out_t.logodds.numpy()
    assert lo[world_to_cell(out_t, (2.0, 0.0))] > 0.5
    assert lo[world_to_cell(out_t, (1.0, 0.0))] < -0.5
    assert lo[world_to_cell(out_t, (-2.0, 0.0))] == 0.0


def test_no_hit_ray_contributes_nothing():
    out_j, out_t = _both(*graph_with_scan())
    _assert_grids_match(out_t, out_j)
    lo = out_t.logodds.numpy()
    assert lo[world_to_cell(out_t, (0.0, 2.0))] == 0.0
    assert lo[world_to_cell(out_t, (-2.0, 0.0))] == 0.0


def test_incremental_skips_projected():
    g, scans, sv = graph_with_scan()
    g1_j, g1_t = _both(g, scans, sv)
    g2_j, g2_t = _both(g, scans, sv, grid_j=g1_j, grid_t=g1_t)
    _assert_grids_match(g2_t, g2_j)
    np.testing.assert_allclose(g2_t.logodds.numpy(), g1_t.logodds.numpy(), atol=1e-6)


def test_drift_triggers_rebuild():
    g, scans, sv = graph_with_scan()
    g1_j, g1_t = _both(g, scans, sv)
    g2 = g._replace(pose=g.pose.at[0, 1].add(1.5))
    g2_j, g2_t = _both(g2, scans, sv, grid_j=g1_j, grid_t=g1_t)
    _assert_grids_match(g2_t, g2_j)
    lo = g2_t.logodds.numpy()
    assert lo[world_to_cell(g2_t, (2.0, 1.5))] > 0.5
    assert lo[world_to_cell(g2_t, (2.0, 0.0))] <= 0.0


def test_probability_and_ternary():
    out_j, out_t = _both(*graph_with_scan())
    p = tocc.occupancy_probability(out_t).numpy()
    np.testing.assert_allclose(p, np.asarray(jocc.occupancy_probability(out_j)), atol=1e-6)
    t = tocc.to_ternary(out_t).numpy()
    np.testing.assert_array_equal(t, np.asarray(jocc.to_ternary(out_j)))
    assert t[world_to_cell(out_t, (2.0, 0.0))] == 100
    assert t[world_to_cell(out_t, (1.0, 0.0))] == 0
    assert t[world_to_cell(out_t, (-2.0, 0.0))] == -1


def test_rotated_node():
    out_j, out_t = _both(*graph_with_scan(pose_xyt=(0.0, 0.0, np.pi / 2)))
    _assert_grids_match(out_t, out_j)
    assert out_t.logodds.numpy()[world_to_cell(out_t, (0.0, 2.0))] > 0.5


def _scans(n: int, bins: int, seed: int) -> np.ndarray:
    """The JAX bench's scans, 2 + 3·U(0,1), drawn with numpy."""
    return (2.0 + 3.0 * np.random.default_rng(seed).random((n, bins))).astype(np.float32)


@pytest.fixture(scope="module")
def graph64():
    g, _ = jsynthetic.make_pose_graph(jax.random.PRNGKey(3), 64, loop_closure_every=8,
                                      radius=2.0)
    return g


def test_64_nodes_full_then_incremental_with_8_new_nodes(graph64):
    cfg_j, cfg_t = jocc.GridConfig(), tocc.GridConfig()
    g = graph64
    n = g.node_capacity
    assert _kbin_ties(np.asarray(g.pose), 360) == 0
    scans = _scans(n, 360, seed=0)
    sv = np.array(g.node_valid)
    slots = np.arange(n)
    # first tick: 56 nodes; second: 8 more, with their scans
    g56 = g._replace(num_nodes=jnp.asarray(56, jnp.int32),
                     node_valid=jnp.asarray(sv & (slots < 56)))
    grid_j = jocc.project(jocc.grid_init(g56, cfg_j), g56, jnp.asarray(scans),
                          jnp.asarray(sv & (slots < 56)), cfg_j)
    grid_t = tocc.project(tocc.grid_init(_to_port(g56), cfg_t), _to_port(g56),
                          torch.from_numpy(scans), torch.from_numpy(sv & (slots < 56)), cfg_t)
    _assert_grids_match(grid_t, grid_j)
    assert int(grid_t.last_projected) == 56
    inc_j = jocc.project(grid_j, g, jnp.asarray(scans), jnp.asarray(sv), cfg_j)
    inc_t = tocc.project(grid_t, _to_port(g), torch.from_numpy(scans), torch.from_numpy(sv),
                         cfg_t)
    _assert_grids_match(inc_t, inc_j)
    assert int(inc_t.last_projected) == 64
    # incremental: the origin stayed, and the grid changed only by 8 nodes' evidence
    np.testing.assert_array_equal(inc_t.origin.numpy(), grid_t.origin.numpy())
    assert not np.array_equal(inc_t.logodds.numpy(), grid_t.logodds.numpy())
    full_t = tocc.project(grid_t, _to_port(g), torch.from_numpy(scans), torch.from_numpy(sv),
                          cfg_t, force_full=True)
    assert not np.array_equal(full_t.logodds.numpy(), inc_t.logodds.numpy())


def test_project_rays_and_mark_node_cells_match_jax(graph64):
    cfg_j, cfg_t = jocc.GridConfig(), tocc.GridConfig()
    g = graph64
    scans = _scans(g.node_capacity, 360, seed=1)
    scans[::7, ::5] = np.inf                       # some rays without a return
    mask = np.array(g.node_valid) & (np.arange(g.node_capacity) % 3 != 0)
    origin = jocc.auto_origin(g, cfg_j)
    lo_j = jax.jit(lambda *a: jocc._project_rays(*a, cfg_j))(
        jnp.zeros((256, 256)), g.pose, jnp.asarray(scans), jnp.asarray(mask), origin)
    gt = _to_port(g)
    origin_t = tocc.auto_origin(gt, cfg_t)
    np.testing.assert_array_equal(origin_t.numpy(), np.asarray(origin))
    lo_t = tocc._project_rays(torch.zeros(256, 256), gt.pose, torch.from_numpy(scans),
                              torch.from_numpy(mask), origin_t, cfg_t)
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_j), atol=1e-4, rtol=0)
    assert (np.asarray(lo_j) > 0).sum() > 100 and (np.asarray(lo_j) < 0).sum() > 100
    mk_j = jax.jit(lambda *a: jocc._mark_node_cells(*a, cfg_j))(
        lo_j, g.pose, jnp.asarray(mask), origin)
    mk_t = tocc._mark_node_cells(lo_t, gt.pose, torch.from_numpy(mask), origin_t, cfg_t)
    np.testing.assert_allclose(mk_t.numpy(), np.asarray(mk_j), atol=1e-4, rtol=0)


def test_center_tables_equal_jax_exactly(monkeypatch):
    # the JAX projection builds its tables in numpy and hands them to
    # jnp.asarray: record what it hands over
    seen = []
    asarray = jocc.jnp.asarray

    def record(a, *args, **kw):
        if isinstance(a, np.ndarray):
            seen.append(a)
        return asarray(a, *args, **kw)

    monkeypatch.setattr(jocc.jnp, "asarray", record)
    g, scans, sv = graph_with_scan()
    jocc._project_rays(jnp.zeros((128, 128)), g.pose, jnp.asarray(scans), jnp.asarray(sv),
                       jnp.zeros(2), CFG_J)
    monkeypatch.undo()
    D_j, Wray_j, bin0_j = [a for a in seen if a.shape == (128 * 128,)]
    D, bin0, Wray = tocc.center_tables(128, 0.1, 180)
    for a, b in ((D, D_j), (bin0, bin0_j), (Wray, Wray_j)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_yaw_of_and_pose_distance_match_jax():
    rng = np.random.default_rng(5)
    a = jlie.se3_exp(jnp.asarray(rng.normal(size=(64, 6)).astype(np.float32)))
    b = jlie.se3_exp(jnp.asarray(rng.normal(size=(64, 6)).astype(np.float32)))
    at, bt = torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b))
    np.testing.assert_allclose(tlie.yaw_of(tlie.pose_q(at)).numpy(),
                               np.asarray(jlie.yaw_of(jlie.pose_q(a))), atol=1e-6)
    dt_j, dr_j = jlie.pose_distance(a, b)
    dt_t, dr_t = tlie.pose_distance(at, bt)
    np.testing.assert_allclose(dt_t.numpy(), np.asarray(dt_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dr_t.numpy(), np.asarray(dr_j), rtol=1e-5, atol=1e-6)
    # identical poses: the floored norms, not NaN
    dt0, dr0 = tlie.pose_distance(at, at)
    assert torch.isfinite(dt0).all() and torch.isfinite(dr0).all()


def test_grid_config_refuses_a_range_beyond_its_half_width():
    """The reference silently drops evidence beyond size·resolution/2
    (uzliti_slam_tpu/mapping/occupancy.py:116); the port raises instead.
    The defaults (6.0 m against 6.4 m) are accepted."""
    assert tocc.GridConfig().max_range == 6.0
    tocc.GridConfig(size=128, resolution=0.1, max_range=6.4)
    with pytest.raises(ValueError, match="half-width"):
        tocc.GridConfig(max_range=6.5)
    with pytest.raises(ValueError, match="half-width"):
        tocc.GridConfig(size=64, resolution=0.05)


# ---------------------------------------------------------------------------
# K11's packed table, its reach culling and its tiles
# ---------------------------------------------------------------------------

from uzliti_slam_tpu_torch.kernels import ops as kops  # noqa: E402


@pytest.mark.parametrize("size, res, bins", [(128, 0.1, 180), (255, 0.05, 360), (32, 0.1, 36)])
def test_packed_center_tables_hold_the_three_tables_bit_for_bit(size, res, bins):
    """K11's table, one 16-byte row a cell (D, bin0's int32 bits, Wray, 0):
    every entry of the three tables comes back exactly, odd sizes
    included."""
    D, bin0, Wray = tocc.center_tables(size, res, bins)
    table = kops.pack_center_tables(D, bin0, Wray)
    assert table.shape == (size * size, 4) and table.dtype == np.float32
    d, b, w = kops.unpack_center_tables(torch.from_numpy(table))
    np.testing.assert_array_equal(d.numpy(), D)
    np.testing.assert_array_equal(b.numpy(), bin0)          # bin0's int bits, read back
    np.testing.assert_array_equal(w.numpy(), Wray)
    assert not table[:, 3].any()
    cached = tocc._tables_on(size, res, bins, torch.device("cpu"))
    assert torch.equal(cached, torch.from_numpy(table))
    assert tocc._tables_on(size, res, bins, torch.device("cpu")) is cached


def _off_grid_case(seed=4, max_range=3.0):
    """The 64-node graph on a 128² grid of 5 cm (half-width 3.2 m) whose
    origin leaves a third of the nodes off the grid, ranges of 1-3.5 m (some
    beyond ``max_range``), a few rays without a return, yaws beyond ±π/2
    (kbin taken mod B)."""
    g, _ = jsynthetic.make_pose_graph(jax.random.PRNGKey(seed), 64, loop_closure_every=8,
                                      radius=2.0)
    cfg_j = jocc.GridConfig(size=128, resolution=0.05, max_range=max_range)
    cfg_t = tocc.GridConfig(size=128, resolution=0.05, max_range=max_range)
    scans = np.random.default_rng(seed).uniform(1.0, 3.5, (g.node_capacity, 360))
    scans = scans.astype(np.float32)
    scans[::5, ::7] = np.inf
    mask = np.array(g.node_valid)
    origin = np.asarray(jocc.auto_origin(g, cfg_j)) + np.array([1.5, -1.0], np.float32)
    return g, cfg_j, cfg_t, scans, mask, origin


def test_culled_projection_matches_jax_with_reach_leaving_the_grid():
    g, cfg_j, cfg_t, scans, mask, origin = _off_grid_case()
    lo_j = jax.jit(lambda *a: jocc._project_rays(*a, cfg_j))(
        jnp.zeros((128, 128)), g.pose, jnp.asarray(scans), jnp.asarray(mask),
        jnp.asarray(origin))
    gt = _to_port(g)
    args = tocc._rays_args(torch.zeros(128, 128), gt.pose, torch.from_numpy(scans),
                           torch.from_numpy(mask), torch.from_numpy(origin), cfg_t, False)
    cx, cy, kbin = args[1].numpy(), args[2].numpy(), args[3].numpy()
    off = (cx < 0) | (cx >= 128) | (cy < 0) | (cy >= 128)
    R = kops.project_reach(cfg_t.resolution, cfg_t.max_range)
    leaves = ~off & ((cx < R) | (cx >= 128 - R) | (cy < R) | (cy >= 128 - R))
    assert off[mask].sum() >= 10 and leaves[mask].sum() >= 10     # both kinds of node
    assert ((kbin >= 0) & (kbin < 360)).all() and kbin.max() > 180
    lo_t = kops.project_rays(*args)
    np.testing.assert_allclose(lo_t.numpy(), np.asarray(lo_j), atol=1e-4, rtol=0)
    assert (np.asarray(lo_j) > 0).sum() > 100 and (np.asarray(lo_j) < 0).sum() > 100


def test_culling_drops_only_zero_terms():
    """The plain version visits only the cells within ``project_reach`` of a
    node; with the reach widened past the grid it visits every cell, and the
    sums are the same bit for bit (the dropped terms are exactly 0)."""
    g, _, cfg_t, scans, mask, origin = _off_grid_case(seed=5)
    gt = _to_port(g)
    args = tocc._rays_args(torch.zeros(128, 128), gt.pose, torch.from_numpy(scans),
                           torch.from_numpy(mask), torch.from_numpy(origin), cfg_t, True)
    culled, mag = kops.project_rays_plain(*args)
    reach = kops.project_reach
    try:
        kops.project_reach = lambda res, max_range: 10_000
        full, mag_full = kops.project_rays_plain(*args)
    finally:
        kops.project_reach = reach
    assert torch.equal(culled, full) and torch.equal(mag, mag_full)
    assert kops.project_reach(0.05, 3.0) == 62 and kops.project_reach(0.05, 6.0) == 122


def test_tiles_keep_every_node_that_reaches_them():
    """K11's tiling replayed: a 16 x 16 tile keeps the nodes whose reach box
    meets it (``csrc/occupancy.cu``); the tile's cells from those nodes alone
    equal the projection of all nodes, and an incremental pass of 8 nodes
    keeps nodes in fewer tiles than a rebuild (a 1 m range: a reach of 22
    cells)."""
    g, _, cfg_t, scans, mask, origin = _off_grid_case(seed=6, max_range=1.0)
    gt = _to_port(g)
    args = list(tocc._rays_args(torch.zeros(128, 128), gt.pose, torch.from_numpy(scans),
                                torch.from_numpy(mask), torch.from_numpy(origin), cfg_t, True))
    ref, _ = kops.project_rays_plain(*args)
    cx, cy, idx, count = args[1], args[2], args[5], int(args[6])
    nodes = idx[:count]
    R = kops.project_reach(cfg_t.resolution, cfg_t.max_range)

    def kept(tr0, tc0, nd):
        x, y = cx[nd], cy[nd]
        return nd[(x + R >= tc0) & (x - R < tc0 + 16) & (y + R >= tr0) & (y - R < tr0 + 16)]

    for tr0 in range(0, 128, 16):
        for tc0 in range(0, 128, 16):
            keep = kept(tr0, tc0, nodes)
            part = list(args)
            part[5] = torch.cat([keep, torch.zeros(len(idx) - len(keep), dtype=torch.int32)])
            part[6] = torch.tensor(len(keep), dtype=torch.int32)
            part[-1] = False            # the marks: only nodes whose cell is in the tile
            tile, _ = kops.project_rays_plain(*part)
            tile = kops.mark_cells_plain(
                tile, cx, cy, torch.zeros(len(cx), dtype=torch.bool).index_fill_(
                    0, nodes.long(), True), 2.0 * cfg_t.miss_logodds, cfg_t.clamp)
            np.testing.assert_allclose(tile[tr0:tr0 + 16, tc0:tc0 + 16].numpy(),
                                       ref[tr0:tr0 + 16, tc0:tc0 + 16].numpy(), atol=1e-6,
                                       rtol=0)
    tiles = [(r, c) for r in range(0, 128, 16) for c in range(0, 128, 16)]
    full = sum(len(kept(r, c, nodes)) > 0 for r, c in tiles)
    inc = sum(len(kept(r, c, nodes[-8:])) > 0 for r, c in tiles)
    assert inc < full
