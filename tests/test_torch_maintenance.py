"""The maintenance timers of the port's pipeline against JAX's, on the CPU.

``maintenance_epoch`` (node merging in the global role, with the banks
merged into the kept nodes; eviction in the local role), ``compact_state``,
``scan_reregistration`` and the ``Slam`` shell's ``maintain`` (the
compaction trigger) and ``add_gps``.  The state is JAX's ``Slam`` run on
``tests/test_maintenance.py``'s sequence (96x128, 20 frames), carried over
with ``state_from_numpy``; JAX's jitted steps donate their state, so each
gets a copy.  Held, with their reasons:

- counts, validity masks, edge endpoints and types, descriptors, the
  compaction permutation and every index field: exactly (discrete; the
  merge pairs as tests/test_torch_lifecycle.py);
- points and poses within 1e-5 (the same float32 formulas of the lie ops,
  contracted on one side);
- merged scans within one 21-bit quantum: their points come from sines and
  cosines of both packages, and a range an ulp from a quantisation step
  moves by one step;
- re-registered laser edges' transforms within 1e-4 (20 ICP Gauss-Newton
  steps, as tests/test_torch_icp.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_maintenance as jmaint
import torch

from uzliti_slam_tpu import pipeline as jpipe
from uzliti_slam_tpu.config import ScopeConfig as JScope
from uzliti_slam_tpu.config import SlamConfig as JCfg
from uzliti_slam_tpu.graph import state as jstate
from uzliti_slam_tpu_torch import pipeline as tpipe
from uzliti_slam_tpu_torch.config import EdgeEstimationConfig as TEst
from uzliti_slam_tpu_torch.config import KeyframeConfig as TKf
from uzliti_slam_tpu_torch.config import ScopeConfig as TScope
from uzliti_slam_tpu_torch.config import SlamConfig as TCfg
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import synthetic as tsyn
from uzliti_slam_tpu_torch.ops import scan as tscan

BASE = jmaint.BASE
T_BASE = TCfg(node_capacity=64, edge_capacity=256, feats_per_node=96, scan_bins=180,
              keyframe=TKf(new_node_distance=0.25),
              estimation=TEst(min_consensus=10, min_matching_score=8.0))
SCALE = tscan.range_scale(6.0)
FAR = np.array([100.0, 0, 0, 1.0, 0, 0, 0], np.float32)
MERGE = dict(merge_nodes=True, scope_size_min=0.5, merge_margin=0.0, merge_dist=0.3,
             merge_angle_deg=20.0)
EVICT = dict(is_sub_graph=True, scope_size_min=1.0, eviction_margin=0.5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(st) -> dict:
    """The fields of a JAX SlamState as ``state_from_numpy`` takes them."""
    out = {k: np.asarray(getattr(st, k)) for k in (
        "scans", "scan_valid", "desc", "desc_valid", "points", "last_kf_odom", "n_keyframes",
        "last_kf_slot")}
    out["graph"] = {k: np.asarray(v) for k, v in st.graph._asdict().items()}
    out["gist"] = {k: np.asarray(v) for k, v in st.gist._asdict().items()}
    out["tunables"] = {k: float(v) for k, v in st.tunables._asdict().items()}
    return out


def _copy(st):
    return jax.tree.map(jnp.copy, st)


def _port(st, cfg):
    return tpipe.state_from_numpy(_arrays(st), device="cpu", config=cfg)


def _assert_graph(gt, gj, atol=1e-5):
    for name, ref in gj._asdict().items():
        got, ref = getattr(gt, name).numpy(), np.asarray(ref)
        if ref.dtype.kind in "biu":
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, atol=atol, err_msg=name)


def _assert_banks(st, sj, scans_exact=False):
    for name in ("desc", "desc_valid", "scan_valid", "last_kf_slot"):
        np.testing.assert_array_equal(getattr(st, name).numpy(), np.asarray(getattr(sj, name)),
                                      err_msg=name)
    for name in ("desc", "stamp", "valid"):
        np.testing.assert_array_equal(getattr(st.gist, name).numpy(),
                                      np.asarray(getattr(sj.gist, name)), err_msg=name)
    np.testing.assert_allclose(st.points.numpy(), np.asarray(sj.points), atol=1e-5)
    got, ref = st.scans.numpy(), np.asarray(sj.scans)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    # in 21-bit quanta: a range is q · fl(1/scale)
    quanta = np.abs(np.round(got[fin] * SCALE) - np.round(ref[fin] * SCALE))
    assert quanta.max(initial=0) <= (0 if scans_exact else 1)


@pytest.fixture(scope="module")
def jax_slam():
    """JAX's Slam on tests/test_maintenance.py's sequence (20 frames)."""
    return jmaint.run_slam(BASE)


@pytest.mark.parametrize("role", ["global", "local"])
def test_maintenance_epoch_matches_jax(jax_slam, role):
    scope = MERGE if role == "global" else EVICT
    jcfg = dataclasses.replace(BASE, scope=JScope(**scope))
    tcfg = dataclasses.replace(T_BASE, scope=TScope(**scope))
    center = FAR if role == "global" else None
    st = _port(jax_slam.state, tcfg)
    sj, info_j = jpipe.maintenance_epoch(_copy(jax_slam.state), jcfg,
                                         center=None if center is None else jnp.asarray(center))
    got, info = tpipe.maintenance_epoch(st, tcfg, center=center)
    assert {k: int(v) for k, v in info.items()} == {k: int(v) for k, v in info_j.items()}
    assert int(info["merged" if role == "global" else "evicted"]) > 0
    _assert_graph(got.graph, sj.graph)
    _assert_banks(got, sj)
    # compaction of the result, every field and the permutation exactly
    cj, perm_j = jpipe.compact_state(_copy(sj))
    ct, perm = tpipe.compact_state(got)
    _assert_graph(ct.graph, cj.graph)
    _assert_banks(ct, cj)
    for name, ref in perm_j.items():
        np.testing.assert_array_equal(perm[name].numpy(), np.asarray(ref), err_msg=name)
    assert int(ct.graph.num_nodes) == int(got.graph.node_valid.sum())


def test_merge_banks_two_nodes_matches_jax():
    """tests/test_maintenance.py's two-node merge: the kept node's scan
    holds both nodes' hits, its descriptor slots are backfilled."""
    _, jcfg, st_j, a, b = jmaint.TestMergeSensorData()._two_node_state()
    tcfg = TCfg(node_capacity=16, edge_capacity=64, feats_per_node=8, scan_bins=8,
                scope=TScope(merge_nodes=True, scope_size_min=0.5, merge_margin=0.0,
                             merge_dist=0.3))
    st = _port(st_j, tcfg)
    sj, info_j = jpipe.maintenance_epoch(_copy(st_j), jcfg)
    got, info = tpipe.maintenance_epoch(st, tcfg)
    assert int(info["merged"]) == int(info_j["merged"]) == 1
    _assert_graph(got.graph, sj.graph)
    _assert_banks(got, sj)
    assert bool(got.graph.node_valid[a]) and not bool(got.graph.node_valid[b])
    assert int(got.desc_valid[a].sum()) == 8 and int(torch.isfinite(got.scans[a]).sum()) >= 2


def test_scan_reregistration_matches_jax(jax_slam):
    st = _port(jax_slam.state, T_BASE)
    ne = int(st.graph.num_edges)
    sj, n_j = jpipe.scan_reregistration(_copy(jax_slam.state), BASE)
    got, n = tpipe.scan_reregistration(st, T_BASE)
    assert int(n) == int(n_j) >= 1
    gt, gj = got.graph, sj.graph
    assert int(gt.num_edges) == int(gj.num_edges) == ne + int(n)
    for name in ("e_from", "e_to", "e_type", "e_valid"):
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)),
                                      err_msg=name)
    np.testing.assert_allclose(gt.e_transform.numpy(), np.asarray(gj.e_transform), atol=1e-4)
    new = slice(ne, ne + int(n))
    assert (gt.e_type[new] == tstate.EDGE_TYPE_2D_LASER).all() and not gt.e_valid[new].any()
    # a second call finds the pairs joined: nothing is added twice
    again, n2 = tpipe.scan_reregistration(got, T_BASE)
    _, n2_j = jpipe.scan_reregistration(_copy(sj), BASE)
    assert int(n2) == int(n2_j)


def _circle_states(n_nodes: int):
    """A JAX and a port state (64 node slots) holding an n-node circle graph
    with the newest keyframe at slot n - 1, and the local role's configs."""
    scope = dict(is_sub_graph=True, scope_size_min=2.0)
    jcfg = JCfg(node_capacity=64, edge_capacity=128, feats_per_node=16, scan_bins=16,
                scope=JScope(**scope))
    tcfg = TCfg(node_capacity=64, edge_capacity=128, feats_per_node=16, scan_bins=16,
                scope=TScope(**scope))
    g, _ = tsyn.make_pose_graph(n_nodes, radius=10.0, loop_closure_every=9, node_capacity=64,
                                edge_capacity=128, generator=torch.Generator().manual_seed(1),
                                device="cpu")
    st_j = jpipe.init_state(jcfg)._replace(
        graph=jstate.GraphState(**{k: jnp.asarray(v) for k, v in tstate.to_numpy(g).items()}),
        last_kf_slot=jnp.asarray(n_nodes - 1, jnp.int32))
    return jcfg, tcfg, st_j


@pytest.mark.parametrize("n_nodes, compacts", [(64, True), (40, False)])
def test_slam_maintain_compaction_trigger_matches_jax(n_nodes, compacts):
    jcfg, tcfg, st_j = _circle_states(n_nodes)
    jslam = jpipe.Slam(jcfg)
    jslam.state = _copy(st_j)
    slam = tpipe.Slam(tcfg, device="cpu")
    slam.state = _port(st_j, tcfg)
    slam.grid = slam.project_map()
    info_j = jslam.maintain()
    info = slam.maintain()
    assert int(info["evicted"]) == int(info_j["evicted"]) > 0
    assert (info["compact_perm"] is not None) == (info_j["compact_perm"] is not None) == compacts
    if compacts:
        for name, ref in info_j["compact_perm"].items():
            np.testing.assert_array_equal(info["compact_perm"][name].numpy(), np.asarray(ref))
        assert slam.grid is None
    assert slam._n_slots_host == jslam._n_slots_host
    _assert_graph(slam.state.graph, jslam.state.graph)
    _assert_banks(slam.state, jslam.state, scans_exact=True)


def test_slam_add_gps_matches_jax(jax_slam):
    jslam = jpipe.Slam(BASE)
    jslam.state = _copy(jax_slam.state)
    jslam._n_slots_host = int(jax_slam.state.graph.num_nodes)
    slam = tpipe.Slam(T_BASE, device="cpu")
    slam.state = _port(jax_slam.state, T_BASE)
    slam._n_slots_host = jslam._n_slots_host
    for xyz, sigma in (([1.0, 2.0, 0.5], 2.0), ([1.5, 2.0, 0.4], 0.5)):
        assert slam.add_gps(xyz, sigma) == jslam.add_gps(xyz, sigma) is True
    _assert_graph(slam.state.graph, jslam.state.graph)
    assert slam._n_slots_host == jslam._n_slots_host
    g = slam.state.graph
    anchor = int(g.num_nodes) - 1
    assert int(g.node_uid[anchor]) == tstate.GPS_ANCHOR_UID and bool(g.node_fixed[anchor])
    gps = (g.e_type == tstate.EDGE_TYPE_3D_GPS).nonzero().flatten()
    assert gps.numel() == 2 and (g.e_from[gps] == anchor).all()
    # the anchor is never evicted
    evict = tpipe.maintenance_epoch(slam.state, dataclasses.replace(
        T_BASE, scope=TScope(is_sub_graph=True, scope_size_min=0.1, eviction_margin=0.0)))[0]
    assert bool(evict.graph.node_valid[anchor])
    assert tpipe.Slam(T_BASE, device="cpu").add_gps([0.0, 0.0, 0.0]) is False
