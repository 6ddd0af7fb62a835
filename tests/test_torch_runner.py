"""The port's local/global runner against JAX's, on the CPU.

``runner.py`` and ``pipeline.recognize_absorbed`` of both packages, on
tests/test_runner.py's duo (a 96x128 WallWorld out-and-back drive, 24
frames, an exchange every 6 frames and 4 drain rounds) run through the
port's ``LocalGlobalSlam`` on the CPU:

- ``recognize_absorbed`` against JAX's with JAX's RANSAC draws injected
  (its key split once per slot, then once per candidate; the triplets
  recomputed from its state), with "gist" and "feature_set", over the
  duo's global map with its loop-closure edges taken out, every node
  absorbed at once: nodes of the outbound and the return leg find each
  other, and the slots' order decides which of the two adds the edge;
- one exchange (``local_make_request``, ``global_exchange_step`` without
  the optimization, ``local_apply_response``) from the duo's states just
  before its fourth exchange, carried into JAX's ``LocalGlobalSlam``, with
  JAX's draws injected: the same ACK, reply, global graph, ship masks,
  evictions and counts;
- twins of tests/test_runner.py's 8 tests on the port's duo.

Held, with their reasons: every index, flag, uid, type and count exactly;
copied poses exactly; the proposed edges' transforms within 1e-4 and
information within 1e-3 of its largest entry (RANSAC's refit, an SVD of
the same float32 covariance, as ``test_torch_ransac.py``); merged poses
within 1e-5 (``test_torch_lifecycle.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu import pipeline as jpipe
from uzliti_slam_tpu import runner as jrunner
from uzliti_slam_tpu.config import EdgeEstimationConfig as JEst
from uzliti_slam_tpu.config import KeyframeConfig as JKf
from uzliti_slam_tpu.config import PlaceRecognitionConfig as JRec
from uzliti_slam_tpu.config import ScopeConfig as JScope
from uzliti_slam_tpu.config import SlamConfig as JCfg
from uzliti_slam_tpu.graph import state as jstate
from uzliti_slam_tpu.io import simulator as jsim
from uzliti_slam_tpu.ops import matching as jmatch
from uzliti_slam_tpu.ops import ransac as jransac
from uzliti_slam_tpu.parallel import scope as jscope
from uzliti_slam_tpu.recognition import recognizer as jrec
from uzliti_slam_tpu_torch import pipeline as tpipe
from uzliti_slam_tpu_torch import runner as trunner
from uzliti_slam_tpu_torch.config import EdgeEstimationConfig as TEst
from uzliti_slam_tpu_torch.config import KeyframeConfig as TKf
from uzliti_slam_tpu_torch.config import PlaceRecognitionConfig as TRec
from uzliti_slam_tpu_torch.config import ScopeConfig as TScope
from uzliti_slam_tpu_torch.config import SlamConfig as TCfg
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import simulator as tsim
from uzliti_slam_tpu_torch.io import synthetic as tsyn
from uzliti_slam_tpu_torch.parallel import scope as tscope

SHAPE = dict(node_capacity=64, edge_capacity=256, feats_per_node=64, scan_bins=90)
GATES = {"gist": {}, "feature_set": dict(min_descriptors=20, min_similarity=0.15)}
SNAPSHOT_AT = 23          # the frame whose exchange the parity test replays
INDEX_FIELDS = ("node_valid", "node_fixed", "merged_into", "node_uid", "e_from", "e_to",
                "e_type", "e_valid", "num_nodes", "num_edges")
BANK_FIELDS = ("scans", "scan_valid", "desc", "desc_valid", "points", "last_kf_odom",
               "n_keyframes", "last_kf_slot")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(method="gist", **caps):
    kw = dict(SHAPE, **caps)
    jcfg = JCfg(**kw, keyframe=JKf(new_node_distance=0.25),
                estimation=JEst(min_consensus=8, min_matching_score=6.0),
                scope=JScope(scope_size_min=2.0, eviction_margin=0.5),
                recognition=JRec(method=method, **GATES[method]))
    tcfg = TCfg(**kw, keyframe=TKf(new_node_distance=0.25),
                estimation=TEst(min_consensus=8, min_matching_score=6.0),
                scope=TScope(scope_size_min=2.0, eviction_margin=0.5),
                recognition=TRec(method=method, **GATES[method]))
    return jcfg, tcfg


def state_arrays(st) -> dict:
    """A port SlamState's fields as numpy arrays (``state_from_numpy``'s
    form)."""
    out = {k: getattr(st, k).cpu().numpy() for k in BANK_FIELDS}
    out["graph"] = tstate.to_numpy(st.graph)
    out["gist"] = {k: v.cpu().numpy() for k, v in st.gist._asdict().items()}
    return out


def jax_state(arrays, jcfg):
    st = jpipe.init_state(jcfg)
    return st._replace(
        graph=jstate.GraphState(**{k: jnp.asarray(v) for k, v in arrays["graph"].items()}),
        gist=jrec.GistBank(**{k: jnp.asarray(v) for k, v in arrays["gist"].items()}),
        **{k: jnp.asarray(arrays[k]) for k in BANK_FIELDS})


def port_state(arrays, tcfg):
    return tpipe.state_from_numpy(arrays, device="cpu", config=tcfg)


def duo_configs(arrays_local, arrays_global, method="gist"):
    """The JAX and port configs of the two roles at the snapshot's
    capacities."""
    def caps(a):
        g = a["graph"]
        return dict(node_capacity=g["pose"].shape[0], edge_capacity=g["e_from"].shape[0])
    return configs(method, **caps(arrays_local)), configs(method, **caps(arrays_global))


def jax_absorb_triplets(st, slots, cfg) -> np.ndarray:
    """The RANSAC triplets JAX's ``recognize_absorbed`` draws, recomputed
    from its state (``pipeline.py:715-786``): the state's key split once
    per slot, the slot's key once per candidate, ``_valid_sample(key, H,
    ok_m, quality=-dist)`` on the candidate's matches."""
    tn, rc, ec = st.tunables, cfg.recognition, cfg.estimation
    g = st.graph
    prng, out = st.prng, []
    for slot in np.asarray(slots):
        prng, k_ransac = jax.random.split(prng)
        s = max(int(slot), 0)
        if rc.method == "gist":
            pr_slots, _, _ = jrec.gist_query(st.gist, st.gist.desc[s], g.stamp[s],
                                             k=rc.k_candidates, max_dist=tn.gist_max_dist,
                                             min_dt=tn.min_time_separation)
        else:
            fbank = jrec.FeatureSetBank(
                desc=st.desc, desc_valid=st.desc_valid & g.node_valid[:, None], stamp=g.stamp,
                valid=g.node_valid & (jnp.sum(st.desc_valid, axis=-1) >= tn.min_descriptors))
            pr_slots, _, _ = jrec.feature_set_query(
                fbank, st.desc[s], st.desc_valid[s], g.stamp[s], k=rc.k_candidates,
                hamming_thresh=tn.feature_hamming_thresh, min_similarity=tn.min_similarity,
                min_dt=tn.min_time_separation)
        keys = jax.random.split(k_ransac, rc.k_candidates)
        bits = jmatch.unpack_bits(st.desc[s])
        tri = []
        for c, cand in enumerate(np.asarray(pr_slots)):
            cs = max(int(cand), 0)
            _, ok_m, dist = jmatch.match_descriptors(
                bits, jmatch.unpack_bits(st.desc[cs]), valid_a=st.desc_valid[s],
                valid_b=st.desc_valid[cs], ratio=tn.match_ratio, max_dist=tn.max_match_distance)
            tri.append(np.asarray(jransac._valid_sample(keys[c], ec.ransac_hypotheses, ok_m,
                                                        quality=-dist)))
        out.append(np.stack(tri))
    return np.stack(out)


def assert_graph_close(tg, jg, rows_with_refit=None):
    """Index fields exactly; poses within 1e-5 (merges); edge transforms and
    information exactly, except the rows in ``rows_with_refit`` (proposed
    closures: RANSAC's refit) within 1e-4 / 1e-3 of the largest entry."""
    got = tstate.to_numpy(tg)
    ref = {k: np.asarray(v) for k, v in jg._asdict().items()}
    for k in INDEX_FIELDS:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    for k in ("pose", "odom_pose", "stamp", "uncertainty"):
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)
    refit = np.zeros(got["e_from"].shape[0], bool)
    if rows_with_refit is not None:
        refit[rows_with_refit] = True
    for k in ("e_transform", "e_info", "e_score"):
        np.testing.assert_array_equal(got[k][~refit], ref[k][~refit], err_msg=k)
    np.testing.assert_allclose(got["e_transform"][refit], ref["e_transform"][refit], atol=1e-4)
    scale = max(np.abs(ref["e_info"][refit]).max(initial=0.0), 1.0)
    np.testing.assert_allclose(got["e_info"][refit], ref["e_info"][refit], atol=1e-3 * scale)
    np.testing.assert_array_equal(got["e_score"][refit], ref["e_score"][refit])


def strip_closures(arrays) -> dict:
    """The state's graph with its loop-closure edges (3D_FULL) taken out:
    the remaining rows moved to the front in order."""
    out = dict(arrays)
    g = dict(arrays["graph"])
    ne = int(g["num_edges"])
    keep = np.nonzero(g["e_type"][:ne] != tstate.EDGE_TYPE_3D_FULL)[0]
    for k in ("e_from", "e_to", "e_transform", "e_info", "e_type", "e_valid", "e_error",
              "e_age", "e_score"):
        col = np.zeros_like(g[k])
        col[:keep.size] = g[k][keep]
        g[k] = col
    g["e_transform"][keep.size:, 3] = 1.0
    g["num_edges"] = np.asarray(keep.size, np.int32)
    out["graph"] = g
    return out


def _frames():
    world = tsim.WallWorld(img_h=96, img_w=128)
    return world, tsim.simulate_sequence(world, n_frames=24, odom_drift=0.05, length=5.0)


@pytest.fixture(scope="module")
def duo_run():
    """tests/test_runner.py's duo through the port on the CPU, with a
    snapshot of both instances just before the exchange at frame 23."""
    _, tcfg = configs()
    world, frames = _frames()
    duo = trunner.LocalGlobalSlam(tcfg, cam=world.cam, cam_pose=tsim.cam_extrinsic(device="cpu"),
                                  device="cpu")
    duo.local.optimize_every = 10 ** 9
    evicted = proposed = 0
    snapshot = None
    for i, fr in enumerate(frames):
        duo.add_frame(fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"])
        if (i + 1) % 6 == 0:
            if i == SNAPSHOT_AT:
                snapshot = dict(local=state_arrays(duo.local.state),
                                glob=state_arrays(duo.global_slam.state),
                                ship=tscope.to_numpy(duo.ship))
            ex = duo.exchange()
            evicted += ex["evicted_local"]
            proposed += ex["proposed_global"]
    for _ in range(4):
        ex = duo.exchange()
        evicted += ex["evicted_local"]
        proposed += ex["proposed_global"]
    return duo, frames, evicted, proposed, snapshot


# ---------------------------------------------------------------------------
# recognize_absorbed and one exchange against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["gist", "feature_set"])
def test_recognize_absorbed_matches_jax(duo_run, method):
    duo = duo_run[0]
    arrays = strip_closures(state_arrays(duo.global_slam.state))
    jcfg, tcfg = configs(method, node_capacity=arrays["graph"]["pose"].shape[0],
                         edge_capacity=arrays["graph"]["e_from"].shape[0])
    live = np.nonzero(arrays["graph"]["node_valid"])[0]
    slots = np.full(32, -1, np.int32)
    slots[:live.size] = live
    mask = slots >= 0
    jst = jax_state(arrays, jcfg)
    tri = jax_absorb_triplets(jst, slots, jcfg)
    jpost, jn = jpipe.recognize_absorbed(jax.tree.map(jnp.copy, jst), jnp.asarray(slots),
                                         jnp.asarray(mask), jcfg)
    tpost, tn, info = tpipe.recognize_absorbed(port_state(arrays, tcfg), torch.from_numpy(slots),
                                               torch.from_numpy(mask), tcfg,
                                               tri=torch.from_numpy(tri))
    assert int(tn) == int(jn) > 0
    assert torch.equal(info["tri"], torch.from_numpy(tri).to(torch.int32))
    ne0 = int(arrays["graph"]["num_edges"])
    assert_graph_close(tpost.graph, jpost.graph, np.arange(ne0, ne0 + int(tn)))
    # each pair is proposed once, though both of its nodes were absorbed:
    # some edge (c -> s) added for slot s has a slot c that, absorbed
    # alone, proposes the same pair; in order, s's edge masks it
    ne = int(tpost.graph.num_edges)
    edges = list(zip(tpost.graph.e_from[ne0:ne].tolist(), tpost.graph.e_to[ne0:ne].tolist()))
    assert len({tuple(sorted(e)) for e in edges}) == len(edges)

    def finds(c, target):
        post, n, _ = tpipe.recognize_absorbed(port_state(arrays, tcfg), torch.tensor([c]),
                                              torch.tensor([True]), tcfg)
        return {int(post.graph.e_from[ne0 + i]) for i in range(int(n))} >= {target}

    assert any(finds(c, target) for c, target in edges)


def jax_delta_without_gist_overwrite(gst, jdelta):
    """The port keeps a live node's GIST when a boundary anchor (a row with
    no descriptors) is re-shipped, where JAX's absorb overwrites it with the
    anchor's empty row (``test_reshipped_anchor_keeps_the_global_gist``).
    Hand JAX the global's own rows there, so that its overwrite writes what
    the bank holds; the round must re-ship such an anchor."""
    slots = np.asarray(jscope.uid_to_slot(gst.graph, jdelta.n_uid))
    anchor = ((slots >= 0) & ~np.asarray(jdelta.n_desc_valid).any(-1)
              & np.asarray(gst.gist.valid)[slots.clip(0)])
    assert anchor.any()
    n_gist = np.asarray(jdelta.n_gist).copy()
    n_gist[anchor] = np.asarray(gst.gist.desc)[slots[anchor]]
    return jdelta._replace(n_gist=jnp.asarray(n_gist))


def test_reshipped_anchor_keeps_the_global_gist(duo_run):
    """A local re-ships the boundary anchors a scope reply gave it, with
    empty banks.  JAX's absorb guards the descriptors, points and scans
    ("empty payloads never clobber", ``runner.py:86-102``) but writes the
    anchor's GIST row over the live node's, so the global's recognizer no
    longer finds the place on a revisit (ROADMAP C4).  The port writes the
    GIST only with the descriptors, or into a slot without one: every other
    bank and the graph equal JAX's."""
    snap = duo_run[4]
    (_, _), (jcfg, tcfg) = duo_configs(snap["local"], snap["glob"])
    jcfg, tcfg = jrunner.global_config(jcfg), trunner.global_config(tcfg)
    jst, tst = jax_state(snap["glob"], jcfg), port_state(snap["glob"], tcfg)
    g = snap["glob"]["graph"]
    live = np.nonzero(g["node_valid"])[0]
    rng = np.random.default_rng(3)
    arrays = {k: np.array(v) for k, v in jscope.make_delta(
        jst.graph, jscope.ship_state_init(jst.graph), jst.gist.desc, max_nodes=8, max_edges=8,
        desc=jst.desc, desc_valid=jst.desc_valid, points=jst.points, scans=jst.scans,
        scan_valid=jst.scan_valid)._asdict().items() if v is not None}
    arrays["n_desc_valid"][:3] = False                 # rows 0-2: anchors, empty banks
    arrays["n_gist"][:3] = rng.integers(0, 256, (3, 32), dtype=np.uint8)
    jd = jscope.GraphDelta(**{k: jnp.asarray(v) for k, v in arrays.items()})
    td = tscope.delta_from_numpy(arrays, "cpu")
    jpost, jslots, jfresh = jrunner._absorb_payloads_jit(jst, jd)
    tpost, tslots, tfresh = trunner._absorb_payloads(tst, td)
    np.testing.assert_array_equal(tslots.numpy(), np.asarray(jslots))
    np.testing.assert_array_equal(tfresh.numpy(), np.asarray(jfresh))
    anchors = arrays["n_uid"][:3]
    assert set(anchors) <= set(g["node_uid"][live])
    s = np.asarray(jslots)[:3]
    np.testing.assert_array_equal(np.asarray(jpost.gist.desc)[s], arrays["n_gist"][:3])
    np.testing.assert_array_equal(tpost.gist.desc[s].numpy(), snap["glob"]["gist"]["desc"][s])
    rest = np.ones(g["pose"].shape[0], bool)
    rest[s] = False
    np.testing.assert_array_equal(tpost.gist.desc.numpy()[rest], np.asarray(jpost.gist.desc)[rest])
    for k in ("desc", "desc_valid", "points", "scans", "scan_valid"):
        np.testing.assert_array_equal(getattr(tpost, k).numpy(), np.asarray(getattr(jpost, k)),
                                      err_msg=k)


def test_exchange_matches_jax(duo_run):
    """One protocol round from the duo's states before its fourth
    exchange, on both packages, without the global's optimization."""
    snap = duo_run[4]
    (jl_cfg, tl_cfg), (jg_cfg, tg_cfg) = duo_configs(snap["local"], snap["glob"])
    cam_pose = jsim.cam_extrinsic()
    jduo = jrunner.LocalGlobalSlam(jl_cfg, cam_pose=cam_pose)
    jduo.local.config = jrunner.local_config(jl_cfg)
    jduo.global_slam.config = jrunner.global_config(jg_cfg)
    jduo.local.state = jax_state(snap["local"], jduo.local.config)
    jduo.global_slam.state = jax_state(snap["glob"], jduo.global_slam.config)
    jduo.ship = jscope.ShipState(**{k: jnp.asarray(v) for k, v in snap["ship"].items()})
    gg = jduo.global_slam.state.graph
    live = np.nonzero(np.asarray(gg.node_valid))[0].astype(np.int32)
    jduo.guid_map.insert_batch(np.asarray(gg.node_uid)[live], live)

    tduo = trunner.LocalGlobalSlam(tl_cfg, cam_pose=tsim.cam_extrinsic(device="cpu"),
                                   device="cpu")
    tduo.local.config = trunner.local_config(tl_cfg)
    tduo.global_slam.config = trunner.global_config(tg_cfg)
    tduo.local.state = port_state(snap["local"], tduo.local.config)
    tduo.global_slam.state = port_state(snap["glob"], tduo.global_slam.config)
    tduo.ship = tscope.ship_from_numpy(snap["ship"], "cpu")

    jdelta, jrobot, jradius = jduo.local_make_request()
    tdelta, trobot, tradius = tduo.local_make_request()
    for k, v in jdelta._asdict().items():
        if k != "sensor_transforms":
            np.testing.assert_array_equal(tscope.to_numpy(tdelta)[k], np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(trobot.numpy(), np.asarray(jrobot))
    np.testing.assert_array_equal(tradius.numpy(), np.asarray(jradius))
    jdelta = jax_delta_without_gist_overwrite(jduo.global_slam.state, jdelta)

    # JAX's draws: its absorb on a copy, then the triplets from its key
    jg = jduo.global_slam
    existing = jduo.guid_map.lookup_batch(np.asarray(jdelta.n_uid, np.int32))
    g_in, _ = jscope.apply_delta(jax.tree.map(jnp.copy, jg.state.graph), jdelta,
                                 existing_slots=existing)
    st_in, slots, _ = jrunner._absorb_payloads_jit(
        jax.tree.map(jnp.copy, jg.state)._replace(graph=g_in), jdelta)
    tri = jax_absorb_triplets(st_in, slots, jg.config)
    ne0 = int(g_in.num_edges)

    jack, jreply, jinfo = jrunner.global_exchange_step(
        jg, jdelta, jrobot, jradius, jduo.delta_nodes, jduo.delta_edges, optimize=False,
        uid_map=jduo.guid_map)
    tack, treply, tinfo = trunner.global_exchange_step(
        tduo.global_slam, tdelta, trobot, tradius, tduo.delta_nodes, tduo.delta_edges,
        optimize=False, tri=torch.from_numpy(tri))
    for port_nt, jax_nt in ((tack, jack), (treply, jreply)):
        for k, v in jax_nt._asdict().items():
            np.testing.assert_array_equal(tscope.to_numpy(port_nt)[k], np.asarray(v), err_msg=k)
    assert tinfo["merged_global"] == jinfo["merged_global"]
    assert tinfo["proposed_global"] == jinfo["proposed_global"] > 0
    assert_graph_close(tduo.global_slam.state.graph, jg.state.graph,
                       np.arange(ne0, ne0 + tinfo["proposed_global"]))

    jl = jduo.local_apply_response(jack, jreply)
    tl = tduo.local_apply_response(tack, treply)
    assert tl == jl and tl["evicted_local"] > 0
    for k in ("node_acked", "edge_acked"):
        np.testing.assert_array_equal(tduo.ship._asdict()[k].numpy(),
                                      np.asarray(getattr(jduo.ship, k)), err_msg=k)
    assert_graph_close(tduo.local.state.graph, jduo.local.state.graph)


# ---------------------------------------------------------------------------
# Twins of tests/test_runner.py on the port's duo
# ---------------------------------------------------------------------------

def test_all_keyframes_reach_global(duo_run):
    duo = duo_run[0]
    _, uids, _ = duo.global_trajectory()
    n_kf = duo.local._n_kf_host
    kf_uids = uids[uids < 1_000_000]
    assert len(kf_uids) == n_kf
    assert len(np.unique(kf_uids)) == n_kf


def test_local_window_bounded_by_eviction(duo_run):
    duo, _, evicted, _, _ = duo_run
    n_live_local = int(duo.local.state.graph.node_valid.sum())
    assert evicted > 0, "scope eviction never fired"
    assert n_live_local < len(duo.global_trajectory()[0])


def test_global_map_consistent_after_loop(duo_run):
    duo, frames = duo_run[:2]
    poses, uids, stamps = duo.global_trajectory()
    kf = uids < 1_000_000
    gt = torch.from_numpy(np.stack([frames[int(s)]["gt_pose"] for s in stamps[kf].astype(int)]))
    assert float(tsyn.ate_rmse(torch.from_numpy(poses[kf]), gt)) < 0.3


def test_boundary_nodes_fixed_in_local(duo_run):
    g = duo_run[0].local.state.graph
    assert int((g.node_fixed & g.node_valid).sum()) >= 1


def test_global_proposes_closures_from_shipped_features(duo_run):
    duo, _, _, proposed, _ = duo_run
    assert proposed > 0, "global never proposed a closure from shipped features"
    g = duo.global_slam.state.graph
    ne = int(g.num_edges)
    assert int((g.e_type[:ne] == tstate.EDGE_TYPE_3D_FULL).sum()) > 0


def test_global_banks_carry_shipped_payloads(duo_run):
    st = duo_run[0].global_slam.state
    live = st.graph.node_valid
    assert int((st.desc_valid.any(-1) & live).sum()) >= 0.9 * int(live.sum())
    assert int((st.scan_valid & live).sum()) >= 0.9 * int(live.sum())


def test_global_builds_occupancy_map(duo_run):
    duo = duo_run[0]
    duo.global_slam.project_map(force_full=True)
    tern = duo.global_slam.map_ternary()
    assert int((tern == 100).sum()) > 10
    assert int((tern == 0).sum()) > 100


def test_resend_until_ack_drains(duo_run):
    duo = duo_run[0]
    delta = tscope.make_delta(duo.local.state.graph, duo.ship, duo.local.state.gist.desc)
    assert int((delta.n_uid >= 0).sum()) == 0
