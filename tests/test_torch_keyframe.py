"""The keyframe step and the ``Slam`` shell: the port's
``pipeline.process_keyframe`` against JAX's, step by step, on the CPU.

A 96x128 WallWorld out-and-back drive (12 keyframes, 3 m each way), the
default configuration (depth refinement, GIST recognition, the feature
estimator, laser edges) at 64 features and 90 scan bins.  Before each step
the JAX state is carried into the port (``state_from_numpy``), and JAX's
RANSAC triplets for the step are injected: ``split(state.prng)`` gives the
step's key, ``split(key, 2·k)`` one key per candidate, and
``ransac._valid_sample(key, K, ok_m, quality=-dist)`` on the JAX side's
matches of that candidate.  Held, with their reasons:

- the new slot, the candidate and proposed-edge counts, and every edge's
  endpoints, type, validity and score exactly (discrete; no match, inlier
  or gate of this sequence sits on its threshold);
- odometry edges within 1e-6 (the same float32 formulas); candidate edges'
  transforms within 1e-4 and information within 1e-3 relative (RANSAC's
  refit, an SVD on the same float32 covariance, as
  ``test_torch_ransac.py``); the ICP laser edge's transform within 1e-4
  and its information within 1e-3 relative (20 Gauss-Newton steps whose
  3x3 solves LAPACK and the port's LU round differently; the fixed point
  is the same);
- the banks: descriptors as ``test_torch_frontend.py`` (≥ 99.5 % of the
  valid keypoints' bits: levels 1-3 start from the resize), points within
  1e-5 m, scans within two 21-bit quanta (the bilateral filter's exp is
  XLA's on one side and torch's on the other: a few ulps of depth that can
  move a quantised range by one step, ``test_torch_depth.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu import pipeline as jpipe
from uzliti_slam_tpu.config import EdgeEstimationConfig as JEst
from uzliti_slam_tpu.config import SlamConfig as JCfg
from uzliti_slam_tpu.io import simulator as jsim
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu.ops import matching as jmatch
from uzliti_slam_tpu.ops import ransac as jransac
from uzliti_slam_tpu.recognition import recognizer as jrec
from uzliti_slam_tpu_torch import pipeline as tpipe
from uzliti_slam_tpu_torch.config import EdgeEstimationConfig as TEst
from uzliti_slam_tpu_torch.config import KeyframeConfig as TKf
from uzliti_slam_tpu_torch.config import SlamConfig as TCfg
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import simulator as tsim
from uzliti_slam_tpu_torch.io import synthetic as tsyn
from uzliti_slam_tpu_torch.ops import scan as tscan

FEATS, BINS, STEPS = 64, 90, 12
SHAPE = dict(node_capacity=32, edge_capacity=256, feats_per_node=FEATS, scan_bins=BINS)
GATES = dict(min_consensus=8, min_matching_score=6.0)
QUANTUM = 1.0 / tscan.range_scale(6.0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These runs are many small CPU ops: one intra-op thread, so that
    parallel test workers do not oversubscribe the cores (each worker's
    torch otherwise starts a thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    return (JCfg(**SHAPE, estimation=JEst(**GATES)), TCfg(**SHAPE, estimation=TEst(**GATES)))


def jax_state_arrays(st) -> dict:
    """The fields of a JAX SlamState as ``state_from_numpy`` takes them."""
    out = {k: np.asarray(getattr(st, k)) for k in (
        "scans", "scan_valid", "desc", "desc_valid", "points", "last_kf_odom", "n_keyframes",
        "last_kf_slot")}
    out["graph"] = {k: np.asarray(v) for k, v in st.graph._asdict().items()}
    out["gist"] = {k: np.asarray(v) for k, v in st.gist._asdict().items()}
    out["tunables"] = {k: float(v) for k, v in st.tunables._asdict().items()}
    return out


def jax_triplets(pre, post, new_slot: int, odom, stamp, cfg) -> np.ndarray:
    """The RANSAC triplets JAX's ``process_keyframe`` draws for this step,
    recomputed from its pre- and post-step states (``pipeline.py:305-415``)."""
    tn, rc, kc = pre.tunables, cfg.recognition, cfg.keyframe
    g = pre.graph
    gist, desc = post.gist.desc[new_slot], post.desc[new_slot]
    pts_valid = post.desc_valid[new_slot]
    st = jnp.float32(stamp)
    pr_slots, _, _ = jrec.gist_query(pre.gist, gist, st, k=rc.k_candidates,
                                     max_dist=tn.gist_max_dist, min_dt=tn.min_time_separation)
    map_pose = jlie.pose_compose(g.diff_transform, jnp.asarray(odom))
    d = jnp.linalg.norm(jlie.pose_t(g.pose) - jlie.pose_t(map_pose)[None], axis=-1)
    rel_q = jlie.quat_mul(jlie.quat_conj(jlie.pose_q(g.pose)), jlie.pose_q(map_pose)[None])
    elig = (g.node_valid & (d < kc.distance_closure_radius)
            & (jnp.degrees(jlie.rotation_angle(rel_q)) < kc.distance_closure_max_angle_deg)
            & (jnp.abs(g.stamp - st) >= tn.min_time_separation))
    _, dist_slots = jax.lax.top_k(-jnp.where(elig, d, jnp.inf), rc.k_candidates)
    cand = jnp.maximum(jnp.concatenate([pr_slots, dist_slots]).astype(jnp.int32), 0)
    keys = jax.random.split(jax.random.split(pre.prng)[1], cand.shape[0])
    bits = jmatch.unpack_bits(desc)
    tri = []
    for i in range(cand.shape[0]):
        c = int(cand[i])
        _, ok_m, dist = jmatch.match_descriptors(
            bits, jmatch.unpack_bits(pre.desc[c]), valid_a=pts_valid, valid_b=pre.desc_valid[c],
            ratio=tn.match_ratio, max_dist=tn.max_match_distance)
        tri.append(np.asarray(jransac._valid_sample(keys[i], cfg.estimation.ransac_hypotheses,
                                                    ok_m, quality=-dist)))
    return np.stack(tri)


def _frames(n=STEPS, length=3.0):
    world = jsim.WallWorld(img_h=96, img_w=128)
    return world, jsim.simulate_sequence(world, n_frames=n, odom_drift=0.06, length=length)


@pytest.fixture(scope="module")
def steps():
    """[(JAX post-state, JAX info, port post-state, port info)] of each step."""
    jcfg, tcfg = _configs()
    world, frames = _frames()
    cam_t = tsim.WallWorld(img_h=96, img_w=128, tex_size=64).cam
    pose = np.asarray(jsim.cam_extrinsic())
    st_j = jpipe.init_state(jcfg)
    out = []
    for fr in frames:
        kf = jpipe.Keyframe(image=jnp.asarray(fr["image"]), depth=jnp.asarray(fr["depth"]),
                            odom_pose=jnp.asarray(fr["odom_pose"]), stamp=jnp.float32(fr["stamp"]))
        pre_arrays = jax_state_arrays(st_j)
        # process_keyframe donates its state: hand it a copy, keep the pre-state
        post_j, info_j = jpipe.process_keyframe(jax.tree.map(jnp.copy, st_j), kf, world.cam,
                                                jnp.asarray(pose), jcfg)
        new = int(info_j["new_slot"])
        tri = jax_triplets(st_j, post_j, new, fr["odom_pose"], fr["stamp"], jcfg)
        st_t = tpipe.state_from_numpy(pre_arrays, device="cpu", config=tcfg)
        post_t, info_t = tpipe.process_keyframe(st_t, fr["image"], fr["depth"], fr["odom_pose"],
                                                fr["stamp"], cam_t, pose, tcfg,
                                                tri=torch.from_numpy(tri))
        out.append((post_j, info_j, post_t, info_t))
        st_j = post_j
    return out


def test_the_sequence_proposes_and_accepts_closures(steps):
    proposed = [int(i_j["n_edges_proposed"]) for _, i_j, _, _ in steps]
    laser = [int(np.sum(np.asarray(p.graph.e_type) == 105)) for p, _, _, _ in steps]
    assert sum(proposed[STEPS // 2:]) >= 3 and laser[-1] >= STEPS // 2


@pytest.mark.parametrize("step", range(STEPS))
def test_process_keyframe_matches_jax_step(steps, step):
    post_j, info_j, post_t, info_t = steps[step]
    for k in ("new_slot", "n_candidates", "n_edges_proposed", "n_features"):
        assert int(info_t[k]) == int(info_j[k]), k
    gj, gt = post_j.graph, post_t.graph
    ne = int(gj.num_edges)
    assert int(gt.num_edges) == ne and int(gt.num_nodes) == int(gj.num_nodes)
    for f in ("e_from", "e_to", "e_type", "e_valid", "e_score", "node_valid", "node_uid",
              "stamp"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(gj, f)), err_msg=f)
    for f in ("last_kf_slot", "n_keyframes", "last_kf_odom"):
        np.testing.assert_array_equal(getattr(post_t, f).numpy(), np.asarray(getattr(post_j, f)),
                                      err_msg=f)
    et = np.asarray(gj.e_type[:ne])
    odo, laser = et == tstate.EDGE_TYPE_2D_WHEEL_ODOMETRY, et == tstate.EDGE_TYPE_2D_LASER
    lc = et == tstate.EDGE_TYPE_3D_FULL
    tf_j, tf_t = np.asarray(gj.e_transform[:ne]), gt.e_transform[:ne].numpy()
    inf_j, inf_t = np.asarray(gj.e_info[:ne]), gt.e_info[:ne].numpy()
    np.testing.assert_allclose(tf_t[odo], tf_j[odo], atol=1e-6)
    np.testing.assert_allclose(inf_t[odo], inf_j[odo], rtol=1e-5)
    for mask in (lc, laser):
        np.testing.assert_allclose(tf_t[mask], tf_j[mask], atol=1e-4)
        np.testing.assert_allclose(inf_t[mask], inf_j[mask], rtol=1e-3,
                                   atol=1e-3 * max(np.abs(inf_j[mask]).max(initial=0.0), 1.0))
    np.testing.assert_allclose(gt.pose.numpy(), np.asarray(gj.pose), atol=1e-6)


@pytest.mark.parametrize("step", [0, STEPS // 2, STEPS - 1])
def test_process_keyframe_banks_match_jax(steps, step):
    post_j, info_j, post_t, _ = steps[step]
    s = int(info_j["new_slot"])
    valid = np.asarray(post_j.desc_valid[s])
    np.testing.assert_array_equal(post_t.desc_valid[s].numpy(), valid)
    diff = np.unpackbits(post_t.desc[s].numpy() ^ np.asarray(post_j.desc[s]), axis=-1)
    assert 1.0 - diff[valid].mean() >= 0.995
    np.testing.assert_allclose(post_t.points[s].numpy()[valid], np.asarray(post_j.points[s])[valid],
                               atol=1e-5)
    ref, got = np.asarray(post_j.scans[s]), post_t.scans[s].numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    assert fin.sum() >= BINS // 12
    np.testing.assert_allclose(got[fin], ref[fin], rtol=0, atol=2.5 * QUANTUM)
    np.testing.assert_array_equal(post_t.gist.desc[s].numpy(), np.asarray(post_j.gist.desc[s]))
    assert bool(post_t.scan_valid[s]) and float(post_t.gist.stamp[s]) == float(post_j.gist.stamp[s])


def test_grow_state_matches_jax():
    jcfg, tcfg = _configs()
    world, frames = _frames(3)
    st_j = jpipe.init_state(jcfg)
    for fr in frames:
        st_j, _ = jpipe.process_keyframe(
            st_j, jpipe.Keyframe(image=jnp.asarray(fr["image"]), depth=jnp.asarray(fr["depth"]),
                                 odom_pose=jnp.asarray(fr["odom_pose"]),
                                 stamp=jnp.float32(fr["stamp"])),
            world.cam, jsim.cam_extrinsic(), jcfg)
    grown_j = jpipe.grow_state(st_j, 64, 300)
    st_t = tpipe.state_from_numpy(jax_state_arrays(st_j), device="cpu", config=tcfg)
    grown_t = tpipe.grow_state(st_t, 64, 300)
    ref = jax_state_arrays(grown_j)
    assert grown_t.graph.node_capacity == 64 and grown_t.graph.edge_capacity == 512
    for k, v in tstate.to_numpy(grown_t.graph).items():
        np.testing.assert_array_equal(v, ref["graph"][k], err_msg=k)
    for k in ("scans", "scan_valid", "desc", "desc_valid", "points"):
        np.testing.assert_array_equal(getattr(grown_t, k).numpy(), ref[k], err_msg=k)
    for k in ("desc", "stamp", "valid"):
        np.testing.assert_array_equal(getattr(grown_t.gist, k).numpy(), ref["gist"][k], err_msg=k)
    # already large enough: unchanged
    assert tpipe.grow_state(grown_t, 64, 300).desc is grown_t.desc


def test_set_param_retunes_gates_and_the_keyframe_gate():
    slam = tpipe.Slam(TCfg(**SHAPE), device="cpu")
    slam.set_param("match_ratio", 0.8)
    assert slam.state.tunables.match_ratio == float(np.float32(0.8))
    assert slam.state.tunables.match_ratio != 0.8            # rounded to float32
    slam.set_param("new_node_distance", 0.5)
    assert slam.config.keyframe.new_node_distance == 0.5
    # only field names: the reference's hasattr also accepts NamedTuple methods
    for name in ("count", "replace", "no_such_gate"):
        with pytest.raises(KeyError, match="unknown tunable"):
            slam.set_param(name, 1.0)
    # the other recognizers' gates retune as the reference's; the other
    # estimators' paths are not ported
    jslam = jpipe.Slam(JCfg(**SHAPE))
    for name, value in (("feature_hamming_thresh", 33.3), ("min_similarity", 0.3),
                        ("min_descriptors", 40), ("repo_min_votes", 7), ("bow_min_score", 0.11)):
        slam.set_param(name, value)
        jslam.set_param(name, value)
        assert getattr(slam.state.tunables, name) == float(getattr(jslam.state.tunables, name))
    for name, item in (("gicp_max_corr", "A25"), ("pnp_reproj_px", "A25")):
        with pytest.raises(NotImplementedError, match=item):
            slam.set_param(name, 1.0)
    jslam.set_param("match_ratio", 0.8)
    assert slam.state.tunables.match_ratio == float(jslam.state.tunables.match_ratio)


def test_slam_raises_for_what_is_not_ported():
    # every recognizer is ported: "bow" asks for its vocabulary instead
    with pytest.raises(ValueError, match="vocabulary"):
        tpipe.Slam(TCfg(**SHAPE, recognition=dataclasses.replace(TCfg().recognition,
                                                                  method="bow")), device="cpu")
    for method in ("feature_set", "repository"):
        tpipe.Slam(TCfg(**SHAPE, recognition=dataclasses.replace(TCfg().recognition,
                                                                 method=method)), device="cpu")
    cases = [(dict(estimation=TEst(method="gicp")), "A25"),
             (dict(estimation=TEst(method="pnp")), "A25"), (dict(sync_to_database="x.db"), "A27")]
    for kw, item in cases:
        with pytest.raises(NotImplementedError, match=item):
            tpipe.Slam(TCfg(**SHAPE, **kw), device="cpu")
    slam = tpipe.Slam(TCfg(**SHAPE), device="cpu")
    for name, item in (("fuse_odometry", "A26"), ("enqueue_frame", "A19"),
                       ("flush_frames", "A19"), ("add_frames", "A19")):
        with pytest.raises(NotImplementedError, match=item):
            getattr(slam, name)()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.Slam(TCfg(**SHAPE))


@pytest.fixture(scope="module")
def port_run():
    """tests/test_pipeline.py's sequence through the port's Slam."""
    cfg = TCfg(node_capacity=64, edge_capacity=256, feats_per_node=96, scan_bins=180,
               keyframe=TKf(new_node_distance=0.25),
               estimation=TEst(min_consensus=10, min_matching_score=8.0))
    world = tsim.WallWorld(img_h=96, img_w=128)
    frames = tsim.simulate_sequence(world, n_frames=36, odom_drift=0.08, length=5.0)
    slam = tpipe.Slam(cfg, cam=world.cam, cam_pose=tsim.cam_extrinsic(device="cpu"), device="cpu")
    slam.optimize_every = 12
    infos = [i for i in (slam.add_frame(fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"])
                         for fr in frames) if i is not None]
    slam.optimize()
    return frames, slam, infos


def test_slam_runs_the_pipeline_test_sequence(port_run):
    """tests/test_pipeline.py's assertions, on the port."""
    frames, slam, infos = port_run
    g = slam.state.graph
    n, ne = int(g.num_nodes), int(g.num_edges)
    assert 20 <= n <= 36
    assert np.median([int(i["n_features"]) for i in infos]) > 30
    assert sum(int(i["n_edges_proposed"]) for i in infos) >= 5
    et, ev = g.e_type[:ne].numpy(), g.e_valid[:ne].numpy()
    lc = et == tstate.EDGE_TYPE_3D_FULL
    assert lc.sum() >= 5 and ev[lc].sum() >= 3
    stamps = g.stamp[:n].numpy().astype(int)
    gt = torch.from_numpy(np.stack([frames[s]["gt_pose"] for s in stamps]))
    odo = torch.from_numpy(np.stack([frames[s]["odom_pose"] for s in stamps]))
    ate, ate_odo = float(tsyn.ate_rmse(g.pose[:n], gt)), float(tsyn.ate_rmse(odo, gt))
    assert ate < 0.2 and ate <= ate_odo + 1e-6
    tern = slam.map_ternary().numpy()
    assert (tern == 100).sum() > 20 and (tern == 0).sum() > 100 and (tern == -1).sum() > 0
    p = slam.map_probability().numpy()
    assert p.min() >= 0.0 and p.max() <= 1.0
    assert np.all(np.isfinite(g.diff_transform.numpy()))
    for t in (g.pose, g.e_info, slam.state.points, slam.state.scans):
        assert bool(torch.all(torch.isfinite(t) | torch.isinf(t)))
    poses, valid = slam.trajectory()
    assert poses.shape == (n, 7) and bool(valid.all())


def test_slam_grows_its_capacity():
    world = tsim.WallWorld(img_h=96, img_w=128, tex_size=64)
    frames = tsim.simulate_sequence(world, n_frames=36, odom_drift=0.08, length=5.0)
    cfg = TCfg(node_capacity=8, edge_capacity=32, feats_per_node=32, scan_bins=90)
    slam = tpipe.Slam(cfg, cam=world.cam, cam_pose=tsim.cam_extrinsic(device="cpu"), device="cpu")
    slam.optimize_every = 10**9
    for fr in frames[:30:3]:
        slam.add_frame(fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"])
    assert slam.config.node_capacity == 16 and slam.state.desc.shape[0] == 16
    assert int(slam.state.graph.num_nodes) == 10 and int(slam.state.n_keyframes) == 10
    uid = slam.state.graph.node_uid[:10].numpy()
    np.testing.assert_array_equal(uid, np.arange(10))


def test_cam_disp_composes_onto_the_extrinsics():
    """A staggered capture's per-camera displacement is composed onto the
    extrinsics before the front-end (``pipeline.py:200-204``)."""
    from uzliti_slam_tpu_torch.ops import lie as tlie

    _, tcfg = _configs()
    world = tsim.WallWorld(img_h=96, img_w=128, tex_size=64)
    fr = tsim.simulate_sequence(tsim.WallWorld(img_h=96, img_w=128), n_frames=2)[1]
    pose = tsim.cam_extrinsic(device="cpu")
    disp = tlie.pose2_to_pose(torch.tensor([0.02, -0.01, 0.03]))
    runs = []
    for cam_pose, cam_disp in ((pose, disp), (tlie.pose_compose(disp, pose), None)):
        st = tpipe.init_state(tcfg, device="cpu")
        runs.append(tpipe.process_keyframe(st, fr["image"], fr["depth"], fr["odom_pose"], 1.0,
                                           world.cam, cam_pose, tcfg, cam_disp=cam_disp)[0])
    for k in ("desc", "desc_valid", "points", "scans"):
        assert torch.equal(getattr(runs[0], k), getattr(runs[1], k)), k
    assert not torch.equal(runs[0].points, tpipe.process_keyframe(
        tpipe.init_state(tcfg, device="cpu"), fr["image"], fr["depth"], fr["odom_pose"], 1.0,
        world.cam, pose, tcfg)[0].points)
