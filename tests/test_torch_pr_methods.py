"""The place-recognition methods through the port's keyframe step and
``Slam``, against the JAX package's, on the CPU: ``"feature_set"`` (K21's
plain version), ``"repository"`` (K22's) and ``"bow"`` (K23's and K24's).

- ``process_keyframe`` step by step against JAX's, in the form of
  ``tests/test_torch_keyframe.py``: 12 keyframes of a 96x128 out-and-back
  drive, JAX's pre-state carried over each step (``state_from_numpy``, the
  repository, the BoW bank and JAX's vocabulary included) and JAX's RANSAC
  triplets injected, recomputed from its states with the method's own query.
  Held exactly: the step's counts and every edge's endpoints, type,
  validity and score, and the method's bank: the repository's validity,
  links, counts and node fields, the BoW bank's stamps and flags.  The
  frame's descriptors agree with JAX's in >= 99.5 % of the bits of its
  valid keypoints (``test_torch_frontend.py``: pyramid levels 1-3 start from
  a resize), so the repository's new descriptors are held to that.  With
  "bow", a flipped bit can move a descriptor to another word (one step of
  12 here): that step's candidates are held on JAX's own frame instead
  (the port's ``quantize`` and ``bow_query`` on JAX's descriptors give
  JAX's vector within 1e-6 and JAX's slots);
- ``grow_state`` and ``compact_state`` with the new banks, against JAX's;
- the ValueErrors of a missing or wrong-sized vocabulary and an unknown
  method;
- tests/test_pr_methods.py's runs through the port's ``Slam``: at least 3
  proposed edges for each method, as those tests assert of JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_keyframe as tk
from uzliti_slam_tpu import pipeline as jpipe
from uzliti_slam_tpu.config import EdgeEstimationConfig as JEst
from uzliti_slam_tpu.config import PlaceRecognitionConfig as JRec
from uzliti_slam_tpu.config import SlamConfig as JCfg
from uzliti_slam_tpu.io import simulator as jsim
from uzliti_slam_tpu.ops import features as jfeat
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu.ops import matching as jmatch
from uzliti_slam_tpu.ops import ransac as jransac
from uzliti_slam_tpu.recognition import recognizer as jrec
from uzliti_slam_tpu.recognition import vocabulary as jvoc
from uzliti_slam_tpu_torch import pipeline as tpipe
from uzliti_slam_tpu_torch.config import EdgeEstimationConfig as TEst
from uzliti_slam_tpu_torch.config import KeyframeConfig as TKf
from uzliti_slam_tpu_torch.config import PlaceRecognitionConfig as TRec
from uzliti_slam_tpu_torch.config import SlamConfig as TCfg
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import simulator as tsim
from uzliti_slam_tpu_torch.recognition import vocabulary as tvoc

STEPS = tk.STEPS
# each method's gates: tests/test_pr_methods.py's, for this sequence
METHODS = {"feature_set": dict(min_descriptors=20, min_similarity=0.15),
           "repository": dict(repo_min_votes=5),
           "bow": dict(bow_words=64, bow_min_score=0.2)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(method):
    rec = METHODS[method]
    return (JCfg(**tk.SHAPE, estimation=JEst(**tk.GATES), recognition=JRec(method=method, **rec)),
            TCfg(**tk.SHAPE, estimation=TEst(**tk.GATES), recognition=TRec(method=method, **rec)))


def train_vocabulary(frames, k, max_keypoints, iterations=6):
    """JAX's vocabulary from the descriptors of every sixth frame, as
    tests/test_pr_methods.py trains it."""
    descs = [np.asarray(jfeat.detect_and_describe(fr["image"], max_keypoints=max_keypoints)[1])
             for fr in frames[::6]]
    return jvoc.build_vocabulary(jax.random.PRNGKey(0), np.concatenate(descs), k=k,
                                 iterations=iterations)


def state_arrays(st) -> dict:
    """A JAX SlamState's fields as ``state_from_numpy`` takes them, the
    method's banks and vocabulary included."""
    out = tk.jax_state_arrays(st)
    for name in ("repo", "bow", "vocab"):
        bank = getattr(st, name)
        if bank is not None:
            out[name] = {k: np.asarray(v) for k, v in bank._asdict().items()}
    return out


def method_candidates(pre, desc, pts_valid, stamp, cfg):
    """The slots JAX's place-recognition query of ``cfg``'s method gives
    for the frame (``pipeline.py:311-353``)."""
    tn, rc, g = pre.tunables, cfg.recognition, pre.graph
    k = rc.k_candidates
    if rc.method == "feature_set":
        fbank = jrec.FeatureSetBank(
            desc=pre.desc, desc_valid=pre.desc_valid & g.node_valid[:, None], stamp=g.stamp,
            valid=g.node_valid & (jnp.sum(pre.desc_valid, axis=-1) >= tn.min_descriptors))
        return jrec.feature_set_query(fbank, desc, pts_valid, stamp, k=k,
                                      hamming_thresh=tn.feature_hamming_thresh,
                                      min_similarity=tn.min_similarity,
                                      min_dt=tn.min_time_separation)[0]
    if rc.method == "repository":
        return jrec.repository_query(pre.repo, desc, pts_valid, stamp, k=k,
                                     match_thresh=tn.feature_hamming_thresh,
                                     min_votes=tn.repo_min_votes,
                                     min_dt=tn.min_time_separation)[0]
    vec = jvoc.quantize(pre.vocab, desc, pts_valid)
    return jvoc.bow_query(pre.bow, vec, stamp, k=k, min_score=tn.bow_min_score,
                          min_dt=tn.min_time_separation)[0]


def method_triplets(pre, post, new_slot: int, odom, stamp, cfg) -> np.ndarray:
    """``test_torch_keyframe.jax_triplets`` with the method's query."""
    tn, rc, kc = pre.tunables, cfg.recognition, cfg.keyframe
    g = pre.graph
    desc, pts_valid = post.desc[new_slot], post.desc_valid[new_slot]
    st = jnp.float32(stamp)
    pr_slots = method_candidates(pre, desc, pts_valid, st, cfg)
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


@pytest.fixture(scope="module", params=list(METHODS))
def steps(request):
    """(method, [(JAX pre-state, JAX post-state, JAX info, port post-state,
    port info)] of each step)."""
    method = request.param
    jcfg, tcfg = _configs(method)
    world, frames = tk._frames()
    cam_t = tsim.WallWorld(img_h=96, img_w=128, tex_size=64).cam
    pose = np.asarray(jsim.cam_extrinsic())
    vocab = (train_vocabulary(frames, METHODS["bow"]["bow_words"], tk.FEATS)
             if method == "bow" else None)
    st_j = jpipe.init_state(jcfg, vocabulary=vocab)
    out = []
    for fr in frames:
        kf = jpipe.Keyframe(image=jnp.asarray(fr["image"]), depth=jnp.asarray(fr["depth"]),
                            odom_pose=jnp.asarray(fr["odom_pose"]), stamp=jnp.float32(fr["stamp"]))
        pre_arrays = state_arrays(st_j)
        post_j, info_j = jpipe.process_keyframe(jax.tree.map(jnp.copy, st_j), kf, world.cam,
                                                jnp.asarray(pose), jcfg)
        tri = method_triplets(st_j, post_j, int(info_j["new_slot"]), fr["odom_pose"],
                              fr["stamp"], jcfg)
        st_t = tpipe.state_from_numpy(pre_arrays, device="cpu", config=tcfg)
        post_t, info_t = tpipe.process_keyframe(st_t, fr["image"], fr["depth"], fr["odom_pose"],
                                                fr["stamp"], cam_t, pose, tcfg,
                                                tri=torch.from_numpy(tri))
        out.append((st_j, post_j, info_j, post_t, info_t))
        st_j = post_j
    return method, out


def test_methods_propose_closures_on_the_return_leg(steps):
    method, out = steps
    proposed = [int(i_j["n_edges_proposed"]) for _, _, i_j, _, _ in out]
    assert sum(proposed[STEPS // 2:]) >= 3, (method, proposed)


def _same_bits(got, ref, valid) -> float:
    diff = np.unpackbits(got ^ ref, axis=-1)
    return 1.0 - float(diff[valid].mean()) if valid.any() else 1.0


def _bow_same_frame(entry) -> bool:
    """The port's BoW vector of the step's frame is JAX's within 1e-6."""
    _, post_j, info_j, post_t, _ = entry
    s = int(info_j["new_slot"])
    return bool(np.abs(post_t.bow.vec[s].numpy() - np.asarray(post_j.bow.vec[s])).max() <= 1e-6)


@pytest.mark.parametrize("step", range(STEPS))
def test_process_keyframe_matches_jax_step(steps, step):
    method, out = steps
    pre_j, post_j, info_j, post_t, info_t = out[step]
    s = int(info_j["new_slot"])
    if method == "bow" and not _bow_same_frame(out[step]):
        # a few of the frame's descriptor bits differ from JAX's (pyramid
        # levels 1-3), enough to move a descriptor to another word: the
        # candidates then differ by construction.  Held instead: the port's
        # quantize and bow_query on JAX's own frame give JAX's vector and
        # candidates, and the bank's row is the port's own vector.
        _, tcfg = _configs(method)
        st_t = tpipe.state_from_numpy(state_arrays(pre_j), device="cpu", config=tcfg)
        dj, vj = np.asarray(post_j.desc[s]), np.asarray(post_j.desc_valid[s])
        vec = tvoc.quantize(st_t.vocab, torch.from_numpy(np.array(dj)),
                            torch.from_numpy(np.array(vj)))
        np.testing.assert_allclose(vec.numpy(), np.asarray(post_j.bow.vec[s]), rtol=0, atol=1e-6)
        stamp = float(post_j.graph.stamp[s])
        np.testing.assert_array_equal(
            tvoc.bow_query(st_t.bow, vec, stamp, k=tcfg.recognition.k_candidates,
                           min_score=st_t.tunables.bow_min_score)[0].numpy(),
            np.asarray(method_candidates(pre_j, post_j.desc[s], post_j.desc_valid[s],
                                         jnp.float32(stamp), _configs(method)[0])))
        assert bool(post_t.bow.valid[s]) and abs(float(post_t.bow.vec[s].sum()) - 1.0) <= 1e-5
        return
    for k in ("new_slot", "n_candidates", "n_edges_proposed", "n_features"):
        assert int(info_t[k]) == int(info_j[k]), (method, k)
    gj, gt = post_j.graph, post_t.graph
    ne = int(gj.num_edges)
    assert int(gt.num_edges) == ne and int(gt.num_nodes) == int(gj.num_nodes)
    for f in ("e_from", "e_to", "e_type", "e_valid", "e_score"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(gj, f)),
                                      err_msg=f"{method} {f}")
    et = np.asarray(gj.e_type[:ne])
    lc = et == tstate.EDGE_TYPE_3D_FULL
    np.testing.assert_allclose(gt.e_transform[:ne].numpy()[lc],
                               np.asarray(gj.e_transform[:ne])[lc], atol=1e-4)
    if method == "repository":
        rt, rj = post_t.repo, post_j.repo
        for f in ("desc_valid", "links", "link_valid", "num_desc", "node_stamp", "node_valid"):
            np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)),
                                          err_msg=f)
        dv = np.asarray(rj.desc_valid)
        assert _same_bits(rt.desc.numpy(), np.asarray(rj.desc), dv) >= 0.995
    if method == "bow":
        bt, bj = post_t.bow, post_j.bow
        np.testing.assert_array_equal(bt.valid.numpy(), np.asarray(bj.valid))
        np.testing.assert_array_equal(bt.stamp.numpy(), np.asarray(bj.stamp))


def test_bow_frames_rarely_change_words(steps):
    """The case above stays the exception: one step of the run, no more."""
    method, out = steps
    if method == "bow":
        assert sum(not _bow_same_frame(e) for e in out) <= 1
    else:
        assert getattr(out[-1][3], "bow") is None


def test_grow_and_compact_state_with_the_banks(steps):
    """``grow_state`` (the repository's descriptor bank keeps its capacity)
    and ``compact_state`` (links follow their nodes, links to dead nodes
    go) on the last step's state with nodes 1, 4 and 7 dropped first,
    against JAX's; the feature-set method has no bank of its own."""
    method, out = steps
    name = {"feature_set": None, "repository": "repo", "bow": "bow"}[method]
    post_j = out[-1][1]
    _, tcfg = _configs(method)
    st_t = tpipe.state_from_numpy(state_arrays(post_j), device="cpu", config=tcfg)
    grown_j = jpipe.grow_state(post_j, 64, 512)
    grown_t = tpipe.grow_state(st_t, 64, 512)
    if name is None:
        assert grown_t.repo is None and grown_t.bow is None and grown_t.vocab is None
        return
    for f, a, b in zip(getattr(grown_t, name)._fields, getattr(grown_t, name),
                       getattr(grown_j, name)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"grow {f}")
    if name == "repo":
        assert grown_t.repo.desc.shape == st_t.repo.desc.shape
        assert grown_t.repo.node_valid.shape == (64,)
    dead_np = np.isin(np.arange(64), [1, 4, 7])
    dead = jnp.asarray(dead_np)
    sj = grown_j._replace(graph=grown_j.graph._replace(node_valid=grown_j.graph.node_valid & ~dead))
    if name == "repo":
        repo = sj.repo
        sj = sj._replace(repo=repo._replace(node_valid=repo.node_valid & ~dead,
                                            link_valid=repo.link_valid & ~dead[repo.links]))
    else:
        sj = sj._replace(bow=sj.bow._replace(valid=sj.bow.valid & ~dead))
    st = tpipe._drop_from_banks(grown_t, torch.from_numpy(dead_np))
    st = st.replace(graph=st.graph.replace(
        node_valid=st.graph.node_valid & ~torch.from_numpy(dead_np)))
    for f, a, b in zip(getattr(st, name)._fields, getattr(st, name), getattr(sj, name)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"drop {f}")
    comp_j, perm_j = jpipe.compact_state(jax.tree.map(jnp.copy, sj))
    comp_t, perm_t = tpipe.compact_state(st)
    np.testing.assert_array_equal(perm_t["node_order"].numpy(), np.asarray(perm_j["node_order"]))
    bt, bj = getattr(comp_t, name), getattr(comp_j, name)
    for f, a, b in zip(bt._fields, bt, bj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f"compact {f}")
    if name == "repo":
        assert not bool(comp_t.repo.node_valid[int(comp_t.graph.node_valid.sum()):].any())


def test_vocabulary_and_method_errors():
    _, tcfg = _configs("bow")
    with pytest.raises(ValueError, match="vocabulary"):
        tpipe.init_state(tcfg, device="cpu")
    wrong = tvoc.from_numpy(np.zeros((16, 32), np.uint8), np.zeros(16, np.float32), "cpu")
    with pytest.raises(ValueError, match="64"):
        tpipe.Slam(tcfg, device="cpu", vocabulary=wrong)
    world, frames = tk._frames(2)
    cfg = dataclasses.replace(tcfg, recognition=TRec(method="kitchen_sink"))
    slam = tpipe.Slam(cfg, cam=tsim.WallWorld(img_h=96, img_w=128, tex_size=64).cam,
                      cam_pose=tsim.cam_extrinsic(device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="kitchen_sink"):
        slam.add_frame(frames[0]["image"], frames[0]["depth"], frames[0]["odom_pose"],
                       frames[0]["stamp"])


# ---------------------------------------------------------------------------
# tests/test_pr_methods.py through the port's Slam
# ---------------------------------------------------------------------------

def _pr_cfg(method, **rec_kw):
    """tests/test_pr_methods.py's ``_cfg``."""
    return TCfg(node_capacity=64, edge_capacity=256, feats_per_node=96, scan_bins=180,
                keyframe=TKf(new_node_distance=0.25),
                estimation=TEst(min_consensus=10, min_matching_score=8.0),
                recognition=TRec(method=method, **rec_kw))


@pytest.fixture(scope="module")
def pr_world():
    world = tsim.WallWorld(img_h=96, img_w=128)
    return world, tsim.simulate_sequence(world, n_frames=30, odom_drift=0.06, length=4.0)


def _run(cfg, world, frames, vocabulary=None):
    slam = tpipe.Slam(cfg, cam=world.cam, cam_pose=tsim.cam_extrinsic(device="cpu"),
                      device="cpu", vocabulary=vocabulary)
    slam.optimize_every = 10**9
    infos = [i for i in (slam.add_frame(fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"])
                         for fr in frames) if i is not None]
    return slam, sum(int(i["n_edges_proposed"]) for i in infos)


@pytest.mark.parametrize("method, rec_kw", [
    ("feature_set", dict(min_descriptors=20, min_similarity=0.15)),
    ("repository", dict(repo_min_votes=5, repo_desc_per_node=48)),
])
def test_method_proposes_closures(pr_world, method, rec_kw):
    world, frames = pr_world
    slam, proposed = _run(_pr_cfg(method, **rec_kw), world, frames)
    assert proposed >= 3
    if method == "repository":
        assert int(slam.state.repo.num_desc) > 0


def test_bow_method_proposes_closures_with_a_port_built_vocabulary(pr_world):
    """The vocabulary trained by the port (K23's plain versions here) on
    descriptors of every sixth frame, as tests/test_pr_methods.py trains
    JAX's."""
    from uzliti_slam_tpu_torch.ops import features as tfeat

    world, frames = pr_world
    descs = [tfeat.detect_and_describe(torch.from_numpy(fr["image"]).float()[None],
                                       max_keypoints=96)[1].reshape(-1, 32)
             for fr in frames[::6]]
    vocab = tvoc.build_vocabulary(torch.cat(descs), k=64, iterations=6,
                                  generator=torch.Generator().manual_seed(0))
    slam, proposed = _run(_pr_cfg("bow", bow_words=64, bow_min_score=0.2), world, frames, vocab)
    assert proposed >= 3 and bool(slam.state.bow.valid.any())
