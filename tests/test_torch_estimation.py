"""The "pnp" and "gicp" estimators through the port's keyframe step against
JAX's, step by step, on the CPU.

A 96x128 WallWorld out-and-back drive (12 frames over 3 m), six keyframes
of it — three going out, three coming back near the start, so that the
return leg proposes distance closures — in the default configuration with
``estimation.method`` "pnp" or "gicp", 64 features and 90 scan bins.  Before
each step the JAX state is carried into the port (``state_from_numpy``,
the voxel clouds included); for "pnp" JAX's uniform keys of the step are
injected: ``split(state.prng)`` gives the step's key, ``split(key, 2·k)``
one key per candidate, ``uniform(key_i, (pnp_hypotheses, F))`` its keys.
Held, with their reasons:

- the new slot, the candidate and proposed-edge counts, every edge's
  endpoints, type, validity and score exactly (discrete; the PnP consensus
  is an inlier count, the gicp score 100 × a count ratio);
- loop-closure transforms within 1e-4 for "pnp" (8 Gauss-Newton steps
  whose 6x6 solves LAPACK and the port's LU round differently; the fixed
  point is the same) and 3e-4 for "gicp" (20 ICP steps whose
  correspondences are argmins over voxel means: a source point with two
  targets an ulp apart in its 6-D distance changes its correspondence on
  one side, which moves the converged pose by ~1e-4 m), information within
  1e-3 relative (the PnP's 0.1·consensus/mse: the mse of the same inliers
  summed in another order);
- the node's voxel cloud: validity exactly, points within 1e-6 m (the
  fixed-point means against JAX's float32 sums), Lab within 1e-3 (XLA's
  pow and cbrt against torch's).

Then ``_merge_banks``' cloud union, ``compact_state`` and ``grow_state``
with the clouds against JAX's (tests/test_estimation_methods.py's runs
through the port's ``Slam`` are ``tests/test_torch_estimation_runs.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_keyframe import jax_state_arrays

from uzliti_slam_tpu import pipeline as jpipe
from uzliti_slam_tpu.config import EdgeEstimationConfig as JEst
from uzliti_slam_tpu.config import SlamConfig as JCfg
from uzliti_slam_tpu.graph import lifecycle as jlife
from uzliti_slam_tpu.io import simulator as jsim
from uzliti_slam_tpu_torch import pipeline as tpipe
from uzliti_slam_tpu_torch.config import EdgeEstimationConfig as TEst
from uzliti_slam_tpu_torch.config import SlamConfig as TCfg
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import simulator as tsim

FEATS, BINS = 64, 90
SHAPE = dict(node_capacity=32, edge_capacity=256, feats_per_node=FEATS, scan_bins=BINS)
GATES = dict(min_consensus=8, min_matching_score=6.0)
KEYFRAMES = (0, 1, 2, 9, 10, 11)
CLOUD = ("clouds", "cloud_lab", "cloud_valid")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small CPU ops: one intra-op thread, so that parallel test
    workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(method: str):
    return (JCfg(**SHAPE, estimation=JEst(method=method, **GATES)),
            TCfg(**SHAPE, estimation=TEst(method=method, **GATES)))


def state_arrays(st) -> dict:
    """A JAX SlamState's fields, the voxel clouds included, as
    ``state_from_numpy`` takes them."""
    out = jax_state_arrays(st)
    if st.clouds is not None:
        out.update({k: np.asarray(getattr(st, k)) for k in CLOUD})
    return out


def jax_pnp_keys(pre, cfg) -> np.ndarray:
    """The uniform keys of JAX's PnP draws in this step, one (H, F) block a
    candidate (``pipeline.py:185, 478``; ``pnp.py:144``)."""
    nb = 2 * cfg.recognition.k_candidates
    keys = jax.random.split(jax.random.split(pre.prng)[1], nb)
    return np.stack([np.asarray(jax.random.uniform(k, (cfg.estimation.pnp_hypotheses, FEATS)))
                     for k in keys])


def _keyframe(fr):
    return jpipe.Keyframe(image=jnp.asarray(fr["image"]), depth=jnp.asarray(fr["depth"]),
                          odom_pose=jnp.asarray(fr["odom_pose"]), stamp=jnp.float32(fr["stamp"]))


def _camera():
    """The port's camera and the extrinsic of the 96x128 WallWorld drive."""
    return tsim.WallWorld(img_h=96, img_w=128, tex_size=64).cam, np.asarray(jsim.cam_extrinsic())


def run_steps(method: str, sequence):
    jcfg, tcfg = _configs(method)
    world, frames = sequence
    cam_t, pose = _camera()
    st_j = jpipe.init_state(jcfg)
    out = []
    for i in KEYFRAMES:
        fr = frames[i]
        pre = state_arrays(st_j)
        keys = jax_pnp_keys(st_j, jcfg) if method == "pnp" else None
        # process_keyframe donates its state: hand it a copy, keep the pre-state
        post_j, info_j = jpipe.process_keyframe(jax.tree.map(jnp.copy, st_j), _keyframe(fr),
                                                world.cam, jnp.asarray(pose), jcfg)
        st_t = tpipe.state_from_numpy(pre, device="cpu", config=tcfg)
        post_t, info_t = tpipe.process_keyframe(
            st_t, fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"], cam_t, pose, tcfg,
            pnp_keys=None if keys is None else torch.from_numpy(keys))
        out.append((post_j, info_j, post_t, info_t))
        st_j = post_j
    return out


@pytest.fixture(scope="module")
def sequence():
    """The 96x128 WallWorld drive: (world, 12 frames over 3 m)."""
    world = jsim.WallWorld(img_h=96, img_w=128)
    return world, jsim.simulate_sequence(world, n_frames=12, odom_drift=0.06, length=3.0)


@pytest.fixture(scope="module")
def pnp_steps(sequence):
    return run_steps("pnp", sequence)


@pytest.fixture(scope="module")
def gicp_steps(sequence):
    return run_steps("gicp", sequence)


def _check_step(post_j, info_j, post_t, info_t, tf_atol: float):
    for k in ("new_slot", "n_candidates", "n_edges_proposed", "n_features"):
        assert int(info_t[k]) == int(info_j[k]), k
    gj, gt = post_j.graph, post_t.graph
    ne = int(gj.num_edges)
    assert int(gt.num_edges) == ne and int(gt.num_nodes) == int(gj.num_nodes)
    for f in ("e_from", "e_to", "e_type", "e_valid", "e_score", "node_valid", "node_uid"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(gj, f)), err_msg=f)
    lc = np.asarray(gj.e_type[:ne]) == tstate.EDGE_TYPE_3D_FULL
    tf_j, tf_t = np.asarray(gj.e_transform[:ne]), gt.e_transform[:ne].numpy()
    inf_j, inf_t = np.asarray(gj.e_info[:ne]), gt.e_info[:ne].numpy()
    np.testing.assert_allclose(tf_t[lc], tf_j[lc], atol=tf_atol)
    np.testing.assert_allclose(inf_t[lc], inf_j[lc], rtol=1e-3,
                               atol=1e-3 * max(np.abs(inf_j[lc]).max(initial=0.0), 1.0))


@pytest.mark.parametrize("step", range(len(KEYFRAMES)))
def test_pnp_step_matches_jax(pnp_steps, step):
    _check_step(*pnp_steps[step], tf_atol=1e-4)


@pytest.mark.parametrize("step", range(len(KEYFRAMES)))
def test_gicp_step_matches_jax(gicp_steps, step):
    post_j, info_j, post_t, info_t = gicp_steps[step]
    _check_step(post_j, info_j, post_t, info_t, tf_atol=3e-4)
    s = int(info_j["new_slot"])
    valid = np.asarray(post_j.cloud_valid[s])
    np.testing.assert_array_equal(post_t.cloud_valid[s].numpy(), valid)
    assert valid.sum() >= 100
    np.testing.assert_allclose(post_t.clouds[s].numpy()[valid],
                               np.asarray(post_j.clouds[s])[valid], atol=1e-6)
    np.testing.assert_allclose(post_t.cloud_lab[s].numpy()[valid],
                               np.asarray(post_j.cloud_lab[s])[valid], atol=1e-3)


@pytest.mark.parametrize("method", ["pnp", "gicp"])
def test_the_return_leg_proposes_closures(pnp_steps, gicp_steps, method):
    steps = pnp_steps if method == "pnp" else gicp_steps
    proposed = [int(i_j["n_edges_proposed"]) for _, i_j, _, _ in steps]
    assert sum(proposed[3:]) >= 2, proposed


def test_slam_reports_its_pnp_keys_and_replays_them(pnp_steps, sequence):
    """A step without injected keys draws them from the state's generator
    and reports them (``info["pnp_keys"]``); handed to ``Slam.add_frame``
    of a state with another generator, they give the same graph bit for
    bit (how a card run is replayed on CPU tensors)."""
    _, tcfg = _configs("pnp")
    cam_t, pose = _camera()
    pre, fr = pnp_steps[4][2], sequence[1][KEYFRAMES[5]]

    def step(seed, **draws):
        slam = tpipe.Slam(tcfg, cam=cam_t, cam_pose=pose, device="cpu")
        slam.optimize_every = 10**9
        slam.state = pre.replace(generator=torch.Generator().manual_seed(seed))
        return slam, slam.add_frame(fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"],
                                    **draws)

    a, info_a = step(1)
    b, info_b = step(2, pnp_keys=info_a["pnp_keys"])
    _, info_c = step(2)
    assert int(info_a["n_edges_proposed"]) > 0
    assert info_a["pnp_keys"].shape == (2 * tcfg.recognition.k_candidates,
                                        tcfg.estimation.pnp_hypotheses, FEATS)
    assert "tri" not in info_a
    assert torch.equal(info_b["pnp_keys"], info_a["pnp_keys"])
    assert not torch.equal(info_c["pnp_keys"], info_a["pnp_keys"])
    for f in ("e_from", "e_to", "e_valid", "e_score", "e_transform", "e_info", "pose"):
        assert torch.equal(getattr(b.state.graph, f), getattr(a.state.graph, f)), f


def test_merge_banks_unions_the_clouds(gicp_steps):
    """``_merge_banks`` on JAX's last gicp state: two pairs merged (one
    kept node with free voxel slots), the clouds moved into the kept nodes'
    new frames and backfilled in the reference's priority order."""
    post_j = gicp_steps[-1][0]
    _, tcfg = _configs("gicp")
    st_j = post_j._replace(cloud_valid=post_j.cloud_valid.at[1, 100:].set(False))
    ki, ai = jnp.array([1, 2], jnp.int32), jnp.array([4, 3], jnp.int32)
    ok = jnp.array([True, True])
    g_after = jlife.merge_nodes(st_j.graph, ki, ai, ok)
    merged_j = jpipe._merge_banks(st_j, st_j.graph, g_after, ki, ai, ok, BINS)
    st_t = tpipe.state_from_numpy(state_arrays(st_j), device="cpu", config=tcfg)
    g_after_t = tstate.from_numpy({k: np.asarray(v) for k, v in g_after._asdict().items()}, "cpu")
    merged_t = tpipe._merge_banks(st_t, st_t.graph, g_after_t, torch.tensor([1, 2]),
                                  torch.tensor([4, 3]), torch.tensor([True, True]), BINS)
    np.testing.assert_array_equal(merged_t.cloud_valid.numpy(), np.asarray(merged_j.cloud_valid))
    np.testing.assert_allclose(merged_t.clouds.numpy(), np.asarray(merged_j.clouds), atol=1e-5)
    np.testing.assert_array_equal(merged_t.cloud_lab.numpy(), np.asarray(merged_j.cloud_lab))
    assert not np.array_equal(np.asarray(merged_j.clouds[1]), np.asarray(st_j.clouds[1]))
    dropped = tpipe._drop_from_banks(merged_t, torch.arange(SHAPE["node_capacity"]) == 4)
    assert not bool(dropped.cloud_valid[4].any()) and bool(dropped.cloud_valid[1].any())


def test_compact_and_grow_carry_the_clouds(gicp_steps):
    post_j = gicp_steps[-1][0]
    _, tcfg = _configs("gicp")
    g = post_j.graph
    st_j = post_j._replace(graph=g._replace(node_valid=g.node_valid.at[1].set(False)
                                            .at[3].set(False)))
    st_t = tpipe.state_from_numpy(state_arrays(st_j), device="cpu", config=tcfg)
    comp_j, _ = jpipe.compact_state(jax.tree.map(jnp.copy, st_j))
    comp_t, _ = tpipe.compact_state(st_t)
    for k in CLOUD:
        np.testing.assert_array_equal(getattr(comp_t, k).numpy(), np.asarray(getattr(comp_j, k)),
                                      err_msg=k)
    grown_j = jpipe.grow_state(st_j, 64, 300)
    grown_t = tpipe.grow_state(st_t, 64, 300)
    for k in CLOUD:
        np.testing.assert_array_equal(getattr(grown_t, k).numpy(), np.asarray(getattr(grown_j, k)),
                                      err_msg=k)


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="teleport"):
        tpipe.Slam(TCfg(**SHAPE, estimation=TEst(method="teleport")), device="cpu")
    with pytest.raises(ValueError, match="teleport"):
        tpipe.process_keyframe(tpipe.init_state(TCfg(**SHAPE), device="cpu"), None, None, None,
                               0.0, None, None, TCfg(**SHAPE, estimation=TEst(method="teleport")))


def test_slam_retunes_the_estimators_gates():
    slam = tpipe.Slam(TCfg(**SHAPE, estimation=TEst(method="pnp")), device="cpu")
    jslam = jpipe.Slam(JCfg(**SHAPE, estimation=JEst(method="pnp")))
    for name, value in (("gicp_max_corr", 0.3), ("pnp_reproj_px", 2.5)):
        slam.set_param(name, value)
        jslam.set_param(name, value)
        assert getattr(slam.state.tunables, name) == float(getattr(jslam.state.tunables, name))
    assert dataclasses.asdict(slam.state.tunables).keys() == jslam.state.tunables._asdict().keys()
