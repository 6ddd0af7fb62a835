"""Port parity: uzliti_slam_tpu_torch.graph.filter against JAX.

Cluster labels, candidate windows, root compaction and keep masks are
discrete and must agree exactly.  The RANSAC triplets cannot be drawn alike
(``jax.random`` has no PyTorch counterpart), so each test draws them with
JAX's own ``_valid_sample`` from the per-root member masks, with the keys
JAX's filter splits, and injects them into the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import filter as jfilter
from uzliti_slam_tpu.graph import state as jstate
from uzliti_slam_tpu.io import synthetic as jsynthetic
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu.ops import ransac as jransac
from uzliti_slam_tpu_torch.graph import filter as tfilter
from uzliti_slam_tpu_torch.graph import state as tstate

KEY = jax.random.PRNGKey(0)


def _to_port(g):
    return tstate.from_numpy({k: np.asarray(v) for k, v in g._asdict().items()}, device="cpu")


def _jax_triplets(key, member, k_hyp):
    keys = jax.random.split(key, member.shape[0])
    return torch.from_numpy(np.array(jax.vmap(
        lambda k, v: jransac._valid_sample(k, k_hyp, v))(keys, jnp.asarray(member))))


def _graph_with_loop_closures(n=60, bad=()):
    """The outlier graph of tests/test_filter.py: a chain with a loop
    closure from every node to node + 30; closures in ``bad`` corrupted."""
    g, _ = jsynthetic.make_pose_graph(KEY, n, odom_noise=0.01, rot_noise=0.002,
                                      loop_closure_every=1, edge_capacity=256)
    lc = np.where(np.asarray(g.e_type[: int(g.num_edges)]) == jstate.EDGE_TYPE_3D_FULL)[0]
    eT = g.e_transform
    for k in bad:
        eT = eT.at[lc[k]].set(jlie.make_pose(
            jnp.asarray(np.random.default_rng(k).normal(0, 5, 3), jnp.float32),
            jnp.array([1.0, 0, 0, 0])))
    return g._replace(e_transform=eT), lc


@pytest.mark.parametrize("n_iters", [3, 16], ids=["not_converged", "default"])
def test_cluster_labels_match_jax_exactly(n_iters):
    rng = np.random.default_rng(0)
    b = 64
    # a chain of stamps 1 s apart (adjacent within max_dt = 1.5 s): 3 rounds
    # cannot carry the least label along it, so a Jacobi and an in-place
    # round differ; the second half is scattered at random
    sf = np.concatenate([np.arange(32.0), rng.uniform(40, 80, 32)]).astype(np.float32)
    st = (sf + rng.uniform(0, 0.4, b)).astype(np.float32)
    valid = rng.random(b) < 0.9
    valid[:32] = True
    ref = np.asarray(jfilter._cluster_labels(jnp.asarray(sf), jnp.asarray(st),
                                             jnp.asarray(valid), 1.5, n_iters))
    got = tfilter._cluster_labels(torch.from_numpy(sf), torch.from_numpy(st),
                                  torch.from_numpy(valid), 1.5, n_iters).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32
    if n_iters == 3:
        assert got[31] == 28 and got[3] == 0       # three hops from the chain's start


def test_recent_candidates_match_jax():
    rng = np.random.default_rng(1)
    for p in (0.0, 0.2, 0.9):
        mask = rng.random(300) < p
        for size in (1, 16, 256):
            ref = np.asarray(jfilter.recent_candidates(jnp.asarray(mask), size))
            got = tfilter.recent_candidates(torch.from_numpy(mask), size).numpy()
            np.testing.assert_array_equal(got, ref)


def test_edge_heuristic_matches_jax():
    g, _ = jsynthetic.make_pose_graph(KEY, 50, loop_closure_every=10, radius=2.0)
    g = g._replace(pose=g.pose.at[40, 0].add(500.0),       # an implausible endpoint
                   e_valid=g.e_valid.at[20].set(False))    # a cut: 21.. unreachable from 0..20
    rng = np.random.default_rng(2)
    cf = np.concatenate([[0, 0, 0], rng.integers(0, 50, 29)]).astype(np.int32)
    ct = np.concatenate([[1, 40, 30], rng.integers(0, 50, 29)]).astype(np.int32)
    ref = np.asarray(jfilter.edge_heuristic(g, jnp.asarray(cf), jnp.asarray(ct)))
    got = tfilter.edge_heuristic(_to_port(g), torch.from_numpy(cf), torch.from_numpy(ct)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0] and not got[1] and ref.sum() not in (0, len(ref))


def test_filter_loop_closures_on_the_outlier_graph_matches_jax():
    g, lc = _graph_with_loop_closures(bad=(3, 7))
    cand = np.pad(lc, (0, 64 - len(lc)), constant_values=-1).astype(np.int32)
    key = jax.random.PRNGKey(1)
    ref = np.asarray(jfilter.filter_loop_closures(g, jnp.asarray(cand), key))
    gt, cand_t = _to_port(g), torch.from_numpy(cand)
    roots = tfilter.cluster_roots(gt, cand_t)
    tri = _jax_triplets(key, roots.member.numpy(), tfilter.FilterConfig().ransac_hypotheses)
    got = tfilter.filter_loop_closures(gt, cand_t, tri=tri).numpy()
    np.testing.assert_array_equal(got, ref)
    kept = set(cand[got].tolist())
    assert int(lc[3]) not in kept and int(lc[7]) not in kept and len(kept) >= 12


def test_apply_filter_matches_jax():
    g, lc = _graph_with_loop_closures(bad=(5,))
    key = jax.random.PRNGKey(2)
    ref = np.asarray(jfilter.apply_filter(g, key, max_candidates=64).e_valid)
    gt = _to_port(g)
    is_lc = (gt.e_type != tstate.EDGE_TYPE_2D_WHEEL_ODOMETRY) & gt.e_valid
    roots = tfilter.cluster_roots(gt, tfilter.recent_candidates(is_lc, 64))
    tri = _jax_triplets(key, roots.member.numpy(), 128)
    got = tfilter.apply_filter(gt, max_candidates=64, tri=tri).e_valid.numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[int(lc[5])]


def test_filter_draws_its_own_triplets_from_a_generator():
    g, lc = _graph_with_loop_closures(bad=(3, 7))
    cand = torch.from_numpy(np.pad(lc, (0, 64 - len(lc)), constant_values=-1).astype(np.int32))
    keep = tfilter.filter_loop_closures(_to_port(g), cand, torch.Generator().manual_seed(0))
    kept = set(cand[keep].tolist())
    assert int(lc[3]) not in kept and int(lc[7]) not in kept and len(kept) >= 12
