"""Port parity: uzliti_slam_tpu_torch.graph.shortest_path against JAX.

Both sides run Bellman-Ford in float32 with the same adds and minima, so
the distances agree to ``rtol=1e-6``: the edge lengths come from two norm
implementations (last-ulp differences), summed along at most 64 hops.
Unreachable nodes are exactly INF on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import shortest_path as jsp
from uzliti_slam_tpu.io import synthetic as jsynthetic
from uzliti_slam_tpu_torch.graph import shortest_path as tsp
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.kernels import ops as kops

RTOL = 1e-6


def _to_port(g):
    return tstate.from_numpy({k: np.asarray(v) for k, v in g._asdict().items()}, device="cpu")


@pytest.fixture(scope="module")
def graph96():
    g, _ = jsynthetic.make_pose_graph(jax.random.PRNGKey(11), 96, loop_closure_every=6,
                                      radius=2.0)
    # one invalid edge, so that INF weights take part
    return g._replace(e_valid=g.e_valid.at[40].set(False))


@pytest.mark.parametrize("n_iters", [5, 64], ids=["below_hop_diameter", "default"])
@pytest.mark.parametrize("weight", ["length", "uncertainty"])
def test_shortest_paths_match_jax(graph96, n_iters, weight):
    g = graph96
    unc = weight == "uncertainty"
    d0 = jnp.full((g.node_capacity,), jsp.INF).at[3].set(0.0)
    ref = np.asarray(jsp.shortest_paths(g, d0, n_iters, use_uncertainty_weight=unc))
    got = tsp.shortest_paths(_to_port(g), torch.from_numpy(np.array(d0)), n_iters,
                             use_uncertainty_weight=unc).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    np.testing.assert_array_equal(got == tsp.INF, ref == jsp.INF)
    if n_iters == 5:
        # Jacobi sweeps: five sweeps reach at most five hops along the chain;
        # an in-place sweep would have reached further
        assert (got[10:40] == tsp.INF).all() and (got[:9] < tsp.INF).all()


def test_pairwise_graph_distance_matches_jax(graph96):
    g = graph96
    rng = np.random.default_rng(0)
    src = rng.integers(0, 96, 24).astype(np.int32)
    tgt = rng.integers(0, 96, 24).astype(np.int32)
    ref = np.asarray(jsp.pairwise_graph_distance(g, jnp.asarray(src), jnp.asarray(tgt)))
    got = tsp.pairwise_graph_distance(_to_port(g), torch.from_numpy(src),
                                      torch.from_numpy(tgt)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_reevaluate_uncertainty_matches_jax(graph96):
    g = graph96._replace(
        node_valid=graph96.node_valid.at[0].set(False),   # the root moves to node 1
        uncertainty=jnp.full((graph96.node_capacity,), 7.0))
    ref = np.asarray(jsp.reevaluate_uncertainty(g).uncertainty)
    got = tsp.reevaluate_uncertainty(_to_port(g)).uncertainty.numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    assert got[1] == 0.0 and got[0] == 7.0


def _chain600(dup_edges=True):
    """A 600-node circle of two laps with a closure every 40 nodes to the
    node one lap ahead (a ladder: over 64 hops across), from the port's
    seeded generator, crossed to JAX as arrays; two padded edge slots
    duplicate real edges."""
    from uzliti_slam_tpu.graph import state as jstate
    from uzliti_slam_tpu_torch.io import synthetic as tsyn

    g, _ = tsyn.make_pose_graph(600, loop_closure_every=40, edge_capacity=640,
                                generator=torch.Generator().manual_seed(5), device="cpu")
    arrays = tstate.to_numpy(g)
    ne = int(arrays["num_edges"])
    if dup_edges:
        for slot, src in ((ne, 10), (ne + 1, 605)):
            for k in ("e_from", "e_to", "e_valid", "e_transform", "e_info", "e_type"):
                arrays[k][slot] = arrays[k][src]
    jg = jstate.GraphState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return jg, arrays


def _hop_diameter_from(arrays, src):
    n = arrays["stamp"].shape[0]
    adj = [[] for _ in range(n)]
    for a, b, v in zip(arrays["e_from"], arrays["e_to"], arrays["e_valid"]):
        if v:
            adj[a].append(b)
            adj[b].append(a)
    hops, frontier, seen = 0, [src], {src}
    while frontier:
        frontier = [v for u in frontier for v in adj[u] if v not in seen and not seen.add(v)]
        hops += bool(frontier)
    return hops


def test_relax_pairs_beyond_the_hop_limit_match_jax():
    jg, arrays = _chain600()
    assert _hop_diameter_from(arrays, 0) > 64
    rng = np.random.default_rng(4)
    src = np.concatenate([[0, 0, 599], rng.integers(0, 600, 29)]).astype(np.int32)
    tgt = np.concatenate([[150, 64, 300], rng.integers(0, 600, 29)]).astype(np.int32)
    ref = np.asarray(jsp.pairwise_graph_distance(jg, jnp.asarray(src), jnp.asarray(tgt)))
    tg = tstate.from_numpy(arrays, device="cpu")
    got = tsp.pairwise_graph_distance(tg, torch.from_numpy(src), torch.from_numpy(tgt)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    np.testing.assert_array_equal(got == tsp.INF, ref == jsp.INF)
    w = tsp._weights(tg, False)
    plain = kops.relax_pairs_plain(torch.from_numpy(src), torch.from_numpy(tgt), tg.e_from,
                                   tg.e_to, w, tg.node_capacity, 64).numpy()
    np.testing.assert_array_equal(plain, got)
    # 150 hops from 0 (half a lap either way): not reached in 64 sweeps; 64 and 40 hops: reached
    assert got[0] == tsp.INF and got[1] < tsp.INF and got[2] < tsp.INF


@pytest.mark.parametrize("case", ["tied_oldest", "no_valid_node", "oldest_invalid"])
def test_relax_uncertainty_matches_jax(case):
    jg, arrays = _chain600()
    arrays["uncertainty"][:] = 7.0
    if case == "tied_oldest":
        arrays["stamp"][[9, 4]] = arrays["stamp"].min() - 1.0   # slot 4 is the first of the tie
    elif case == "no_valid_node":
        arrays["node_valid"][:] = False
    else:
        arrays["node_valid"][:3] = False
    jg = jg._replace(**{k: jnp.asarray(arrays[k]) for k in ("stamp", "node_valid",
                                                            "uncertainty")})
    ref = np.asarray(jsp.reevaluate_uncertainty(jg).uncertainty)
    tg = tstate.from_numpy(arrays, device="cpu")
    got = tsp.reevaluate_uncertainty(tg).uncertainty.numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL)
    plain = kops.relax_uncertainty_plain(tg.stamp, tg.node_valid, tg.uncertainty, tg.e_from,
                                         tg.e_to, tsp._weights(tg, False), 64).numpy()
    np.testing.assert_array_equal(plain, got)
    if case == "tied_oldest":
        assert got[4] == 0.0 and got[9] > 0.0
    if case == "no_valid_node":
        assert (got == 7.0).all()
    if case == "oldest_invalid":
        assert got[3] == 0.0 and (got[:3] == 7.0).all()
    # beyond 64 hops of the root the uncertainty keeps its old value
    assert (got == 7.0).sum() > 100 or case == "no_valid_node"
