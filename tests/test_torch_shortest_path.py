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
