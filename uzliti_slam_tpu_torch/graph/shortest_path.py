"""On-device shortest-path relaxation over the pose graph.

PyTorch counterpart of ``uzliti_slam_tpu/graph/shortest_path.py``: masked
Bellman-Ford sweeps relax every valid edge in parallel, in both directions,
from the sweep's start distances.  Edge length is the Euclidean distance
between endpoint positions.  The sweeps of every row are kernel K5
(``kernels/ops.relax_min``) on a CUDA device.
"""

from __future__ import annotations

import torch

from uzliti_slam_tpu_torch.graph.state import GraphState
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie

INF = kops.INF


def edge_lengths(g: GraphState) -> torch.Tensor:
    """Euclidean length of each edge from current node positions."""
    pf = lie.pose_t(g.pose[g.e_from.long()])
    pt = lie.pose_t(g.pose[g.e_to.long()])
    return torch.linalg.vector_norm(pf - pt, dim=-1)


def _weights(g: GraphState, use_uncertainty_weight: bool) -> torch.Tensor:
    if use_uncertainty_weight:
        w = 1.0 / torch.sqrt(torch.clamp(g.e_info[:, 0, 0], min=1e-12))
    else:
        w = edge_lengths(g)
    return torch.where(g.e_valid, w, INF).contiguous()


def _relax(g: GraphState, dist0: torch.Tensor, n_iters: int,
           use_uncertainty_weight: bool = False) -> torch.Tensor:
    return kops.relax_min(dist0.contiguous(), g.e_from, g.e_to,
                          _weights(g, use_uncertainty_weight), n_iters)


def shortest_paths(g: GraphState, source_dist0: torch.Tensor, n_iters: int = 64,
                   use_uncertainty_weight: bool = False) -> torch.Tensor:
    """Multi-source Bellman-Ford. ``source_dist0``: (N,) initial distances
    (0 at sources, INF elsewhere). Returns (N,) geodesic distances.

    With ``use_uncertainty_weight`` the edge length becomes
    1/sqrt(info[0,0]).
    """
    return _relax(g, source_dist0[None], n_iters, use_uncertainty_weight)[0]


def pairwise_graph_distance(g: GraphState, sources: torch.Tensor, targets: torch.Tensor,
                            n_iters: int = 64) -> torch.Tensor:
    """Graph distance between B (source, target) node pairs; (B,): one
    (B, N) relaxation front, all pairs at once."""
    n = g.node_capacity
    b = sources.shape[0]
    init = torch.full((b, n), INF, device=g.device).scatter(1, sources.long()[:, None], 0.0)
    dist = _relax(g, init, n_iters)
    return torch.gather(dist, 1, targets.long()[:, None])[:, 0]


def reevaluate_uncertainty(g: GraphState, n_iters: int = 64) -> GraphState:
    """Uncertainty = geodesic distance from the oldest valid node (the
    least stamp; the first slot on a tie)."""
    stamp_key = torch.where(g.node_valid, g.stamp, INF)
    root = torch.argmin(stamp_key)
    d0 = torch.full((g.node_capacity,), INF, device=g.device)
    d0 = d0.index_fill(0, root.view(1), 0.0)
    dist = shortest_paths(g, d0, n_iters)
    unc = torch.where(g.node_valid & (dist < INF), dist, g.uncertainty)
    return g.replace(uncertainty=unc)
