"""On-device shortest-path relaxation over the pose graph.

PyTorch counterpart of ``uzliti_slam_tpu/graph/shortest_path.py``: masked
Bellman-Ford sweeps relax every valid edge in parallel, in both directions,
from the sweep's start distances.  Edge length is the Euclidean distance
between endpoint positions.  The sweeps are kernel K5 on a CUDA device:
``shortest_paths`` reaches its rows entry (``kernels/ops.relax_min``),
``pairwise_graph_distance`` its pairs entry (``relax_pairs``) and
``reevaluate_uncertainty`` its uncertainty entry (``relax_uncertainty``),
each after K5's table (``relax_table``).
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


def shortest_paths(g: GraphState, source_dist0: torch.Tensor, n_iters: int = 64,
                   use_uncertainty_weight: bool = False) -> torch.Tensor:
    """Multi-source Bellman-Ford. ``source_dist0``: (N,) initial distances
    (0 at sources, INF elsewhere). Returns (N,) geodesic distances (K5,
    ``kernels/ops.relax_min``).

    With ``use_uncertainty_weight`` the edge length becomes
    1/sqrt(info[0,0]).
    """
    return kops.relax_min(source_dist0[None].contiguous(), g.e_from, g.e_to,
                          _weights(g, use_uncertainty_weight), n_iters)[0]


def pairwise_graph_distance(g: GraphState, sources: torch.Tensor, targets: torch.Tensor,
                            n_iters: int = 64) -> torch.Tensor:
    """Graph distance between B (source, target) node pairs; (B,): one
    relaxation a pair, all pairs at once (K5's pairs entry,
    ``kernels/ops.relax_pairs``)."""
    return kops.relax_pairs(sources.to(torch.int32).contiguous(),
                            targets.to(torch.int32).contiguous(), g.e_from, g.e_to,
                            _weights(g, False), g.node_capacity, n_iters)


def reevaluate_uncertainty(g: GraphState, n_iters: int = 64) -> GraphState:
    """Uncertainty = geodesic distance from the oldest valid node (the
    least stamp; the first slot on a tie), where a node is valid and
    reached (K5's uncertainty entry, ``kernels/ops.relax_uncertainty``: the
    root, the relaxation and the write-back in one launch)."""
    return g.replace(uncertainty=kops.relax_uncertainty(
        g.stamp, g.node_valid, g.uncertainty, g.e_from, g.e_to, _weights(g, False), n_iters))
