"""Graph lifecycle: capacity growth.

The port's counterpart of ``uzliti_slam_tpu/graph/lifecycle.py``'s
``ensure_capacity``, which ``pipeline.grow_state`` needs.  Merging,
eviction, compaction and the scope radius are not ported.
"""

from __future__ import annotations

import torch

from uzliti_slam_tpu_torch.graph.state import GraphState
from uzliti_slam_tpu_torch.ops import lie


def _pad_rows(arr: torch.Tensor, cap: int, fill=0) -> torch.Tensor:
    pad = cap - arr.shape[0]
    if pad <= 0:
        return arr
    return torch.cat([arr, arr.new_full((pad,) + tuple(arr.shape[1:]), fill)])


def _identity_rows(poses: torch.Tensor, cap: int) -> torch.Tensor:
    """Poses padded to ``cap`` rows of the identity [0, 0, 0, 1, 0, 0, 0]."""
    pad = cap - poses.shape[0]
    if pad <= 0:
        return poses
    return torch.cat([poses, lie.pose_identity((pad,), poses.device).to(poses.dtype)])


def ensure_capacity(g: GraphState, min_nodes: int, min_edges: int,
                    growth: float = 2.0) -> GraphState:
    """``g`` re-padded to the next capacity tier (× ``growth`` until at least
    ``min_nodes`` node and ``min_edges`` edge slots), or ``g`` itself if it
    has them: new node slots are invalid with identity poses, their own
    ``merged_into`` slot and uid -1; new edge slots are empty with identity
    transforms.  Changes shapes (a host-side step between keyframes)."""
    ncap, ecap = g.node_capacity, g.edge_capacity
    new_n, new_e = ncap, ecap
    while new_n < min_nodes:
        new_n = int(new_n * growth)
    while new_e < min_edges:
        new_e = int(new_e * growth)
    if new_n == ncap and new_e == ecap:
        return g
    dev = g.device
    return g.replace(
        pose=_identity_rows(g.pose, new_n),
        odom_pose=_identity_rows(g.odom_pose, new_n),
        stamp=_pad_rows(g.stamp, new_n),
        uncertainty=_pad_rows(g.uncertainty, new_n),
        node_valid=_pad_rows(g.node_valid, new_n),
        node_fixed=_pad_rows(g.node_fixed, new_n),
        merged_into=torch.cat([g.merged_into,
                               torch.arange(ncap, new_n, dtype=torch.int32, device=dev)]),
        node_uid=_pad_rows(g.node_uid, new_n, -1),
        e_from=_pad_rows(g.e_from, new_e),
        e_to=_pad_rows(g.e_to, new_e),
        e_transform=_identity_rows(g.e_transform, new_e),
        e_info=_pad_rows(g.e_info, new_e),
        e_type=_pad_rows(g.e_type, new_e),
        e_valid=_pad_rows(g.e_valid, new_e),
        e_error=_pad_rows(g.e_error, new_e),
        e_age=_pad_rows(g.e_age, new_e),
        e_score=_pad_rows(g.e_score, new_e),
    )
