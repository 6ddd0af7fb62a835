"""Loop-closure outlier rejection: edge-heuristic gate + spatio-temporal
cluster RANSAC.

PyTorch counterpart of ``uzliti_slam_tpu/graph/filter.py``:

1. ``edge_heuristic``: a candidate edge is plausible iff the graph distance
   between its endpoints can explain their pose discrepancy
   (``2·f·dist + 1 > ‖Δt‖`` and ``10·f·dist + 30° > Δθ``); unreachable
   endpoints are accepted.  Batched multi-source Bellman-Ford (kernel K5).
2. ``filter_loop_closures``: candidates are clustered by from/to stamp
   proximity (kernel K6); every cluster with ≥ min_size edges spanning ≥ 2 s
   on both sides runs RANSAC over its endpoint positions (kernel K7) and
   only its consensus set stays valid; crowded clusters are capped to the
   best + temporally spread edges.

No step reads a device value on the host: the JAX package's sized
``nonzero(size=…, fill_value=-1)`` becomes a cumsum-and-scatter compaction.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from uzliti_slam_tpu_torch.graph import shortest_path
from uzliti_slam_tpu_torch.graph import state as gstate
from uzliti_slam_tpu_torch.graph.state import GraphState
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie, ransac


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """Same fields and defaults as ``uzliti_slam_tpu.graph.filter.FilterConfig``."""

    max_dt: float = 5.0            # cluster stamp proximity
    min_cluster_size: int = 5
    min_time_span: float = 2.0     # per side
    max_error: float = 0.3         # RANSAC inlier radius
    ransac_hypotheses: int = 128
    max_edges_per_cluster: int = 5
    scope_size_factor: float = 0.1


def edge_heuristic(g: GraphState, cand_from: torch.Tensor, cand_to: torch.Tensor,
                   scope_size_factor: float = 0.1, n_iters: int = 64) -> torch.Tensor:
    """Batched ``checkEdgeHeuristic``: (B,) bool plausibility per candidate."""
    dist = shortest_path.pairwise_graph_distance(g, cand_from, cand_to, n_iters)
    rel = lie.pose_relative(g.pose[cand_from.long()], g.pose[cand_to.long()])
    dt = torch.linalg.vector_norm(lie.pose_t(rel), dim=-1)
    dr_deg = lie.rotation_angle(lie.pose_q(rel)) * (180.0 / math.pi)
    reachable = dist < shortest_path.INF
    ok = ((2.0 * scope_size_factor * dist + 1.0 > dt)
          & (10.0 * scope_size_factor * dist + 30.0 > dr_deg))
    return torch.where(reachable, ok, True)


def _cluster_labels(stamp_from, stamp_to, valid, max_dt: float, n_iters: int = 16):
    """Min-label propagation on the stamp adjacency (kernel K6): candidates
    i, j belong together iff both endpoint stamps are within max_dt."""
    return kops.cluster_labels(stamp_from.contiguous(), stamp_to.contiguous(),
                               valid.contiguous(), max_dt, n_iters)


def _compact(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of the first ``size`` True entries of ``mask`` (B,), -1
    padded: ``jnp.nonzero(mask, size=size, fill_value=-1)`` without a host
    read."""
    b = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int32), dim=0) - 1
    slot = torch.where(mask & (pos < size), pos, size).long()
    out = torch.full((size + 1,), -1, dtype=torch.int32, device=mask.device)
    ids = torch.arange(b, dtype=torch.int32, device=mask.device)
    # every spilled or False entry lands in the spare slot ``size``
    return out.scatter(0, slot, ids)[:size]


class ClusterRoots(NamedTuple):
    """What ``filter_loop_closures`` computes before RANSAC."""

    valid: torch.Tensor       # (B,) candidate participates
    labels: torch.Tensor      # (B,) int32 cluster label (B = none)
    root_live: torch.Tensor   # (R,) bool
    root_safe: torch.Tensor   # (R,) int64 root candidate index (0 if dead)
    member: torch.Tensor      # (R, B) bool
    p_pred: torch.Tensor      # (B, 3) predicted 'to' position via the edge
    p_act: torch.Tensor       # (B, 3) actual 'to' position
    sf: torch.Tensor          # (B,) 'from' stamp
    st: torch.Tensor          # (B,) 'to' stamp


def cluster_roots(g: GraphState, cand_idx: torch.Tensor, config: FilterConfig = FilterConfig(),
                  cand_mask: torch.Tensor | None = None) -> ClusterRoots:
    """Endpoint positions, clusters, and the compacted cluster roots that
    run RANSAC, with each root's member mask (``filter.py:105-154``).

    A root is a candidate whose label is its own index and whose cluster
    passed the size and span gates; there are at most
    ``b // min_cluster_size`` of them, in ascending slot order.
    """
    b = cand_idx.shape[0]
    dev = cand_idx.device
    present = cand_idx >= 0
    ci = torch.where(present, cand_idx, 0).long()
    ef, et = g.e_from[ci].long(), g.e_to[ci].long()
    valid = present & (g.e_valid[ci] if cand_mask is None else cand_mask)
    valid = valid & g.node_valid[ef] & g.node_valid[et]

    p_pred = lie.pose_t(lie.pose_compose(g.pose[ef], g.e_transform[ci])).contiguous()
    p_act = lie.pose_t(g.pose[et]).contiguous()
    sf, st = g.stamp[ef], g.stamp[et]
    labels = _cluster_labels(sf, st, valid, config.max_dt)

    # per-cluster stats over b + 1 segments (label b = no cluster)
    lab = labels.long()

    def seg(x, op, init):
        base = torch.full((b + 1,), init, dtype=x.dtype, device=dev)
        return base.scatter_reduce(0, lab, torch.where(valid, x, init), op, include_self=False)

    csize = torch.zeros(b + 1, dtype=torch.int32, device=dev).scatter_add(
        0, lab, valid.to(torch.int32))
    f_min, f_max = seg(sf, "amin", math.inf), seg(sf, "amax", -math.inf)
    t_min, t_max = seg(st, "amin", math.inf), seg(st, "amax", -math.inf)
    runs = ((csize >= config.min_cluster_size)
            & ((f_max - f_min) >= config.min_time_span)
            & ((t_max - t_min) >= config.min_time_span))

    n_roots = max(1, min(b, b // max(config.min_cluster_size, 1)))
    ids = torch.arange(b, device=dev)
    is_root = (lab == ids) & valid & runs[:b]
    root_slot = _compact(is_root, n_roots)
    root_live = root_slot >= 0
    root_safe = torch.where(root_live, root_slot, 0).long()
    member = (lab[None, :] == root_safe[:, None]) & valid[None, :] & root_live[:, None]
    return ClusterRoots(valid, labels, root_live, root_safe, member, p_pred, p_act, sf, st)


def filter_loop_closures(
    g: GraphState,
    cand_idx: torch.Tensor,
    generator: torch.Generator | None = None,
    config: FilterConfig = FilterConfig(),
    cand_mask: torch.Tensor | None = None,
    tri: torch.Tensor | None = None,
) -> torch.Tensor:
    """Validate candidate loop-closure edges (edge-table indices
    ``cand_idx``, (B,) with -1 padding). Returns (B,) bool: which stay valid.

    ``cand_mask`` (B,) selects which candidates participate (default: the
    edges' current validity); a candidate with an invalid endpoint never
    does.  ``tri`` (n_roots, ransac_hypotheses, 3) gives each root's
    hypothesis triplets; without it they are drawn from ``generator``.
    """
    b = cand_idx.shape[0]
    dev = cand_idx.device
    cr = cluster_roots(g, cand_idx, config, cand_mask)
    valid, lab = cr.valid, cr.labels.long()
    n_roots = cr.member.shape[0]

    res = ransac.ransac_rigid_batch(
        cr.p_pred.expand(n_roots, b, 3), cr.p_act.expand(n_roots, b, 3), cr.member,
        config.ransac_hypotheses, config.max_error, config.min_cluster_size,
        tri=tri, generator=generator)
    # consensus mask per root: inliers under each root's model
    pred_t = lie.pose_apply(res.pose[:, None, :], cr.p_pred[None])      # (R, b, 3)
    inlier = (torch.sum((pred_t - cr.p_act[None]) ** 2, dim=-1) < config.max_error**2) & cr.member
    root_ok = res.ok & cr.root_live

    # each candidate's label -> its compacted root row (-1 = none ran); dead
    # rows scatter into the spare slot b
    rowmap = torch.full((b + 1,), -1, dtype=torch.int32, device=dev)
    rowmap = rowmap.scatter(
        0, torch.where(cr.root_live, cr.root_safe, b),
        torch.where(cr.root_live, torch.arange(n_roots, dtype=torch.int32, device=dev), -1))
    my_row = rowmap[torch.clamp(lab, 0, b)]
    row_safe = torch.clamp(my_row, min=0).long()
    ran = (my_row >= 0) & root_ok[row_safe]
    keep = ran & torch.gather(inlier, 0, row_safe[None])[0]   # inlier[row_safe[j], j]

    # cap per cluster: best max_edges_per_cluster by score + spread by stamp,
    # applied only when a cluster keeps more than twice that
    kv = keep & valid
    score = torch.where(kv, g.e_score[torch.where(cand_idx >= 0, cand_idx, 0).long()], -math.inf)
    kmax = config.max_edges_per_cluster
    rank_score = _rank_within_cluster(score, lab)
    rank_time = _rank_within_cluster(-torch.where(kv, cr.sf, math.inf), lab)
    n_kept = torch.zeros(b + 1, dtype=torch.int32, device=dev).scatter_add(
        0, lab, kv.to(torch.int32))[lab]
    crowded = n_kept > 2 * kmax
    spread_pick = (rank_time % torch.clamp(n_kept // kmax, min=1)) == 0
    cap_pick = (rank_score < kmax) | spread_pick
    keep = torch.where(crowded, keep & cap_pick, keep)
    return keep & valid


def recent_candidates(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of the most recent ``size`` True entries of ``mask``
    (-1 padded), in ascending slot order."""
    count = torch.sum(mask, dtype=torch.int32)
    recent = mask & (torch.cumsum(mask.to(torch.int32), dim=0) > count - size)
    return _compact(recent, size)


def _rank_within_cluster(score: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Rank (0 = best) of each element among its cluster by descending score."""
    higher = (labels[None, :] == labels[:, None]) & (score[None, :] > score[:, None])
    return torch.sum(higher, dim=-1)


def apply_filter(g: GraphState, generator: torch.Generator | None = None,
                 config: FilterConfig = FilterConfig(), max_candidates: int = 256,
                 tri: torch.Tensor | None = None) -> GraphState:
    """Run the cluster filter over all non-odometry valid edges and write the
    verdict back into the graph's edge validity."""
    is_lc = (g.e_type != gstate.EDGE_TYPE_2D_WHEEL_ODOMETRY) & g.e_valid
    idx = recent_candidates(is_lc, max_candidates)
    keep = filter_loop_closures(g, idx, generator, config, tri=tri)
    return g.replace(e_valid=write_validity(g.e_valid, idx, keep))


def write_validity(e_valid: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """``e_valid`` with slot ``idx[i]`` set to ``keep[i]`` for every present
    candidate (idx ≥ 0); padding writes into a spare slot that is dropped."""
    E = e_valid.shape[0]
    slot = torch.where(idx >= 0, idx, E).long()
    return torch.cat([e_valid, e_valid[:1]]).scatter(0, slot, keep)[:E]
