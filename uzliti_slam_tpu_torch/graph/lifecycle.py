"""Graph lifecycle: scope window, eviction, node merging, compaction and
capacity growth.

The port's counterpart of ``uzliti_slam_tpu/graph/lifecycle.py``:

- ``scope_radius``, ``out_of_scope_mask`` and ``evict_nodes``: the local
  scope window of a sub-graph (the reference evicts shipped nodes beyond
  ``max(scope_size_min, scope_size_factor · uncertainty)`` + a margin);
- ``find_merge_pairs`` (kernel K19 on a CUDA device), ``merge_nodes`` and
  ``merge_step``: revisited-area densification control, close node pairs
  outside the scope merged into the older node at their geodesic average,
  edges rewired with a displacement rewrite and self-loops dropped;
- ``compact_graph``: slot reclamation, live nodes and edges moved to the
  front in a stable order;
- ``ensure_capacity``: host-side growth to the next capacity tier.

The reference runs these under ``jax.jit``, where XLA on the CPU contracts
each multiply into the add that consumes it.  The gates that decide which
nodes are evicted or merged follow that compiled form (``_norm3``, and the
translation distance and rotation angle of ``kernels.ops.merge_pairs``),
so the same pairs are found.
"""

from __future__ import annotations

import torch

from uzliti_slam_tpu_torch.graph.state import GPS_ANCHOR_UID, GraphState
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie


def _norm3(v: torch.Tensor) -> torch.Tensor:
    """‖v‖ over the last axis (3) as ``jnp.linalg.norm`` compiles on the
    CPU: sqrt(fma(z, z, fma(y, y, x·x)))."""
    return kops.sqrt_f32(kops.sum_sq_fma(*v.unbind(-1)))


def scope_radius(uncertainty: torch.Tensor, scope_size_min: float = 8.0,
                 scope_size_factor: float = 0.1) -> torch.Tensor:
    """Adaptive local-scope radius (``graph_slam_node.cpp:586``)."""
    return torch.clamp(scope_size_factor * uncertainty, min=scope_size_min)


def out_of_scope_mask(g: GraphState, center: torch.Tensor, radius: torch.Tensor,
                      margin: float = 4.0, shipped: torch.Tensor | None = None) -> torch.Tensor:
    """Nodes eligible for eviction: valid, farther than radius + margin
    from the robot, not the GPS anchor, and (with ``shipped``) already
    ACKed by the global graph (``graph_slam_node.cpp:619-660``)."""
    d = _norm3(lie.pose_t(g.pose) - lie.pose_t(center)[None])
    mask = g.node_valid & (d > radius + margin) & (g.node_uid != GPS_ANCHOR_UID)
    if shipped is not None:
        mask = mask & shipped
    return mask


def evict_nodes(g: GraphState, evict: torch.Tensor) -> GraphState:
    """Invalidate the evicted nodes and every edge touching them."""
    edge_dead = evict[g.e_from.long()] | evict[g.e_to.long()]
    return g.replace(node_valid=g.node_valid & ~evict, node_fixed=g.node_fixed & ~evict,
                     e_valid=g.e_valid & ~edge_dead)


def find_merge_pairs(g: GraphState, center: torch.Tensor, radius: torch.Tensor,
                     dist_thresh: float = 0.25, angle_thresh_deg: float = 15.0,
                     margin: float = 6.0, max_pairs: int = 16):
    """Candidate (keep, absorb) node pairs: closer than ``dist_thresh`` m and
    ``angle_thresh_deg`` degrees, both outside the active scope, keep = the
    older node (``graph_slam_node.cpp:740-747``).  Greedy: ``max_pairs``
    rounds each take the closest remaining pair (ties to the lower flat
    index i·N + j) whose nodes are both unused.  Returns (keep (max_pairs,)
    int32, absorb (max_pairs,) int32, ok (max_pairs,) bool); a round with
    no pair left gives (0, 0, False).  Kernel K19 on a CUDA device."""
    d_center = _norm3(lie.pose_t(g.pose) - lie.pose_t(center)[None])
    eligible = g.node_valid & (d_center > radius + margin)
    return kops.merge_pairs(g.pose.contiguous(), g.stamp.contiguous(), eligible.contiguous(),
                            dist_thresh, angle_thresh_deg, max_pairs)


def _scatter_last(arr: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``arr`` with rows ``idx`` set to ``vals`` in order, a later write to
    the same row winning: the reference's scatter with duplicate indices
    (its masked writes all land on slot N - 1).  Only each row's last
    writer is written, so the result does not depend on the device's
    order."""
    k = idx.shape[0]
    order = torch.arange(k, device=idx.device)
    later = (idx[None, :] == idx[:, None]) & (order[None, :] > order[:, None])
    last = ~later.any(-1)
    # losing writers are redirected to a scratch row past the end
    ext = torch.cat([arr, arr[:1]])
    tgt = torch.where(last, idx.long(), arr.shape[0])
    return ext.index_copy(0, tgt, vals.to(arr.dtype))[:arr.shape[0]]


def merge_nodes(g: GraphState, keep: torch.Tensor, absorb: torch.Tensor,
                ok: torch.Tensor) -> GraphState:
    """Merge each ``ok`` (keep, absorb) pair: the kept node moves to the
    geodesic average of both poses, the absorbed node's edges are rewired
    to it with a displacement rewrite (relative to the kept node's new
    pose), self-loops are dropped and the absorbed node is invalidated
    (``graph_slam_node.cpp:890-1062``; remap ``slam_graph.cpp:191-195``).
    Pairs are disjoint, so the remap is one level."""
    n = g.node_capacity
    dev = g.device
    last = torch.full_like(keep, n - 1)
    abs_idx = torch.where(ok, absorb, last)
    keep_idx = torch.where(ok, keep, last)
    remap0 = torch.arange(n, dtype=torch.int32, device=dev)
    remap = _scatter_last(remap0, abs_idx, torch.where(ok, keep, remap0[abs_idx.long()]))

    pose_keep = g.pose[torch.where(ok, keep, 0).long()]
    pose_abs = g.pose[torch.where(ok, absorb, 0).long()]
    avg = lie.pose_interpolate(pose_keep, pose_abs, 0.5)
    new_pose = _scatter_last(g.pose, keep_idx,
                             torch.where(ok[:, None], avg, g.pose[keep_idx.long()]))

    ef, et = g.e_from.long(), g.e_to.long()
    ef_new, et_new = remap[ef], remap[et]
    disp_from = lie.pose_relative(new_pose[ef_new.long()], g.pose[ef])
    disp_to = lie.pose_relative(g.pose[et], new_pose[et_new.long()])
    moved = _scatter_last(torch.zeros(n, dtype=torch.bool, device=dev), keep_idx, ok)
    adj_f = (ef_new != g.e_from) | moved[ef]
    adj_t = (et_new != g.e_to) | moved[et]
    T = g.e_transform
    T = torch.where(adj_f[:, None], lie.pose_compose(disp_from, T), T)
    T = torch.where(adj_t[:, None], lie.pose_compose(T, disp_to), T)
    absorbed = _scatter_last(torch.zeros(n, dtype=torch.bool, device=dev), abs_idx, ok)
    return g.replace(
        pose=new_pose, e_from=ef_new, e_to=et_new, e_transform=T,
        e_valid=g.e_valid & (ef_new != et_new),
        node_valid=g.node_valid & ~absorbed,
        merged_into=remap[g.merged_into.long()],
    )


def merge_step(g: GraphState, center: torch.Tensor, radius: torch.Tensor,
               **kwargs) -> tuple[GraphState, torch.Tensor]:
    """One merge epoch (the reference's ``mergeTimerCallback``): (graph,
    number of merges as a () int tensor)."""
    ki, ai, ok = find_merge_pairs(g, center, radius, **kwargs)
    return merge_nodes(g, ki, ai, ok), ok.sum()


def _stable_front(live: torch.Tensor) -> torch.Tensor:
    """Slots of ``live`` first, then the rest, each in slot order (int32):
    a stable partition."""
    return torch.sort(torch.where(live, 0, 1), stable=True).indices.to(torch.int32)


def compact_graph(g: GraphState) -> tuple[GraphState, dict]:
    """Slot reclamation: live nodes and edges permuted to the front in a
    stable order, so the high-water marks shrink to the live counts and the
    freed capacity is reused (the reference frees map entries on
    ``removeNode``, ``slam_graph.cpp:216-229``).  The newest node stays the
    last live slot.

    Returns (graph, perm): ``node_order`` (N,) the old slot at each new
    slot, ``node_inv`` (N,) each old slot's new slot (-1 if dead),
    ``edge_order`` (E,) the old edge slot at each new slot, ``edge_kept``
    (E,) whether the edge at a new slot survived (int32, bool)."""
    n, e = g.node_capacity, g.edge_capacity
    dev = g.device
    valid = g.node_valid
    node_order = _stable_front(valid)
    no = node_order.long()
    ar_n = torch.arange(n, dtype=torch.int32, device=dev)
    pos = torch.empty_like(ar_n).index_copy_(0, no, ar_n)
    node_inv = torch.where(valid, pos, -1)
    live = valid[no]

    # merged_into: old slot -> live old slot, re-expressed in new slots
    mi = node_inv[g.merged_into[no].long()]
    mi = torch.where((mi >= 0) & live, mi, ar_n)

    # edges whose endpoints are both live (still-invalid pending closures of
    # dead nodes go: an evicted endpoint can never validate them)
    in_table = torch.arange(e, device=dev) < g.num_edges
    keep = in_table & valid[g.e_from.long()] & valid[g.e_to.long()]
    edge_order = _stable_front(keep)
    eo = edge_order.long()
    kept = keep[eo]

    def eperm(a):
        return torch.where(kept.reshape((-1,) + (1,) * (a.dim() - 1)), a[eo], 0)

    ef = torch.clamp(node_inv[g.e_from[eo].long()], min=0)
    et = torch.clamp(node_inv[g.e_to[eo].long()], min=0)
    # the identity pose made on the device: writing a Python scalar into a
    # CUDA tensor (lie.pose_identity) would synchronise
    ident = (torch.arange(7, device=dev) == 3).to(g.e_transform.dtype)
    g2 = g.replace(
        pose=g.pose[no], odom_pose=g.odom_pose[no], stamp=g.stamp[no],
        uncertainty=g.uncertainty[no], node_valid=live, node_fixed=g.node_fixed[no],
        merged_into=mi, node_uid=torch.where(live, g.node_uid[no], -1),
        e_from=torch.where(kept, ef, 0), e_to=torch.where(kept, et, 0),
        e_transform=torch.where(kept[:, None], g.e_transform[eo], ident),
        e_info=eperm(g.e_info), e_type=eperm(g.e_type), e_valid=kept & g.e_valid[eo],
        e_error=eperm(g.e_error), e_age=eperm(g.e_age), e_score=eperm(g.e_score),
        num_nodes=valid.sum(dtype=torch.int32), num_edges=keep.sum(dtype=torch.int32),
    )
    perm = {"node_order": node_order, "node_inv": node_inv, "edge_order": edge_order,
            "edge_kept": kept}
    return g2, perm


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
