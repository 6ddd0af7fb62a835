"""Local/global scope protocol: graph-delta shipping with ACKs.

PyTorch counterpart of ``uzliti_slam_tpu/parallel/scope.py``, the
reference's two-process architecture (a local bounded-scope SLAM and a
global persistent SLAM exchanging deltas with an explicit ACK protocol,
``graph_slam_node.cpp:356-663``):

- ``make_delta``    — the local packs un-ACKed nodes and edges into a
                      fixed-size ``GraphDelta``; resend-until-ACK falls out
                      of selecting what is not ACKed;
- ``apply_delta``   — the global upserts nodes by uid (new nodes unfixed)
                      and edges by (from, to, type) and returns the ACK;
- ``apply_ack``     — the local marks the ACKed entries;
- ``scope_reply``   — the global answers a scope request with the nearest
                      in-radius nodes, to be held fixed;
- ``apply_scope``   — the local merges those fixed boundary nodes.

The uid lookups are K31 (``kernels.ops.uid_slots``), the edge-key
compares K32 (``edge_key_match``) and the serial upserts K33
(``delta_upsert``, ``scope_merge``).  K31 reads the live ``node_uid`` and
``node_valid`` on every call: no uid -> slot map is kept, so none can go
stale after merges, evictions or compactions.  None of these functions
reads a device value on the host.

Transport is the caller's choice.  The ``*_from_numpy`` functions take a
structure as a dict of numpy arrays (the JAX package's, field by field, or
the port's own ``to_numpy``) and return the port's on a device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from uzliti_slam_tpu_torch import _device
from uzliti_slam_tpu_torch.graph import filter as gfilter
from uzliti_slam_tpu_torch.graph import lifecycle
from uzliti_slam_tpu_torch.graph import state as gstate
from uzliti_slam_tpu_torch.graph.state import GraphState
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie


class GraphDelta(NamedTuple):
    """Fixed-capacity graph delta (the reference's ``Graph`` message)."""
    # nodes
    n_uid: torch.Tensor          # (Dn,) int32, -1 = empty row
    n_pose: torch.Tensor         # (Dn, 7)
    n_odom_pose: torch.Tensor    # (Dn, 7)
    n_stamp: torch.Tensor        # (Dn,)
    n_uncertainty: torch.Tensor  # (Dn,)
    n_gist: torch.Tensor         # (Dn, 32) uint8, the place-recognition payload
    # edges
    e_from_uid: torch.Tensor     # (De,) int32
    e_to_uid: torch.Tensor       # (De,) int32
    e_type: torch.Tensor         # (De,) int32, -1 = empty row
    e_transform: torch.Tensor    # (De, 7)
    e_info: torch.Tensor         # (De, 6, 6)
    e_score: torch.Tensor        # (De,)
    e_valid: torch.Tensor        # (De,) bool, the validated flag travels with the edge
    # sensor payloads (optional): ``feat_budget`` rows of each node's banks
    n_desc: torch.Tensor | None = None        # (Dn, F, 32) uint8
    n_desc_valid: torch.Tensor | None = None  # (Dn, F) bool
    n_points: torch.Tensor | None = None      # (Dn, F, 3) base-frame keypoints
    n_scan: torch.Tensor | None = None        # (Dn, B) virtual-scan ranges
    n_scan_valid: torch.Tensor | None = None  # (Dn,) bool
    # calibration meta (optional), shipped with every delta
    sensor_transforms: torch.Tensor | None = None  # (S, 7) camera extrinsics
    odom_params: torch.Tensor | None = None        # (3,) drift model parameters


class Ack(NamedTuple):
    """The ACK message."""
    node_uids: torch.Tensor   # (Dn,) int32, -1 = not applied
    edge_from: torch.Tensor   # (De,) int32 uid, -1 = not applied
    edge_to: torch.Tensor     # (De,) int32 uid
    edge_type: torch.Tensor   # (De,) int32


class ShipState(NamedTuple):
    """Local-side resend bookkeeping (the un-ACKed sets)."""
    node_acked: torch.Tensor  # (N,) bool
    edge_acked: torch.Tensor  # (E,) bool


class ScopeReply(NamedTuple):
    """The scope answer: boundary nodes, to be held fixed."""
    uid: torch.Tensor    # (K,) int32, -1 = empty row
    pose: torch.Tensor   # (K, 7)
    stamp: torch.Tensor  # (K,)


def ship_state_init(g: GraphState) -> ShipState:
    return ShipState(
        node_acked=torch.zeros(g.node_capacity, dtype=torch.bool, device=g.device),
        edge_acked=torch.zeros(g.edge_capacity, dtype=torch.bool, device=g.device))


def uid_to_slot(g: GraphState, uids: torch.Tensor) -> torch.Tensor:
    """Map uids -> node slots of ``g``; -1 if unknown (K31)."""
    return kops.uid_slots(g.node_uid, g.node_valid,
                          uids.to(device=g.device, dtype=torch.int32).contiguous())


def make_delta(g: GraphState, ship: ShipState, gists: torch.Tensor, max_nodes: int = 32,
               max_edges: int = 64, desc: torch.Tensor | None = None,
               desc_valid: torch.Tensor | None = None, points: torch.Tensor | None = None,
               scans: torch.Tensor | None = None, scan_valid: torch.Tensor | None = None,
               feat_budget: int | None = None,
               sensor_transforms: torch.Tensor | None = None) -> GraphDelta:
    """Pack up to (max_nodes, max_edges) un-ACKed valid entries.

    Pass the per-node sensor banks to ship their payloads; ``feat_budget``
    caps the descriptor rows per node (the banks are response-ordered, so
    the slice keeps the strongest features).  ``sensor_transforms`` and the
    graph's ``odom_params`` ride along as the calibration meta.  An empty
    row holds slot 0's data with uid / type -1, as the reference's."""
    n_sel = gfilter.first_indices(g.node_valid & ~ship.node_acked, max_nodes)
    npresent = n_sel >= 0
    ns = torch.clamp(n_sel, min=0).long()
    e_sel = gfilter.first_indices((torch.arange(g.edge_capacity, device=g.device) < g.num_edges)
                    & ~ship.edge_acked, max_edges)
    epresent = e_sel >= 0
    es = torch.clamp(e_sel, min=0).long()

    fb = slice(None, feat_budget)
    payload = {}
    if desc is not None:
        payload["n_desc"] = desc[ns, fb]
        payload["n_desc_valid"] = desc_valid[ns, fb] & npresent[:, None]
    if points is not None:
        payload["n_points"] = points[ns, fb]
    if scans is not None:
        payload["n_scan"] = scans[ns]
        payload["n_scan_valid"] = scan_valid[ns] & npresent
    if sensor_transforms is not None:
        payload["sensor_transforms"] = sensor_transforms
    ef, et = g.e_from[es].long(), g.e_to[es].long()
    return GraphDelta(
        **payload,
        odom_params=g.odom_params,
        n_uid=torch.where(npresent, g.node_uid[ns], -1),
        n_pose=g.pose[ns], n_odom_pose=g.odom_pose[ns], n_stamp=g.stamp[ns],
        n_uncertainty=g.uncertainty[ns], n_gist=gists[ns],
        e_from_uid=torch.where(epresent, g.node_uid[ef], -1),
        e_to_uid=torch.where(epresent, g.node_uid[et], -1),
        e_type=torch.where(epresent, g.e_type[es], -1),
        e_transform=g.e_transform[es], e_info=g.e_info[es], e_score=g.e_score[es],
        e_valid=epresent & g.e_valid[es])


def to_device(nt, device: torch.device):
    """A NamedTuple of tensors (or None) with every tensor on ``device``,
    contiguous."""
    return type(nt)(*(None if x is None else x.to(device).contiguous() for x in nt))


def apply_delta(g: GraphState, delta: GraphDelta,
                existing_slots: torch.Tensor | None = None) -> tuple[GraphState, Ack]:
    """Upsert the delta into the (global) graph; return the ACK.

    New nodes are inserted UNFIXED; existing nodes keep their current
    (optimized) pose: the global graph is the authority.  Edges dedup by
    (from, to, type) against the table and earlier rows of the delta;
    edges whose endpoints are not present are skipped and stay un-ACKed
    (the resend protocol delivers them after their nodes).  The delta's
    ``odom_params`` are adopted.

    ``existing_slots``: optional (Dn,) pre-resolved slots of the delta's
    node uids (-1 = unknown), taken as given, as the reference takes them
    (each unknown row then inserts).  One K31 launch resolves the node uids
    and both endpoint columns, one K32 launch finds the table duplicates,
    one K33 launch upserts and builds the ACK."""
    dev = g.device
    delta = to_device(delta, dev)
    dn, de = delta.n_uid.shape[0], delta.e_type.shape[0]
    ends = [delta.e_from_uid, delta.e_to_uid]
    if existing_slots is None:
        node_found, ef, et = uid_to_slot(g, torch.cat([delta.n_uid] + ends)).split([dn, de, de])
    else:
        node_found = torch.as_tensor(existing_slots).to(device=dev, dtype=torch.int32)
        ef, et = uid_to_slot(g, torch.cat(ends)).split([de, de])
    table_dup, _ = kops.edge_key_match(ef, et, delta.e_type, g.e_from, g.e_to, g.e_type,
                                       num_rows=g.num_edges)
    g, ack_nodes, ack_from = kops.delta_upsert(g, delta, node_found.contiguous(), ef, et,
                                               table_dup, existing_slots is None)
    if delta.odom_params is not None:
        g = g.replace(odom_params=delta.odom_params.to(torch.float32))
    return g, Ack(node_uids=ack_nodes, edge_from=ack_from, edge_to=delta.e_to_uid,
                  edge_type=delta.e_type)


def apply_ack(g: GraphState, ship: ShipState, ack: Ack) -> ShipState:
    """Mark ACKed nodes and edges so they stop being resent.  Edges match by
    (from_uid, to_uid, type) over every row of the table, present or not,
    as the reference's (its rows past ``num_edges`` read slot 0's uid)."""
    ack = to_device(ack, g.device)
    slot = uid_to_slot(g, ack.node_uids)
    node_acked = gstate.set_rows(ship.node_acked, torch.clamp(slot, min=0), slot >= 0,
                                 torch.ones_like(slot, dtype=torch.bool))
    _, row_hit = kops.edge_key_match(ack.edge_from, ack.edge_to, ack.edge_type, g.e_from,
                                     g.e_to, g.e_type, node_uid=g.node_uid)
    return ShipState(node_acked=node_acked, edge_acked=ship.edge_acked | row_hit)


def scope_reply(g: GraphState, center, radius, max_nodes: int = 32) -> ScopeReply:
    """The global's answer: the nearest in-radius nodes, nearest first and
    ties to the lower slot (the reference's ``lax.top_k``; a stable sort
    here, since ``torch.topk`` promises no order)."""
    dev = g.device
    center = torch.as_tensor(center).to(device=dev, dtype=torch.float32)
    radius = torch.as_tensor(radius).to(device=dev, dtype=torch.float32)
    d = lifecycle._norm3(lie.pose_t(g.pose) - lie.pose_t(center)[None])
    key = torch.where(g.node_valid & (d <= radius), d, torch.inf)
    vals, idx = kops.smallest_k(key, max_nodes)
    ok = torch.isfinite(vals)
    safe = torch.where(ok, idx, 0)
    return ScopeReply(uid=torch.where(ok, g.node_uid[safe], -1), pose=g.pose[safe],
                      stamp=g.stamp[safe])


def apply_scope(g: GraphState, reply: ScopeReply) -> GraphState:
    """The local merges boundary nodes: known uids take the global pose and
    are frozen; unknown uids are inserted as fixed anchors (K31, then one
    K33 launch)."""
    reply = to_device(reply, g.device)
    uid = reply.uid.to(torch.int32)
    return kops.scope_merge(g, uid, reply.pose.to(torch.float32),
                            reply.stamp.to(torch.float32), uid_to_slot(g, uid))


# ---------------------------------------------------------------------------
# Carrying the structures across (transport, and the JAX package's arrays)
# ---------------------------------------------------------------------------

def to_numpy(nt) -> dict:
    """A structure of this module as a dict of numpy arrays (None kept)."""
    return {k: None if v is None else v.detach().cpu().numpy() for k, v in nt._asdict().items()}


def _from_numpy(cls, arrays: dict, device):
    def cross(v):
        return None if v is None else torch.from_numpy(np.array(v, copy=True)).to(device)
    return cls(**{k: cross(arrays.get(k)) for k in cls._fields})


def delta_from_numpy(arrays: dict, device=None) -> GraphDelta:
    """A ``GraphDelta`` on ``device`` (default: the CUDA card) from numpy
    arrays keyed by field name (a missing optional field is None)."""
    return _from_numpy(GraphDelta, arrays, _device.resolve(device))


def ack_from_numpy(arrays: dict, device=None) -> Ack:
    return _from_numpy(Ack, arrays, _device.resolve(device))


def reply_from_numpy(arrays: dict, device=None) -> ScopeReply:
    return _from_numpy(ScopeReply, arrays, _device.resolve(device))


def ship_from_numpy(arrays: dict, device=None) -> ShipState:
    return _from_numpy(ShipState, arrays, _device.resolve(device))
