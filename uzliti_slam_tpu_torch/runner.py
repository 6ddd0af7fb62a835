"""Dual-instance local/global deployment: two live SLAM instances wired by
the scope protocol.

PyTorch counterpart of ``uzliti_slam_tpu/runner.py``, the reference's
flagship topology (``iti_slam_launch/launch/slam.launch:1-22``): a LOCAL
bounded-scope SLAM ingests keyframes and keeps only a window around the
robot, while a GLOBAL persistent SLAM accumulates, merges and optimizes the
full map.  They exchange:

- graph deltas with resend-until-ACK (``graph_slam_node.cpp:356-396,
  434-533``);
- scope requests answered with fixed boundary nodes (``:535-663``);
- eviction of shipped out-of-scope local nodes (``:619-660``) and node
  merging on the global (``:665-777``).

Here both instances live in one process and the transport is tensor
passing; ``global_exchange_step`` is the global's half and runs as well on
the far side of a pipe (``parallel.scope``'s ``to_numpy`` and
``*_from_numpy`` carry the messages).  The global's uid -> slot lookups run
on the card (K31) against the live graph: no host map is kept, so none can
go stale.

Host reads, the reference's own: the global's node and edge counts (one
transfer, for growth), its merge count and proposals (one), ``maintain``'s
own read on each side, and the local's ACK and eviction counts (one).
"""

from __future__ import annotations

import dataclasses

import torch

from uzliti_slam_tpu_torch import pipeline
from uzliti_slam_tpu_torch.config import SlamConfig
from uzliti_slam_tpu_torch.graph import lifecycle
from uzliti_slam_tpu_torch.graph import state as gstate
from uzliti_slam_tpu_torch.parallel import scope
from uzliti_slam_tpu_torch.recognition import recognizer as rec


def local_config(base: SlamConfig | None = None) -> SlamConfig:
    """The ``local_slam.yaml`` role: bounded scope, no merging."""
    base = base or SlamConfig()
    return dataclasses.replace(
        base, scope=dataclasses.replace(base.scope, is_sub_graph=True, merge_nodes=False))


def global_config(base: SlamConfig | None = None) -> SlamConfig:
    """The ``global_slam.yaml`` role: persistent, merging, no construction."""
    base = base or SlamConfig()
    return dataclasses.replace(
        base, instance_id=base.instance_id + 1,
        scope=dataclasses.replace(base.scope, is_sub_graph=False, merge_nodes=True))


def _last_rows(slots: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """``ok`` where no later ok row writes the same slot: a scatter with
    repeated indices keeps the last write, as the reference's scan does."""
    n = slots.shape[0]
    later = torch.arange(n, device=slots.device)
    rep = ((slots[None, :] == slots[:, None]) & ok[None, :] & (later[None, :] > later[:, None]))
    return ok & ~rep.any(-1)


def _absorb_payloads(state: pipeline.SlamState, delta: scope.GraphDelta):
    """Write a delta's sensor payloads into the global's banks: the gist
    into the recognition bank (the reference re-runs its recognizer on
    received nodes, ``:473-476``), the descriptors, 3-D points and virtual
    scans (``_absorb_payloads_jit``, ``runner.py:62-111`` of the JAX
    package).  Empty payloads never clobber: a local re-ships boundary
    anchors whose banks are empty, and those rows are dropped rather than
    wiping the global's data.  Returns (state, slots, fresh), ``fresh``
    marking the nodes whose descriptors just landed (computed before the
    write), to drive ``pipeline.recognize_absorbed``.  Reads nothing on the
    host."""
    graph = state.graph
    uids = delta.n_uid
    slots = scope.uid_to_slot(graph, uids)
    ok = (uids >= 0) & (slots >= 0)
    safe = torch.clamp(slots, min=0).long()
    gist_ok = ok
    if delta.n_desc is not None:
        # a re-shipped boundary anchor (no descriptors) keeps the node's
        # GIST too, where the reference overwrites it (ROADMAP C4)
        gist_ok = ok & (delta.n_desc_valid.any(-1) | ~state.gist.valid[safe])
    gist_rows = _last_rows(slots, gist_ok)
    gist = rec.GistBank(
        desc=gstate.set_rows(state.gist.desc, safe, gist_rows, delta.n_gist),
        stamp=gstate.set_rows(state.gist.stamp, safe, gist_rows, delta.n_stamp),
        valid=gstate.set_rows(state.gist.valid, safe, gist_rows,
                              torch.ones_like(ok)))
    state = state.replace(gist=gist)

    if delta.n_desc is not None:
        f = delta.n_desc.shape[1]
        has_payload = ok & delta.n_desc_valid.any(-1)
        fresh = has_payload & ~state.desc_valid[safe].any(-1)
        rows = _last_rows(slots, has_payload)

        def front(bank, vals):
            """The bank with its first f columns of each written row set."""
            return gstate.set_rows(bank, safe, rows,
                                   torch.cat([vals, bank[safe, f:]], dim=1))

        state = state.replace(desc=front(state.desc, delta.n_desc),
                              desc_valid=front(state.desc_valid, delta.n_desc_valid),
                              points=front(state.points, delta.n_points))
    else:
        fresh = torch.zeros_like(ok)
    if delta.n_scan is not None:
        rows = _last_rows(slots, ok & delta.n_scan_valid)
        state = state.replace(scans=gstate.set_rows(state.scans, safe, rows, delta.n_scan),
                              scan_valid=gstate.set_rows(state.scan_valid, safe, rows,
                                                         torch.ones_like(ok)))
    return state, slots, fresh


def _grow_ship(ship: scope.ShipState, ncap: int, ecap: int) -> scope.ShipState:
    """Re-pad the ACK masks after the local graph grew (new slots un-ACKed)."""
    def pad(a, cap):
        if a.shape[0] >= cap:
            return a
        return torch.cat([a, torch.zeros(cap - a.shape[0], dtype=torch.bool, device=a.device)])

    return scope.ShipState(node_acked=pad(ship.node_acked, ncap),
                           edge_acked=pad(ship.edge_acked, ecap))


def _remap_ship(ship: scope.ShipState, perm: dict) -> scope.ShipState:
    """Remap the ACK masks through a compaction's permutation."""
    return scope.ShipState(node_acked=ship.node_acked[perm["node_order"].long()],
                           edge_acked=ship.edge_acked[perm["edge_order"].long()]
                           & perm["edge_kept"])


def global_exchange_step(gslam: pipeline.Slam, delta: scope.GraphDelta, robot, radius,
                         delta_nodes: int = 32, delta_edges: int = 64, optimize: bool = True,
                         tri: torch.Tensor | None = None):
    """The GLOBAL role's half of one protocol round, transport-agnostic.

    Takes a received ``GraphDelta`` and the local's robot pose and scope
    radius; returns ``(ack, reply, info)``: the ACK, the scope reply and
    ``{"merged_global", "proposed_global"}`` as ints, with the RANSAC
    triplets the recognition of the absorbed nodes used (``"tri"``;
    ``tri`` injects them).  The same body runs in the in-process
    ``LocalGlobalSlam`` and behind a process boundary."""
    g = gslam.state.graph
    dev = g.device
    delta = scope.to_device(delta, dev)
    robot = torch.as_tensor(robot).to(device=dev, dtype=torch.float32)
    radius = torch.as_tensor(radius).to(device=dev, dtype=torch.float32)
    # grow the global before applying: a dropped insert would stall the
    # resend loop until capacity appears
    n_nodes, n_edges = torch.stack([g.num_nodes, g.num_edges]).tolist()
    cfg = gslam.config
    if (n_nodes + delta_nodes >= int(0.9 * cfg.node_capacity)
            or n_edges + delta_edges >= int(0.9 * cfg.edge_capacity)):
        new_cfg = dataclasses.replace(cfg, node_capacity=max(cfg.node_capacity * 2, 64),
                                      edge_capacity=max(cfg.edge_capacity * 2, 256))
        gslam.state = pipeline.grow_state(gslam.state, new_cfg.node_capacity,
                                          new_cfg.edge_capacity)
        gslam.config = new_cfg

    gg, ack = scope.apply_delta(gslam.state.graph, delta)
    st, slots, fresh = _absorb_payloads(gslam.state.replace(graph=gg), delta)
    # the global re-runs its recognizer on the received nodes and proposes
    # edges from the shipped features (graph_slam_node.cpp:473-476)
    st, n_proposed, rinfo = pipeline.recognize_absorbed(st, slots, fresh, gslam.config, tri=tri)
    gslam.state = st

    reply = scope.scope_reply(gslam.state.graph, robot, radius)
    info_g = gslam.maintain(center=robot)
    if optimize:
        gslam.optimize()
    merged, proposed = torch.stack([info_g["merged"].to(torch.int32),
                                    n_proposed.to(torch.int32)]).tolist()
    return ack, reply, {"merged_global": merged, "proposed_global": proposed,
                        "tri": rinfo["tri"]}


class LocalGlobalSlam:
    """Two ``pipeline.Slam`` instances and the scope protocol as one runner,
    on ``device`` (default: the CUDA card).

    Drive with ``add_frame`` (feeds the local instance); call ``exchange``
    on the scope timer's cadence; the global map is ``self.global_slam``.
    ``feat_budget`` caps the descriptor rows shipped a node (None: the whole
    bank)."""

    def __init__(self, config: SlamConfig | None = None, cam=None, cam_pose=None,
                 delta_nodes: int = 32, delta_edges: int = 64,
                 feat_budget: int | None = None, device=None):
        base = config or SlamConfig()
        self.local = pipeline.Slam(local_config(base), cam=cam, cam_pose=cam_pose, device=device)
        self.global_slam = pipeline.Slam(global_config(base), cam=cam, cam_pose=cam_pose,
                                         device=device)
        self.device = self.local.device
        self.ship = scope.ship_state_init(self.local.state.graph)
        self.delta_nodes = delta_nodes
        self.delta_edges = delta_edges
        self.feat_budget = feat_budget

    # -- ingestion (local role) -------------------------------------------

    def add_frame(self, image, depth, odom_pose, stamp, **kw):
        return self.local.add_frame(image, depth, odom_pose, stamp, **kw)

    # -- the exchange (scope timers) --------------------------------------

    def exchange(self, optimize_global: bool = True, tri: torch.Tensor | None = None) -> dict:
        """One full protocol round:

        1. ship un-ACKed local nodes and edges; the global upserts them and
           ACKs;
        2. the local requests its scope; the global replies with fixed
           boundary nodes;
        3. the local evicts shipped out-of-scope nodes (and reclaims slots);
        4. the global merges revisited-area nodes and (optionally)
           optimizes.

        ``tri`` injects the global's recognition draws
        (``global_exchange_step``)."""
        delta, robot, radius = self.local_make_request()
        ack, reply, info_g = global_exchange_step(
            self.global_slam, delta, robot, radius, self.delta_nodes, self.delta_edges,
            optimize=optimize_global, tri=tri)
        info_l = self.local_apply_response(ack, reply)
        return {**info_l, **info_g}

    def local_make_request(self):
        """LOCAL half, outbound: the un-ACKed delta, and the scope request's
        robot pose and adaptive radius (``graph_slam_node.cpp:578-617``),
        all on the device."""
        lg = self.local.state.graph
        self.ship = _grow_ship(self.ship, lg.node_capacity, lg.edge_capacity)
        ls = self.local.state
        cam_pose = self.local.cam_pose
        delta = scope.make_delta(
            lg, self.ship, ls.gist.desc, max_nodes=self.delta_nodes,
            max_edges=self.delta_edges, desc=ls.desc, desc_valid=ls.desc_valid,
            points=ls.points, scans=ls.scans, scan_valid=ls.scan_valid,
            feat_budget=self.feat_budget,
            sensor_transforms=cam_pose if cam_pose.dim() == 2 else cam_pose[None])
        # the robot: the map-frame pose of the newest keyframe
        last = torch.clamp(ls.last_kf_slot, min=0).long().view(1)
        robot = lg.pose.index_select(0, last)[0]
        sc = self.local.config.scope
        radius = lifecycle.scope_radius(lg.uncertainty.index_select(0, last)[0],
                                        sc.scope_size_min, sc.scope_size_factor)
        return delta, robot, radius

    def local_apply_response(self, ack: scope.Ack, reply: scope.ScopeReply) -> dict:
        """LOCAL half, inbound: mark the ACKed entries, merge the fixed
        boundary nodes, evict shipped out-of-scope nodes, reclaim slots."""
        dev = self.device
        ack, reply = scope.to_device(ack, dev), scope.to_device(reply, dev)
        lg = self.local.state.graph
        self.ship = scope.apply_ack(lg, self.ship, ack)
        n_acked = (ack.node_uids >= 0).sum(dtype=torch.int32)
        self.local.state = self.local.state.replace(
            graph=scope.apply_scope(self.local.state.graph, reply))
        info_l = self.local.maintain(shipped=self.ship.node_acked)
        if info_l["compact_perm"] is not None:
            self.ship = _remap_ship(self.ship, info_l["compact_perm"])
        acked, evicted = torch.stack([n_acked, info_l["evicted"].to(torch.int32)]).tolist()
        return {"acked_nodes": acked, "evicted_local": evicted}

    # -- results ------------------------------------------------------------

    def global_trajectory(self):
        """(poses (n, 7), uids (n,), stamps (n,)) of the global's live
        nodes, as numpy arrays."""
        g = self.global_slam.state.graph
        n = int(g.num_nodes)
        valid = g.node_valid[:n].cpu().numpy()
        return (g.pose[:n].cpu().numpy()[valid], g.node_uid[:n].cpu().numpy()[valid],
                g.stamp[:n].cpu().numpy()[valid])
