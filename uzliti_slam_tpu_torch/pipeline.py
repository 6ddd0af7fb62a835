"""The SLAM orchestrator: the keyframe step, the optimization tick and the
``Slam`` shell.

PyTorch counterpart of ``uzliti_slam_tpu/pipeline.py`` with every place
recognizer and every registration estimator (laser edges, depth
refinement):

- ``process_keyframe`` ingests one keyframe: the front-end
  (``keyframe_frontend``: the bilateral depth filter K17, features and
  descriptors K12-K14, the GIST in K14's same launch, the virtual scan
  K15), the map-pose
  bootstrap, the place-recognition query of ``recognition.method`` (the
  GIST, K16; the feature sets, K21; the repository, K22; the bag of words,
  K23 + K24) and the distance candidates, the pair
  dedup, the registration of every candidate by ``estimation.method`` —
  "feature": Hamming matching (K16, every candidate in one launch) and
  RANSAC (K7, soft-PROSAC draws); "pnp": K16 on camera 0's keypoints and
  the PnP RANSAC (K28); "gicp": the frame's voxel cloud (K25) against each
  candidate's by the 6-D ICP (K26 normals, K27) — the acceptance gates, the
  new node, its odometry edge, the ICP laser edge (K18) and the candidate
  edges (both entered invalid, for the epoch's filter to validate), and
  the node's bank rows (the repository's insert, K22; the BoW vector; the
  voxel cloud).  It reads no device value on the host.
- ``optimize_epoch`` filters the loop closures (K5-K8), solves (K1-K4, K9,
  K10), refreshes uncertainty and the map→odom correction; it reads one
  device value on the host (``solver._host_decision``, whether the
  odometry restart runs its second solve).  ``project_map`` projects the
  scans into the live occupancy grid (K11), reading nothing on the host.
- the periodic maintenance timers: ``maintenance_epoch`` (node merging,
  K19, with the banks merged and their scans re-binned by K15's
  ``bin_min_max``; scope eviction), ``compact_state`` (slot reclamation)
  and ``scan_reregistration`` (ICP against the nearest nodes, K18 on the
  batch), each reading nothing on the host.
- ``recognize_absorbed`` is the global role's recognition of the nodes a
  scope delta brought (the GIST query, K16, or the feature sets, K21;
  K16's matching and K7 for every candidate), a slot at a time, reading
  nothing on the host.
- ``Slam`` is the imperative shell: the host keyframe gate, capacity
  growth, the epoch schedule with the calibration (K20) every
  ``calibrate_every`` epochs, ``maintain`` (with compaction),
  ``reregister_scans``, ``add_gps``, live retuning of the gates.

``SlamState`` holds the JAX ``SlamState``'s fields for these
configurations (the repository, the BoW bank and the vocabulary only where
the method uses them, the voxel clouds only for "gicp"), with a
``torch.Generator`` (the RANSAC draws and the PnP keys) where JAX keeps a
``prng`` key, and the gates as host floats (``config.Tunables``).  Options of the
reference that are not ported raise ``NotImplementedError`` naming the
``ROADMAP.md`` item that brings them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from uzliti_slam_tpu_torch import _device
from uzliti_slam_tpu_torch.config import (KeyframeConfig, SlamConfig, Tunables,
                                          tunables_from_config)
from uzliti_slam_tpu_torch.frontend import camera as cam_mod
from uzliti_slam_tpu_torch.graph import filter as gfilter
from uzliti_slam_tpu_torch.graph import calibration, lifecycle, shortest_path, solver
from uzliti_slam_tpu_torch.graph import state as gstate
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.mapping import occupancy
from uzliti_slam_tpu_torch.ops import depth as depth_ops
from uzliti_slam_tpu_torch.ops import features, icp, lie, matching, ransac
from uzliti_slam_tpu_torch.ops import gicp as gicp_ops
from uzliti_slam_tpu_torch.ops import pnp as pnp_ops
from uzliti_slam_tpu_torch.ops import scan as scan_ops
from uzliti_slam_tpu_torch.recognition import recognizer as rec
from uzliti_slam_tpu_torch.recognition import vocabulary as voc

MAX_CANDIDATES = 256


@dataclasses.dataclass
class SlamState:
    graph: gstate.GraphState
    generator: torch.Generator   # RANSAC draws and PnP keys, on the graph's device
    scans: torch.Tensor          # (N, scan_bins) float32 virtual-scan near ranges
    scan_valid: torch.Tensor     # (N,) bool: the node has a scan
    gist: rec.GistBank           # per-node binary GIST
    desc: torch.Tensor           # (N, F, 32) uint8 per-node descriptors
    desc_valid: torch.Tensor     # (N, F) bool
    points: torch.Tensor         # (N, F, 3) float32 base-frame keypoints
    last_kf_odom: torch.Tensor   # (7,) odometry pose of the last keyframe
    n_keyframes: torch.Tensor    # () int32 keyframes ingested (the uid counter)
    last_kf_slot: torch.Tensor   # () int32 slot of the newest keyframe node, -1 before
    tunables: Tunables           # the live gates, host floats
    # the method's own recognition state (None unless recognition.method
    # selects it)
    repo: rec.FeatureRepository | None = None
    bow: voc.BowBank | None = None
    vocab: voc.Vocabulary | None = None
    # the per-node voxel clouds (None unless estimation.method == "gicp")
    clouds: torch.Tensor | None = None       # (N, V, 3) float32 base-frame points
    cloud_lab: torch.Tensor | None = None    # (N, V, 3) float32 CIELAB colors
    cloud_valid: torch.Tensor | None = None  # (N, V) bool

    def replace(self, **changes) -> "SlamState":
        return dataclasses.replace(self, **changes)


def init_state(config: SlamConfig = SlamConfig(), seed: int = 0, device=None,
               vocabulary: voc.Vocabulary | None = None) -> SlamState:
    """An empty state of the configured capacities (no scans: +inf ranges),
    the gates from ``config`` and a generator seeded with ``seed``, on
    ``device`` (default: the CUDA card).  ``recognition.method="repository"``
    adds an empty repository of ``repo_desc_per_node`` descriptors a node
    slot; ``"bow"`` an empty BoW bank and ``vocabulary`` (moved to
    ``device``), which it needs, of ``bow_words`` words, else ValueError;
    ``estimation.method="gicp"`` empty voxel clouds of ``gicp_max_voxels``
    a node."""
    device = _device.resolve(device)
    n, f = config.node_capacity, config.feats_per_node
    rc = config.recognition
    repo = bow = vocab = None
    if rc.method == "repository":
        repo = rec.repository_init(n * rc.repo_desc_per_node, rc.repo_links_per_desc, n, device)
    if rc.method == "bow":
        if vocabulary is None:
            raise ValueError("method='bow' needs a trained vocabulary "
                             "(recognition.vocabulary.build_vocabulary)")
        if vocabulary.centers.shape[0] != rc.bow_words:
            raise ValueError(f"vocabulary has {vocabulary.centers.shape[0]} words, "
                             f"config.recognition.bow_words={rc.bow_words}")
        bow = voc.bow_bank_init(n, rc.bow_words, device)
        vocab = voc.Vocabulary(*(t.to(device) for t in vocabulary))
    clouds = cloud_lab = cloud_valid = None
    if config.estimation.method == "gicp":
        v = config.estimation.gicp_max_voxels
        clouds = torch.zeros(n, v, 3, device=device)
        cloud_lab = torch.zeros(n, v, 3, device=device)
        cloud_valid = torch.zeros(n, v, dtype=torch.bool, device=device)
    return SlamState(
        graph=gstate.empty_graph(n, config.edge_capacity, device),
        generator=torch.Generator(device=device).manual_seed(seed),
        scans=torch.full((n, config.scan_bins), torch.inf, device=device),
        scan_valid=torch.zeros(n, dtype=torch.bool, device=device),
        gist=rec.gist_bank_init(n, device),
        desc=torch.zeros(n, f, 32, dtype=torch.uint8, device=device),
        desc_valid=torch.zeros(n, f, dtype=torch.bool, device=device),
        points=torch.zeros(n, f, 3, device=device),
        last_kf_odom=lie.pose_identity((), device),
        n_keyframes=torch.zeros((), dtype=torch.int32, device=device),
        last_kf_slot=torch.full((), -1, dtype=torch.int32, device=device),
        tunables=tunables_from_config(config),
        repo=repo, bow=bow, vocab=vocab, clouds=clouds, cloud_lab=cloud_lab,
        cloud_valid=cloud_valid,
    )


def state_from_numpy(arrays: dict, seed: int = 0, device=None,
                     config: SlamConfig | None = None) -> SlamState:
    """A SlamState from numpy arrays, the fields of a JAX ``SlamState``:
    ``arrays["graph"]`` holds the graph's fields as ``graph.state.from_numpy``
    takes them; ``scans``, ``scan_valid``, ``desc``, ``desc_valid``,
    ``points``, ``last_kf_odom``, ``n_keyframes``, ``last_kf_slot``,
    ``gist`` (a dict of ``desc``, ``stamp``, ``valid``), ``repo`` and
    ``bow`` (dicts of their banks' fields), ``vocab`` (a dict of
    ``centers``, ``idf``), ``clouds``, ``cloud_lab``, ``cloud_valid`` (for
    ``estimation.method="gicp"``) and ``tunables`` (a dict of gate values) are taken
    where present, else made as ``init_state(config)`` makes them for the
    graph's node capacity.  A JAX ``prng`` key cannot cross: the generator
    is seeded with ``seed``."""
    device = _device.resolve(device)
    config = config or SlamConfig()
    graph = gstate.from_numpy({k: np.asarray(v) for k, v in arrays["graph"].items()}, device)
    vocab = (voc.from_numpy(arrays["vocab"]["centers"], arrays["vocab"]["idf"], device)
             if "vocab" in arrays else None)
    base = init_state(dataclasses.replace(config, node_capacity=graph.node_capacity,
                                          edge_capacity=graph.edge_capacity), seed, device,
                      vocabulary=vocab)

    def bank(cls, fields):
        return cls(*(torch.from_numpy(np.array(fields[k])).to(device) for k in cls._fields))

    def cross(x, like: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=like.cpu().numpy().dtype)).to(device)

    def take(name: str, like: torch.Tensor | None) -> torch.Tensor | None:
        return cross(arrays[name], like) if name in arrays and like is not None else like

    gist = arrays.get("gist", {})
    tunables = (Tunables(**{k: float(np.float32(v)) for k, v in arrays["tunables"].items()})
                if "tunables" in arrays else base.tunables)
    return base.replace(
        graph=graph, scans=take("scans", base.scans), scan_valid=take("scan_valid", base.scan_valid),
        gist=rec.GistBank(*(cross(gist[k], getattr(base.gist, k)) if k in gist
                            else getattr(base.gist, k) for k in rec.GistBank._fields)),
        desc=take("desc", base.desc), desc_valid=take("desc_valid", base.desc_valid),
        points=take("points", base.points), last_kf_odom=take("last_kf_odom", base.last_kf_odom),
        n_keyframes=take("n_keyframes", base.n_keyframes),
        last_kf_slot=take("last_kf_slot", base.last_kf_slot), tunables=tunables,
        repo=bank(rec.FeatureRepository, arrays["repo"]) if "repo" in arrays else base.repo,
        bow=bank(voc.BowBank, arrays["bow"]) if "bow" in arrays else base.bow,
        clouds=take("clouds", base.clouds), cloud_lab=take("cloud_lab", base.cloud_lab),
        cloud_valid=take("cloud_valid", base.cloud_valid))


def epoch_candidates(g: gstate.GraphState, config: SlamConfig = SlamConfig()):
    """The epoch's loop-closure candidates and their heuristic gate.

    Candidates are the most recent ``min(256, edge_capacity)`` edges that
    are neither wheel odometry nor GPS priors, lie below ``num_edges`` and
    have live endpoints, regardless of their current validity.  Returns
    (idx (B,) int32, -1 padded; cand_mask (B,) bool: present and plausible).
    """
    E = g.edge_capacity
    ef, et = g.e_from.long(), g.e_to.long()
    slot_idx = torch.arange(E, device=g.device)
    is_lc = (
        (g.e_type != gstate.EDGE_TYPE_2D_WHEEL_ODOMETRY)
        & (g.e_type != gstate.EDGE_TYPE_3D_GPS)
        & (slot_idx < g.num_edges)
        & g.node_valid[ef] & g.node_valid[et]
    )
    idx = gfilter.recent_candidates(is_lc, min(MAX_CANDIDATES, E))
    cand_valid = idx >= 0
    safe = torch.where(cand_valid, idx, 0).long()
    heur = gfilter.edge_heuristic(g, g.e_from[safe], g.e_to[safe],
                                  config.scope.scope_size_factor) & cand_valid
    return idx, heur


def epoch_ransac_members(state: SlamState, config: SlamConfig = SlamConfig()) -> torch.Tensor:
    """(n_roots, B) member masks of the cluster roots the epoch's filter runs
    RANSAC on, so that a caller can draw or inject each root's triplets."""
    idx, heur = epoch_candidates(state.graph, config)
    return gfilter.cluster_roots(state.graph, idx, config.filter, cand_mask=heur).member


def optimize_epoch(state: SlamState, config: SlamConfig = SlamConfig(),
                   tri: torch.Tensor | None = None) -> tuple[SlamState, solver.SolveStats]:
    """Filter loop closures, solve, update uncertainty and the map→odom
    correction.  ``tri`` (n_roots, ransac_hypotheses, 3) injects the RANSAC
    triplets; without it they are drawn from ``state.generator``.
    Functional: ``state.graph`` is not modified (the generator advances)."""
    g = state.graph
    idx, heur = epoch_candidates(g, config)
    keep = gfilter.filter_loop_closures(g, idx, state.generator, config.filter,
                                        cand_mask=heur, tri=tri)
    g = g.replace(e_valid=gfilter.write_validity(g.e_valid, idx, keep))

    g, stats = solver.optimize(g, config.solver)
    g = shortest_path.reevaluate_uncertainty(g)

    # map->odom diff from the newest valid node (graph_slam_node.cpp:188-202)
    newest = torch.argmax(torch.where(g.node_valid, g.stamp, -math.inf)).view(1)
    diff = lie.pose_compose(g.pose.index_select(0, newest)[0],
                            lie.pose_inverse(g.odom_pose.index_select(0, newest)[0]))
    return state.replace(graph=g.replace(diff_transform=diff)), stats


def project_map(state: SlamState, config: SlamConfig = SlamConfig(),
                grid: occupancy.OccupancyGrid | None = None,
                force_full: bool = False) -> occupancy.OccupancyGrid:
    """Project the graph's virtual scans into the live occupancy grid
    (``Slam.project_map``, ``pipeline.py:1834-1847``): incremental, or a
    full rebuild after drift, on force, or when ``grid`` is None or was
    made for another node capacity (then a fresh ``grid_init`` grid).
    Returns the new grid; kernel K11 on a CUDA device, no host read."""
    g = state.graph
    if grid is None or grid.ref_poses.shape[0] != g.node_capacity:
        grid = occupancy.grid_init(g, config.grid)
        force_full = True
    return occupancy.project(grid, g, state.scans, state.scan_valid, config.grid,
                             force_full=force_full)


def map_probability(grid: occupancy.OccupancyGrid) -> torch.Tensor:
    """(size, size) occupancy probabilities of a grid."""
    return occupancy.occupancy_probability(grid)


def map_ternary(grid: occupancy.OccupancyGrid) -> torch.Tensor:
    """ROS-style -1/0/100 occupancy classes of a grid."""
    return occupancy.to_ternary(grid)


# ---------------------------------------------------------------------------
# Periodic maintenance (the reference's auxiliary timers)
# ---------------------------------------------------------------------------

def scan_reregistration(state: SlamState, config: SlamConfig = SlamConfig(),
                        k_targets: int = 4) -> tuple[SlamState, torch.Tensor]:
    """ICP the newest keyframe's scan against its ``k_targets`` nearest
    nodes with scans and add laser edges (the reference's scan
    re-registration timer, ``GraphSlam.cfg:24``; ``pipeline.py:883-948``
    of the JAX package).  Targets already joined to the newest node by a
    laser edge are skipped; the ICP batch is one K18 launch; new edges enter
    invalid, for the epoch's filter to validate.  Returns (state, number of
    edges added as a () tensor); reads nothing on the host."""
    g = state.graph
    dev = g.device
    ec, tn = config.estimation, state.tunables
    cur = torch.clamp(state.last_kf_slot, min=0)
    cur1 = cur.long().view(1)
    has = (state.last_kf_slot >= 0) & state.scan_valid.index_select(0, cur1)[0]
    pose_cur = g.pose.index_select(0, cur1)[0]
    d = lifecycle._norm3(lie.pose_t(g.pose) - lie.pose_t(pose_cur)[None])
    slots = torch.arange(g.node_capacity, device=dev)
    eligible = (g.node_valid & state.scan_valid & (slots != cur) & (slots != cur - 1)
                & (d < config.keyframe.distance_closure_radius * 2))
    vals, targets = kops.smallest_k(torch.where(eligible, d, torch.inf), k_targets)
    targets = targets.to(torch.int32)
    cur_k = cur.to(torch.int32).expand(k_targets)
    laser = ((torch.arange(g.edge_capacity, device=dev) < g.num_edges)
             & (g.e_type == gstate.EDGE_TYPE_2D_LASER))
    t_ok = (torch.isfinite(vals) & has
            & rec.mask_existing_pairs(g.e_from, g.e_to, laser, targets, cur_k))
    cur_pts, cur_ok = _scan_pts(state.scans.index_select(0, cur1)[0])
    tl = targets.long()
    tp, tok = _scan_pts(state.scans[tl])
    init2 = lie.pose_to_pose2(lie.pose_relative(g.pose[tl], pose_cur[None]))
    ires = icp.icp_point_to_line(
        cur_pts.expand(k_targets, -1, -1), cur_ok.expand(k_targets, -1), tp, tok, init2,
        iterations=ec.icp_iterations, max_corr_dist=tn.icp_max_corr,
        min_valid_fraction=tn.icp_min_valid_fraction)
    ok = t_ok & ires.ok
    g, _ = gstate.add_edges(
        g, torch.where(ok, targets, -1), cur_k, icp.icp_edge_pose(ires.pose2),
        icp.icp_information_6d(ires.cov3),
        torch.full((k_targets,), gstate.EDGE_TYPE_2D_LASER, dtype=torch.int32, device=dev),
        torch.zeros(k_targets, device=dev), torch.zeros(k_targets, dtype=torch.bool, device=dev))
    return state.replace(graph=g), ok.sum()


def _merge_banks(state: SlamState, g_before: gstate.GraphState, g_after: gstate.GraphState,
                 ki: torch.Tensor, ai: torch.Tensor, ok: torch.Tensor, n_bins: int) -> SlamState:
    """Fold each absorbed node's sensor payload into its kept node (the
    reference merges laser scans and moves sensor data on ``mergeNodes``,
    ``graph_slam_node.cpp:890-1062``; ``pipeline.py:950-1065`` of the JAX
    package):

    - descriptors and 3-D points: the kept node's invalid slots are
      backfilled with the absorbed node's valid entries (a fixed budget F),
      points re-expressed in the kept node's new frame;
    - scans: both nodes' scan points move into the new kept frame, and
      their union is re-binned to one virtual scan (``points_to_scan``: one
      K15 ``bin_min_max`` launch for every pair);
    - voxel clouds (the gicp estimator): the kept node's free voxel slots
      are backfilled with the absorbed node's, both moved into the kept
      node's new frame.

    The pairs are disjoint, so every pair is computed from the same state
    at once and only the ok pairs are written (the reference's sequential
    loop writes a not-ok pair's slot 0 back unchanged)."""
    ks, as_ = torch.clamp(ki, min=0).long(), torch.clamp(ai, min=0).long()
    rel_k = lie.pose_relative(g_after.pose[ks], g_before.pose[ks])
    rel_a = lie.pose_relative(g_after.pose[ks], g_before.pose[as_])

    def backfill(kv, av):
        """Each row's slots by priority: the kept node's valid entries, the
        absorbed node's valid ones, then the invalid (a stable sort); the
        first as many as a row holds."""
        pri = torch.cat([torch.where(kv, 0, 2), torch.where(av, 1, 3)], dim=1)
        order = torch.sort(pri, dim=1, stable=True).indices[:, :kv.shape[1]]

        def pick(a, b):
            both = torch.cat([a, b], dim=1)
            idx = order.reshape(order.shape + (1,) * (both.dim() - 2)).expand(
                order.shape + both.shape[2:])
            return torch.gather(both, 1, idx)
        return pick

    kv, av = state.desc_valid[ks], state.desc_valid[as_]
    pick = backfill(kv, av)
    desc_all = pick(state.desc[ks], state.desc[as_])
    valid_all = pick(kv, av)
    pts_all = pick(lie.pose_apply(rel_k[:, None], state.points[ks]),
                   lie.pose_apply(rel_a[:, None], state.points[as_]))

    def tf2(p2, pts):
        c, s = torch.cos(p2[:, None, 2]), torch.sin(p2[:, None, 2])
        x = c * pts[..., 0] - s * pts[..., 1] + p2[:, None, 0]
        y = s * pts[..., 0] + c * pts[..., 1] + p2[:, None, 1]
        return torch.stack([x, y], dim=-1)

    sv_k, sv_a = state.scan_valid[ks], state.scan_valid[as_]
    pk2, okk = _scan_pts(state.scans[ks])
    pa2, oka = _scan_pts(state.scans[as_])
    union = torch.cat([tf2(lie.pose_to_pose2(rel_k), pk2), tf2(lie.pose_to_pose2(rel_a), pa2)],
                      dim=1)
    union_ok = torch.cat([okk & sv_k[:, None], oka & sv_a[:, None]], dim=1)
    merged = scan_ops.points_to_scan(union, union_ok, n_bins=n_bins)

    if state.clouds is not None:
        kvc, avc = state.cloud_valid[ks], state.cloud_valid[as_]
        pick_c = backfill(kvc, avc)
        state = state.replace(
            clouds=gstate.set_rows(state.clouds, ks, ok, pick_c(
                lie.pose_apply(rel_k[:, None], state.clouds[ks]),
                lie.pose_apply(rel_a[:, None], state.clouds[as_]))),
            cloud_lab=gstate.set_rows(state.cloud_lab, ks, ok,
                                      pick_c(state.cloud_lab[ks], state.cloud_lab[as_])),
            cloud_valid=gstate.set_rows(state.cloud_valid, ks, ok, pick_c(kvc, avc)))
    return state.replace(
        desc=gstate.set_rows(state.desc, ks, ok, desc_all),
        desc_valid=gstate.set_rows(state.desc_valid, ks, ok, valid_all),
        points=gstate.set_rows(state.points, ks, ok, pts_all),
        scans=gstate.set_rows(state.scans, ks, ok, merged.ranges),
        scan_valid=gstate.set_rows(state.scan_valid, ks, ok, sv_k | sv_a),
    )


def _drop_from_banks(state: SlamState, dead: torch.Tensor) -> SlamState:
    """Dead nodes leave the recognition and sensor banks (and the
    repository's links to them go)."""
    repo, bow = state.repo, state.bow
    if repo is not None:
        repo = repo._replace(node_valid=repo.node_valid & ~dead,
                             link_valid=repo.link_valid & ~dead[repo.links.long()])
    if bow is not None:
        bow = rec.drop_nodes(bow, dead)
    cloud_valid = None if state.cloud_valid is None else state.cloud_valid & ~dead[:, None]
    return state.replace(gist=rec.drop_nodes(state.gist, dead),
                         scan_valid=state.scan_valid & ~dead,
                         desc_valid=state.desc_valid & ~dead[:, None], repo=repo, bow=bow,
                         cloud_valid=cloud_valid)


def maintenance_epoch(state: SlamState, config: SlamConfig = SlamConfig(),
                      shipped: torch.Tensor | None = None,
                      center=None) -> tuple[SlamState, dict]:
    """Scope-window maintenance (``pipeline.py:1068-1145`` of the JAX
    package): node merging in the global role (``config.scope.merge_nodes``,
    the reference's ``mergeTimerCallback``; K19, the banks merged into the
    kept nodes) and eviction in the local role (``is_sub_graph``).  The
    robot centre is the newest keyframe's pose, or ``center`` (7,) when
    given (an instance without keyframes).  ``shipped`` (N,) gates eviction
    to nodes the global graph has ACKed; without it everything outside the
    scope goes.  Returns (state, {"merged", "evicted"} as () int32
    tensors); reads nothing on the host."""
    g = state.graph
    sc = config.scope
    cur = torch.clamp(state.last_kf_slot, min=0).long().view(1)
    center = (g.pose.index_select(0, cur)[0] if center is None
              else _as_tensor(center, g.device).to(torch.float32))
    radius = lifecycle.scope_radius(g.uncertainty.index_select(0, cur)[0], sc.scope_size_min,
                                    sc.scope_size_factor)
    zero = torch.zeros((), dtype=torch.int32, device=g.device)
    n_merged, evicted = zero, zero
    if sc.merge_nodes:
        g_before = g
        ki, ai, ok = lifecycle.find_merge_pairs(
            g, center, radius, dist_thresh=sc.merge_dist, angle_thresh_deg=sc.merge_angle_deg,
            margin=sc.merge_margin)
        g = lifecycle.merge_nodes(g, ki, ai, ok)
        n_merged = ok.sum(dtype=torch.int32)
        state = _merge_banks(state, g_before, g, ki, ai, ok, config.scan_bins)
        # absorbed nodes leave the banks, or recognition keeps proposing them
        state = _drop_from_banks(state, g_before.node_valid & ~g.node_valid)
    if sc.is_sub_graph:
        mask = lifecycle.out_of_scope_mask(g, center, radius, sc.eviction_margin,
                                           shipped=shipped)
        g = lifecycle.evict_nodes(g, mask)
        state = _drop_from_banks(state, mask)
        evicted = mask.sum(dtype=torch.int32)
    return state.replace(graph=g), {"merged": n_merged, "evicted": evicted}


def compact_state(state: SlamState) -> tuple[SlamState, dict]:
    """Slot reclamation over the graph and every per-node bank
    (``lifecycle.compact_graph``; ``pipeline.py:1149-1208`` of the JAX
    package): live nodes move to the front, the high-water marks shrink to
    the live counts, and a bounded local scope stays in one capacity tier.
    The repository's links follow their nodes, and links to dead nodes go;
    its descriptors stay where they are.  Returns (state, perm), ``perm``
    as ``compact_graph`` gives it."""
    g, perm = lifecycle.compact_graph(state.graph)
    order = perm["node_order"].long()
    inv = perm["node_inv"]
    live = g.node_valid
    last = state.last_kf_slot
    new_last = torch.where(last >= 0, inv[torch.clamp(last, min=0).long()], -1).to(torch.int32)
    gist, repo, bow = state.gist, state.repo, state.bow
    if repo is not None:
        remapped = inv[repo.links.long()]
        repo = repo._replace(node_stamp=repo.node_stamp[order],
                             node_valid=repo.node_valid[order] & live,
                             links=torch.clamp(remapped, min=0).to(torch.int32),
                             link_valid=repo.link_valid & (remapped >= 0))
    if bow is not None:
        bow = voc.BowBank(vec=bow.vec[order], stamp=bow.stamp[order],
                          valid=bow.valid[order] & live)
    if state.clouds is not None:
        state = state.replace(clouds=state.clouds[order], cloud_lab=state.cloud_lab[order],
                              cloud_valid=state.cloud_valid[order] & live[:, None])
    return state.replace(
        graph=g,
        gist=rec.GistBank(desc=gist.desc[order], stamp=gist.stamp[order],
                          valid=gist.valid[order] & live),
        desc=state.desc[order], desc_valid=state.desc_valid[order] & live[:, None],
        points=state.points[order], scans=state.scans[order],
        scan_valid=state.scan_valid[order] & live, last_kf_slot=new_last, repo=repo, bow=bow,
    ), perm


# ---------------------------------------------------------------------------
# Keyframe front-end
# ---------------------------------------------------------------------------

class FrontendOutput(NamedTuple):
    desc: torch.Tensor       # (C·K, 32) uint8 descriptors, camera-major
    pts_base: torch.Tensor   # (C·K, 3) keypoints in the robot base frame
    pts_valid: torch.Tensor  # (C·K,) valid keypoint with depth > 0.1 m
    uv: torch.Tensor         # (C, K, 2) level-0 pixel coordinates
    kp_valid: torch.Tensor   # (C, K) valid keypoints
    scan: scan_ops.Scan      # the cameras' virtual scans merged in polar space
    gist: torch.Tensor       # (32,) uint8 binary GIST of camera 0
    # the frame's voxel cloud (points (V, 3), Lab (V, 3), valid (V,)) in
    # the base frame, for estimation.method == "gicp", else None
    cloud: tuple | None = None


def _as_tensor(x, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``.  uint16 crosses as its int16 bit pattern (few
    ops take uint16), which ``_depth_metres`` reads back on the device.  A
    host array goes to the card through pinned memory without blocking, so
    ingesting a frame does not synchronise the host with the card."""
    if not isinstance(x, torch.Tensor):
        x = np.ascontiguousarray(x)
        x = x.view(np.int16) if x.dtype == np.uint16 else x
        x = torch.from_numpy(x if x.flags.writeable else x.copy())
    elif x.dtype == torch.uint16:
        x = x.view(torch.int16)
    if device.type == "cuda" and x.device.type == "cpu":
        return x.pin_memory().to(device, non_blocking=True)
    return x.to(device)


def _depth_metres(deps: torch.Tensor, depth_scale: float) -> torch.Tensor:
    """Float depth as float32 metres; integer depth (sensor units, a
    uint16 as its int16 bits) × ``depth_scale``, converted on the device."""
    if deps.dtype.is_floating_point:
        return deps.to(torch.float32)
    units = deps.to(torch.int32)
    if deps.dtype == torch.int16:
        units = units & 0xFFFF
    return units.to(torch.float32) * depth_scale


def _cloud_points(cam: cam_mod.PinholeCamera, raw: torch.Tensor, deps: torch.Tensor,
                  depth_scale: float) -> torch.Tensor:
    """Camera-frame points (C, H, W, 3) of every pixel, as the reference's
    compiled form gives them: from integer depth units XLA reassociates
    ((u − cx)/fx) · (units · s) into units · ((u − cx)/fx · s), and a point
    on a voxel face moves with that rounding; float depth is backprojected
    as it is."""
    if raw.dtype.is_floating_point:
        return cam_mod.backproject_image(cam, deps)
    units = _depth_metres(raw, 1.0)
    h, w = deps.shape[-2:]
    uu = torch.arange(w, dtype=torch.float32, device=deps.device)
    vv = torch.arange(h, dtype=torch.float32, device=deps.device)
    x = units * ((uu - cam.cx) / cam.fx * depth_scale)[None, None, :]
    y = units * ((vv - cam.cy) / cam.fy * depth_scale)[None, :, None]
    return torch.stack([x, y, deps], dim=-1)


def keyframe_frontend(image, depth, cam: cam_mod.PinholeCamera, cam_pose,
                      config: SlamConfig = SlamConfig(), device=None,
                      tunables: Tunables | None = None) -> FrontendOutput:
    """The per-camera front-end of one keyframe (``_keyframe_body``,
    ``pipeline.py:187-302`` of the JAX package, before the candidate
    search).

    ``image``: (H, W) or (C, H, W) uint8 or float; ``depth``: the same
    shape, uint16 in sensor units (× ``config.depth_scale``) or float
    metres; ``cam_pose``: (7,) or (C, 7) camera-to-base extrinsics.  Numpy
    arrays or tensors; the work runs on ``device``, else on the device of
    a tensor ``image``, else on the CUDA card.  Each camera's depth is
    rectified with its image where ``frontend.rectify`` is set, then, with
    ``frontend.use_depth_refinement`` (the default), smoothed by the joint
    bilateral filter guided by the image (K17) before the keypoints' depth
    lookup and the scan.  Each camera takes ``feats_per_node // C``
    keypoints at the FAST threshold of ``tunables`` (default: from
    ``config``); the GIST is camera 0's, rolled by its extrinsic's roll.
    With ``estimation.method="gicp"`` the frame's voxel cloud is built from
    every camera's raw depth and image (before rectification and the
    filter, as the reference builds it): every pixel with depth > 0.1 m,
    gray replicated into Lab, one voxel grid (K25) over all cameras.
    The "sift" family raises ``NotImplementedError``, as the reference
    cannot run it either: the live banks hold binary descriptors, and the
    reference's keyframe body reshapes descriptors to 32-byte rows
    (``uzliti_slam_tpu/pipeline.py:252``).  SIFT runs offline, through
    ``ops.features.detect_and_describe`` and ``ops.matching.match_descriptors_l2``.
    """
    fc = config.frontend
    if fc.descriptor == "sift":
        raise NotImplementedError(
            "the 'sift' descriptor family has no keyframe path: the live banks hold binary "
            "descriptors and the keyframe body takes 32-byte rows; use "
            "ops.features.detect_and_describe and ops.matching.match_descriptors_l2 offline")
    tn = tunables if tunables is not None else tunables_from_config(config)
    if device is None and isinstance(image, torch.Tensor):
        device = image.device
    device = _device.resolve(device)
    imgs = _as_tensor(image, device)
    deps = _as_tensor(depth, device)
    poses = _as_tensor(cam_pose, device).to(torch.float32)
    imgs = (imgs if imgs.dim() == 3 else imgs[None]).to(torch.float32)
    raw = deps if deps.dim() == 3 else deps[None]
    deps = _depth_metres(raw, config.depth_scale)
    poses = poses if poses.dim() == 2 else poses[None]
    n_cams, H, W = imgs.shape
    k_per_cam = config.feats_per_node // n_cams
    if k_per_cam * n_cams != config.feats_per_node:
        raise ValueError(f"feats_per_node budget {config.feats_per_node} not divisible by "
                         f"{n_cams} cameras")
    cloud = None
    if config.estimation.method == "gicp":
        ec = config.estimation
        pb = lie.pose_apply(poses[:, None, :], _cloud_points(cam, raw, deps, config.depth_scale)
                            .reshape(n_cams, H * W, 3))
        d = deps.reshape(-1)
        # XLA compiles the division by 255 into a product with its float32 reciprocal
        gray = torch.clamp(imgs.reshape(-1) * (1.0 / 255.0), 0.0, 1.0)
        cloud = gicp_ops.voxel_downsample(
            pb.reshape(-1, 3), gicp_ops.rgb_to_lab(torch.stack([gray, gray, gray], dim=-1)),
            (d > 0.1) & torch.isfinite(d), ec.gicp_voxel, ec.gicp_max_voxels)
    if fc.rectify:
        imgs = cam_mod.rectify_image(cam, imgs)
        deps = cam_mod.rectify_image(cam, deps, nearest=True)
    if fc.use_depth_refinement:
        deps = depth_ops.joint_bilateral_filter(deps, imgs)

    # the keypoints' descriptors and camera 0's GIST (rolled by its
    # extrinsic's roll) in one K14 launch
    kps, desc, gist = features.detect_describe_gist(
        imgs, roll_angle=lie.roll_of(lie.pose_q(poses[0])), max_keypoints=k_per_cam,
        threshold=tn.fast_threshold, grid=fc.grid, n_levels=fc.pyramid_levels,
        scale_factor=fc.scale_factor, descriptor=fc.descriptor)
    ui = torch.clamp(kps.uv[..., 0].to(torch.int32), 0, W - 1).long()
    vi = torch.clamp(kps.uv[..., 1].to(torch.int32), 0, H - 1).long()
    z = torch.gather(deps.reshape(n_cams, -1), 1, vi * W + ui)
    pts_cam = cam_mod.backproject(cam, kps.uv[..., 0], kps.uv[..., 1], z)
    pts_base = lie.pose_apply(poses[:, None, :], pts_cam)
    pts_valid = kps.valid & (z > 0.1) & torch.isfinite(z)

    vscan = scan_ops.depth_to_scan(deps, cam, poses, n_bins=config.scan_bins,
                                   height_band=(-0.4, 0.6), max_range=6.0)
    # merge the cameras' scans in polar space, newest camera preferred
    merged = scan_ops.Scan(vscan.ranges[0], vscan.far_ranges[0], vscan.angle_min,
                           vscan.angle_max)
    for i in range(1, n_cams):
        merged = scan_ops.merge_scans(merged, scan_ops.Scan(
            vscan.ranges[i], vscan.far_ranges[i], vscan.angle_min, vscan.angle_max))

    return FrontendOutput(desc=desc.reshape(-1, 32), pts_base=pts_base.reshape(-1, 3),
                          pts_valid=pts_valid.reshape(-1), uv=kps.uv, kp_valid=kps.valid,
                          scan=merged, gist=gist, cloud=cloud)


# ---------------------------------------------------------------------------
# The keyframe step
# ---------------------------------------------------------------------------

ESTIMATION_METHODS = ("feature", "pnp", "gicp")


def check_supported(config: SlamConfig) -> None:
    """Raise ``ValueError`` for an unknown estimation method, as the
    reference does."""
    if config.estimation.method not in ESTIMATION_METHODS:
        raise ValueError(f"unknown estimation method {config.estimation.method!r}")


def _scan_pts(ranges: torch.Tensor):
    """2-D points and validity of a stored scan (near ranges over
    [-π, π), the bounds as the reference's float32 constants)."""
    pi = float(np.float32(np.pi))
    return scan_ops.scan_points(scan_ops.Scan(ranges, ranges, -pi, pi))


def _recognize(state: SlamState, fe: FrontendOutput, st: torch.Tensor, config: SlamConfig):
    """The place-recognition candidates of ``config.recognition.method``
    (``pipeline.py:311-353`` of the JAX package): (slots (k,), ok (k,), the
    frame's BoW vector or None).  The feature sets are the state's node
    descriptors; a node is searched, and the frame queries, only with
    ``min_descriptors`` valid descriptors.  An unknown method raises
    ``ValueError``."""
    g, tn, rc = state.graph, state.tunables, config.recognition
    k, min_dt = rc.k_candidates, tn.min_time_separation
    if rc.method == "gist":
        slots, _, ok = rec.gist_query(state.gist, fe.gist, st, k=k, max_dist=tn.gist_max_dist,
                                      min_dt=min_dt)
        return slots, ok, None
    if rc.method == "feature_set":
        fbank = rec.FeatureSetBank(
            desc=state.desc, desc_valid=state.desc_valid & g.node_valid[:, None], stamp=g.stamp,
            valid=g.node_valid & (state.desc_valid.sum(-1) >= tn.min_descriptors))
        slots, _, ok = rec.feature_set_query(fbank, fe.desc, fe.pts_valid, st, k=k,
                                             hamming_thresh=tn.feature_hamming_thresh,
                                             min_similarity=tn.min_similarity, min_dt=min_dt)
        return slots, ok & (fe.pts_valid.sum() >= tn.min_descriptors), None
    if rc.method == "repository":
        slots, _, ok = rec.repository_query(state.repo, fe.desc, fe.pts_valid, st, k=k,
                                            match_thresh=tn.feature_hamming_thresh,
                                            min_votes=tn.repo_min_votes, min_dt=min_dt)
        return slots, ok, None
    if rc.method == "bow":
        vec = voc.quantize(state.vocab, fe.desc, fe.pts_valid)
        slots, _, ok = voc.bow_query(state.bow, vec, st, k=k, min_score=tn.bow_min_score,
                                     min_dt=min_dt)
        return slots, ok, vec
    raise ValueError(f"unknown place_recognition method {rc.method!r}")


def _register_feature(state: SlamState, fe: FrontendOutput, cs: torch.Tensor,
                      config: SlamConfig, tri: torch.Tensor | None):
    """The feature estimator: Hamming 2-NN + ratio test against every
    candidate (K16, one launch), then RANSAC with soft-PROSAC draws (K7).
    Returns the registration and the triplets drawn (or ``tri``)."""
    tn, ec = state.tunables, config.estimation
    mi, ok_m, dist = matching.match_against_bank(fe.desc, fe.pts_valid, state.desc,
                                                 state.desc_valid, cs, tn.match_ratio,
                                                 tn.max_match_distance)
    nb, F = cs.shape[0], fe.desc.shape[0]
    cpts = state.points.index_select(0, cs.long())
    dst = torch.gather(cpts, 1, mi.long()[..., None].expand(nb, F, 3))
    res = ransac.ransac_rigid_batch(
        fe.pts_base[None].expand(nb, F, 3), dst, ok_m, ec.ransac_hypotheses,
        tn.ransac_inlier_thresh, tn.min_consensus, tn.ransac_min_sigma, tri=tri,
        generator=state.generator, quality=-dist)
    return (res.pose, res.information, res.consensus.to(torch.float32), res.ok), res.tri


def _register_pnp(state: SlamState, fe: FrontendOutput, cs: torch.Tensor, cam, cam0,
                  config: SlamConfig, keys: torch.Tensor | None):
    """The PnP estimator (``pipeline.py:417-457`` of the JAX package): camera
    0's keypoints matched against every candidate (K16), then the PnP
    RANSAC (K28) of the candidate's 3-D points against their pixels, with
    the measured depth of each keypoint in camera 0.  The edge is
    (cam0 ∘ T)⁻¹ over base frames; its information diag(1, 1, 1, 100, 100,
    100) · 0.1 · consensus / max(mse, 1e-2).  Returns the registration and
    the draws' uniform keys (or ``keys``)."""
    tn, ec = state.tunables, config.estimation
    nb, F = cs.shape[0], fe.desc.shape[0]
    k_per_cam = fe.uv.shape[1]
    valid2d = fe.kp_valid.reshape(-1) & (torch.arange(F, device=cs.device) < k_per_cam)
    depth0 = torch.where(fe.pts_valid,
                         lie.pose_apply(lie.pose_inverse(cam0)[None], fe.pts_base)[:, 2], 0.0)
    mi, ok_m, _ = matching.match_against_bank(fe.desc, valid2d, state.desc, state.desc_valid,
                                              cs, tn.match_ratio, tn.max_match_distance)
    cpts = state.points.index_select(0, cs.long())
    X = torch.gather(cpts, 1, mi.long()[..., None].expand(nb, F, 3))
    if keys is None:
        keys = torch.rand((nb, ec.pnp_hypotheses, F), generator=state.generator, device=cs.device)
    pr = pnp_ops.pnp_ransac(X, fe.uv.reshape(-1, 2), ok_m, cam.fx, cam.fy, cam.cx, cam.cy,
                            n_hypotheses=ec.pnp_hypotheses, reproj_thresh_px=tn.pnp_reproj_px,
                            min_consensus=tn.min_consensus, depth=depth0, keys=keys)
    pose = lie.pose_inverse(lie.pose_compose(cam0[None], pr.pose))
    consensus = pr.consensus.to(torch.float32)
    base = 0.1 * consensus / torch.clamp(pr.reproj_mse, min=1e-2)
    diag = torch.cat([torch.ones(nb, 3, device=cs.device),
                      torch.full((nb, 3), 100.0, device=cs.device)], dim=-1)
    return (pose, torch.diag_embed(diag * base[:, None]), consensus, pr.ok), keys


def _register_gicp(state: SlamState, fe: FrontendOutput, cs: torch.Tensor,
                   map_pose: torch.Tensor, config: SlamConfig):
    """The gicp estimator (``pipeline.py:459-472`` of the JAX package): the
    frame's voxel cloud against every candidate's by the 6-D ICP (K26's
    normals, K27), from the candidate-relative map pose; the score is 100 ×
    the correspondence fraction, and a candidate without a cloud fails."""
    g, tn, ec = state.graph, state.tunables, config.estimation
    idx = cs.long()
    cvalid = state.cloud_valid.index_select(0, idx)
    init = lie.pose_relative(g.pose.index_select(0, idx), map_pose[None])
    rg = gicp_ops.gicp_6d(*fe.cloud, state.clouds.index_select(0, idx),
                          state.cloud_lab.index_select(0, idx), cvalid, init_pose=init,
                          iterations=ec.gicp_iterations, max_corr_dist=tn.gicp_max_corr)
    return rg.pose, rg.information, 100.0 * rg.fraction, rg.ok & cvalid.any(-1)


def process_keyframe(state: SlamState, image, depth, odom_pose, stamp,
                     cam: cam_mod.PinholeCamera, cam_pose, config: SlamConfig = SlamConfig(),
                     cam_disp=None, tri: torch.Tensor | None = None,
                     pnp_keys: torch.Tensor | None = None) -> tuple[SlamState, dict]:
    """Ingest one keyframe (``_keyframe_body``, ``pipeline.py:159-623`` of
    the JAX package) on the state's device.

    ``image``/``depth``/``cam_pose`` as ``keyframe_frontend`` takes them;
    ``odom_pose`` (7,) the base's odometry pose; ``stamp`` seconds (a
    number or a () tensor); ``cam_disp`` (C, 7) optional per-camera
    capture displacement, composed onto the extrinsics.  ``tri`` (2·k,
    ``ransac_hypotheses``, 3) injects the RANSAC triplets of the 2·k
    candidates ("feature"), ``pnp_keys`` (2·k, ``pnp_hypotheses``, F) the
    PnP draws' uniform keys ("pnp"); without them they are drawn from
    ``state.generator``.
    Returns the new state (functional: ``state``'s tensors are not
    modified; the generator advances) and ``info``: ``new_slot``,
    ``n_candidates``, ``n_edges_proposed``, ``n_features`` as device
    tensors, and the draws the step used, ``tri`` ("feature") or
    ``pnp_keys`` ("pnp"), which replay it.  Reads no device value on the
    host.
    """
    check_supported(config)
    g = state.graph
    dev = g.device
    tn, rc, ec, kc = state.tunables, config.recognition, config.estimation, config.keyframe
    if state.desc.shape[1] != config.feats_per_node:
        raise ValueError(f"the state holds {state.desc.shape[1]} descriptors a node, "
                         f"config.feats_per_node is {config.feats_per_node}")
    odom = _as_tensor(odom_pose, dev).to(torch.float32)
    st = rec.scalar(stamp, torch.float32, dev)
    poses = _as_tensor(cam_pose, dev).to(torch.float32)
    poses = poses if poses.dim() == 2 else poses[None]
    if cam_disp is not None:
        disp = _as_tensor(cam_disp, dev).to(torch.float32)
        poses = lie.pose_compose(disp if disp.dim() == 2 else disp[None], poses)
    fe = keyframe_frontend(image, depth, cam, poses, config, device=dev, tunables=tn)

    # map-pose bootstrap from the map->odom correction
    map_pose = lie.pose_compose(g.diff_transform, odom)
    prev_slot = state.last_kf_slot
    has_prev = prev_slot >= 0
    prev_safe = torch.clamp(prev_slot, min=0).long().view(1)

    # candidates before inserting the node: the place-recognition query of
    # the configured method and the distance loop closures (nearest valid
    # nodes within the radius, heading within the angle, temporally
    # separated)
    k = rc.k_candidates
    pr_slots, pr_ok, bow_vec = _recognize(state, fe, st, config)
    d_nodes = torch.linalg.vector_norm(lie.pose_t(g.pose) - lie.pose_t(map_pose), dim=-1)
    rel_q = lie.quat_mul(lie.quat_conj(lie.pose_q(g.pose)), lie.pose_q(map_pose)[None])
    ang_ok = torch.rad2deg(lie.rotation_angle(rel_q)) < kc.distance_closure_max_angle_deg
    d_eligible = (g.node_valid & (d_nodes < kc.distance_closure_radius) & ang_ok
                  & (torch.abs(g.stamp - st) >= tn.min_time_separation))
    d_vals, dist_slots = kops.smallest_k(torch.where(d_eligible, d_nodes, torch.inf), k)
    cand_slots = torch.cat([pr_slots, dist_slots.to(torch.int32)])
    cand_ok = torch.cat([pr_ok, torch.isfinite(d_vals)])
    # dedup against existing edges (by presence: a proposed pair is never
    # proposed again) and within the list (only an OK earlier duplicate
    # suppresses a later one)
    edge_present = torch.arange(g.edge_capacity, device=dev) < g.num_edges
    cand_ok = cand_ok & rec.mask_existing_pairs(g.e_from, g.e_to, edge_present, cand_slots,
                                                g.num_nodes.expand(cand_slots.shape))
    nb = cand_slots.shape[0]
    order = torch.arange(nb, device=dev)
    earlier_dup = ((cand_slots[None, :] == cand_slots[:, None]) & cand_ok[None, :]
                   & (order[None, :] < order[:, None]))
    cand_ok = cand_ok & ~earlier_dup.any(-1)

    # registration of every candidate by the configured estimator, gated
    # afterwards
    cs = torch.clamp(cand_slots, min=0)
    draws = {}
    if ec.method == "gicp":
        r_pose, r_info, r_score, r_ok = _register_gicp(state, fe, cs, map_pose, config)
    elif ec.method == "pnp":
        (r_pose, r_info, r_score, r_ok), draws["pnp_keys"] = _register_pnp(
            state, fe, cs, cam, poses[0], config, pnp_keys)
    else:
        (r_pose, r_info, r_score, r_ok), draws["tri"] = _register_feature(state, fe, cs,
                                                                          config, tri)
    t_norm = torch.linalg.vector_norm(lie.pose_t(r_pose), dim=-1)
    r_deg = torch.rad2deg(lie.rotation_angle(lie.pose_q(r_pose)))
    edge_ok = (cand_ok & r_ok & (r_score >= tn.min_matching_score)
               & (t_norm < tn.max_edge_translation) & (r_deg < tn.max_edge_rotation_deg))

    # the node; its uid from the keyframe counter, not the slot
    uncertainty = torch.where(has_prev, g.uncertainty.index_select(0, prev_safe)[0], 0.0)
    g, new_slot = gstate.add_node(g, map_pose, odom, st, uncertainty=uncertainty,
                                  uid=config.instance_id * 1_000_000 + state.n_keyframes)
    rel_odom = lie.pose_relative(g.odom_pose.index_select(0, prev_safe)[0], odom)

    # the edges, in the reference's order: odometry, the ICP laser edge to
    # the previous keyframe, the candidates; all but odometry enter invalid
    prev_or_none = torch.where(has_prev, prev_slot, -1)
    froms, transforms, infos = [prev_or_none[None]], [rel_odom[None]], [
        gstate.odometry_information(rel_odom)[None]]
    etypes = [gstate.EDGE_TYPE_2D_WHEEL_ODOMETRY]
    if config.use_laser_edges:
        prev_pts, prev_ok = _scan_pts(state.scans.index_select(0, prev_safe)[0])
        cur_pts, cur_ok = scan_ops.scan_points(fe.scan)
        ires = icp.icp_point_to_line(
            cur_pts, cur_ok, prev_pts, prev_ok & state.scan_valid.index_select(0, prev_safe)[0],
            lie.pose_to_pose2(rel_odom), iterations=ec.icp_iterations,
            max_corr_dist=tn.icp_max_corr, min_valid_fraction=tn.icp_min_valid_fraction)
        froms.append(torch.where(has_prev & ires.ok, prev_slot, -1)[None])
        transforms.append(icp.icp_edge_pose(ires.pose2)[None])
        infos.append(icp.icp_information_6d(ires.cov3)[None])
        etypes.append(gstate.EDGE_TYPE_2D_LASER)
    n_fixed = len(etypes)
    # built by concatenation: a scalar written into a CUDA tensor's element
    # is a synchronising host-to-device copy
    et = torch.cat([torch.full((1,), t, dtype=torch.int32, device=dev) for t in etypes]
                   + [torch.full((nb,), gstate.EDGE_TYPE_3D_FULL, dtype=torch.int32, device=dev)])
    valid = torch.arange(n_fixed + nb, device=dev) == 0       # odometry enters valid
    froms.append(torch.where(edge_ok, cand_slots, -1))
    g, _ = gstate.add_edges(
        g, torch.cat(froms), new_slot.expand(n_fixed + nb), torch.cat(transforms + [r_pose]),
        torch.cat(infos + [r_info]), et,
        torch.cat([torch.zeros(n_fixed, device=dev), r_score]), valid)

    # the node's bank rows
    ns = torch.clamp(new_slot, min=0).long()
    wrote = new_slot >= 0
    repo, bow = state.repo, state.bow
    if rc.method == "repository":
        repo = rec.repository_add(repo, ns, fe.desc, fe.pts_valid, st,
                                  match_thresh=tn.feature_hamming_thresh, ok=wrote)
    if rc.method == "bow":
        bow = voc.bow_bank_add(bow, new_slot, bow_vec, st)
    if ec.method == "gicp":
        cp, cl, cv = fe.cloud
        state = state.replace(clouds=gstate.set_row(state.clouds, ns, wrote, cp),
                              cloud_lab=gstate.set_row(state.cloud_lab, ns, wrote, cl),
                              cloud_valid=gstate.set_row(state.cloud_valid, ns, wrote, cv))
    state = state.replace(
        graph=g, repo=repo, bow=bow,
        gist=rec.gist_bank_add(state.gist, new_slot, fe.gist, st),
        desc=gstate.set_row(state.desc, ns, wrote, fe.desc),
        desc_valid=gstate.set_row(state.desc_valid, ns, wrote, fe.pts_valid),
        points=gstate.set_row(state.points, ns, wrote, fe.pts_base),
        scans=gstate.set_row(state.scans, ns, wrote, fe.scan.ranges),
        scan_valid=gstate.set_row(state.scan_valid, ns, wrote, True),
        last_kf_odom=odom,
        n_keyframes=state.n_keyframes + 1,
        last_kf_slot=torch.where(wrote, new_slot, state.last_kf_slot).to(torch.int32),
    )
    info = {"new_slot": new_slot, "n_candidates": cand_ok.sum(), "n_edges_proposed": edge_ok.sum(),
            "n_features": fe.pts_valid.sum(), **draws}
    return state, info


def recognize_absorbed(state: SlamState, slots: torch.Tensor, mask: torch.Tensor,
                       config: SlamConfig = SlamConfig(),
                       tri: torch.Tensor | None = None) -> tuple[SlamState, torch.Tensor, dict]:
    """The global's place recognition and registration of absorbed nodes
    (``pipeline.py:690-811`` of the JAX package): the reference's global
    re-runs its recognizer on every received node and registers the matches
    (``graph_slam_node.cpp:473-476``).  The shipped payloads already sit in
    the banks, so each of the K ``slots`` (K,) whose ``mask`` (K,) holds
    runs the configured query — the GIST (K16), or the feature sets (K21)
    for every other method ("repository" and "bow" keep no index on the
    wire) — the pair dedup against the edges present and earlier
    candidates, the Hamming matching of every candidate (K16, one launch)
    and RANSAC with soft-PROSAC draws (K7); accepted edges enter invalid.

    The slots run in order, a host loop that reads nothing back: each
    slot's dedup reads the edges earlier slots added.  ``tri`` (K, k,
    ``ransac_hypotheses``, 3) injects the RANSAC triplets; without it they
    are drawn from ``state.generator`` for every slot, masked or not.
    Returns (state, edges proposed as a () tensor, {"tri": the triplets
    used})."""
    g = state.graph
    dev = g.device
    tn, rc, ec = state.tunables, config.recognition, config.estimation
    k = rc.k_candidates
    slots = slots.to(device=dev, dtype=torch.int32)
    mask = mask.to(device=dev, dtype=torch.bool)
    n_proposed = torch.zeros((), dtype=torch.int32, device=dev)
    draws = []
    for i in range(slots.shape[0]):
        s = torch.clamp(slots[i], min=0).long()
        s1 = s.view(1)
        stamp = g.stamp.index_select(0, s1)[0]
        desc = state.desc.index_select(0, s1)[0]
        desc_valid = state.desc_valid.index_select(0, s1)[0]
        if rc.method == "gist":
            pr_slots, _, pr_ok = rec.gist_query(
                state.gist, state.gist.desc.index_select(0, s1)[0], stamp, k=k,
                max_dist=tn.gist_max_dist, min_dt=tn.min_time_separation)
        else:
            fbank = rec.FeatureSetBank(
                desc=state.desc, desc_valid=state.desc_valid & g.node_valid[:, None],
                stamp=g.stamp,
                valid=g.node_valid & (state.desc_valid.sum(-1) >= tn.min_descriptors))
            pr_slots, _, pr_ok = rec.feature_set_query(
                fbank, desc, desc_valid, stamp, k=k, hamming_thresh=tn.feature_hamming_thresh,
                min_similarity=tn.min_similarity, min_dt=tn.min_time_separation)
            pr_ok = pr_ok & (desc_valid.sum() >= tn.min_descriptors)
        pr_ok = pr_ok & mask[i] & (pr_slots != s)
        # dedup against the edges present (both directions) and earlier candidates
        edge_present = torch.arange(g.edge_capacity, device=dev) < g.num_edges
        s_k = s.to(torch.int32).expand(k)
        pr_ok = pr_ok & rec.mask_existing_pairs(g.e_from, g.e_to, edge_present, pr_slots, s_k)
        order = torch.arange(k, device=dev)
        earlier_dup = ((pr_slots[None, :] == pr_slots[:, None]) & pr_ok[None, :]
                       & (order[None, :] < order[:, None]))
        pr_ok = pr_ok & ~earlier_dup.any(-1)

        cs = torch.clamp(pr_slots, min=0)
        mi, ok_m, dist = matching.match_against_bank(desc, desc_valid, state.desc,
                                                     state.desc_valid, cs, tn.match_ratio,
                                                     tn.max_match_distance)
        F = desc.shape[0]
        dst = torch.gather(state.points.index_select(0, cs.long()), 1,
                           mi.long()[..., None].expand(k, F, 3))
        res = ransac.ransac_rigid_batch(
            state.points.index_select(0, s1).expand(k, F, 3), dst, ok_m, ec.ransac_hypotheses,
            tn.ransac_inlier_thresh, tn.min_consensus, tn.ransac_min_sigma,
            tri=None if tri is None else tri[i], generator=state.generator, quality=-dist)
        draws.append(res.tri)
        t_norm = torch.linalg.vector_norm(lie.pose_t(res.pose), dim=-1)
        r_deg = torch.rad2deg(lie.rotation_angle(lie.pose_q(res.pose)))
        edge_ok = (pr_ok & res.ok & (res.consensus >= tn.min_matching_score)
                   & (t_norm < tn.max_edge_translation) & (r_deg < tn.max_edge_rotation_deg))
        g, _ = gstate.add_edges(
            g, torch.where(edge_ok, pr_slots, -1), s_k, res.pose, res.information,
            torch.full((k,), gstate.EDGE_TYPE_3D_FULL, dtype=torch.int32, device=dev),
            res.consensus.to(torch.float32), torch.zeros(k, dtype=torch.bool, device=dev))
        n_proposed = n_proposed + edge_ok.sum(dtype=torch.int32)
    tri_used = (torch.stack(draws) if draws else
                torch.zeros((0, k, ec.ransac_hypotheses, 3), dtype=torch.int32, device=dev))
    return state.replace(graph=g), n_proposed, {"tri": tri_used}


def grow_state(state: SlamState, node_capacity: int, edge_capacity: int) -> SlamState:
    """The graph and every per-node bank re-padded to the next capacity tier
    (``lifecycle.ensure_capacity``); a host-side step between keyframes."""
    g = lifecycle.ensure_capacity(state.graph, node_capacity, edge_capacity)
    new_n, old_n = g.node_capacity, state.desc.shape[0]
    if new_n == old_n:
        return state.replace(graph=g)

    def pad(a: torch.Tensor, fill=0) -> torch.Tensor:
        return torch.cat([a, a.new_full((new_n - old_n,) + tuple(a.shape[1:]), fill)])

    repo, bow = state.repo, state.bow
    if repo is not None:
        # the node-indexed fields grow; the descriptor bank keeps its
        # capacity (it scales with the features seen, not the node slots)
        repo = repo._replace(node_stamp=pad(repo.node_stamp), node_valid=pad(repo.node_valid))
    if bow is not None:
        bow = voc.BowBank(*(pad(x) for x in bow))
    if state.clouds is not None:
        state = state.replace(clouds=pad(state.clouds), cloud_lab=pad(state.cloud_lab),
                              cloud_valid=pad(state.cloud_valid))
    return state.replace(
        graph=g, gist=rec.GistBank(*(pad(x) for x in state.gist)), desc=pad(state.desc),
        desc_valid=pad(state.desc_valid), points=pad(state.points),
        scans=pad(state.scans, math.inf), scan_valid=pad(state.scan_valid), repo=repo, bow=bow)


# ---------------------------------------------------------------------------
# The Slam shell
# ---------------------------------------------------------------------------

def _keyframe_due_np(last_pose, cur_pose, dist_thresh, angle_deg) -> bool:
    """The host keyframe gate: moved at least ``dist_thresh`` metres or
    turned at least ``angle_deg`` degrees since the last keyframe."""
    dt = float(np.linalg.norm(cur_pose[:3] - last_pose[:3]))
    dot = float(np.abs(np.clip(np.sum(cur_pose[3:7] * last_pose[3:7]), -1.0, 1.0)))
    dr = 2.0 * np.arccos(dot)
    return dt >= dist_thresh or np.degrees(dr) >= angle_deg


def _host_pose(pose) -> np.ndarray:
    if isinstance(pose, torch.Tensor):
        pose = pose.detach().cpu().numpy()
    return np.asarray(pose, np.float32)


class Slam:
    """Imperative shell over the functional core (``Slam`` of the JAX
    package): the host keyframe gate, capacity growth and the epoch
    schedule.  Runs on ``device`` (default: the CUDA card).  Feed it host
    (numpy) frames and odometry: the gate reads the odometry on the host,
    and the keyframe step reads nothing back.  ``recognition.method="bow"``
    needs a ``vocabulary`` (``recognition.vocabulary``)."""

    def __init__(self, config: SlamConfig = SlamConfig(), cam=None, cam_pose=None, seed: int = 0,
                 device=None, vocabulary: voc.Vocabulary | None = None):
        check_supported(config)
        if config.sync_to_database:
            raise NotImplementedError("sync_to_database: the graph database is not ported "
                                      "(ROADMAP.md A27)")
        self.device = _device.resolve(device)
        self.config = config
        self.cam = cam or cam_mod.default_kinect()
        self.cam_pose = (lie.pose_identity((), self.device) if cam_pose is None
                         else _as_tensor(cam_pose, self.device).to(torch.float32))
        self.state = init_state(config, seed, self.device, vocabulary)
        self.grid: occupancy.OccupancyGrid | None = None
        self.optimize_every = 10
        self.auto_grow = True
        self._since_opt = 0
        self._epochs_since_calib = 0
        self._last_kf_odom_host = _host_pose(lie.pose_identity((), "cpu"))
        self._n_kf_host = 0
        # the node-slot high-water mark, as the host counts it: what gates growth
        self._n_slots_host = 0

    def add_frame(self, image, depth, odom_pose, stamp, cam_disp=None,
                  tri: torch.Tensor | None = None,
                  pnp_keys: torch.Tensor | None = None) -> dict | None:
        """Process a frame if it is keyframe-due; returns the step's info
        (device tensors: reading them synchronises) or None.  ``tri`` and
        ``pnp_keys`` inject the step's draws (``process_keyframe``)."""
        kc = self.config.keyframe
        odom = _host_pose(odom_pose)
        due = self._n_kf_host == 0 or _keyframe_due_np(
            self._last_kf_odom_host, odom, kc.new_node_distance, kc.new_node_angle_deg)
        if not due:
            return None
        if self.auto_grow and self._n_slots_host >= int(0.9 * self.config.node_capacity):
            new_cfg = dataclasses.replace(self.config, node_capacity=self.config.node_capacity * 2,
                                          edge_capacity=self.config.edge_capacity * 2)
            self.state = grow_state(self.state, new_cfg.node_capacity, new_cfg.edge_capacity)
            self.config = new_cfg
        self.state, info = process_keyframe(self.state, image, depth, odom, stamp, self.cam,
                                            self.cam_pose, self.config, cam_disp, tri, pnp_keys)
        self._last_kf_odom_host = odom
        self._n_kf_host += 1
        self._n_slots_host += 1
        self._since_opt += 1
        if self._since_opt >= self.optimize_every:
            self.optimize()
        return info

    def optimize(self) -> solver.SolveStats:
        """The optimization tick: ``optimize_epoch``, a calibration every
        ``config.calibrate_every`` epochs (when > 0), then the projection
        into the live grid when ``config.project_map``."""
        self.state, stats = optimize_epoch(self.state, self.config)
        self._since_opt = 0
        self._epochs_since_calib += 1
        if 0 < self.config.calibrate_every <= self._epochs_since_calib:
            self.calibrate()
        if self.config.project_map:
            self.project_map()
        return stats

    def calibrate(self, update_extrinsics: bool = False,
                  iterations: int = 20) -> calibration.CalibrationResult:
        """The calibration epoch (the reference's ``SensorTransformOptimizer``
        run live; ``pipeline.py:1794-1832`` of the JAX package): on the
        current graph, re-estimate the odometry drift parameters (K20) and
        store them on the graph, where a solve with
        ``solver.use_odometry_calibration`` reads them.  The loop closures
        are sensor factors through camera 0 only with
        ``update_extrinsics=True``, which then also adopts the refined
        camera extrinsics into ``self.cam_pose``."""
        g = self.state.graph
        cam_poses = self.cam_pose if self.cam_pose.dim() == 2 else self.cam_pose[None]
        sensor_idx = torch.where(g.e_type == gstate.EDGE_TYPE_3D_FULL,
                                 0 if update_extrinsics else -1, -1).to(torch.int32)
        result = calibration.calibrate(g, cam_poses, sensor_idx, sensor_idx, iterations)
        self.state = self.state.replace(graph=g.replace(odom_params=result.odom_params))
        if update_extrinsics:
            new_cp = result.sensor_transforms
            self.cam_pose = new_cp if self.cam_pose.dim() == 2 else new_cp[0]
        self._epochs_since_calib = 0
        return result

    def maintain(self, shipped=None, center=None) -> dict:
        """The merge / eviction timer (role set by ``config.scope``), then
        slot reclamation: when the high-water mark is at least max(64, ¼ of
        the node capacity) and at most half of it is live, the state is
        compacted (``compact_state``), the grid is dropped (its slot-aligned
        snapshot is stale: the next projection rebuilds it) and
        ``compact_perm`` carries the permutation, else it is None.  Reads
        the high-water mark and the live count in one transfer."""
        self.state, info = maintenance_epoch(self.state, self.config, shipped, center)
        info = dict(info, compact_perm=None)
        g = self.state.graph
        hw, live = torch.stack([g.num_nodes, g.node_valid.sum(dtype=torch.int32)]).tolist()
        if hw >= max(64, int(0.25 * self.config.node_capacity)) and live <= hw // 2:
            self.state, info["compact_perm"] = compact_state(self.state)
            hw = live
            self.grid = None
        self._n_slots_host = hw
        return info

    def reregister_scans(self, k_targets: int = 4) -> torch.Tensor:
        """The scan re-registration timer: the number of laser edges added
        (a () tensor)."""
        self.state, n = scan_reregistration(self.state, self.config, k_targets)
        return n

    def add_gps(self, xyz, sigma: float = 1.0) -> bool:
        """A GPS fix for the newest keyframe, as a translation-only
        TYPE_3D_GPS factor from a fixed map-origin anchor node (made on the
        first fix, uid ``GPS_ANCHOR_UID``).  A low-rate host path: reads the
        newest slot and the anchor on the host.  False when there is no
        keyframe yet or a table is full."""
        g = self.state.graph
        dev = g.device
        last = int(self.state.last_kf_slot)
        if last < 0:
            return False
        anchors = torch.nonzero(g.node_valid & (g.node_uid == gstate.GPS_ANCHOR_UID)).flatten()
        if anchors.numel() == 0:
            ident = lie.pose_identity((), dev)
            g, slot = gstate.add_node(g, ident, ident, torch.zeros((), device=dev), fixed=True,
                                      uid=gstate.GPS_ANCHOR_UID)
            anchor = int(slot)
            if anchor < 0:
                return False
            self._n_slots_host += 1
        else:
            anchor = int(anchors[0])
        measurement = lie.make_pose(_as_tensor(np.asarray(xyz, np.float32), dev),
                                    torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev))
        info = (1.0 / float(sigma) ** 2) * torch.eye(6, device=dev)
        g, eslot = gstate.add_edge(g, anchor, last, measurement, info,
                                   etype=gstate.EDGE_TYPE_3D_GPS)
        self.state = self.state.replace(graph=g)
        return int(eslot) >= 0

    def set_param(self, name: str, value: float) -> None:
        """Retune a gate of ``config.Tunables`` (rounded to float32), or a
        keyframe-gate field of ``config.keyframe``, for the next frames."""
        if name in {f.name for f in dataclasses.fields(Tunables)}:
            self.state = self.state.replace(tunables=self.state.tunables.replace(**{name: value}))
        elif name in {f.name for f in dataclasses.fields(KeyframeConfig)}:
            self.config = dataclasses.replace(
                self.config, keyframe=dataclasses.replace(self.config.keyframe, **{name: value}))
        else:
            raise KeyError(f"unknown tunable {name!r}")

    def project_map(self, force_full: bool = False) -> occupancy.OccupancyGrid:
        """Project the scans into the live occupancy grid (a fresh full
        rebuild the first time or after growth)."""
        self.grid = project_map(self.state, self.config, self.grid, force_full)
        return self.grid

    def map_probability(self) -> torch.Tensor:
        if self.grid is None:
            self.project_map()
        return map_probability(self.grid)

    def map_ternary(self) -> torch.Tensor:
        if self.grid is None:
            self.project_map()
        return map_ternary(self.grid)

    def trajectory(self):
        """(poses (n, 7), valid (n,)) of the used node slots (reads the node
        count on the host)."""
        g = self.state.graph
        n = int(g.num_nodes)
        return g.pose[:n], g.node_valid[:n]

    def fuse_odometry(self, *args, **kwargs):
        raise NotImplementedError("the odometry x IMU EKF is not ported (ROADMAP.md A26)")

    def enqueue_frame(self, *args, **kwargs):
        raise NotImplementedError("the chunked ingest (process_frame_chunk) is not ported "
                                  "(ROADMAP.md A19, with A20)")

    flush_frames = add_frames = enqueue_frame
