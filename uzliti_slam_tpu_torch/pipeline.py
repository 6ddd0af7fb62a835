"""The SLAM orchestrator: the keyframe step, the optimization tick and the
``Slam`` shell.

PyTorch counterpart of ``uzliti_slam_tpu/pipeline.py`` in its default
configuration (GIST recognition, the feature estimator, laser edges, depth
refinement):

- ``process_keyframe`` ingests one keyframe: the front-end
  (``keyframe_frontend``: the bilateral depth filter K17, features and
  descriptors K12-K14, the virtual scan K15, the GIST), the map-pose
  bootstrap, the GIST query (K16) and the distance candidates, the pair
  dedup, Hamming matching (K16, every candidate in one launch) and RANSAC
  (K7, soft-PROSAC draws) for every candidate, the acceptance gates, the
  new node, its odometry edge, the ICP laser edge (K18) and the candidate
  edges (both entered invalid, for the epoch's filter to validate), and
  the node's bank rows.  It reads no device value on the host.
- ``optimize_epoch`` filters the loop closures (K5-K8), solves (K1-K4, K9,
  K10), refreshes uncertainty and the map→odom correction; it reads one
  device value on the host (``solver._host_decision``, whether the
  odometry restart runs its second solve).  ``project_map`` projects the
  scans into the live occupancy grid (K11), reading nothing on the host.
- ``Slam`` is the imperative shell: the host keyframe gate, capacity
  growth, the epoch schedule, live retuning of the gates.

``SlamState`` holds the JAX ``SlamState``'s fields for this configuration,
with a ``torch.Generator`` (the RANSAC draws) where JAX keeps a ``prng``
key, and the gates as host floats (``config.Tunables``).  Options of the
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
from uzliti_slam_tpu_torch.config import (UNPORTED_GATES, KeyframeConfig, SlamConfig, Tunables,
                                          tunables_from_config)
from uzliti_slam_tpu_torch.frontend import camera as cam_mod
from uzliti_slam_tpu_torch.graph import filter as gfilter
from uzliti_slam_tpu_torch.graph import lifecycle, shortest_path, solver
from uzliti_slam_tpu_torch.graph import state as gstate
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.mapping import occupancy
from uzliti_slam_tpu_torch.ops import depth as depth_ops
from uzliti_slam_tpu_torch.ops import features, icp, lie, matching, ransac
from uzliti_slam_tpu_torch.ops import scan as scan_ops
from uzliti_slam_tpu_torch.recognition import recognizer as rec

MAX_CANDIDATES = 256


@dataclasses.dataclass
class SlamState:
    graph: gstate.GraphState
    generator: torch.Generator   # RANSAC draws, on the graph's device
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

    def replace(self, **changes) -> "SlamState":
        return dataclasses.replace(self, **changes)


def init_state(config: SlamConfig = SlamConfig(), seed: int = 0, device=None) -> SlamState:
    """An empty state of the configured capacities (no scans: +inf ranges),
    the gates from ``config`` and a generator seeded with ``seed``, on
    ``device`` (default: the CUDA card)."""
    device = _device.resolve(device)
    n, f = config.node_capacity, config.feats_per_node
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
    )


def state_from_numpy(arrays: dict, seed: int = 0, device=None,
                     config: SlamConfig | None = None) -> SlamState:
    """A SlamState from numpy arrays, the fields of a JAX ``SlamState``:
    ``arrays["graph"]`` holds the graph's fields as ``graph.state.from_numpy``
    takes them; ``scans``, ``scan_valid``, ``desc``, ``desc_valid``,
    ``points``, ``last_kf_odom``, ``n_keyframes``, ``last_kf_slot``,
    ``gist`` (a dict of ``desc``, ``stamp``, ``valid``) and ``tunables`` (a
    dict of gate values) are taken where present, else made as
    ``init_state(config)`` makes them for the graph's node capacity.  A JAX
    ``prng`` key cannot cross: the generator is seeded with ``seed``."""
    device = _device.resolve(device)
    config = config or SlamConfig()
    graph = gstate.from_numpy({k: np.asarray(v) for k, v in arrays["graph"].items()}, device)
    base = init_state(dataclasses.replace(config, node_capacity=graph.node_capacity,
                                          edge_capacity=graph.edge_capacity), seed, device)

    def cross(x, like: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(np.array(x, dtype=like.cpu().numpy().dtype)).to(device)

    def take(name: str, like: torch.Tensor) -> torch.Tensor:
        return cross(arrays[name], like) if name in arrays else like

    gist = arrays.get("gist", {})
    # the reference's gates of unported paths have no place here
    tunables = (Tunables(**{k: float(np.float32(v)) for k, v in arrays["tunables"].items()
                            if k not in UNPORTED_GATES})
                if "tunables" in arrays else base.tunables)
    return base.replace(
        graph=graph, scans=take("scans", base.scans), scan_valid=take("scan_valid", base.scan_valid),
        gist=rec.GistBank(*(cross(gist[k], getattr(base.gist, k)) if k in gist
                            else getattr(base.gist, k) for k in rec.GistBank._fields)),
        desc=take("desc", base.desc), desc_valid=take("desc_valid", base.desc_valid),
        points=take("points", base.points), last_kf_odom=take("last_kf_odom", base.last_kf_odom),
        n_keyframes=take("n_keyframes", base.n_keyframes),
        last_kf_slot=take("last_kf_slot", base.last_kf_slot), tunables=tunables)


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
    The "sift" family is not ported: it raises ``NotImplementedError``.
    """
    fc = config.frontend
    if fc.descriptor == "sift":
        raise NotImplementedError("the 'sift' descriptor family is not ported "
                                  "(ROADMAP.md A25, B20)")
    tn = tunables if tunables is not None else tunables_from_config(config)
    if device is None and isinstance(image, torch.Tensor):
        device = image.device
    device = _device.resolve(device)
    imgs = _as_tensor(image, device)
    deps = _as_tensor(depth, device)
    poses = _as_tensor(cam_pose, device).to(torch.float32)
    imgs = (imgs if imgs.dim() == 3 else imgs[None]).to(torch.float32)
    deps = _depth_metres(deps if deps.dim() == 3 else deps[None], config.depth_scale)
    poses = poses if poses.dim() == 2 else poses[None]
    n_cams, H, W = imgs.shape
    k_per_cam = config.feats_per_node // n_cams
    if k_per_cam * n_cams != config.feats_per_node:
        raise ValueError(f"feats_per_node budget {config.feats_per_node} not divisible by "
                         f"{n_cams} cameras")
    if fc.rectify:
        imgs = cam_mod.rectify_image(cam, imgs)
        deps = cam_mod.rectify_image(cam, deps, nearest=True)
    if fc.use_depth_refinement:
        deps = depth_ops.joint_bilateral_filter(deps, imgs)

    kps, desc = features.detect_and_describe(
        imgs, max_keypoints=k_per_cam, threshold=tn.fast_threshold, grid=fc.grid,
        n_levels=fc.pyramid_levels, scale_factor=fc.scale_factor, descriptor=fc.descriptor)
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

    gist = features.binary_gist(imgs[0], roll_angle=lie.roll_of(lie.pose_q(poses[0])))
    return FrontendOutput(desc=desc.reshape(-1, 32), pts_base=pts_base.reshape(-1, 3),
                          pts_valid=pts_valid.reshape(-1), uv=kps.uv, kp_valid=kps.valid,
                          scan=merged, gist=gist)


# ---------------------------------------------------------------------------
# The keyframe step
# ---------------------------------------------------------------------------

def check_supported(config: SlamConfig) -> None:
    """Raise ``NotImplementedError`` for an option whose path the port does
    not have yet, naming the ROADMAP.md item that brings it."""
    if config.recognition.method != "gist":
        raise NotImplementedError(f"recognition.method={config.recognition.method!r}: only "
                                  "'gist' is ported (ROADMAP.md A24)")
    if config.estimation.method != "feature":
        raise NotImplementedError(f"estimation.method={config.estimation.method!r}: only "
                                  "'feature' is ported (ROADMAP.md A25)")


def _scan_pts(ranges: torch.Tensor):
    """2-D points and validity of a stored scan (near ranges over
    [-π, π), the bounds as the reference's float32 constants)."""
    pi = float(np.float32(np.pi))
    return scan_ops.scan_points(scan_ops.Scan(ranges, ranges, -pi, pi))


def process_keyframe(state: SlamState, image, depth, odom_pose, stamp,
                     cam: cam_mod.PinholeCamera, cam_pose, config: SlamConfig = SlamConfig(),
                     cam_disp=None, tri: torch.Tensor | None = None) -> tuple[SlamState, dict]:
    """Ingest one keyframe (``_keyframe_body``, ``pipeline.py:159-623`` of
    the JAX package, default configuration) on the state's device.

    ``image``/``depth``/``cam_pose`` as ``keyframe_frontend`` takes them;
    ``odom_pose`` (7,) the base's odometry pose; ``stamp`` seconds (a
    number or a () tensor); ``cam_disp`` (C, 7) optional per-camera
    capture displacement, composed onto the extrinsics.  ``tri`` (2·k,
    ``ransac_hypotheses``, 3) injects the RANSAC triplets of the 2·k
    candidates; without it they are drawn from ``state.generator``.
    Returns the new state (functional: ``state``'s tensors are not
    modified; the generator advances) and ``info``: ``new_slot``,
    ``n_candidates``, ``n_edges_proposed``, ``n_features`` as device
    tensors.  Reads no device value on the host.
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

    # candidates before inserting the node: the GIST query and the distance
    # loop closures (nearest valid nodes within the radius, heading within
    # the angle, temporally separated)
    k = rc.k_candidates
    pr_slots, _, pr_ok = rec.gist_query(state.gist, fe.gist, st, k=k, max_dist=tn.gist_max_dist,
                                        min_dt=tn.min_time_separation)
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

    # registration of every candidate: Hamming 2-NN + ratio test (K16, one
    # launch), then RANSAC with soft-PROSAC draws (K7); gated afterwards
    cs = torch.clamp(cand_slots, min=0)
    mi, ok_m, dist = matching.match_against_bank(fe.desc, fe.pts_valid, state.desc,
                                                 state.desc_valid, cs, tn.match_ratio,
                                                 tn.max_match_distance)
    F = fe.desc.shape[0]
    cpts = state.points.index_select(0, cs.long())
    dst = torch.gather(cpts, 1, mi.long()[..., None].expand(nb, F, 3))
    res = ransac.ransac_rigid_batch(
        fe.pts_base[None].expand(nb, F, 3), dst, ok_m, ec.ransac_hypotheses,
        tn.ransac_inlier_thresh, tn.min_consensus, tn.ransac_min_sigma, tri=tri,
        generator=state.generator, quality=-dist)
    r_score = res.consensus.to(torch.float32)
    t_norm = torch.linalg.vector_norm(lie.pose_t(res.pose), dim=-1)
    r_deg = torch.rad2deg(lie.rotation_angle(lie.pose_q(res.pose)))
    edge_ok = (cand_ok & res.ok & (r_score >= tn.min_matching_score)
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
        g, torch.cat(froms), new_slot.expand(n_fixed + nb), torch.cat(transforms + [res.pose]),
        torch.cat(infos + [res.information]), et,
        torch.cat([torch.zeros(n_fixed, device=dev), r_score]), valid)

    # the node's bank rows
    ns = torch.clamp(new_slot, min=0).long()
    wrote = new_slot >= 0
    state = state.replace(
        graph=g,
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
            "n_features": fe.pts_valid.sum()}
    return state, info


def grow_state(state: SlamState, node_capacity: int, edge_capacity: int) -> SlamState:
    """The graph and every per-node bank re-padded to the next capacity tier
    (``lifecycle.ensure_capacity``); a host-side step between keyframes."""
    g = lifecycle.ensure_capacity(state.graph, node_capacity, edge_capacity)
    new_n, old_n = g.node_capacity, state.desc.shape[0]
    if new_n == old_n:
        return state.replace(graph=g)

    def pad(a: torch.Tensor, fill=0) -> torch.Tensor:
        return torch.cat([a, a.new_full((new_n - old_n,) + tuple(a.shape[1:]), fill)])

    return state.replace(
        graph=g, gist=rec.GistBank(*(pad(x) for x in state.gist)), desc=pad(state.desc),
        desc_valid=pad(state.desc_valid), points=pad(state.points),
        scans=pad(state.scans, math.inf), scan_valid=pad(state.scan_valid))


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
    and the keyframe step reads nothing back."""

    def __init__(self, config: SlamConfig = SlamConfig(), cam=None, cam_pose=None, seed: int = 0,
                 device=None):
        check_supported(config)
        if config.calibrate_every > 0:
            raise NotImplementedError("calibrate_every > 0: odometry calibration is not ported "
                                      "(ROADMAP.md A23)")
        if config.sync_to_database:
            raise NotImplementedError("sync_to_database: the graph database is not ported "
                                      "(ROADMAP.md A27)")
        self.device = _device.resolve(device)
        self.config = config
        self.cam = cam or cam_mod.default_kinect()
        self.cam_pose = (lie.pose_identity((), self.device) if cam_pose is None
                         else _as_tensor(cam_pose, self.device).to(torch.float32))
        self.state = init_state(config, seed, self.device)
        self.grid: occupancy.OccupancyGrid | None = None
        self.optimize_every = 10
        self.auto_grow = True
        self._since_opt = 0
        self._last_kf_odom_host = _host_pose(lie.pose_identity((), "cpu"))
        self._n_kf_host = 0
        # the node-slot high-water mark, as the host counts it: what gates growth
        self._n_slots_host = 0

    def add_frame(self, image, depth, odom_pose, stamp, cam_disp=None) -> dict | None:
        """Process a frame if it is keyframe-due; returns the step's info
        (device tensors: reading them synchronises) or None."""
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
                                            self.cam_pose, self.config, cam_disp)
        self._last_kf_odom_host = odom
        self._n_kf_host += 1
        self._n_slots_host += 1
        self._since_opt += 1
        if self._since_opt >= self.optimize_every:
            self.optimize()
        return info

    def optimize(self) -> solver.SolveStats:
        """The optimization tick: ``optimize_epoch``, then the projection
        into the live grid when ``config.project_map``."""
        self.state, stats = optimize_epoch(self.state, self.config)
        self._since_opt = 0
        if self.config.project_map:
            self.project_map()
        return stats

    def set_param(self, name: str, value: float) -> None:
        """Retune a gate of ``config.Tunables`` (rounded to float32), or a
        keyframe-gate field of ``config.keyframe``, for the next frames.
        A gate of the reference's whose path is not ported raises
        ``NotImplementedError``."""
        if name in UNPORTED_GATES:
            raise NotImplementedError(f"{name}: its path is not ported "
                                      f"(ROADMAP.md {UNPORTED_GATES[name]})")
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
