"""The optimization tick (loop-closure filter, solve, uncertainty, map)
and the keyframe front-end.

PyTorch counterpart of what ``uzliti_slam_tpu/pipeline.py:Slam.optimize``
runs at every optimization timer tick of a live robot: ``optimize_epoch``,
then ``project_map`` into the live occupancy grid (the reference's default,
``SlamConfig.project_map=True``; the port keeps that field for parity with
the reference's config, nothing here reads it, and the caller decides
whether to call ``project_map``).  ``SlamState`` holds the fields these
read: the graph, the nodes' virtual scans and, where the JAX package keeps
a ``prng`` key, a ``torch.Generator`` on the graph's device (the RANSAC
draws).  The rest of the JAX ``SlamState`` (descriptors, recognition
banks, keyframe bookkeeping) and the ``Slam`` shell belong to the keyframe
slice, not ported yet; until then a caller runs ``optimize_epoch`` and
then ``project_map``, in the order ``Slam.optimize`` does.

On a CUDA device the epoch runs kernels K5 (graph distances), K6
(clusters), K7 (RANSAC), K8 (components and gauge) and the solve's K1-K4,
K9 and K10, and reads one device value on the host:
``solver._host_decision``, whether the odometry restart runs its second
solve.  The projection runs K11 and reads nothing on the host.

``keyframe_frontend`` is the per-camera front-end of the reference's
keyframe step (``_keyframe_body`` before its candidate search): features
and descriptors (K12 FAST + NMS, K13 grid top-k, K14 orientation and
descriptors), the keypoints' base-frame points, the virtual scan (K15) and
the binary GIST (K14 again).  It reads nothing on the host.  The rest of
the keyframe step (matching, recognition, ICP, graph insertion) comes
with a later slice.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from uzliti_slam_tpu_torch import _device
from uzliti_slam_tpu_torch.config import SlamConfig
from uzliti_slam_tpu_torch.frontend import camera as cam_mod
from uzliti_slam_tpu_torch.graph import filter as gfilter
from uzliti_slam_tpu_torch.graph import shortest_path, solver
from uzliti_slam_tpu_torch.graph import state as gstate
from uzliti_slam_tpu_torch.mapping import occupancy
from uzliti_slam_tpu_torch.ops import features, lie
from uzliti_slam_tpu_torch.ops import scan as scan_ops

MAX_CANDIDATES = 256


@dataclasses.dataclass
class SlamState:
    graph: gstate.GraphState
    generator: torch.Generator   # RANSAC draws, on the graph's device
    scans: torch.Tensor          # (N, scan_bins) float32 virtual-scan near ranges
    scan_valid: torch.Tensor     # (N,) bool: the node has a scan

    def replace(self, **changes) -> "SlamState":
        return dataclasses.replace(self, **changes)


def init_state(config: SlamConfig = SlamConfig(), seed: int = 0, device=None) -> SlamState:
    """An empty graph of the configured capacities, no scans (+inf ranges)
    and a generator seeded with ``seed``, on ``device`` (default: the CUDA
    card)."""
    device = _device.resolve(device)
    n = config.node_capacity
    return SlamState(
        graph=gstate.empty_graph(n, config.edge_capacity, device),
        generator=torch.Generator(device=device).manual_seed(seed),
        scans=torch.full((n, config.scan_bins), torch.inf, device=device),
        scan_valid=torch.zeros(n, dtype=torch.bool, device=device),
    )


def state_from_numpy(arrays: dict, seed: int = 0, device=None) -> SlamState:
    """A SlamState from numpy arrays: ``arrays["graph"]`` holds the graph's
    fields as ``graph.state.from_numpy`` takes them (e.g. from a JAX
    ``SlamState``), and ``arrays["scans"]`` / ``arrays["scan_valid"]``, where
    present, the nodes' scans (else +inf ranges of the default
    ``SlamConfig.scan_bins`` bins, none valid); other entries belong to
    slices not ported yet and are ignored.
    A JAX ``prng`` key cannot cross: the generator is seeded with ``seed``."""
    device = _device.resolve(device)
    graph = gstate.from_numpy({k: np.asarray(v) for k, v in arrays["graph"].items()}, device)
    n = graph.node_capacity
    scans = np.asarray(arrays.get("scans", np.full((n, SlamConfig.scan_bins), np.inf)),
                       np.float32)
    scan_valid = np.asarray(arrays.get("scan_valid", np.zeros(n, bool)), bool)
    return SlamState(graph=graph, generator=torch.Generator(device=device).manual_seed(seed),
                     scans=torch.from_numpy(scans).to(device),
                     scan_valid=torch.from_numpy(scan_valid).to(device))


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
        x = np.asarray(x)
        x = torch.from_numpy(np.ascontiguousarray(x.view(np.int16) if x.dtype == np.uint16 else x))
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
                      config: SlamConfig = SlamConfig(), device=None) -> FrontendOutput:
    """The per-camera front-end of one keyframe (``_keyframe_body``,
    ``pipeline.py:187-302`` of the JAX package, before the candidate
    search).

    ``image``: (H, W) or (C, H, W) uint8 or float; ``depth``: the same
    shape, uint16 in sensor units (× ``config.depth_scale``) or float
    metres; ``cam_pose``: (7,) or (C, 7) camera-to-base extrinsics.  Numpy
    arrays or tensors; the work runs on ``device``, else on the device of
    a tensor ``image``, else on the CUDA card.  Each camera takes
    ``feats_per_node // C`` keypoints; the GIST is camera 0's, rolled by
    its extrinsic's roll.  Depth refinement (the bilateral filter) and the
    "sift" family are not ported: they raise ``NotImplementedError``.
    """
    fc = config.frontend
    if fc.use_depth_refinement:
        raise NotImplementedError(
            "use_depth_refinement=True needs the joint bilateral depth filter, which "
            "the port brings with the keyframe step (slice 5)")
    if fc.descriptor == "sift":
        raise NotImplementedError("the 'sift' descriptor family is not ported")
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

    kps, desc = features.detect_and_describe(
        imgs, max_keypoints=k_per_cam, threshold=fc.fast_threshold, grid=fc.grid,
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
