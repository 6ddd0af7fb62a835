"""Occupancy-grid projection as a gather-based inverse sensor model.

PyTorch counterpart of ``uzliti_slam_tpu/mapping/occupancy.py``: every
node's virtual scan becomes log-odds evidence on a size² grid.  Each cell,
for each projected node, looks up that node's range at its own bearing bin
in static centre-pinned tables (distance ``D``, bearing bin ``bin0``, ray
weight ``Wray = res·B / (2π·d)``), classifies itself free, occupied or
unknown, and the node terms are summed.  The per-(cell, node) work is the
hand-written kernel K11 (``kernels/ops.project_rays``), which also marks the
node footprints (``_mark_node_cells``) in the same pass; the TPU's one-hot
matmul form of the same lookup is not carried over.

``project`` picks a full rebuild or an incremental pass on the device (the
reference's ``lax.cond``): the base grid, the origin and the set of nodes
are selected with ``torch.where``, the nodes are compacted on the device
with a cumsum and a scatter, and K11 runs once over them, so an incremental
call costs its new nodes and nothing is read on the host.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from uzliti_slam_tpu_torch.graph.state import GraphState
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Same fields and defaults as ``uzliti_slam_tpu.mapping.occupancy.GridConfig``."""

    resolution: float = 0.05     # m/cell (slam.yaml:17-19)
    size: int = 256              # cells per side
    max_range: float = 6.0       # slam.yaml:42-43
    hit_logodds: float = 0.85
    miss_logodds: float = -0.4
    clamp: float = 10.0
    drift_dist: float = 0.5      # full-rebuild trigger (graph_grid_mapper.cpp:305-308)
    drift_angle_deg: float = 5.0

    def __post_init__(self):
        # The reference silently drops evidence that lies beyond the grid's
        # half-width from a node (uzliti_slam_tpu/mapping/occupancy.py:116):
        # with a max_range past size·resolution/2 part of every scan would
        # vanish.  The port refuses such a grid instead.
        half = self.size * self.resolution / 2
        if self.max_range > half:
            raise ValueError(f"max_range {self.max_range} m exceeds the grid's half-width "
                             f"size·resolution/2 = {half} m: evidence beyond it is dropped")


class OccupancyGrid(NamedTuple):
    logodds: torch.Tensor         # (size, size)
    origin: torch.Tensor          # (2,) world coords of cell (0, 0)
    last_projected: torch.Tensor  # () int32 — nodes [0, last) already projected
    ref_poses: torch.Tensor       # (N, 7) node poses at last projection (drift check)


def grid_init(g: GraphState, config: GridConfig = GridConfig()) -> OccupancyGrid:
    """An empty grid centred on the world origin, on the graph's device."""
    half = config.size * config.resolution / 2
    dev = g.device
    return OccupancyGrid(
        logodds=torch.zeros(config.size, config.size, device=dev),
        origin=torch.full((2,), -half, device=dev),
        last_projected=torch.zeros((), dtype=torch.int32, device=dev),
        ref_poses=lie.pose_identity((g.node_capacity,), dev),
    )


def auto_origin(g: GraphState, config: GridConfig) -> torch.Tensor:
    """Center the grid on the graph bounding box (``:535-573``)."""
    t = lie.pose_t(g.pose)[:, :2]
    big = 1e9
    mn = torch.where(g.node_valid[:, None], t, big).amin(dim=0)
    mx = torch.where(g.node_valid[:, None], t, -big).amax(dim=0)
    center = 0.5 * (mn + mx)
    half = config.size * config.resolution / 2
    return center - half


@functools.lru_cache(maxsize=8)
def center_tables(size: int, res: float, bins: int):
    """The static centre-pinned tables (D, bin0, Wray), each (size²,) and
    row-major (rows are y): built in float64 numpy exactly as the reference
    builds them (``occupancy.py:115-125``), then cast to float32 / int32."""
    c0 = size // 2
    off = (np.arange(size) - c0) * res
    dxs = np.broadcast_to(off[None, :], (size, size)).reshape(-1)
    dys = np.broadcast_to(off[:, None], (size, size)).reshape(-1)
    D = np.sqrt(dxs * dxs + dys * dys).astype(np.float32)
    bin0 = np.mod(
        np.floor((np.arctan2(dys, dxs) + np.pi) * (bins / (2 * np.pi))).astype(np.int64),
        bins,
    ).astype(np.int32)
    Wray = (res * bins / (2 * np.pi * np.maximum(D, res))).astype(np.float32)
    return D, bin0, Wray


_device_tables: dict = {}


def _tables_on(size: int, res: float, bins: int, device: torch.device) -> torch.Tensor:
    """``center_tables`` packed for K11 (``kops.pack_center_tables``: one
    16-byte row a cell) on ``device``, cached.  The copy to a CUDA device
    goes from pinned memory without a synchronisation."""
    key = (size, res, bins, device)
    if key not in _device_tables:
        host = torch.from_numpy(kops.pack_center_tables(*center_tables(size, res, bins)))
        if device.type == "cuda":
            pinned = host.pin_memory()
            # the pinned buffer is kept with the copy it feeds
            _device_tables[key] = (pinned.to(device, non_blocking=True), pinned)
        else:
            _device_tables[key] = (host, None)
    return _device_tables[key][0]


def _node_cells(poses: torch.Tensor, origin: torch.Tensor, res: float):
    """(cx, cy) int32: the cell containing each node, floor((p - origin)/res).

    Computed as (p - origin)·fl(1/res), which is what the reference's
    compiled division by the constant ``res`` evaluates (XLA rewrites it,
    and nodes on a cell edge land in other cells than a true division puts
    them), with the reciprocal an IEEE float32 division on every device."""
    t = lie.pose_t(poses)
    inv = 1.0 / torch.full_like(origin, res)
    cell = torch.floor((t[:, :2] - origin) * inv).to(torch.int32)
    return cell[:, 0].contiguous(), cell[:, 1].contiguous()


def _compact(mask: torch.Tensor):
    """(idx (N,) int32, count () int32): the slots where ``mask`` is set, in
    ascending order, then padding; by a cumsum and a scatter on the device."""
    n = mask.shape[0]
    m = mask.to(torch.int32)
    pos = torch.cumsum(m, dim=0, dtype=torch.int32) - 1
    dest = torch.where(mask, pos, n).long()
    slots = torch.arange(n, dtype=torch.int32, device=mask.device)
    idx = torch.zeros(n + 1, dtype=torch.int32, device=mask.device).scatter_(0, dest, slots)
    return idx[:n], m.sum(dtype=torch.int32)


def _rays_args(logodds: torch.Tensor, poses: torch.Tensor, scans: torch.Tensor,
               mask: torch.Tensor, origin: torch.Tensor, config: GridConfig,
               mark_nodes: bool) -> tuple:
    """The arguments ``kops.project_rays`` takes for these nodes: the node
    cells, bearing shifts (in [0, B)) and compacted node list, and the
    device table."""
    size, res = config.size, config.resolution
    bins = scans.shape[1]
    table = _tables_on(size, res, bins, logodds.device)
    yaw = lie.yaw_of(lie.pose_q(poses))
    cx, cy = _node_cells(poses, origin, res)
    kbin = torch.remainder(torch.round(yaw * (bins / (2 * math.pi))).to(torch.int32), bins)
    idx, count = _compact(mask)
    return (logodds, cx, cy, kbin, scans, idx, count, table, res, config.max_range,
            config.hit_logodds, config.miss_logodds, config.clamp, mark_nodes)


def _project_rays(logodds: torch.Tensor, poses: torch.Tensor, scans: torch.Tensor,
                  mask: torch.Tensor, origin: torch.Tensor, config: GridConfig,
                  mark_nodes: bool = False) -> torch.Tensor:
    """Accumulate the scan evidence of the nodes in ``mask`` into the grid
    and clip (kernel K11 on CUDA tensors); with ``mark_nodes``, also the
    footprint marks of ``_mark_node_cells``, in the same pass.

    Each node is snapped to its containing cell and its yaw to an integer
    number of bearing bins (``kbin = round(yaw·B/2π)``, half to even, taken
    mod B), as the reference does; a finite return within max_range marks its
    endpoint cell occupied, a finite return beyond it still carves free
    space up to max_range, and rays with no return (inf) carry nothing.
    """
    return kops.project_rays(*_rays_args(logodds, poses, scans, mask, origin, config,
                                         mark_nodes))


def _mark_node_cells(logodds, poses, mask, origin, config: GridConfig):
    """Robot footprint cells are known-free (``:330-344``): 2·miss per node
    of ``mask`` in its cell, then clip.  ``project`` does this inside K11."""
    cx, cy = _node_cells(poses, origin, config.resolution)
    return kops.mark_cells_plain(logodds, cx, cy, mask, 2.0 * config.miss_logodds, config.clamp)


def project(
    grid: OccupancyGrid,
    g: GraphState,
    scans: torch.Tensor,
    scan_valid: torch.Tensor,
    config: GridConfig = GridConfig(),
    force_full: bool = False,
) -> OccupancyGrid:
    """Project the graph's scans into the grid.

    Incremental: only nodes at slots ≥ ``last_projected`` inside the window
    of the 64 most recent slots are rendered, unless any already-projected
    node drifted more than the threshold since the last projection, more
    than 64 nodes are new, or ``force_full`` — then the whole map is rebuilt
    from scratch (``occupancy_grid_projector.cpp:52-76``), recentred on the
    graph bounding box.  The choice is made on the device; K11 runs once
    over the chosen nodes.
    """
    full, mask, origin, base = _select(grid, g, scan_valid, config, force_full)
    lo = _project_rays(base, g.pose, scans, mask, origin, config, mark_nodes=True)

    slots = torch.arange(g.node_capacity, dtype=torch.int32, device=g.device)
    last = torch.maximum(grid.last_projected, g.num_nodes)
    return OccupancyGrid(
        logodds=lo,
        origin=origin,
        last_projected=last,
        # snapshot poses of everything projected so far for the drift check
        ref_poses=torch.where(((slots < last) & g.node_valid)[:, None] | full,
                              g.pose, grid.ref_poses),
    )


def _select(grid: OccupancyGrid, g: GraphState, scan_valid: torch.Tensor, config: GridConfig,
            force_full: bool):
    """``project``'s branch, on the device: (full () bool, the node mask
    (N,), the origin (2,), the base log-odds)."""
    n = g.node_capacity
    slots = torch.arange(n, dtype=torch.int32, device=g.device)
    dt, dr = lie.pose_distance(g.pose, grid.ref_poses)
    already = (slots < grid.last_projected) & g.node_valid
    drifted = torch.any(
        already
        & ((dt > config.drift_dist) | (torch.rad2deg(dr) > config.drift_angle_deg))
    )
    window = min(64, n)
    full = drifted | force_full | (g.num_nodes - grid.last_projected > window)

    live = g.node_valid & scan_valid
    start = torch.clamp(g.num_nodes - window, 0, n - window)
    in_window = (slots >= start) & (slots < start + window) & (slots >= grid.last_projected)
    mask = torch.where(full, live, live & in_window)
    origin = torch.where(full, auto_origin(g, config), grid.origin)
    base = torch.where(full, torch.zeros_like(grid.logodds), grid.logodds)
    return full, mask, origin, base


def occupancy_probability(grid: OccupancyGrid) -> torch.Tensor:
    """Log-odds -> probability map in [0, 1]; 0.5 = unknown."""
    return torch.sigmoid(grid.logodds)


def to_ternary(grid: OccupancyGrid, occ_thresh: float = 0.65, free_thresh: float = 0.35):
    """ROS-style -1/0/100 occupancy classes (int32)."""
    p = occupancy_probability(grid)
    unknown = torch.abs(grid.logodds) < 1e-6
    neg = torch.full_like(grid.logodds, -1, dtype=torch.int32)
    return torch.where(unknown, neg, torch.where(
        p > occ_thresh, 100, torch.where(p < free_thresh, 0, neg)))
