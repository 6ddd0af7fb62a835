"""The port's configuration: what the optimization tick reads.

Counterpart of ``uzliti_slam_tpu/config.py`` with the same names and
defaults.  ``SlamConfig`` carries only the fields that
``pipeline.optimize_epoch`` and ``pipeline.project_map`` read (capacities,
the scan bins, the solver, the loop-closure filter, the scope's heuristic
factor, the occupancy grid), and ``project_map``, the reference's switch
for the projection after an epoch, kept for parity: the port has no
``Slam`` shell yet, so nothing reads it and the caller decides.  The
fields of the slices not ported yet (front-end, recognition, estimation,
keyframing, database sync, odometry calibration, depth units, the
instance id) wait for those slices.
"""

from __future__ import annotations

import dataclasses

from uzliti_slam_tpu_torch.graph.filter import FilterConfig
from uzliti_slam_tpu_torch.graph.solver import SolverConfig
from uzliti_slam_tpu_torch.mapping.occupancy import GridConfig


@dataclasses.dataclass(frozen=True)
class ScopeConfig:
    """Same fields and defaults as ``uzliti_slam_tpu.config.ScopeConfig``;
    the epoch reads ``scope_size_factor`` (the edge heuristic's scale)."""

    is_sub_graph: bool = False
    scope_size_min: float = 8.0
    scope_size_factor: float = 0.1
    eviction_margin: float = 4.0
    merge_nodes: bool = False
    merge_dist: float = 0.25
    merge_angle_deg: float = 15.0
    merge_margin: float = 6.0


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    node_capacity: int = 512
    edge_capacity: int = 2048
    scan_bins: int = 360
    # the live solver: multi-start from the odometry prior, chain-PCG with
    # 12 steps, factor refreshed every 5 accepted steps, early exit
    solver: SolverConfig = SolverConfig(
        odometry_restart=True, preconditioner="chain",
        pcg_iterations=12, precond_refresh=5,
    )
    filter: FilterConfig = FilterConfig()
    scope: ScopeConfig = ScopeConfig()
    # the occupancy grid projected after every optimization epoch
    grid: GridConfig = GridConfig()
    project_map: bool = True
