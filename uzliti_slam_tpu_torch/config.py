"""The port's configuration: what the optimization tick and the keyframe
front-end read.

Counterpart of ``uzliti_slam_tpu/config.py`` with the same names and
defaults.  ``SlamConfig`` carries only the fields that
``pipeline.optimize_epoch``, ``pipeline.project_map`` and
``pipeline.keyframe_frontend`` read (capacities, the feature budget, the
front-end, the depth units, the scan bins, the solver, the loop-closure
filter, the scope's heuristic factor, the occupancy grid), and
``project_map``, the reference's switch for the projection after an
epoch, kept for parity: the port has no ``Slam`` shell yet, so nothing
reads it and the caller decides.  The front-end's FAST threshold is
``frontend.fast_threshold`` (the reference reads it from its live
``Tunables``, which come with the keyframe step).  The fields of the
slices not ported yet (recognition, estimation, keyframing, database sync,
odometry calibration, the instance id) wait for those slices.
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
class FeatureExtractionConfig:
    """Same fields and defaults as
    ``uzliti_slam_tpu.config.FeatureExtractionConfig`` (the reference's
    FeatureExtraction.cfg): budget, FAST threshold, pyramid, grid, depth
    refinement, descriptor family ("brief" | "brisk" | "freak"; "sift" is
    not ported) and rectification."""

    max_keypoints: int = 300
    fast_threshold: float = 20.0
    pyramid_levels: int = 4
    scale_factor: float = 1.2
    grid: int = 4
    use_depth_refinement: bool = True
    descriptor: str = "brief"
    rectify: bool = False


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    node_capacity: int = 512
    edge_capacity: int = 2048
    feats_per_node: int = 128
    scan_bins: int = 360
    frontend: FeatureExtractionConfig = FeatureExtractionConfig()
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
    # metres per unit of integer depth inputs (uint16 wire format):
    # 0.001 = millimetres (Kinect)
    depth_scale: float = 1e-3
