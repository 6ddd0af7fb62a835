"""The port's configuration: what the keyframe step, the optimization
tick and the ``Slam`` shell read.

Counterpart of ``uzliti_slam_tpu/config.py`` with the same names and
defaults, less the knobs of paths the port does not have: the other
recognizers' (repository, BoW, feature sets; ROADMAP.md A24) and
estimators' (GICP, PnP; A25), which come with those paths.  The switches
that select such a path (``recognition.method``, ``estimation.method``,
``calibrate_every``, ``sync_to_database``) are kept, and ``pipeline.Slam``
raises ``NotImplementedError`` for their unported values.

The numeric gates live in ``Tunables``, as in the reference, which keeps
them as float32 device scalars so that ``Slam.set_param`` retunes them
without recompiling.  PyTorch recompiles nothing, so here they are host
floats, each rounded to float32 as the reference's are: a threshold then
compares as the reference's does (``fl32(0.9)·second``,
``fl32(fl32(0.05)²)``), and a kernel wrapper passes it as a scalar
without reading the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

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
    not ported) and rectification.  The FAST threshold the front-end uses
    is ``Tunables.fast_threshold``, initialised from this one."""

    max_keypoints: int = 300
    fast_threshold: float = 20.0
    pyramid_levels: int = 4
    scale_factor: float = 1.2
    grid: int = 4
    use_depth_refinement: bool = True
    descriptor: str = "brief"
    rectify: bool = False


@dataclasses.dataclass(frozen=True)
class PlaceRecognitionConfig:
    """The fields of ``uzliti_slam_tpu.config.PlaceRecognitionConfig`` that
    ``method="gist"`` reads, with the same defaults."""

    method: str = "gist"
    k_candidates: int = 5
    gist_max_dist: float = 60.0
    min_time_separation: float = 5.0


@dataclasses.dataclass(frozen=True)
class EdgeEstimationConfig:
    """The fields of ``uzliti_slam_tpu.config.EdgeEstimationConfig`` that
    ``method="feature"`` (Hamming match + RANSAC) and the ICP laser edges
    read, with the same defaults."""

    method: str = "feature"
    ransac_hypotheses: int = 128
    ransac_inlier_thresh: float = 0.05
    ransac_min_sigma: float = 0.01
    min_consensus: int = 12
    match_ratio: float = 0.9
    max_match_distance: float = 64.0
    icp_iterations: int = 20
    icp_max_corr: float = 0.5
    icp_min_valid_fraction: float = 0.25
    min_matching_score: float = 10.0
    max_edge_translation: float = 2.0
    max_edge_rotation_deg: float = 60.0


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Same fields and defaults as ``uzliti_slam_tpu.config.KeyframeConfig``:
    the host keyframe gate and the distance loop closures."""

    new_node_distance: float = 0.3
    new_node_angle_deg: float = 10.0
    distance_closure_radius: float = 2.0
    distance_closure_max_angle_deg: float = 30.0


@dataclasses.dataclass(frozen=True)
class Tunables:
    """The live-retunable gates of the ported paths
    (``uzliti_slam_tpu.config.Tunables`` less ``UNPORTED_GATES``), host
    floats rounded to float32."""

    fast_threshold: float
    gist_max_dist: float
    min_time_separation: float
    match_ratio: float
    max_match_distance: float
    ransac_inlier_thresh: float
    ransac_min_sigma: float
    min_consensus: float
    min_matching_score: float
    max_edge_translation: float
    max_edge_rotation_deg: float
    icp_max_corr: float
    icp_min_valid_fraction: float

    def replace(self, **changes) -> "Tunables":
        return dataclasses.replace(self, **{k: f32(v) for k, v in changes.items()})


# the reference's gates whose paths are not ported, and the ROADMAP.md
# item that brings each
UNPORTED_GATES = {
    **dict.fromkeys(("feature_hamming_thresh", "min_similarity", "min_descriptors",
                     "repo_min_votes", "bow_min_score"), "A24"),
    **dict.fromkeys(("gicp_max_corr", "pnp_reproj_px"), "A25"),
}


def f32(v) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


def tunables_from_config(cfg: "SlamConfig") -> Tunables:
    """The gates' initial values from the static config."""
    fc, rc, ec = cfg.frontend, cfg.recognition, cfg.estimation
    return Tunables(
        fast_threshold=f32(fc.fast_threshold),
        gist_max_dist=f32(rc.gist_max_dist),
        min_time_separation=f32(rc.min_time_separation),
        match_ratio=f32(ec.match_ratio),
        max_match_distance=f32(ec.max_match_distance),
        ransac_inlier_thresh=f32(ec.ransac_inlier_thresh),
        ransac_min_sigma=f32(ec.ransac_min_sigma),
        min_consensus=f32(ec.min_consensus),
        min_matching_score=f32(ec.min_matching_score),
        max_edge_translation=f32(ec.max_edge_translation),
        max_edge_rotation_deg=f32(ec.max_edge_rotation_deg),
        icp_max_corr=f32(ec.icp_max_corr),
        icp_min_valid_fraction=f32(ec.icp_min_valid_fraction),
    )


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    instance_id: int = 0            # namespaces node uids across instances
    node_capacity: int = 512
    edge_capacity: int = 2048
    feats_per_node: int = 128
    scan_bins: int = 360
    frontend: FeatureExtractionConfig = FeatureExtractionConfig()
    recognition: PlaceRecognitionConfig = PlaceRecognitionConfig()
    estimation: EdgeEstimationConfig = EdgeEstimationConfig()
    # the live solver: multi-start from the odometry prior, chain-PCG with
    # 12 steps, factor refreshed every 5 accepted steps, early exit
    solver: SolverConfig = SolverConfig(
        odometry_restart=True, preconditioner="chain",
        pcg_iterations=12, precond_refresh=5,
    )
    filter: FilterConfig = FilterConfig()
    scope: ScopeConfig = ScopeConfig()
    keyframe: KeyframeConfig = KeyframeConfig()
    use_laser_edges: bool = True
    # the occupancy grid projected after every optimization epoch
    grid: GridConfig = GridConfig()
    project_map: bool = True
    # SQLite write-through of the reference (not ported: Slam raises)
    sync_to_database: str | None = None
    # odometry-drift calibration every N epochs (not ported: Slam raises)
    calibrate_every: int = 0
    # metres per unit of integer depth inputs (uint16 wire format):
    # 0.001 = millimetres (Kinect)
    depth_scale: float = 1e-3
