"""The port's configuration: what the keyframe step, the optimization
tick and the ``Slam`` shell read.

Counterpart of ``uzliti_slam_tpu/config.py`` with the same names and
defaults for the ported paths: every place recognizer ("gist",
"feature_set", "repository", "bow") and every registration estimator
("feature", "gicp", "pnp").  The switch of an unported path
(``sync_to_database``) is kept, and ``pipeline.Slam`` raises
``NotImplementedError`` for it.

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
    """Same fields and defaults as ``uzliti_slam_tpu.config.ScopeConfig``:
    the role of ``pipeline.maintenance_epoch`` (``merge_nodes``, the global
    role; ``is_sub_graph``, the local role's eviction), its gates, and the
    epoch's edge heuristic scale (``scope_size_factor``)."""

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
    refinement, descriptor family ("brief" | "brisk" | "freak"; "sift" has
    no keyframe path, as in the reference: ``pipeline.keyframe_frontend``
    raises) and rectification.  The FAST threshold the front-end uses
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
    """Same fields and defaults as
    ``uzliti_slam_tpu.config.PlaceRecognitionConfig``: the method ("gist" |
    "feature_set" | "repository" | "bow"), the candidate count, and each
    method's gates and capacities.  The gates the keyframe step reads are
    ``Tunables``' copies of these."""

    method: str = "gist"
    k_candidates: int = 5
    gist_max_dist: float = 60.0
    feature_hamming_thresh: float = 40.0
    min_similarity: float = 0.2
    min_time_separation: float = 5.0
    # feature_set: a node is searched, and a frame queries, only with this
    # many valid descriptors
    min_descriptors: int = 64
    # repository: unique-descriptor capacity per node slot, links per
    # descriptor, votes a candidate needs
    repo_desc_per_node: int = 32
    repo_links_per_desc: int = 8
    repo_min_votes: int = 5
    # bow: vocabulary size and the L1 score a candidate needs
    bow_words: int = 256
    bow_min_score: float = 0.05


@dataclasses.dataclass(frozen=True)
class EdgeEstimationConfig:
    """Same fields and defaults as
    ``uzliti_slam_tpu.config.EdgeEstimationConfig``: the registration
    estimator ("feature" = Hamming match + 3-point RANSAC, "gicp" = dense
    colored 6-D ICP on voxel clouds, "pnp" = 2D-3D RANSAC), the ICP laser
    edges and the acceptance gates."""

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
    gicp_voxel: float = 0.05
    gicp_max_voxels: int = 256
    gicp_iterations: int = 20
    gicp_max_corr: float = 0.2
    pnp_hypotheses: int = 64
    pnp_reproj_px: float = 3.0


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
    """The live-retunable gates (``uzliti_slam_tpu.config.Tunables``), host
    floats rounded to float32."""

    fast_threshold: float
    gist_max_dist: float
    feature_hamming_thresh: float
    min_similarity: float
    min_time_separation: float
    min_descriptors: float
    repo_min_votes: float
    bow_min_score: float
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
    gicp_max_corr: float
    pnp_reproj_px: float

    def replace(self, **changes) -> "Tunables":
        return dataclasses.replace(self, **{k: f32(v) for k, v in changes.items()})


def f32(v) -> float:
    """``v`` rounded to float32, as a Python float."""
    return float(np.float32(v))


def tunables_from_config(cfg: "SlamConfig") -> Tunables:
    """The gates' initial values from the static config."""
    fc, rc, ec = cfg.frontend, cfg.recognition, cfg.estimation
    return Tunables(
        fast_threshold=f32(fc.fast_threshold),
        gist_max_dist=f32(rc.gist_max_dist),
        feature_hamming_thresh=f32(rc.feature_hamming_thresh),
        min_similarity=f32(rc.min_similarity),
        min_time_separation=f32(rc.min_time_separation),
        min_descriptors=f32(rc.min_descriptors),
        repo_min_votes=f32(rc.repo_min_votes),
        bow_min_score=f32(rc.bow_min_score),
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
        gicp_max_corr=f32(ec.gicp_max_corr),
        pnp_reproj_px=f32(ec.pnp_reproj_px),
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
    # odometry-drift calibration (Slam.calibrate) every N optimization
    # epochs; 0 = never
    calibrate_every: int = 0
    # metres per unit of integer depth inputs (uint16 wire format):
    # 0.001 = millimetres (Kinect)
    depth_scale: float = 1e-3
