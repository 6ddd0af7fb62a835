#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one GPU: the pose-graph solve, the
optimization epoch, the occupancy projection that follows it, the keyframe
front-end, the keyframe step through the ``Slam`` shell, and an end-to-end
run judged by ATE.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (Hopper,
``sm_90a``) and ``nvcc``.  It builds the port's kernels from ``csrc/`` (one
``nvcc`` per source, all at once) into ``build/uzliti_slam_tpu_torch/`` and
runs, in order, each phase printing lines of its own:

1. the environment: torch and CUDA versions, nvcc, the card's name and
   power limit (nvidia-smi);
2. the kernels' build, timed, and the two epoch graphs;
3. each solve kernel (K1 linearize, K2 hvp, K3 chain_apply, K4
   residual_chi2, K9 chain_factor, K10 pcg) against its plain PyTorch
   version on the card, on the inputs the solve gives it on a generated
   1k-node and 100k-node graph, each epoch kernel (K5 relax_min, K6
   cluster_labels, K7 ransac_rigid, K8 components) on the inputs the
   500-node and 10k-node epochs give it, K8's grid route on the 100k-node
   solve's inputs, and K11 project_rays on a 500-node full rebuild, an
   8-new-node incremental pass and a 10k-node full rebuild, and the
   front-end's kernels (K12 fast_nms and K13 grid_topk on all four pyramid
   levels, K14 orb_describe on every level and the GIST, K15 scan_bins) on
   the arguments one VGA keyframe gives them, with one camera and with the
   front + rear rig, and the keyframe step's kernels (K16 hamming_top2, both
   entry points, K17 bilateral, K18 icp) on the arguments a late VGA
   keyframe step of phase 11 gives them: error against a stated tolerance,
   the median time of both, and the least time the card could take for the
   work this data needs;
4. the 1k-node headline solve (20 LM x 12 PCG, chain factor refreshed every
   5, fixed iteration count) through ``optimize``: launch counts of one
   solve, no host synchronisation inside the timed solves (CUDA sync debug
   mode "error"), final χ² against the same solve on CPU tensors and
   against the sparse oracle, median solve time, and a profile with no
   cuSOLVER or cuBLAS item;
5. the library default ``SolverConfig()`` (early exit) at 1k nodes against
   the oracle, with the factors K9 actually built against the refreshes
   the reference's loop makes, and a profile;
6. the headline configuration at 10k nodes against the oracle (LM);
7. the headline configuration at 100k nodes: time, finite χ² below χ²₀,
   K8 launched on its grid route;
8. the 500-node RGB-D + laser epoch (``pipeline.optimize_epoch`` with the
   live ``SlamConfig``): launch counts per kernel, the factors K9 built
   against the reference's refreshes, sync-free timed epochs except the
   one restart read, the planted bad laser edge rejected, laser
   edges validated, χ² and ATE against ground truth and odometry, and the
   same epoch on CPU tensors through the plain path with the same RANSAC
   draws; then ``pipeline.project_map`` on its result, as ``Slam.optimize``
   runs it: a full rebuild, an incremental pass after 8 nodes with scans
   are added and a rebuild after a node drifts 1 m, each sync-free, timed,
   and matched by the same sequence on CPU tensors;
9. the same epoch at 10k nodes, then one full ``project_map``: time,
   finite, χ² below χ²₀;
10. the keyframe front-end at VGA (``pipeline.keyframe_frontend``; the JAX
   bench's ``keyframe_vga`` and ``keyframe_vga_2cam`` rungs, 256 features,
   360 scan bins, depth refinement off), one camera and the front + rear
   rig: launch counts of one keyframe, ms per keyframe over 10 sync-free
   keyframes after 3 warm-up ones, a profile, valid keypoints, the scan on
   the wall, and the same frames on CPU tensors through the plain path;
11. the keyframe step in the default configuration (depth refinement, GIST
   recognition, matching + RANSAC, ICP laser edges) through
   ``Slam.add_frame`` on the same 13 frames with the JAX bench's
   ``_make_slam`` settings, one camera and the rig: ms per keyframe step
   over 10 sync-free steps after 3 warm-up ones, launches of K12-K18 and K7
   over them, a profile of one more step, candidates on the return leg
   and, with one camera, loop closures proposed and accepted there (the
   rig's rear camera is fed the front's frame, so the ratio test rejects
   its duplicate descriptors), and the same frames on CPU tensors through
   the plain path with the card's RANSAC draws (the same graph);
12. the JAX bench's ATE rung (48 frames at 96x128, an epoch every 8
   keyframes) through ``Slam`` on the card with RANSAC draws from seeds
   0, 1 and 2: each ATE of SLAM below the raw odometry's and below 1.1x
   the JAX package's largest CPU result over seeds;
13. the maintenance and calibration timers: (a) ``maintenance_epoch`` in
   the global role on phase 8's 500-node state (scans and descriptors
   added, the robot 100 m away): 16 merges (K19, the merged scans re-binned
   by K15's ``bin_min_max``), sync-free and timed, the same on CPU tensors,
   consistent edges, an epoch after it; (b) K19 on phase 9's 10k-node
   state, its plain version's pairs exactly; (c) the bounded local scope of
   ``tests/test_lifecycle.py`` (520 frames at 96x128, ``Slam.maintain``
   every 20): one capacity tier, >= 3 compactions, <= 60 live nodes, no
   keyframe dropped, ms per maintain and per compacting maintain; (d)
   ``Slam.reregister_scans`` on phase 11's one-camera Slam (K18 once on a
   batch of 4, the same edges on CPU tensors); (e) ``Slam.calibrate`` on a
   1k-node biased-odometry graph (K20): the drift recovered within 2e-2,
   then the calibrated solve against the uncalibrated one and on CPU
   tensors.  Phase 3 holds K19 and ``bin_min_max`` (exactly) and K20 (θ
   within 1e-4) against their plain versions on the arguments those paths
   give them;
14. the other place recognizers: (c) the keyframe step of phase 11 (VGA, 1
   camera, the same frames and settings) with ``recognition.method``
   "feature_set" (K21), "repository" (K22) and "bow" (K23 + K24, after a
   256-word vocabulary is built on the card from the sequence's
   descriptors with K23): ms per step, launches, a profile, sync-free steps
   and the same graph on CPU tensors; (a) K21-K24 against their plain
   versions on a late step's arguments (and the vocabulary build's last
   round) and at the large shapes (10k nodes, D = 320k, 100k descriptors):
   K21-K23 exactly, K24's scores within 1e-6; (b) each recognizer's
   kernels per query on banks of 1k, 10k and 50k nodes, with the bank's
   bytes; (d) tests/test_pr_methods.py's 30-frame 96x128 run per method on
   the card: at least 3 proposed edges each;
15. the other registration estimators: (b) the keyframe step of phase 11
   with ``estimation.method`` "pnp" (K16 on camera 0's keypoints, K28) and
   "gicp" (K25-K27), and "gicp" on the front + rear rig: ms per step,
   launches, a profile with no cuSOLVER item, sync-free steps and the same
   graph on CPU tensors with the draws each card step reports replayed
   (``Slam.add_frame(pnp_keys=)``); (a) K25-K28 against their plain
   versions on a late step's arguments and at larger shapes (the rig's
   614,400 pixels into 1024 voxels, GICP on 1024-voxel clouds, PnP on 512
   non-planar correspondences with 256 draws): K25 and K28's draws, counts
   and ok exactly, K26 by |dot| on separated eigenvalues, K27's and K28's
   refined poses within 1e-4, K28's mse, and each family of its hypotheses
   (DLT, homography, Kabsch) by draw, the wall's coplanar DLT draws named
   by their null space (see PNP_HYP_MEDIAN); (c)
   tests/test_estimation_methods.py's 24-frame run per method on the card,
   held to its bars.

Then one JSON line with the kernels' results, the nvidia-smi line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed check raises,
and the exit code is not 0.  Without a CUDA device it exits with code 1
before doing anything.
"""

from __future__ import annotations

import json
import math
import re
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
HEADLINE = dict(iterations=20, pcg_iterations=12, preconditioner="chain",
                precond_refresh=5, early_exit=False)
# Solve-level χ² tolerance: summation order alone moves a converged χ² by
# 5.9e-5 relative JAX against JAX, 12-step PCG is not converged, and an LM
# accept test can turn on a near-tie, so 1e-3 relative plus 1e-6·χ²₀.
CHI2_RTOL = 1e-3
# Oracle bar of tests/test_solver.py: within 10% of "what g2o returns".
ORACLE_FACTOR, ORACLE_ATOL = 1.10, 1e-3
# Kernel against plain version, as max|kernel - plain| / max|plain|:
#  K1 1e-3 — the Jacobian's Q block takes (θ²/2 + cos θ - 1)/θ⁴ just above
#     its 1e-2 Taylor switch, where float32 keeps few bits, and scales it
#     by |ρ|; a different rounding order there moves Jⱼ by ~1e-4 of its
#     scale, then H = JᵀWJ and float atomics add their own;
#  K2, K3, K4 1e-4 — the same arithmetic summed in another order.
# K6 and K8 are held exactly (integer labels of exact compares); K5 to one
# ulp of a distance (minima of the same float sums); K7 by compare_ransac.
#  K9 1e-4 — each level tensor of the factor (the same closed-form 6x6
#     inverses and products in float64, multiplied in another order, then
#     stored in float32); its root is a block LDLᵀ inverse where the plain
#     version takes LU, so the root is held through what the solve uses: the
#     apply on a fixed right-hand side within CHAIN_APPLY_RTOL;
#  K10 1e-4 of max|x| after a 12-step PCG — dots summed in another order —
#     and the same stall flag at every step.
# K11 log-odds: within PROJECT_ATOL at 500 nodes; at 10k nodes within
# PROJECT_SUM_RTOL·S + PROJECT_ATOL_LARGE, S the cell's sum of |node terms|
# (free and hit terms of many nodes cancel, and the two sum them in
# another order); ternary classes equal except within TERNARY_NEAR of a
# threshold.
KERNEL_TOL = {"linearize": 1e-3, "hvp": 1e-4, "chain_apply": 1e-4, "residual_chi2": 1e-4,
              "chain_factor": 1e-4, "pcg": 1e-4}
CHAIN_APPLY_RTOL = 1e-3
PROJECT_ATOL = 1e-4
PROJECT_SUM_RTOL, PROJECT_ATOL_LARGE = 2e-6, 1e-5
TERNARY_NEAR = 1e-4
RELAX_MAX_ULP = 1
RANSAC_POSE_ATOL = 1e-4      # refit pose, per component
RANSAC_NEAR_REL = 1e-5       # a point this close to the inlier radius may flip
# K12, K13 and K15 are held exactly (the same float operations in the same
# order; integer minima); K14's descriptors exactly given the plain
# version's angles, its own angles within ANGLE_ATOL rad (moment sums in
# another order off level 0, atan2 on the card).
ANGLE_ATOL = 1e-5
# The front-end on the card against the same frames on CPU tensors: level 0
# exact, descriptor bits of valid keypoints equal within MIN_EQUAL_BITS
# (levels 1-3 and the GIST start from a resize, a matrix product summed in
# another order on the card), points within PTS_ATOL m, the scan equal up
# to MAX_MOVED_BINS (a bearing an ulp from a bin edge: atan2 on the card
# against the CPU's), the GIST within GIST_MAX_BITS bits.
MIN_EQUAL_BITS, PTS_ATOL, MAX_MOVED_BINS, GIST_MAX_BITS = 0.995, 1e-5, 1, 2
WALL_ATOL = 0.05             # m: |r·|cos θ| - 3.0| of a valid scan bin
REPLACES = {
    "linearize": "uzliti_slam_tpu/graph/solver.py:355 (_make_fused_linearize)",
    "hvp": "uzliti_slam_tpu/graph/solver.py:306 (_make_hvp)",
    "chain_apply": "uzliti_slam_tpu/graph/tridiag.py:198 (block_tridiag_apply)",
    "residual_chi2": "uzliti_slam_tpu/graph/solver.py:1034 (_robust_chi2_from_r)"
                     " + graph/factors.py:72 (batched_residuals)",
    "relax_min": "uzliti_slam_tpu/graph/shortest_path.py:29 (shortest_paths)",
    "cluster_labels": "uzliti_slam_tpu/graph/filter.py:66 (_cluster_labels)",
    "ransac_rigid": "uzliti_slam_tpu/ops/ransac.py:123 (ransac_rigid)"
                    " + :54 (kabsch_quat) + :32 (kabsch)",
    "components": "uzliti_slam_tpu/graph/solver.py:212 (connected_components)"
                  " + :242 (gauge_fix_mask)",
    "chain_factor": "uzliti_slam_tpu/graph/tridiag.py:145 (block_tridiag_factor)"
                    " + :22-72 (_inv3, _inv6) + :75 (_pad_pow2) + :112 (_dense_root_inverse)",
    "pcg": "uzliti_slam_tpu/graph/solver.py:512 (_pcg)",
    "project_rays": "uzliti_slam_tpu/mapping/occupancy.py:70 (_project_rays)"
                    " + :191 (_mark_node_cells)",
    "fast_nms": "uzliti_slam_tpu/ops/features.py:54 (fast_score) + :105 (nms)",
    "grid_topk": "uzliti_slam_tpu/ops/features.py:114 (select_topk_grid)",
    "orb_describe": "uzliti_slam_tpu/ops/features.py:159 (_sep_blur) + :171"
                    " (intensity_centroid_angles) + :285 (brief_descriptors)",
    "scan_bins": "uzliti_slam_tpu/ops/scan.py:38 (_bin_min_max) + :109 (depth_to_scan)",
    "hamming_top2": "uzliti_slam_tpu/ops/matching.py:53 (hamming_matrix) + :80 (knn_match)"
                    " + :100 (ratio_test) via :116 (match_descriptors)"
                    " + recognition/recognizer.py:76 (gist_query)",
    "bilateral": "uzliti_slam_tpu/ops/depth.py:29 (joint_bilateral_filter)",
    "icp": "uzliti_slam_tpu/ops/icp.py:40 (_correspondences) inside :64 (icp_point_to_line)",
}
REPLACES.update({
    "merge_pairs": "uzliti_slam_tpu/graph/lifecycle.py:77 (find_merge_pairs)",
    "calib_gn": "uzliti_slam_tpu/graph/calibration.py:63 (calibrate)",
    "bin_min_max": "uzliti_slam_tpu/ops/scan.py:38 (_bin_min_max) via :166 (points_to_scan)",
})
SOURCE = {k: f"uzliti_slam_tpu_torch/csrc/{k}.cu" for k in REPLACES}
SOURCE["project_rays"] = "uzliti_slam_tpu_torch/csrc/occupancy.cu"
SOURCE["bin_min_max"] = "uzliti_slam_tpu_torch/csrc/scan_bins.cu"
SOLVE_KERNELS = ("linearize", "hvp", "chain_apply", "residual_chi2", "chain_factor", "pcg")
EPOCH_KERNELS = ("relax_min", "cluster_labels", "ransac_rigid", "components")
MAP_KERNELS = ("project_rays",)
FRONTEND_KERNELS = ("fast_nms", "grid_topk", "orb_describe", "scan_bins")
# the keyframe step's own kernels; K16 has two wrappers (matching, GIST query)
KEYFRAME_KERNELS = ("hamming_top2", "bilateral", "icp")
KEYFRAME_WRAPPERS = {"hamming_top2": ("hamming_top2", "gist_topk"), "bilateral": ("bilateral",),
                     "icp": ("icp",)}
STEP_KERNELS = FRONTEND_KERNELS + KEYFRAME_KERNELS + ("ransac_rigid",)
# the maintenance and calibration timers' kernels (phase 13): K19, K20 and
# K15's second entry point
MAINT_KERNELS = ("merge_pairs", "calib_gn", "bin_min_max")
# the device functions each front-end kernel's wrapper launches
FRONTEND_DEVICE_FUNCTIONS = {"fast_nms": ("fast_nms_tile",), "grid_topk": ("cell_topk", "global_topk"),
                             "orb_describe": ("box_blur", "describe"),
                             "scan_bins": ("init_table", "scan_pixels", "finalize"),
                             "hamming_top2": ("match_top2", "gist_rounds"),
                             "bilateral": ("bilateral_tile",), "icp": ("icp_problems",),
                             "ransac_rigid": ("ransac_roots",),
                             "merge_pairs": ("row_keys", "greedy_rounds"),
                             "calib_gn": ("init_theta", "calib_edges", "calib_solve"),
                             "bin_min_max": ("bin_rows",),
                             "feature_votes": ("node_sims", "topk_sims"),
                             "repository": ("nearest_chunk", "nearest_finish", "desc_hits",
                                            "topk_votes"),
                             "bow_words": ("assign_words", "count_bits", "majority_bytes"),
                             "bow_query": ("row_scores", "topk_scores"),
                             "voxel_grid": ("voxel_sort_chunks", "voxel_merge",
                                            "voxel_accumulate", "voxel_finish"),
                             "knn_normals": ("knn_normals_kernel",), "gicp": ("gicp_problems",),
                             "pnp": ("pnp_hypotheses_kernel", "pnp_refine_kernel")}
# cuSOLVER / cuBLAS items that must not appear in a profiled solve
LIBRARY_ITEMS = ("getrf", "getrs", "trsm", "gemv")
# The card's published peaks (H100 SXM at 700 W):
# device memory 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s, the
# rate used here for every scalar operation (float32 or int32).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# The JAX bench's epoch rung (bench.py:393-422), and 10k nodes at the same
# ~0.5 m keyframe spacing (radius scaled by 20)
EPOCH_500 = dict(n=500, node_capacity=512, edge_capacity=4096, radius=2.0)
EPOCH_10K = dict(n=10_000, node_capacity=10240, edge_capacity=32768, radius=40.0)
# The JAX bench's keyframe rungs (bench.py:283-335): a 640x480 WallWorld at
# f = 525, 13 frames of an out-and-back drive, 256 features, 360 bins, the
# front camera or the front + rear rig (the rear turned by 3.14159 rad and
# fed the same frame)
KEYFRAME_VGA = dict(img_h=480, img_w=640, f=525.0, n_frames=13, odom_drift=0.05, length=6.0,
                    feats=256, scan_bins=360, warmup=3)
# K16 is held exactly (integer distances, the same tie rule); K17 within
# BILATERAL_ULPS of the plain version's depth (expf and torch's exp on the
# card; fma_plain's double rounding); K18's pose within ICP_POSE_ATOL and
# covariance within ICP_COV_RTOL of its largest entry (sums in another
# order over 20 Gauss-Newton steps), the same ok flag.
BILATERAL_ULPS = 4
ICP_POSE_ATOL, ICP_COV_RTOL = 1e-4, 1e-3
# The keyframe step on the card against the same frames on CPU tensors
# (phase 11): the same nodes, edge endpoints, types and flags; edge
# transforms within KF_TRANSFORM_ATOL (RANSAC refits and ICP poses from
# points a few ulps of filtered depth apart).
KF_TRANSFORM_ATOL = 1e-3
# The JAX bench's ATE rung (bench.py:338-379): 48 frames at 96x128, 64
# features, 90 bins, keyframe gate 0.2 m, an epoch every 8 keyframes and a
# final one.  The RANSAC draws cannot be JAX's, so the bar is taken over
# seeds: on the CPU (``python tests/test_torch_ate.py``, seeds 0-7) the JAX
# package reads 0.012020-0.012344 m and the port 0.011992-0.012029 m
# (odometry 0.034465 m), a spread of 0.00035 m over both; the bar is 1.1x
# JAX's largest reading, 3.5 such spreads above it.
ATE_RUN = dict(img_h=96, img_w=128, n_frames=48, odom_drift=0.06, length=5.0, feats=64,
               scan_bins=90, node_capacity=64, edge_capacity=512, gate=0.2, optimize_every=8)
ATE_SEEDS = (0, 1, 2)
# Phase 13.  K19 and bin_min_max are held exactly (the same float operations
# in the same order; integer minima); K20's θ within CALIB_THETA_ATOL and
# its cost history within CALIB_HIST_RTOL of the plain version (float64
# sums on the card against float32 products, 20 Gauss-Newton steps to the
# same fixed point).  The merged state on the card against the same
# maintenance on CPU tensors: indices, flags and descriptors exactly, poses
# and points within MERGE_POSE_ATOL, scans within one 21-bit quantum.
CALIB_THETA_ATOL, CALIB_HIST_RTOL = 1e-4, 1e-4
MERGE_POSE_ATOL = 1e-5
FAR_CENTER = (100.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0)   # the robot 100 m away: every node eligible
# tests/test_calibration.py:162-214 at 1k nodes
CALIB_1K = dict(n=1000, node_capacity=1024, edge_capacity=4096, p_true=(1.04, 0.05, 0.03))
# tests/test_lifecycle.py:219-273: 520 frames at 96x128, a 0.35 m step,
# maintain() every 20 frames, an 8 m local scope in one 128 / 1024 tier
LONG_RUN = dict(img_h=96, img_w=128, f=110.0, frames=520, step=0.35, maintain_every=20,
                node_capacity=128, edge_capacity=1024, feats=64, scan_bins=90)
ATE_JAX_CPU_MAX_M = 0.012344205752015114
ATE_BAR_M = 1.1 * ATE_JAX_CPU_MAX_M
# Phase 14: the other place recognizers, K21-K24, each with its wrappers;
# the kernels each method's keyframe step launches
RECOGNITION_REPLACES = {
    "feature_votes": "uzliti_slam_tpu/recognition/recognizer.py:145 (feature_set_query)",
    "repository": "uzliti_slam_tpu/recognition/recognizer.py:206 (repository_add: its search"
                  " :223-241) + :285 (repository_query)",
    "bow_words": "uzliti_slam_tpu/recognition/vocabulary.py:100 (quantize) + :33"
                 " (build_vocabulary: its rounds :69-78, :90-94)",
    "bow_query": "uzliti_slam_tpu/recognition/vocabulary.py:161 (bow_query) + :117 (bow_score)",
}
RECOGNITION_KERNELS = tuple(RECOGNITION_REPLACES)
RECOGNITION_WRAPPERS = {"feature_votes": ("feature_votes",),
                        "repository": ("repo_nearest", "repo_votes"),
                        "bow_words": ("word_assign", "word_majority"),
                        "bow_query": ("bow_query",)}
METHOD_KERNELS = {"feature_set": ("feature_votes",), "repository": ("repository",),
                  "bow": ("bow_words", "bow_query")}
# K21-K23 are held exactly (integer distances, votes and counts; one IEEE
# division); K24's scores within BOW_SCORE_ATOL (|v - q| summed over 256
# words in another order), its slots exactly unless two scores lie within
# BOW_NEAR_TIE.
BOW_SCORE_ATOL, BOW_NEAR_TIE = 1e-6, 1e-5
RECOGNITION_SIZES = (1000, 10_000, 50_000)
# tests/test_pr_methods.py: 30 frames at 96x128, and each method's gates
PR_RUN = dict(img_h=96, img_w=128, n_frames=30, odom_drift=0.06, length=4.0)
PR_GATES = {"feature_set": dict(min_descriptors=20, min_similarity=0.15),
            "repository": dict(repo_min_votes=5, repo_desc_per_node=48),
            "bow": dict(bow_words=64, bow_min_score=0.2)}
# Phase 15: the gicp and pnp registration estimators, K25-K28, and the
# kernels each estimator's keyframe step launches besides the front-end's,
# the bilateral filter and the ICP laser edge
REGISTRATION_REPLACES = {
    "voxel_grid": "uzliti_slam_tpu/ops/gicp.py:56 (voxel_downsample)",
    "knn_normals": "uzliti_slam_tpu/ops/gicp.py:89 (estimate_normals)",
    "gicp": "uzliti_slam_tpu/ops/gicp.py:105 (gicp_6d)",
    "pnp": "uzliti_slam_tpu/ops/pnp.py:107 (pnp_ransac, with _dlt_pose :29, _homography_pose"
           " :58 and ransac.kabsch)",
}
REGISTRATION_KERNELS = tuple(REGISTRATION_REPLACES)
REGISTRATION_SOURCE = {"voxel_grid": "uzliti_slam_tpu_torch/csrc/voxel_grid.cu",
                       "knn_normals": "uzliti_slam_tpu_torch/csrc/gicp.cu",
                       "gicp": "uzliti_slam_tpu_torch/csrc/gicp.cu",
                       "pnp": "uzliti_slam_tpu_torch/csrc/pnp.cu"}
REGISTRATION_WRAPPERS = {"voxel_grid": ("voxel_grid",), "knn_normals": ("knn_normals",),
                         "gicp": ("gicp",), "pnp": ("pnp_hypotheses", "pnp_refine")}
ESTIMATION_KERNELS = {"pnp": ("hamming_top2", "pnp"),
                      "gicp": ("voxel_grid", "knn_normals", "gicp")}
# K25 exactly (the same fixed-point sums); K26's normals within
# NORMAL_DOT_TOL of ±the plain version's where the two smallest eigenvalues
# of the plain version's covariance are at least EIG_GAP of the largest apart
# (a normal's sign is arbitrary, and a near-double eigenvalue leaves its
# vector free in the plane); K27's pose within GICP_POSE_ATOL (20 steps of a
# 6x6 solve from sums in another order) and the same ok flag; K28's draws,
# best hypothesis, consensus counts and ok exactly, its refined pose within
# PNP_POSE_ATOL and its mse within PNP_MSE_RTOL of max(mse, PNP_MSE_FLOOR)
# where the result is ok (the step's information divides by the mse floored
# at 1e-2 px², and an exact fit's mse is rounding, ~1e-9 px²; a
# failed candidate's few inliers leave its Gauss-Newton system
# near-singular: its unused pose is free; each such pose that differs is
# logged with its ok flag, consensus and best index).  K28's hypotheses,
# each family on its own (quaternions up to sign): the median draw within
# PNP_HYP_MEDIAN and every draw within PNP_HYP_MAX (tests/test_torch_pnp.py's
# per-draw bar against LAPACK), over the draws whose 6 correspondences are
# valid (a draw with an invalid one scores -1 and is never used); Kabsch
# only where 3 or more of them have a measured depth (fewer leave its
# rotation free); a DLT draw beyond PNP_HYP_MAX must be degenerate: its
# 12x12 system's two smallest singular values both at most DLT_NULL_RATIO
# of the largest (a coplanar draw's null space has more than one
# dimension, and its pose is arbitrary on both sides).
NORMAL_DOT_TOL, EIG_GAP = 1e-5, 1e-3
GICP_POSE_ATOL = 1e-4
PNP_POSE_ATOL, PNP_MSE_RTOL, PNP_MSE_FLOOR = 1e-4, 1e-4, 1e-2
PNP_HYP_MEDIAN, PNP_HYP_MAX, DLT_NULL_RATIO = 1e-4, 1e-3, 1e-4
# tests/test_estimation_methods.py's run: 24 frames at 96x128
EST_RUN = dict(img_h=96, img_w=128, n_frames=24, odom_drift=0.08, length=5.0)


T_START = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One line per phase, with the seconds since the script started."""
    fields["t_s"] = time.perf_counter() - T_START
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def time_pair(kernel_fn, plain_fn, trials: int = 21, calls: int = 10, warm: bool = True):
    """Median ms per call of two functions on the card, in alternating
    trials (plain, kernel, kernel, plain, ...) timed with CUDA events; a
    warm-up call of each first unless the caller has just run both."""
    def one(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    for fn in (kernel_fn, plain_fn) if warm else ():
        fn()
    torch.cuda.synchronize()
    tk, tp = [], []
    for i in range(trials):
        order = [(plain_fn, tp), (kernel_fn, tk)]
        for fn, acc in (order if i % 2 == 0 else order[::-1]):
            acc.append(one(fn))
    return statistics.median(tk), statistics.median(tp)


def timed_solves(optimize, g, cfg, reps: int):
    """Median seconds per solve; each solve runs under CUDA sync debug mode
    "error", so a host synchronisation inside ``optimize`` raises."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = optimize(g, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


# longer names first: a mangled name takes the first entry it contains
DEVICE_FUNCTIONS = ("linearize_edges", "linearize_mask", "hvp_seed", "hvp_edges",
                    "chain_forward", "chain_backward", "chain_root", "factor_level",
                    "factor_root", "pcg_init", "pcg_alpha", "pcg_beta", "project_cells",
                    "residual_edges", "sum_partials",
                    "relax_rows", "cluster_rounds", "ransac_roots", "components_cta",
                    "gauge_cta", "k_init_labels", "k_scatter_min", "k_jump_out", "k_jump",
                    "k_gauge_init", "k_gauge_reduce_stamp", "k_gauge_reduce_slot",
                    "k_gauge_write", "fast_nms_tile", "global_topk", "cell_topk", "box_blur",
                    "describe", "scan_pixels", "init_table", "finalize", "match_top2",
                    "gist_rounds", "bilateral_tile", "icp_problems", "row_keys",
                    "greedy_rounds", "init_theta", "calib_edges", "calib_solve", "bin_rows",
                    "voxel_sort_chunks", "voxel_merge", "voxel_accumulate", "voxel_finish",
                    "knn_normals_kernel", "gicp_problems", "pnp_hypotheses_kernel",
                    "pnp_refine_kernel")


def ptxas_summary(text: str) -> dict:
    """Registers and spilled bytes per device function, from ``ptxas -v``."""
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = next((f for f in DEVICE_FUNCTIONS if f in m.group(1)), m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return out


def device_profile(fn) -> tuple[dict, dict]:
    """One profiled call: (wall ms, summed device-kernel ms, the busy share
    they give, the device launches and the five kernels with the most
    device time; every device kernel's name and device ms in the trace)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us == 0:
        return {"profile": "not measured (no device time in the trace)"}, {}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return ({"profiled_wall_ms": 1e3 * wall, "device_kernel_ms": dev_us / 1e3,
             "device_busy_share": dev_us / 1e6 / wall,
             "device_launches": sum(e.count for e in kernels),
             "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top}},
            {e.key: e.self_device_time_total / 1e3 for e in kernels})


def library_items(names) -> list:
    """The cuSOLVER / cuBLAS kernels among profiled kernel names."""
    return [k for k in names if any(item in k.lower() for item in LIBRARY_ITEMS)]


def time_call(fn, trials: int = 21, calls: int = 10) -> float:
    """Median ms per call of one function on the card (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(trials):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return statistics.median(out)


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def kernel_work(name: str, args) -> tuple[int, int]:
    """(bytes, operations) one call must move and do on these inputs: each
    input read once and each output written once; operations counted from
    the kernel's arithmetic per edge, node, hypothesis or point (rounded
    counts of its multiplies, adds, compares and minima), over only the
    entries this data needs: edges of finite weight (K5), valid candidates
    (K6), roots with members and their valid points (K7), valid edges (K8)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    if name == "linearize":
        r, adj, info, valid, ef, et, free, both_free, is_chain, _ = args
        E, n = r.shape[0], free.shape[0]
        # out: Ji, Jj, W (E, 6, 6) and grad, Hb, U (n, 78)
        return (_nbytes(r, adj, info, valid, ef, et, free, both_free, is_chain)
                + 4 * (3 * 36 * E + 78 * n), 4500 * E)
    if name == "hvp":
        Ji, Jj, W, ef, et, v, damp, free = args
        return _nbytes(*args) + 4 * v.numel(), 360 * ef.shape[0] + 12 * v.shape[0]
    if name == "chain_apply":
        (levels, root_inv, _), b = args
        halves = [lv[0].shape[0] for lv in levels]
        return (_nbytes(root_inv, b, *(m for lv in levels for m in lv)) + 4 * b.numel(),
                sum(372 * h for h in halves) + 2 * root_inv.numel())
    if name == "residual_chi2":
        poses, ef, et, meas, info, valid, _ = args
        return (_nbytes(poses, ef, et, meas, info, valid) + 4 * (6 * ef.shape[0] + 1),
                400 * ef.shape[0])
    if name == "relax_min":
        dist0, ef, et, w, n_iters = args
        live = int((w < kops.INF).sum())
        return 2 * _nbytes(dist0) + _nbytes(ef, et, w), dist0.shape[0] * n_iters * live * 4
    if name == "cluster_labels":
        sf, st, valid, _, n_iters = args
        b, nv = sf.shape[0], int(valid.sum())
        return _nbytes(sf, st, valid) + 4 * b, n_iters * nv * nv * 6
    if name == "ransac_rigid":
        src, dst, valid, tri, *_ = args
        R, M, _ = src.shape
        K = tri.shape[1]
        roots, points = int(valid.any(-1).sum()), int(valid.sum())
        table = sum(12 * M * (1 if t.stride(0) == 0 else R) for t in (src, dst))
        return (table + _nbytes(valid, tri) + R * (4 * (7 + 1 + 1 + 36 + 1) + 1) + 4 * R * K,
                roots * (1350 * K + 2000) + points * (40 * K + 110))
    if name == "components":
        ef, et, ev, nv, nf, stamp, n, iters = args
        return (_nbytes(ef, et, ev, nv, nf, stamp) + 5 * n,
                iters * (2 * int(ev.sum()) + 2 * n) + 6 * n)
    if name == "chain_factor":
        # per odd block of a level: two 6x6 Schur inverses (~250 operations
        # each) and eight 6x6 products (432 each); the root: m inverses and
        # 2m products, then 6m column solves of m blocks (216 each).  Only
        # live odd blocks count: those holding a row of the unpadded chain.
        D, U, cutoff = args
        halves, m = kops._factor_shapes(D.shape[0], cutoff)
        live, n_valid = 0, D.shape[0]
        for _ in halves:
            n_valid = -(-n_valid // 2)
            live += n_valid
        out = 4 * (5 * 36 * sum(halves) + 36 * m * m)
        return _nbytes(D, U) + out, live * (2 * 250 + 8 * 432) + m * (250 + 2 * 432) + 6 * m * m * 216
    if name == "pcg":
        # a 12-step PCG's vector updates: b, z0, and each step's Hp and z
        # read once, x written once; 4 + 12·10 operations per entry
        b, steps = args
        return 4 * b.numel() * (2 + 2 * steps + 1), b.numel() * (4 + 10 * steps)
    if name == "project_rays":
        # base, tables and the active nodes' scans and scalars read once,
        # the grid written once; ~20 operations per (cell, node) pair whose
        # centre-table offset lies on the grid
        (logodds, cx, cy, kbin, scans, idx, count, D, bin0, Wray, *_rest) = args
        size, c = logodds.shape[0], int(count)
        nodes = idx[:c].long()
        rows = (size - (cy[nodes].long() - size // 2).abs()).clamp(min=0)
        cols = (size - (cx[nodes].long() - size // 2).abs()).clamp(min=0)
        pairs = int((rows * cols).sum())
        return (_nbytes(logodds, D, bin0, Wray) + 4 * logodds.numel()
                + c * (4 * scans.shape[1] + 16), 20 * pairs)
    if name == "fast_nms":
        # the image read and the scores written once; per pixel inside the
        # 21-px border 16 differences, 32 compares, ~20 mask operations and
        # the sums (2 per passing ring pixel, counted for all 16), per pixel
        # 11 for the 3x3 maximum and the test
        img, _ = args
        C, H, W = img.shape
        inner = C * max(H - 42, 0) * max(W - 42, 0)
        return 2 * _nbytes(img), 100 * inner + 11 * img.numel()
    if name == "grid_topk":
        # the scores read once, the keypoints written once; k_cell rounds of
        # a compare and a select per score of the grid
        score, k_total, grid = args
        C, H, W = score.shape
        gh, gw, k_cell, _ = kops._grid_shapes(H, W, k_total, grid)
        return _nbytes(score) + C * k_total * 13, 2 * k_cell * C * grid * grid * gh * gw
    if name == "orb_describe":
        # image, keypoints and pattern read once, angles and descriptors
        # written once; the blur's 10 adds and a multiply per pixel, and per
        # keypoint the moments (4 operations on each of 177 disc pixels) and
        # 256 tests of two rotated samples (~10 operations each)
        img, uv, pattern, *rest = args
        kps = uv.shape[0] * uv.shape[1]
        return (_nbytes(img, uv, pattern) + kps * (4 + 32),
                11 * img.numel() + kps * (4 * 177 + 512 * 10))
    if name == "scan_bins":
        # depth and transforms read once, near and far written once; ~60
        # operations per pixel (backprojection, extrinsic, range, atan2 as
        # ~20, tests, bin, the two atomics)
        depth, _, xf, n_bins, *_ = args
        return _nbytes(depth, xf) + 8 * depth.shape[0] * n_bins, 60 * depth.numel()
    if name == "hamming_top2":
        # the query and the candidates' stored descriptors and flags read
        # once, idx, ok and best written once; per valid (query, stored) pair
        # 8 XORs, 8 popcounts and 8 adds, per pair 3 compares of the top-2
        query, bank, bank_valid, cslot, valid_a, *_ = args
        C, Na, F = cslot.shape[0], query.shape[0], bank.shape[1]
        vb = bank_valid.index_select(0, cslot.long()).sum(-1)
        pairs = int(valid_a.sum()) * int(vb.sum())
        return (_nbytes(query, cslot, valid_a) + C * F * 33 + 9 * C * Na,
                24 * pairs + 3 * C * Na * F)
    if name == "gist_topk":
        # the bank, its stamps and flags read once; 24 per eligible entry,
        # 3 per entry for the gate, k rounds of a compare per entry
        query, bank, stamp, valid, q_stamp, k, min_dt, _ = args
        elig = int((valid & ((stamp - q_stamp).abs() >= min_dt)).sum())
        return _nbytes(query, bank, stamp, valid, q_stamp) + 9 * k, 24 * elig + (3 + 2 * k) * bank.shape[0]
    if name == "bilateral":
        # depth and guide read once, the filtered depth written once; per tap
        # of a pixel ~8 operations and the exponential (~10)
        depth, guide = args
        return 3 * _nbytes(depth), 25 * 18 * depth.numel()
    if name == "icp":
        # scans, flags and init read once, pose, fraction, mse, covariance and
        # ok written once; per iteration and source point 7 operations per
        # valid target and ~60 for the residual, Jacobian and sums
        src, src_valid, dst, dst_valid, init, iterations, *_ = args
        B, M, _ = src.shape
        return (_nbytes(src, src_valid, dst, dst_valid, init) + B * (4 * 14 + 1),
                (iterations + 1) * M * (7 * int(dst_valid.sum()) + 60 * B))
    if name == "merge_pairs":
        # poses, stamps and flags read once, the pairs written once; ~150
        # operations per pair the rows test (an eligible row against every
        # eligible newer node: ne·(ne-1)/2 pairs), then the rounds: 8 per
        # entry of the N·(2·max_pairs - 1) list, max_pairs times
        pose, stamp, elig, _, _, max_pairs = args
        ne, n = int(elig.sum()), pose.shape[0]
        return (_nbytes(pose, stamp, elig) + 9 * max_pairs,
                150 * ne * (ne - 1) // 2 + 8 * max_pairs * n * (2 * max_pairs - 1))
    if name == "calib_gn":
        # the edge tables read once per step (iterations + 1 passes), θ and
        # the cost history written once; per active residual group ~40 pose
        # operations of ~60 dual operations on P + 1 floats, and 12 per
        # entry of its P(P+1)/2 + P + 1 sums; the P x P solve per step
        Xi, Xj, meas, is_s, is_o, sf, st, L0, iters, *_ = args
        P = 6 * L0.shape[0] + 3
        nt = P * (P + 1) // 2 + P + 1
        groups = int(is_s.sum()) + int(is_o.sum())
        return ((iters + 1) * _nbytes(Xi, Xj, meas, is_s, is_o, sf, st, L0) + 4 * (P + iters + 1),
                (iters + 1) * (groups * (2400 * (P + 1) + 12 * nt) + P ** 3))
    if name == "bin_min_max":
        # ranges, flags and bins read once, near and far written once; per
        # valid entry a multiply, the clip, the conversion and the two
        # atomics, per bin the write-back
        rng, ok, bins, n_bins, _ = args
        b = rng.numel() // rng.shape[-1]
        return _nbytes(rng, ok, bins) + 8 * b * n_bins, 6 * int(ok.sum()) + 4 * b * n_bins
    if name == "feature_votes":
        # the query and the eligible nodes' descriptors and flags read once,
        # stamps and flags of every node, the top-k written once; 24 per
        # (valid query, valid stored) pair of an eligible node (8 XORs, 8
        # popcounts, 8 adds), then k rounds of two compares per node
        query, qvalid, bank, bank_valid, stamp, valid, q_stamp, k, _, _, min_dt = args
        elig = valid & ((stamp - q_stamp).abs() >= min_dt)
        pairs = int(qvalid.sum()) * int(bank_valid[elig].sum())
        return (_nbytes(query, qvalid, stamp, valid) + 33 * bank.shape[1] * int(elig.sum())
                + 9 * k, 24 * pairs + 2 * k * stamp.shape[0])
    if name == "repo_nearest":
        # the query flags, the valid queries and the valid stored descriptors
        # read once, the valid queries' nearest and duplicate flags written
        # once (an invalid query's are never read); 24 per (valid query,
        # valid stored) pair and per pair of valid queries
        query, qvalid, bank, bank_valid, _ = args
        nq, nv = int(qvalid.sum()), int(bank_valid.sum())
        return (_nbytes(qvalid, bank_valid) + 32 * (nq + nv) + 9 * nq,
                24 * nq * nv + 24 * nq * (nq - 1) // 2)
    if name == "repo_votes":
        # the query and the valid stored descriptors with their link rows
        # read once, the node stamps and flags, the top-k written once; 24
        # per (valid query, valid stored) pair (a stored descriptor with no
        # hit needs all of them), k rounds of three operations per node
        query, qvalid, bank, bank_valid, links, link_valid, stamp, valid, *_rest = args
        k, nv, L = _rest[1], int(bank_valid.sum()), links.shape[1]
        return (_nbytes(query, qvalid, bank_valid, stamp, valid) + (32 + 5 * L) * nv + 9 * k,
                24 * int(qvalid.sum()) * nv + 3 * k * stamp.shape[0])
    if name == "word_assign":
        # the flags, the valid descriptors and the words read once, their
        # word and distance and the histogram written once (an invalid
        # descriptor's word is never read); 24 per (valid descriptor, word)
        # pair
        desc, valid, centers = args
        mv, K = int(valid.sum()), centers.shape[0]
        return _nbytes(valid, centers) + 40 * mv + 4 * K, 24 * mv * K
    if name == "word_majority":
        # the flags, the valid descriptors, their words and the counts read
        # once, the centres written once; per valid descriptor 256 bit tests
        # and an add per set bit, per centre bit a compare
        desc, valid, word, counts = args
        K, mv = counts.shape[0], int(valid.sum())
        popc = torch.tensor([bin(b).count("1") for b in range(256)], device=desc.device)
        set_bits = int(popc[desc[valid].long()].sum())
        return (_nbytes(valid, counts) + 36 * mv + 32 * K,
                256 * mv + set_bits + 3 * 256 * K)
    if name == "bow_query":
        # the stamps and flags and the query read once, the rows that pass
        # the validity and time gates read once (a row that fails them
        # scores -1 unread), the top-k written once; per eligible entry a
        # subtract, two absolute values and two adds, k rounds of two
        # compares per row
        bank, stamp, valid, q, q_stamp, k, _, min_dt = args
        N, K = bank.shape
        elig = int((valid & ((stamp - q_stamp).abs() >= min_dt)).sum())
        return (_nbytes(stamp, valid, q, q_stamp) + 4 * K * elig + 9 * k,
                5 * K * elig + 2 * k * N)
    if name == "voxel_grid":
        # the points read once, the kept voxels written once; per point the
        # hash (~12), its share of the chunk's bitonic sort (78 stages), the
        # slot's binary search and a hit's 6 fixed-point adds
        pts, lab, valid, _, V = args
        n = pts.shape[0]
        return (_nbytes(pts, lab, valid) + 25 * V,
                n * (12 + 78 + 2 * max(V, 2).bit_length()) + 6 * int(valid.sum()))
    if name == "knn_normals":
        # per point a test against each valid point (8 flops), then the mean,
        # covariance and the 3x3 symmetric eigenvector (~300 flops)
        points, valid, *_ = args
        B, M, _ = points.shape
        nv = int(valid.sum())
        return _nbytes(points, valid) + 12 * B * M, 8 * M * nv + 300 * B * M
    if name == "gicp":
        # the Lab distance of every (source point, valid target) pair once
        # (8 flops: it does not move with the pose), per iteration the 3-D
        # distance, its weighted sum with the Lab one and the running minimum
        # (11 flops) and ~120 flops of each source point's row; the audit's
        # 3-D distances (8)
        src, _, src_valid, dst, dst_lab, dst_valid, normals, init, iters, *_ = args
        M, nv = src.shape[0], int(dst_valid.sum())
        return (_nbytes(src, args[1], src_valid, dst, dst_lab, dst_valid, normals, init)
                + 40 * dst.shape[0],
                8 * M * nv + iters * (11 * M * nv + 120 * M * dst.shape[0]) + 8 * M * nv)
    if name == "pnp_hypotheses":
        # per draw the selection (2 compares a key), then what a direct SVD
        # of each system costs for its singular values and right vectors
        # (Golub-Reinsch, 4mn² + 8n³ flops: the 12x12 DLT 20,736, the 12x9
        # homography 9,720, the 6x3 plane 432), and the small fits (~3000)
        X, xn, valid, depth, keys = args
        B, H, M = keys.shape
        F = 2 if depth is None else 3
        svd = sum(4 * m * n * n + 8 * n ** 3 for m, n in ((12, 12), (12, 9), (6, 3)))
        return (_nbytes(X, xn, valid, keys, *(() if depth is None else (depth,)))
                + B * H * (24 + 28 * F), B * H * (2 * M + svd + 3000))
    if name == "pnp_refine":
        # the K x M consensus (~40 flops each) and 8 Gauss-Newton steps over
        # the best hypothesis' rows (~300 flops a point: the projection, its
        # 3x6 Jacobian, the 21 + 6 sums)
        X, xn, valid, depth, samples, poses, *_ = args
        B, M, _ = X.shape
        K = poses.shape[1]
        return (_nbytes(X, xn, valid, samples, poses, *(() if depth is None else (depth,)))
                + B * (28 + 4 * K + 13), B * (40 * K * M + 8 * 300 * M))
    raise KeyError(name)


def bound(name: str, args) -> dict:
    """The larger of the bytes over device memory's rate and the operations
    over the scalar rate, in ms, and which of the two it is."""
    nbytes, ops = kernel_work(name, args)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------

def make_graph(n_nodes: int, device, seed: int = SEED):
    from uzliti_slam_tpu_torch.io import synthetic

    g, _ = synthetic.make_pose_graph(
        n_nodes, loop_closure_every=10, generator=torch.Generator().manual_seed(seed),
        device=device)
    return g


def kernel_inputs(g, cfg):
    """The inputs each solve kernel gets in the first LM iteration (K10:
    the first PCG solve's operators and right-hand side)."""
    from uzliti_slam_tpu_torch.graph import solver

    free = (g.node_valid & ~solver.gauge_fix_mask(g, solver.connected_components(g))).float()
    p = solver._Problem(g, free, cfg)
    gen = torch.Generator().manual_seed(SEED + 1)
    r0, _ = p.residuals(g.pose)
    Ji, Jj, W, grad, Hb, U = p.linearize(r0)
    lam = torch.full((), cfg.lambda_init, device=g.device)
    damp = p.damp(lam, Hb)
    pack = p.build_pack(Hb, U, damp)
    Dm = torch.where(free[:, None, None] > 0, Hb + torch.diag_embed(damp), p.eye6)
    v = torch.randn(g.node_capacity, 6, generator=gen).to(g.device)
    return {
        "residual_chi2": (g.pose, g.e_from, g.e_to, g.e_transform, g.e_info, p.valid,
                          cfg.huber_delta),
        "linearize": (r0, p.adj_meas_inv, g.e_info, p.valid, g.e_from, g.e_to, free,
                      p.both_free, p.is_chain, cfg.huber_delta),
        "hvp": (Ji, Jj, W, g.e_from, g.e_to, v, damp, free),
        "chain_apply": (pack, -grad),
        "chain_factor": (Dm, U, cfg.chain_dense_cutoff),
        "pcg": (Ji, Jj, W, g.e_from, g.e_to, damp, free, pack, -grad, cfg.pcg_iterations,
                cfg.pcg_tol),
    }


def compare_kernels(g, label: str):
    """Each solve kernel against its plain version on the same card inputs."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops

    inputs = kernel_inputs(g, solver.SolverConfig(**HEADLINE))
    results = {}
    for name in ("residual_chi2", "linearize", "hvp", "chain_apply"):
        args = inputs[name]
        kernel_fn = getattr(kops, name)
        plain_fn = getattr(kops, f"{name}_plain")
        got, ref = kernel_fn(*args), plain_fn(*args)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        err, rel = 0.0, 0.0
        for a, b in zip(got, ref):
            check(bool(torch.isfinite(a).all()), f"{name}: non-finite output")
            e = float((a - b).abs().max())
            err = max(err, e)
            rel = max(rel, e / max(float(b.abs().max()), 1e-30))
        row = {"max_abs_err": err, "max_rel_err": rel, "tol_rel": KERNEL_TOL[name]}
        row["ms"], row["plain_ms"] = time_pair(lambda: kernel_fn(*args), lambda: plain_fn(*args))
        row.update(bound(name, args))
        log(f"3 kernel {name} {label}", **row)
        check(rel <= KERNEL_TOL[name],
              f"{name} {label}: rel err {rel:.3g} > {KERNEL_TOL[name]}")
        results[name] = row
    results["chain_factor"] = compare_chain_factor(inputs["chain_factor"], label)
    results["pcg"] = compare_pcg(inputs["pcg"], label)
    return results


def _flat_factor(factor) -> list:
    return [t for lv in factor[0] for t in lv]


def compare_chain_factor(args, label: str) -> dict:
    """K9 against its plain version: every level tensor within 1e-4 of its
    largest entry, the apply (K3 on both factors) on a fixed right-hand side
    within CHAIN_APPLY_RTOL, and ‖A·root_inv - I‖∞ of both roots printed;
    torch.linalg.inv_ex on the same root timed as the library yardstick.
    Also printed: the plain version's time in float32 (the reference's
    precision), and how far K3 on K9's factor and on that float32 factor
    each lands from a solve wholly in float64."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    D, U, cutoff = args
    got, ref = kops.chain_factor(*args), kops.chain_factor_plain(*args)
    torch.cuda.synchronize()
    err, rel = 0.0, 0.0
    for a, b in zip(_flat_factor(got), _flat_factor(ref)):
        check(bool(torch.isfinite(a).all()), f"chain_factor {label}: non-finite level")
        e = float((a - b).abs().max())
        err, rel = max(err, e), max(rel, e / max(float(b.abs().max()), 1e-30))
    rhs = torch.randn(D.shape[0], 6, generator=torch.Generator().manual_seed(SEED + 3)).to(D.device)
    x_k, x_p = kops.chain_apply(got, rhs), kops.chain_apply(ref, rhs)
    apply_rel = float((x_k - x_p).abs().max() / x_p.abs().max())
    # K9 computes in float64 where the reference computes in float32: both
    # factors' applies (K3, float32) against a solve wholly in float64
    ref32 = kops.chain_factor_plain(D, U, cutoff, work_dtype=torch.float32)
    x64 = kops.chain_apply_plain(kops.chain_factor_plain(D.double(), U.double(), cutoff),
                                 rhs.double())
    scale64 = float(x64.abs().max())
    err64_k = float((x_k.double() - x64).abs().max()) / scale64
    err64_f32 = float((kops.chain_apply(ref32, rhs).double() - x64).abs().max()) / scale64
    _, Dk, Uk = kops.chain_reduce_plain(D, U, cutoff)
    # the root system in float64, as both versions build and invert it
    A = (kops.root_matrix_plain(Dk, Uk) if Dk.shape[0] > 1
         else Dk[0] + 1e-8 * torch.eye(6, dtype=Dk.dtype, device=D.device))
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    res_k = float(torch.linalg.matrix_norm(A @ got[1].to(A.dtype) - eye, ord=math.inf))
    res_p = float(torch.linalg.matrix_norm(A @ ref[1].to(A.dtype) - eye, ord=math.inf))
    row = {"max_abs_err": err, "max_rel_err": rel, "tol_rel": KERNEL_TOL["chain_factor"],
           "levels": len(got[0]), "root_blocks": Dk.shape[0], "apply_rel_err": apply_rel,
           "apply_rtol": CHAIN_APPLY_RTOL, "root_residual_inf_kernel": res_k,
           "root_residual_inf_plain": res_p, "apply_err_vs_float64_solve_kernel": err64_k,
           "apply_err_vs_float64_solve_float32_factor": err64_f32}
    row["ms"], row["plain_ms"] = time_pair(lambda: kops.chain_factor(*args),
                                           lambda: kops.chain_factor_plain(*args))
    row["plain_float32_ms"] = time_call(
        lambda: kops.chain_factor_plain(D, U, cutoff, work_dtype=torch.float32))
    row["library_ms"] = time_call(lambda: torch.linalg.inv_ex(A))
    row.update(bound("chain_factor", args))
    log(f"3 kernel chain_factor {label}", **row)
    check(rel <= KERNEL_TOL["chain_factor"], f"chain_factor {label}: level rel err {rel:.3g}")
    check(math.isfinite(res_k), f"chain_factor {label}: non-finite root")
    check(apply_rel <= CHAIN_APPLY_RTOL, f"chain_factor {label}: apply rel err {apply_rel:.3g}")
    return row


def compare_pcg(args, label: str) -> dict:
    """K10 against its plain version: a full PCG solve with the same K2 and
    K3 operators, x within 1e-4 of max|x| and the same stall flag at every
    step; timed on the updates alone (fixed Hp and z)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    Ji, Jj, W, ef, et, damp, free, pack, b, steps, tol = args

    def hvp(v):
        return kops.hvp(Ji, Jj, W, ef, et, v, damp, free)

    def apply(r):
        return kops.chain_apply(pack, r)

    def solve(init, alpha, beta):
        x, r, p, scal = init(b, apply(b))
        oks = []
        for _ in range(steps):
            alpha(p, hvp(p), x, r, scal, tol)
            oks.append(scal[2].clone())
            beta(r, apply(r), p, scal)
        return x, torch.stack(oks)

    kernel = (kops.pcg_init, kops.pcg_alpha, kops.pcg_beta)
    plain = (kops.pcg_init_plain, kops.pcg_alpha_plain, kops.pcg_beta_plain)
    x_k, ok_k = solve(*kernel)
    x_p, ok_p = solve(*plain)
    torch.cuda.synchronize()
    err = float((x_k - x_p).abs().max())
    rel = err / max(float(x_p.abs().max()), 1e-30)
    Hp, z = hvp(b), apply(b)

    def updates(init, alpha, beta):
        x, r, p, scal = init(b, z)
        for _ in range(steps):
            alpha(p, Hp, x, r, scal, tol)
            beta(r, z, p, scal)

    row = {"max_abs_err": err, "max_rel_err": rel, "tol_rel": KERNEL_TOL["pcg"],
           "route": "cta" if b.numel() <= kops.PCG_CTA_MAX else "grid", "steps": steps, "ok_pattern": [int(v) for v in ok_k.cpu().tolist()],
           "same_ok_pattern": bool(torch.equal(ok_k, ok_p))}
    row["ms"], row["plain_ms"] = time_pair(lambda: updates(*kernel), lambda: updates(*plain))
    row.update(bound("pcg", (b, steps)))
    log(f"3 kernel pcg {label}", **row)
    check(bool(torch.isfinite(x_k).all()), f"pcg {label}: non-finite x")
    check(rel <= KERNEL_TOL["pcg"], f"pcg {label}: rel err {rel:.3g}")
    check(row["same_ok_pattern"], f"pcg {label}: stall flags differ")
    return row


# ---------------------------------------------------------------------------
# Occupancy projection inputs and K11 against its plain version
# ---------------------------------------------------------------------------

LOGIT_065 = math.log(0.65 / 0.35)     # to_ternary's thresholds as log-odds


def with_scans(state, seed: int):
    """``state`` with the JAX bench's scans, 2 + 3·U(0,1) drawn with numpy
    (bench.py:214-220), on every slot and valid on its valid nodes."""
    import numpy as np

    n = state.graph.node_capacity
    scans = (2.0 + 3.0 * np.random.default_rng(seed).random((n, 360))).astype(np.float32)
    return state.replace(scans=torch.from_numpy(scans).to(state.graph.device),
                         scan_valid=state.graph.node_valid.clone())


def add_scanned_nodes(state, k: int):
    """``k`` new keyframes after the last node, 5 cm apart, each with its
    scan valid (their scans were drawn with the rest)."""
    from uzliti_slam_tpu_torch.graph import state as gstate
    from uzliti_slam_tpu_torch.ops import lie

    g = state.graph
    n0 = int(g.num_nodes)
    last = g.pose[n0 - 1]
    for i in range(k):
        step = torch.zeros(6, device=g.device)
        step[0] = 0.05 * (i + 1)
        pose = lie.pose_compose(last, lie.se3_exp(step))
        g, _ = gstate.add_node(g, pose, pose, g.stamp[n0 - 1] + (i + 1))
    return state.replace(graph=g, scan_valid=g.node_valid.clone())


def drifted(state, slot: int, metres: float):
    """``state`` with node ``slot`` moved by ``metres`` along x."""
    pose = state.graph.pose.clone()
    pose[slot, 0] += metres
    return state.replace(graph=state.graph.replace(pose=pose))


def map_args(state, cfg, grid):
    """(full, the arguments K11 gets) when ``pipeline.project_map`` runs
    on ``state`` with ``grid``."""
    from uzliti_slam_tpu_torch.mapping import occupancy

    g, force = state.graph, grid is None
    if grid is None:
        grid = occupancy.grid_init(g, cfg.grid)
    full, mask, origin, base = occupancy._select(grid, g, state.scan_valid, cfg.grid, force)
    return full, occupancy._rays_args(base, g.pose, state.scans, mask, origin, cfg.grid, True)


def ternary_mismatch(got, ref) -> tuple[int, int]:
    """(cells whose ternary class differs, of those the ones within
    TERNARY_NEAR of a class threshold in the plain log-odds)."""
    from uzliti_slam_tpu_torch.mapping import occupancy

    def classes(lo):
        return occupancy.to_ternary(occupancy.OccupancyGrid(lo, None, None, None))

    diff = classes(got) != classes(ref)
    near = (((ref - LOGIT_065).abs() < TERNARY_NEAR) | ((ref + LOGIT_065).abs() < TERNARY_NEAR)
            | ((ref.abs() - 1e-6).abs() < TERNARY_NEAR))
    return int(diff.sum()), int((diff & near).sum())


def compare_project(args, label: str, large: bool, trials: int = 21, calls: int = 10) -> dict:
    """K11 against its plain version on the arguments a projection gives
    it: log-odds within PROJECT_ATOL (or, ``large``, within
    PROJECT_SUM_RTOL·S + PROJECT_ATOL_LARGE per cell), ternary classes
    equal except next to a threshold."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    got = kops.project_rays(*args)
    ref, mag = kops.project_rays_plain(*args)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"project_rays {label}: non-finite")
    err = (got - ref).abs()
    cell_bound = PROJECT_SUM_RTOL * mag.float() + PROJECT_ATOL_LARGE if large else None
    n_diff, n_near = ternary_mismatch(got, ref)
    row = {"max_abs_err": float(err.max()), "nodes": int(args[6]),
           "cells_nonzero": int((ref != 0).sum()), "ternary_differ": n_diff,
           "ternary_differ_near_threshold": n_near}
    if large:
        worst = int((err / cell_bound).flatten().argmax())
        row.update(worst_cell_err=float(err.flatten()[worst]),
                   worst_cell_bound=float(cell_bound.flatten()[worst]),
                   max_abs_sum=float(mag.max()))
    else:
        row["tol_abs"] = PROJECT_ATOL
    row["ms"], row["plain_ms"] = time_pair(lambda: kops.project_rays(*args),
                                           lambda: kops.project_rays_plain(*args),
                                           trials=trials, calls=calls)
    row.update(bound("project_rays", args))
    log(f"3 kernel project_rays {label}", **row)
    if large:
        check(bool((err <= cell_bound).all()), f"project_rays {label}: beyond 2e-6·S + 1e-5")
    else:
        check(row["max_abs_err"] <= PROJECT_ATOL,
              f"project_rays {label}: err {row['max_abs_err']:.3g} > {PROJECT_ATOL}")
    check(n_diff == n_near, f"project_rays {label}: {n_diff - n_near} ternary classes differ")
    return row


def epoch_kernel_inputs(state, cfg) -> dict:
    """The inputs K5-K8 get in an epoch on ``state``: the heuristic's (B, N)
    relaxation, the candidates' stamps, the roots' RANSAC problems (triplets
    drawn on the card from a seeded generator) and the solve's components."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.graph import filter as gfilter
    from uzliti_slam_tpu_torch.graph import shortest_path
    from uzliti_slam_tpu_torch.ops import ransac

    g, fc = state.graph, cfg.filter
    idx, heur = pipeline.epoch_candidates(g, cfg)
    safe = torch.where(idx >= 0, idx, 0).long()
    n = g.node_capacity
    dist0 = torch.full((idx.shape[0], n), shortest_path.INF, device=g.device).scatter(
        1, g.e_from[safe].long()[:, None], 0.0)
    cr = gfilter.cluster_roots(g, idx, fc, cand_mask=heur)
    R, b = cr.member.shape
    tri = ransac._valid_sample(torch.Generator(device=g.device).manual_seed(SEED),
                               fc.ransac_hypotheses, cr.member)
    return {
        "relax_min": (dist0, g.e_from, g.e_to, shortest_path._weights(g, False), 64),
        "cluster_labels": (cr.sf, cr.st, cr.valid, fc.max_dt, 16),
        "ransac_rigid": (cr.p_pred.expand(R, b, 3), cr.p_act.expand(R, b, 3), cr.member, tri,
                         fc.max_error, fc.min_cluster_size, 0.01),
        "components": components_inputs(g),
    }


def components_inputs(g) -> tuple:
    """The inputs K8 gets in a solve on ``g`` (solver.connected_components
    and gauge_fix_mask)."""
    n = g.node_capacity
    return (g.e_from, g.e_to, g.e_valid, g.node_valid, g.node_fixed, g.stamp, n,
            max(2 * math.ceil(math.log2(max(n, 2))), 8))


def components_route(n: int) -> str:
    """Which of K8's routes ``kernels/ops.components`` takes at N nodes."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    return "cta" if 12 * n <= kops._SMEM_BYTES else "grid"


def _components_both(kernel: bool):
    """K8 as the solve runs it: labels, then the gauge mask from them."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    comp = kops.components if kernel else kops.components_plain
    gauge = kops.gauge_fix if kernel else kops.gauge_fix_plain

    def fn(ef, et, ev, nv, nf, stamp, n, iters):
        labels = comp(ef, et, ev, n, iters)
        return labels, gauge(labels, nv, nf, stamp)
    return fn


def compare_ransac(got, ref, args, label: str) -> dict:
    """K7 against its plain version: the same best hypothesis, ok flag and
    consensus per root; refit poses within RANSAC_POSE_ATOL on the roots
    that passed; per-hypothesis counts apart only by points within
    RANSAC_NEAR_REL of the inlier radius (counted and printed)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    src, dst, valid, tri, max_error, *_ = args
    pose_k, cons_k, _, _, ok_k, best_k, counts_k = got
    pose_p, cons_p, _, _, ok_p, best_p, counts_p = ref
    _, err2 = kops.ransac_hypotheses_plain(src, dst, valid, tri)
    near = ((err2 / max_error**2 - 1.0).abs() < RANSAC_NEAR_REL) & valid[:, None]
    diff = (counts_k - counts_p).abs()
    pose_err = (pose_k - pose_p).abs().amax(dim=1)
    live_err = float(torch.where(ok_p, pose_err, 0.0).max())
    row = {"max_abs_err": live_err, "max_abs_err_all_roots": float(pose_err.max()),
           "roots": int(src.shape[0]), "roots_ok": int(ok_p.sum()),
           "best_mismatches": int((best_k != best_p).sum()),
           "near_radius_points": int(near.sum()), "count_diffs": int((diff > 0).sum()),
           "pose_atol": RANSAC_POSE_ATOL}
    log(f"3 kernel ransac_rigid {label} check", **row)
    check(torch.equal(best_k, best_p.to(best_k.dtype)), f"ransac_rigid {label}: best differs")
    check(torch.equal(ok_k, ok_p), f"ransac_rigid {label}: ok differs")
    check(torch.equal(cons_k, cons_p), f"ransac_rigid {label}: consensus differs")
    check(live_err <= RANSAC_POSE_ATOL, f"ransac_rigid {label}: pose err {live_err:.3g}")
    check(bool((diff <= near.sum(-1)).all()),
          f"ransac_rigid {label}: counts differ beyond near-radius points")
    return row


def compare_epoch_kernels(inputs: dict, label: str) -> dict:
    """K5-K8 (those in ``inputs``) against their plain versions on the
    inputs an epoch or a solve gives them."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    fns = {name: (getattr(kops, name), getattr(kops, f"{name}_plain"))
           for name in ("relax_min", "cluster_labels", "ransac_rigid")}
    fns["components"] = (_components_both(True), _components_both(False))
    results = {}
    for name, args in inputs.items():
        kernel_fn, plain_fn = fns[name]
        got, ref = kernel_fn(*args), plain_fn(*args)
        torch.cuda.synchronize()
        if name == "ransac_rigid":
            row = compare_ransac(got, ref, args, label)
        elif name == "relax_min":
            check(bool(torch.isfinite(got).all()), f"relax_min {label}: non-finite")
            ulp = int((got.view(torch.int32).long() - ref.view(torch.int32).long()).abs().max())
            row = {"max_abs_err": float((got - ref).abs().max()), "max_ulp": ulp,
                   "tol_ulp": RELAX_MAX_ULP, "rows": int(got.shape[0])}
            check(ulp <= RELAX_MAX_ULP, f"relax_min {label}: {ulp} ulp apart")
        else:
            pairs = tuple(zip(got, ref)) if isinstance(got, tuple) else ((got, ref),)
            mism = sum(int((a != b).sum()) for a, b in pairs)
            row = {"max_abs_err": 0.0 if mism == 0 else float("nan"), "mismatches": mism}
            if name == "components":
                row["route"] = components_route(args[6])
            check(mism == 0, f"{name} {label}: {mism} entries differ from the plain version")
        row["ms"], row["plain_ms"] = time_pair(lambda: kernel_fn(*args), lambda: plain_fn(*args))
        row.update(bound(name, args))
        log(f"3 kernel {name} {label}", **row)
        results[name] = row
    return results


# ---------------------------------------------------------------------------
# Solves
# ---------------------------------------------------------------------------

def headline_solve(g, chi2_oracle: float, reps: int):
    """Phase 4: counts, sync-free timed solves, χ² against CPU and oracle."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops

    cfg = solver.SolverConfig(**HEADLINE)
    for _ in range(2):                       # warm-up: cuBLAS/cuSOLVER handles
        solver.optimize(g, cfg)
    torch.cuda.synchronize()
    kops.reset_launches()
    _, (g2, st) = timed_solves(solver.optimize, g, cfg, reps=1)
    counts = dict(kops.launches)
    # K10: one launch before each PCG solve and two per step, 20 solves
    expected = {"linearize": 24, "hvp": 240, "chain_apply": 260, "residual_chi2": 22,
                "relax_min": 0, "cluster_labels": 0, "ransac_rigid": 0, "components": 2,
                "chain_factor": 4, "pcg": 20 * (1 + 2 * 12), "project_rays": 0,
                **{k: 0 for k in FRONTEND_KERNELS + KEYFRAME_KERNELS + MAINT_KERNELS
                   + RECOGNITION_KERNELS + REGISTRATION_KERNELS}}
    check(counts == expected, f"launch counts {counts} != {expected}")
    finals = []
    for _ in range(reps):
        t1, (g2, st) = timed_solves(solver.optimize, g, cfg, reps=1)
        finals.append((t1, float(st.chi2_history[-1])))
    t = statistics.median(f[0] for f in finals)
    hist = st.chi2_history.cpu()
    chi2_0, chi2 = float(hist[0]), float(hist[-1])
    spread = max(f[1] for f in finals) - min(f[1] for f in finals)
    _, st_cpu = solver.optimize(g.to("cpu"), cfg)
    chi2_cpu = float(st_cpu.chi2_history[-1])
    prof, names = device_profile(lambda: solver.optimize(g, cfg))
    lib_items = library_items(names)
    log("4 headline 1k", solve_ms=1e3 * t, solves_per_s=1.0 / t, chi2_0=chi2_0,
        chi2=chi2, chi2_run_to_run_spread=spread, chi2_cpu_plain=chi2_cpu,
        chi2_oracle=chi2_oracle, ratio_vs_oracle=chi2 / chi2_oracle, launches=counts,
        accepted=int(st.accepted.sum()), sync_free=True, library_items=lib_items, **prof)
    check(not lib_items, f"1k solve: library kernels in the profile: {lib_items}")
    check(abs(chi2 - chi2_cpu) <= CHI2_RTOL * chi2_cpu + 1e-6 * chi2_0,
          f"1k χ² {chi2} vs CPU plain path {chi2_cpu}")
    check(chi2 <= ORACLE_FACTOR * chi2_oracle + ORACLE_ATOL,
          f"1k χ² {chi2} vs oracle {chi2_oracle}")
    return counts


def oracle_chi2(g, **kw) -> float:
    from uzliti_slam_tpu_torch.graph import oracle, solver

    g_cpu = g.to("cpu")
    return float(solver.total_chi2(g_cpu, oracle.sparse_gn_oracle(g_cpu, **kw), 1.0))


def reference_refreshes(hist, acc, cfg) -> int:
    """The factors the reference's early-exit loop builds inside its loop
    (``solver.py:899-905``: at iteration 0 and whenever ``stale >= refresh``,
    until ``done``), replayed in float32 from a χ² history and accept flags."""
    import numpy as np

    f32 = np.float32
    refresh = max(1, min(int(cfg.precond_refresh), cfg.iterations))
    lam, stale, builds = f32(cfg.lambda_init), 0, 0
    for it in range(cfg.iterations):
        if it == 0 or stale >= refresh:
            builds, stale = builds + 1, 0
        accept, prev, new = bool(acc[it]), f32(hist[it]), f32(hist[it + 1])
        gain = (prev - new) / max(prev, f32(1e-12))
        done = ((accept and gain < f32(cfg.early_exit_tol) and lam <= f32(cfg.lambda_init))
                or (not accept and lam >= f32(cfg.lambda_max)))
        lam = f32(np.clip(lam / f32(cfg.lambda_factor) if accept
                          else lam * f32(cfg.lambda_factor), cfg.lambda_min, cfg.lambda_max))
        stale = stale + 1 if accept else refresh
        if done:
            break
    return builds


def solve_against_oracle(g, phase: str, cfg_kw: dict, chi2_oracle, reps: int,
                         profile: bool = False):
    """Phases 5-7: a warm-up solve with the counts (and K9's device count of
    factors built) set to 0 just before it and read just after; timed,
    sync-free solves; χ² against the oracle (if any).  Returns the
    warm-up's launch counts."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops

    cfg = solver.SolverConfig(**cfg_kw)
    builds = kops.factor_builds(g.device)
    builds.zero_()
    kops.reset_launches()
    _, st_w = solver.optimize(g, cfg)          # warm-up at this size
    counts = dict(kops.launches)
    built = int(builds)
    t, (g2, st) = timed_solves(solver.optimize, g, cfg, reps=reps)
    hist = st.chi2_history.cpu()
    chi2_0, chi2 = float(hist[0]), float(hist[-1])
    chi2_poses = float(solver.total_chi2(g, g2.pose, cfg.huber_delta))
    fields = dict(n_nodes=int(g.num_nodes), solve_ms=1e3 * t, solves_per_s=1.0 / t,
                  chi2_0=chi2_0, chi2=chi2, chi2_of_poses=chi2_poses,
                  accepted=int(st.accepted.sum()), launches=counts, factors_built=built,
                  components_route=components_route(g.node_capacity))
    if cfg.early_exit:
        fields["reference_refreshes"] = reference_refreshes(
            st_w.chi2_history.cpu().tolist(), st_w.accepted.cpu().tolist(), cfg)
    if chi2_oracle is not None:
        fields.update(chi2_oracle=chi2_oracle, ratio_vs_oracle=chi2 / chi2_oracle)
    names = []
    if profile:
        prof, names = device_profile(lambda: solver.optimize(g, cfg))
        fields.update(library_items=library_items(names), **prof)
    log(phase, **fields)
    check(torch.isfinite(g2.pose).all().item() and chi2 == chi2, f"{phase}: non-finite")
    check(chi2 < chi2_0, f"{phase}: χ² {chi2} not below χ²₀ {chi2_0}")
    check(not library_items(names), f"{phase}: library kernels in the profile")
    if cfg.early_exit:
        check(built == fields["reference_refreshes"],
              f"{phase}: {built} factors built, the reference builds "
              f"{fields['reference_refreshes']}")
    if chi2_oracle is not None:
        check(chi2 <= ORACLE_FACTOR * chi2_oracle + ORACLE_ATOL,
              f"{phase}: χ² {chi2} vs oracle {chi2_oracle}")
    return counts


# ---------------------------------------------------------------------------
# Epochs
# ---------------------------------------------------------------------------

def lift_sync_check_for_restart_read() -> list:
    """Let ``solver._host_decision`` (the epoch's one host read: does the
    odometry restart run its second solve?) pass under sync debug mode
    "error", and record its answers.  Every other synchronisation in a
    timed epoch still raises."""
    from uzliti_slam_tpu_torch.graph import solver

    host_decision, reads = solver._host_decision, []

    def lifted(flag):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            reads.append(host_decision(flag))
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        return reads[-1]

    solver._host_decision = lifted
    return reads


def record_lm_loops(fn):
    """Run ``fn()`` with every ``solver.lm_loop`` call's (χ² history,
    accept flags) recorded, as device tensors (nothing is read); returns
    (fn's result, the records)."""
    from uzliti_slam_tpu_torch.graph import solver

    lm_loop, records = solver.lm_loop, []

    def recorded(*args):
        out = lm_loop(*args)
        records.append((out[2], out[3]))
        return out

    solver.lm_loop = recorded
    try:
        return fn(), records
    finally:
        solver.lm_loop = lm_loop


def make_epoch_state(n: int, node_capacity: int, edge_capacity: int, radius: float, device):
    """The ``epoch_500_rgbd_laser`` graph of the JAX bench at ``n`` nodes: a
    circle with a loop closure every 5 nodes, one laser edge per consecutive
    pair entering invalid, plus one bad laser edge on a revisit (node 5 to
    the node a loop later, as ``tests/test_filter.py:181-186`` plants it).
    Returns (config, state, ground truth, the bad edge's slot)."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.config import SlamConfig
    from uzliti_slam_tpu_torch.graph import state as gstate
    from uzliti_slam_tpu_torch.io import synthetic
    from uzliti_slam_tpu_torch.ops import lie

    cfg = SlamConfig(node_capacity=node_capacity, edge_capacity=edge_capacity)
    g, gt = synthetic.make_pose_graph(
        n, loop_closure_every=5, node_capacity=node_capacity, edge_capacity=edge_capacity,
        radius=radius, generator=torch.Generator().manual_seed(SEED), device=device)
    rel = lie.pose_relative(g.pose[: n - 1], g.pose[1:n])
    info = 50.0 * torch.eye(6, device=device)
    for i in range(n - 1):
        g, _ = gstate.add_edge(g, i, i + 1, rel[i], info, etype=gstate.EDGE_TYPE_2D_LASER,
                               valid=False)
    bad = lie.make_pose(torch.tensor([4.0, -3.0, 1.0], device=device),
                        torch.tensor([1.0, 0.0, 0.0, 0.0], device=device))
    g, bad_slot = gstate.add_edge(g, 5, 5 + n // 2, bad, info,
                                  etype=gstate.EDGE_TYPE_2D_LASER, valid=False)
    state = pipeline.init_state(cfg, seed=SEED, device=device).replace(graph=g)
    return cfg, state, gt, int(bad_slot)


def timed_epochs(state, cfg, reps: int):
    """Median seconds per epoch; each runs under CUDA sync debug mode
    "error" (the restart read lifted, see lift_sync_check_for_restart_read)."""
    from uzliti_slam_tpu_torch import pipeline

    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = pipeline.optimize_epoch(state, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def epoch_phase(phase: str, built, n: int, reps: int, reads: list, cpu_check: bool) -> dict:
    """Phases 8-9: one optimize_epoch with the counts set to 0 just before
    it and read just after, and the factors K9 built in it against the
    refreshes the reference's loop makes in each of its LM solves; timed
    epochs; the filter's verdict, χ², ATE and
    uncertainty checked; with ``cpu_check``, the same epoch on CPU tensors
    through the plain path with the same RANSAC draws, and a profile."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.graph import state as gstate
    from uzliti_slam_tpu_torch.io import synthetic
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.ops import ransac

    cfg, state, gt, bad_slot = built
    timed_epochs(state, cfg, reps=1)                 # warm-up at this size
    builds = kops.factor_builds(state.graph.device)
    builds.zero_()
    kops.reset_launches()
    reads.clear()
    _, loops = record_lm_loops(lambda: timed_epochs(state, cfg, reps=1))
    counts, restart, built_factors = dict(kops.launches), list(reads), int(builds)
    # the refreshes the reference's loop makes, over each LM solve of the epoch
    ref_builds = sum(reference_refreshes(h.cpu().tolist(), a.cpu().tolist(), cfg.solver)
                     for h, a in loops)
    check(all(counts[k] > 0 for k in SOLVE_KERNELS + EPOCH_KERNELS),
          f"{phase}: a kernel was not launched: {counts}")
    check(len(restart) == 1, f"{phase}: {len(restart)} restart reads, expected 1")
    check(built_factors == ref_builds,
          f"{phase}: {built_factors} factors built, the reference builds {ref_builds}")
    t, (state2, stats) = timed_epochs(state, cfg, reps)
    g2 = state2.graph
    hist = stats.chi2_history.cpu()
    chi2_0, chi2 = float(hist[0]), float(hist[-1])
    ev, etype = g2.e_valid.cpu(), g2.e_type.cpu()
    laser = etype == gstate.EDGE_TYPE_2D_LASER
    laser[bad_slot] = False
    idx = pipeline.epoch_candidates(state.graph, cfg)[0].cpu()
    cand = idx[idx >= 0].long()
    ate = float(synthetic.ate_rmse(g2.pose[:n].cpu(), gt.cpu()))
    ate_odom = float(synthetic.ate_rmse(g2.odom_pose[:n].cpu(), gt.cpu()))
    unc = g2.uncertainty[:n].cpu()
    unc_finite = bool(torch.isfinite(unc[g2.node_valid[:n].cpu()]).all())
    fields = dict(n_nodes=n, edges=int(state.graph.num_edges), epoch_ms=1e3 * t,
                  epochs_per_s=1.0 / t, launches=counts, restart_ran=restart[0],
                  chi2_0=chi2_0, chi2=chi2, accepted=int(stats.accepted.sum()),
                  candidates=int(cand.numel()), candidates_kept=int(ev[cand].sum()),
                  bad_edge_valid=bool(ev[bad_slot]), laser_validated=int(ev[laser].sum()),
                  ate_m=ate, ate_odometry_m=ate_odom, uncertainty_finite=unc_finite,
                  uncertainty_max=float(unc.max()), sync_free_but_restart_read=True,
                  factors_built=built_factors, lm_solves=len(loops),
                  reference_refreshes=ref_builds)
    same_valid, c_gpu, c_cpu = True, 0.0, 0.0
    if cpu_check:
        member = pipeline.epoch_ransac_members(state, cfg)
        tri = ransac._valid_sample(torch.Generator(device=member.device).manual_seed(SEED + 2),
                                   cfg.filter.ransac_hypotheses, member)
        s_gpu, st_gpu = pipeline.optimize_epoch(state, cfg, tri=tri)
        s_cpu, st_cpu = pipeline.optimize_epoch(state_to(state, "cpu"), cfg, tri=tri.cpu())
        c_gpu, c_cpu = float(st_gpu.chi2_history[-1]), float(st_cpu.chi2_history[-1])
        same_valid = torch.equal(s_gpu.graph.e_valid.cpu(), s_cpu.graph.e_valid)
        fields.update(cpu_plain_same_e_valid=same_valid, chi2_injected_draws=c_gpu,
                      chi2_cpu_plain=c_cpu)
        fields.update(device_profile(lambda: pipeline.optimize_epoch(state, cfg))[0])
    log(phase, **fields)
    check(not ev[bad_slot], f"{phase}: the planted bad laser edge survived the filter")
    check(math.isfinite(chi2), f"{phase}: χ² not finite")
    check(chi2 < chi2_0, f"{phase}: χ² {chi2} not below χ²₀ {chi2_0}")
    check(bool(torch.isfinite(g2.pose).all()), f"{phase}: non-finite poses")
    check(unc_finite, f"{phase}: non-finite uncertainty on a valid node")
    if cpu_check:
        check(int(ev[laser].sum()) >= 5, f"{phase}: {int(ev[laser].sum())} laser edges validated")
        check(ate < ate_odom, f"{phase}: ATE {ate} not below odometry ATE {ate_odom}")
        check(same_valid, f"{phase}: edge validity differs from the CPU plain path")
        check(abs(c_gpu - c_cpu) <= CHI2_RTOL * abs(c_cpu) + 1e-6 * chi2_0,
              f"{phase}: χ² {c_gpu} vs CPU plain path {c_cpu}")
    return counts, state2


def state_to(state, device):
    """A SlamState with every tensor on ``device`` (a fresh generator)."""
    from uzliti_slam_tpu_torch.recognition import recognizer as rec

    return state.replace(
        graph=state.graph.to(device), generator=torch.Generator(device=device),
        scans=state.scans.to(device), scan_valid=state.scan_valid.to(device),
        gist=rec.GistBank(*(x.to(device) for x in state.gist)), desc=state.desc.to(device),
        desc_valid=state.desc_valid.to(device), points=state.points.to(device),
        last_kf_odom=state.last_kf_odom.to(device), n_keyframes=state.n_keyframes.to(device),
        last_kf_slot=state.last_kf_slot.to(device))


def timed_projection(state, cfg, grid, reps: int):
    """Median seconds of ``pipeline.project_map`` on the same inputs; each
    call under CUDA sync debug mode "error" (nothing lifted)."""
    from uzliti_slam_tpu_torch import pipeline

    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = pipeline.project_map(state, cfg, grid)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def map_phase(phase: str, state, cfg, reps: int, cpu_check: bool) -> dict:
    """The projection ``Slam.optimize`` runs after an epoch: a full rebuild
    into a fresh grid, an incremental pass after 8 nodes with scans are
    added, and a rebuild after one node drifts 1 m — the counts set to 0
    just before the sequence and read just after, each call sync-free and
    timed; with ``cpu_check``, the same sequence on CPU tensors through the
    plain path, compared grid by grid.  Returns the sequence's counts."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.kernels import ops as kops

    s_full = with_scans(state, SEED + 5)
    n0 = int(s_full.graph.num_nodes)
    steps = [("full", s_full)]
    if cpu_check:
        s_inc = add_scanned_nodes(s_full, 8)
        steps += [("incremental", s_inc), ("drift", drifted(s_inc, 10, 1.0))]
    expect_full = {"full": True, "incremental": False, "drift": True}
    kops.reset_launches()
    grids, grid = [], None
    for _, st in steps:
        _, grid = timed_projection(st, cfg, grid, reps=1)
        grids.append(grid)
    counts = dict(kops.launches)
    fields = {"launches": counts, "nodes_before": n0}
    grid_prev = None
    for (name, st), g_out in zip(steps, grids):
        full, args = map_args(st, cfg, grid_prev)
        t, again = timed_projection(st, cfg, grid_prev, reps)
        check(torch.equal(again.logodds, g_out.logodds), f"{phase} {name}: not reproducible")
        fields[name] = {"ms": 1e3 * t, "full": bool(full), "nodes_projected": int(args[6]),
                        "last_projected": int(g_out.last_projected),
                        "cells_nonzero": int((g_out.logodds != 0).sum()),
                        "finite": bool(torch.isfinite(g_out.logodds).all())}
        check(fields[name]["finite"], f"{phase} {name}: non-finite grid")
        check(bool(full) == expect_full[name], f"{phase} {name}: full rebuild is {bool(full)}")
        grid_prev = g_out
    if cpu_check:
        check(fields["incremental"]["nodes_projected"] == 8,
              f"{phase}: the incremental pass projected "
              f"{fields['incremental']['nodes_projected']} nodes, not 8")
        grid_c, worst = None, 0.0
        for (name, st), g_out in zip(steps, grids):
            grid_c = pipeline.project_map(state_to(st, "cpu"), cfg, grid_c)
            err = float((g_out.logodds.cpu() - grid_c.logodds).abs().max())
            worst = max(worst, err)
            n_diff, n_near = ternary_mismatch(g_out.logodds.cpu(), grid_c.logodds)
            fields[name].update(cpu_plain_max_abs_err=err, ternary_differ=n_diff,
                                ternary_differ_near_threshold=n_near)
            check(err <= PROJECT_ATOL, f"{phase} {name}: {err:.3g} from the CPU plain path")
            check(n_diff == n_near, f"{phase} {name}: ternary classes differ from the CPU path")
            check(torch.equal(g_out.origin.cpu(), grid_c.origin), f"{phase} {name}: origin")
            check(int(g_out.last_projected) == int(grid_c.last_projected),
                  f"{phase} {name}: last_projected")
            check(torch.equal(g_out.ref_poses.cpu(), grid_c.ref_poses), f"{phase} {name}: ref_poses")
        fields["cpu_plain_max_abs_err"] = worst
    log(phase, **fields)
    check(counts["project_rays"] == len(steps), f"{phase}: K11 launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# The keyframe front-end
# ---------------------------------------------------------------------------

def keyframe_world():
    """(world, frames) of the JAX bench's keyframe rung, as host arrays."""
    from uzliti_slam_tpu_torch.io import simulator

    kv = KEYFRAME_VGA
    world = simulator.WallWorld(img_h=kv["img_h"], img_w=kv["img_w"], f=kv["f"])
    frames = simulator.simulate_sequence(world, n_frames=kv["n_frames"],
                                         odom_drift=kv["odom_drift"], length=kv["length"])
    return world, frames


def keyframe_rig(n_cams: int, device):
    """(config, extrinsics (7,) or (2, 7)) of the 1-camera or front + rear rung."""
    from uzliti_slam_tpu_torch.config import FeatureExtractionConfig, SlamConfig
    from uzliti_slam_tpu_torch.io import simulator
    from uzliti_slam_tpu_torch.ops import lie

    cfg = SlamConfig(feats_per_node=KEYFRAME_VGA["feats"], scan_bins=KEYFRAME_VGA["scan_bins"],
                     frontend=FeatureExtractionConfig(use_depth_refinement=False))
    front = simulator.cam_extrinsic(device=device)
    if n_cams == 1:
        return cfg, front
    rear = lie.pose_compose(lie.pose2_to_pose(torch.tensor([0.0, 0.0, 3.14159], device=device)),
                            front)
    return cfg, torch.stack([front, rear])


def frame_inputs(frame: dict, n_cams: int):
    """(image, depth) host arrays of a frame, stacked once per camera."""
    import numpy as np

    if n_cams == 1:
        return frame["image"], frame["depth"]
    return np.stack([frame["image"]] * n_cams), np.stack([frame["depth"]] * n_cams)


def record_args(fn, names=FRONTEND_KERNELS):
    """Run ``fn()`` with every call's arguments of the wrappers ``names``
    (K12-K15 by default) recorded; returns {wrapper: [(args, kwargs), ...]}."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    saved = {name: getattr(kops, name) for name in names}
    calls = {name: [] for name in names}

    def recorded(name):
        def call(*args, **kw):
            calls[name].append((args, kw))
            return saved[name](*args, **kw)
        return call

    for name in names:
        setattr(kops, name, recorded(name))
    try:
        fn()
    finally:
        for name, f in saved.items():
            setattr(kops, name, f)
    return calls


def bound_calls(name: str, calls) -> dict:
    """``bound`` summed over a keyframe's calls of one kernel."""
    return bound_wrapper_calls({name: calls}, (name,))


def bound_wrapper_calls(calls: dict, wrappers) -> dict:
    """``bound`` summed over all the calls ({wrapper: [(args, kwargs)]}) of
    the wrappers named."""
    nbytes = ops = 0
    for w in wrappers:
        for args, kw in calls[w]:
            b, o = kernel_work(w, (*args, *kw.values()))
            nbytes, ops = nbytes + b, ops + o
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return {"bytes": nbytes, "ops": ops, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def frontend_library(name: str, calls):
    """One PyTorch call per kernel call that computes the same function, or
    None: K13 ``torch.topk`` over the (C·cells, cell) view of each level's
    scores (its tie order is not the reference's); K15 ``scatter_reduce_``
    with amin and amax on each scan's quantised ranges."""
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.ops import scan

    if name == "grid_topk":
        views = []
        for (score, k_total, grid), _ in calls:
            C, H, W = score.shape
            gh, gw, k_cell, _n = kops._grid_shapes(H, W, k_total, grid)
            cells = score[:, : gh * grid, : gw * grid].reshape(C, grid, gh, grid, gw)
            views.append((cells.permute(0, 1, 3, 2, 4).reshape(C * grid * grid, gh * gw)
                          .contiguous(), k_cell))
        return time_call(lambda: [torch.topk(v, k) for v, k in views])
    if name == "scan_bins":
        work = []
        for args, _ in calls:
            rng, ok, bins = kops.scan_pixels_plain(*args)
            n_bins, max_range = args[3], args[7]
            q = torch.clamp(rng * scan.range_scale(max_range), 0.0, float(scan.Q_MAX)).to(torch.int32)
            slot = torch.where(ok, bins.long(), n_bins)
            lo = torch.full((q.shape[0], n_bins + 1), 2**31 - 1, dtype=torch.int32, device=q.device)
            work.append((lo, torch.full_like(lo, -1), slot, q))

        def reduce():
            for lo, hi, slot, q in work:
                lo.scatter_reduce_(1, slot, q, "amin")
                hi.scatter_reduce_(1, slot, q, "amax")
        return time_call(reduce)
    return None


def compare_frontend(calls: dict, label: str) -> dict:
    """K12-K15 against their plain versions on the arguments one keyframe
    gives them: K12, K13 and K15 exactly; K14's angles within ANGLE_ATOL and
    its descriptors exactly given the plain version's angles (the GIST call
    takes its angle as given).  Times are per keyframe: all of the
    keyframe's calls of the kernel."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    rows = {}
    for name in FRONTEND_KERNELS:
        kernel_fn, plain_fn = getattr(kops, name), getattr(kops, f"{name}_plain")
        cl = calls[name]
        check(len(cl) > 0, f"{name} {label}: no call recorded")
        mism, ang_err = 0, 0.0
        for args, kw in cl:
            got, ref = kernel_fn(*args, **kw), plain_fn(*args, **kw)
            torch.cuda.synchronize()
            if name == "orb_describe" and "angles" not in kw:
                ang_err = max(ang_err, float((got[0] - ref[0]).abs().max()))
                got = kernel_fn(*args, angles=ref[0].contiguous())
                torch.cuda.synchronize()
            pairs = list(zip(got, ref)) if isinstance(got, tuple) else [(got, ref)]
            mism += sum(int((a != b).sum()) for a, b in pairs)
        row = {"calls": len(cl), "mismatches": mism,
               "max_abs_err": ang_err if name == "orb_describe" else (0.0 if mism == 0 else
                                                                       float("nan"))}
        if name == "orb_describe":
            row["angle_atol"] = ANGLE_ATOL

        def run(fn):
            for args, kw in cl:
                fn(*args, **kw)

        row["ms"], row["plain_ms"] = time_pair(lambda: run(kernel_fn), lambda: run(plain_fn))
        row["library_ms"] = frontend_library(name, cl)
        row.update(bound_calls(name, cl))
        log(f"3 kernel {name} {label}", **row)
        check(mism == 0, f"{name} {label}: {mism} entries differ from the plain version")
        check(ang_err <= ANGLE_ATOL, f"{name} {label}: angles {ang_err:.3g} rad apart")
        rows[name] = row
    return rows


def wall_error(scan) -> tuple[int, float]:
    """(valid bins, the largest |r·|cos θ| - 3.0| over them at each bin's
    centre bearing): the WallWorld's wall is 3 m ahead of the base (and,
    for the rear camera fed the same frame, 3 m behind)."""
    r, ang = scan.ranges, scan.angles()
    ok = torch.isfinite(r)
    err = torch.where(ok, (r * torch.cos(ang).abs() - 3.0).abs(), 0.0)
    return int(ok.sum()), float(err.max())


def frontend_against_cpu(out, cpu, n_cams: int) -> dict:
    """The card's front-end output against the plain path's on CPU tensors."""
    import numpy as np

    valid = cpu.pts_valid.numpy()
    k = out.desc.shape[0] // n_cams
    level0 = (np.arange(k) < k // 4)[None].repeat(n_cams, 0).reshape(-1) & valid
    diff = np.unpackbits(out.desc.cpu().numpy() ^ cpu.desc.numpy(), axis=-1)
    near, ref = out.scan.ranges.cpu(), cpu.scan.ranges
    far, ref_far = out.scan.far_ranges.cpu(), cpu.scan.far_ranges
    return {"same_pts_valid": bool(np.array_equal(out.pts_valid.cpu().numpy(), valid)),
            "level0_bits_differ": int(diff[level0].sum()),
            "equal_bit_share": float(1.0 - diff[valid].mean()),
            "pts_max_abs_err": float((out.pts_base.cpu() - cpu.pts_base)[torch.from_numpy(valid)]
                                     .abs().max()),
            "scan_bins_moved": int((near != ref).sum()) + int((far != ref_far).sum()),
            "gist_bits_differ": int(np.unpackbits(out.gist.cpu().numpy() ^ cpu.gist.numpy()).sum())}


def frontend_phase(phase: str, world, frames, n_cams: int, device, reps: int = 10):
    """Phase 10: ``pipeline.keyframe_frontend`` on the rung's frames: warm-up
    keyframes, then the counts set to 0 just before one keyframe and read
    just after, ``reps`` timed keyframes each under CUDA sync debug mode
    "error", a profile, and the checks.  Returns (counts, fields)."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.kernels import ops as kops

    cfg, pose = keyframe_rig(n_cams, device)
    warm = KEYFRAME_VGA["warmup"]
    inputs = [frame_inputs(fr, n_cams) for fr in frames]

    def one(i):
        return pipeline.keyframe_frontend(*inputs[i], world.cam, pose, cfg)

    for i in range(warm):
        one(i)
    torch.cuda.synchronize()
    kops.reset_launches()
    one(warm)
    torch.cuda.synchronize()
    counts = dict(kops.launches)
    times, outs = [], []
    for i in range(warm, warm + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            outs.append(one(i))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    t = statistics.median(times)
    kp_valid = min(int(o.kp_valid.sum()) for o in outs)
    walls = [wall_error(o.scan) for o in outs]
    fields = {"n_cams": n_cams, "keyframe_ms": 1e3 * t, "keyframes_per_s": 1.0 / t,
              "keyframe_ms_min": 1e3 * min(times), "keyframe_ms_max": 1e3 * max(times),
              "launches": {k: counts[k] for k in FRONTEND_KERNELS}, "sync_free": True,
              "valid_keypoints_min": kp_valid, "budget": cfg.feats_per_node,
              "scan_valid_bins_min": min(w[0] for w in walls),
              "wall_err_max_m": max(w[1] for w in walls)}
    cpu_rows = []
    for i in (0, reps - 1):
        cpu = pipeline.keyframe_frontend(*inputs[warm + i], world.cam, pose.cpu(), cfg,
                                         device="cpu")
        cpu_rows.append(frontend_against_cpu(outs[i], cpu, n_cams))
    fields["cpu_plain"] = cpu_rows
    prof, device_ms = device_profile(lambda: one(warm))
    fields.update(prof)
    # each kernel's device time in the profiled keyframe, all of its launches
    fields["kernel_device_ms"] = {
        name: sum(ms for key, ms in device_ms.items()
                  if any(f"::{f}(" in key for f in FRONTEND_DEVICE_FUNCTIONS[name]))
        for name in FRONTEND_KERNELS}
    log(phase, **fields)
    check(all(counts[k] > 0 for k in FRONTEND_KERNELS), f"{phase}: a kernel was not launched: "
          f"{counts}")
    check(kp_valid >= cfg.feats_per_node // 2, f"{phase}: {kp_valid} valid keypoints")
    check(fields["scan_valid_bins_min"] >= 30 * n_cams,
          f"{phase}: {fields['scan_valid_bins_min']} valid scan bins")
    check(fields["wall_err_max_m"] <= WALL_ATOL, f"{phase}: a scan bin lies "
          f"{fields['wall_err_max_m']:.3g} m off the wall")
    for row in cpu_rows:
        check(row["same_pts_valid"], f"{phase}: pts_valid differs from the CPU plain path")
        check(row["level0_bits_differ"] == 0, f"{phase}: level-0 descriptor bits differ")
        check(row["equal_bit_share"] >= MIN_EQUAL_BITS, f"{phase}: descriptor bits {row}")
        check(row["pts_max_abs_err"] <= PTS_ATOL, f"{phase}: points {row['pts_max_abs_err']}")
        check(row["scan_bins_moved"] <= MAX_MOVED_BINS, f"{phase}: scan {row}")
        check(row["gist_bits_differ"] <= GIST_MAX_BITS, f"{phase}: GIST {row}")
    return counts, fields


# ---------------------------------------------------------------------------
# The keyframe step and the Slam shell
# ---------------------------------------------------------------------------

def _ulps(got, ref) -> float:
    """Largest |got - ref| in units of the last place of ``ref`` (float32)."""
    ref64 = ref.double()
    ulp = torch.nextafter(ref.abs(), torch.full_like(ref, math.inf)).double() - ref.abs().double()
    return float(((got.double() - ref64).abs() / ulp).max())


def keyframe_library(name: str, calls):
    """One PyTorch call per kernel call computing the same function, or
    None: K16 ``torch.cdist(p=0)`` on the unpacked bits (the Hamming
    distances) plus ``torch.topk`` (two calls, another tie order)."""
    from uzliti_slam_tpu_torch.ops import matching

    if name != "hamming_top2":
        return None
    work = []
    for (query, bank, bank_valid, cslot, *_), _ in calls["hamming_top2"]:
        q = matching.unpack_bits(query)
        b = matching.unpack_bits(bank.index_select(0, cslot.long()))
        work.append((q[None].expand(b.shape[0], -1, -1).contiguous(), b, 2))
    for (query, bank, _stamp, _valid, _q_stamp, k, *_), _ in calls["gist_topk"]:
        work.append((matching.unpack_bits(query)[None, None], matching.unpack_bits(bank)[None], k))
    return time_call(lambda: [torch.topk(torch.cdist(a, b, p=0), k, largest=False)
                              for a, b, k in work])


def compare_keyframe_kernels(calls: dict, label: str) -> dict:
    """K16-K18 against their plain versions on the arguments one keyframe
    step gives them: K16 exactly (both entry points), K17 within
    BILATERAL_ULPS, K18's pose within ICP_POSE_ATOL, covariance within
    ICP_COV_RTOL and the same ok flag.  Times are per keyframe step."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    rows = {}
    for name in KEYFRAME_KERNELS:
        wrappers = KEYFRAME_WRAPPERS[name]
        check(all(calls[w] for w in wrappers), f"{name} {label}: no call recorded")
        mism, err, ok_same = 0, 0.0, True
        for w in wrappers:
            kernel_fn, plain_fn = getattr(kops, w), getattr(kops, f"{w}_plain")
            for args, kw in calls[w]:
                got, ref = kernel_fn(*args, **kw), plain_fn(*args, **kw)
                torch.cuda.synchronize()
                if name == "hamming_top2":
                    mism += sum(int((a != b).sum()) for a, b in zip(got, ref))
                elif name == "bilateral":
                    err = max(err, _ulps(got, ref))
                    mism += int(((got == 0) != (ref == 0)).sum())
                else:
                    ok_same &= bool(torch.equal(got[4], ref[4]))
                    err = max(err, float((got[0] - ref[0]).abs().max()))
                    cov_scale = float(ref[3].abs().max())
                    mism += int(float((got[3] - ref[3]).abs().max()) > ICP_COV_RTOL * cov_scale)
        row = {"calls": {w: len(calls[w]) for w in wrappers}, "mismatches": mism,
               "max_abs_err": float(mism) if name == "hamming_top2" else err}
        if name == "bilateral":
            row["max_ulps"], row["ulps_bound"] = err, BILATERAL_ULPS
        if name == "icp":
            row["same_ok"], row["pose_atol"] = ok_same, ICP_POSE_ATOL

        def run(fn_names, plain: bool):
            for w in fn_names:
                fn = getattr(kops, f"{w}_plain" if plain else w)
                for args, kw in calls[w]:
                    fn(*args, **kw)

        row["ms"], row["plain_ms"] = time_pair(lambda: run(wrappers, False),
                                               lambda: run(wrappers, True))
        row["library_ms"] = keyframe_library(name, calls)
        row.update(bound_wrapper_calls(calls, wrappers))
        log(f"3 kernel {name} {label}", **row)
        check(mism == 0, f"{name} {label}: {mism} entries differ from the plain version")
        if name == "bilateral":
            check(err <= BILATERAL_ULPS, f"{name} {label}: {err} ulps from the plain version")
        if name == "icp":
            check(ok_same and err <= ICP_POSE_ATOL, f"{name} {label}: pose {err}, same ok {ok_same}")
        rows[name] = row
    return rows


def step_config(n_cams: int, device, method: str = "gist", estimation: str = "feature"):
    """(config, extrinsics) of the JAX bench's keyframe rungs in the default
    configuration (``_make_slam``, bench.py:283-309): 256 features, 360 bins,
    node capacity 512, edge capacity 2048, keyframe gate 0 m / 0°,
    min_consensus 10, min_matching_score 8; place recognition by ``method``
    with its default gates, registration by ``estimation`` with its
    defaults."""
    from uzliti_slam_tpu_torch.config import (EdgeEstimationConfig, KeyframeConfig,
                                              PlaceRecognitionConfig, SlamConfig)

    _, pose = keyframe_rig(n_cams, device)
    cfg = SlamConfig(node_capacity=512, edge_capacity=2048, feats_per_node=KEYFRAME_VGA["feats"],
                     scan_bins=KEYFRAME_VGA["scan_bins"],
                     keyframe=KeyframeConfig(new_node_distance=0.0, new_node_angle_deg=0.0),
                     estimation=EdgeEstimationConfig(method=estimation, min_consensus=10,
                                                     min_matching_score=8.0),
                     recognition=PlaceRecognitionConfig(method=method))
    return cfg, pose


def slam_structure(slam) -> dict:
    """Nodes, edges and flags of a Slam's graph, on the host."""
    g = slam.state.graph
    n, ne = int(g.num_nodes), int(g.num_edges)
    return {"n": n, "ne": ne, **{k: getattr(g, k)[:ne].cpu() for k in
                                 ("e_from", "e_to", "e_type", "e_valid", "e_transform")},
            "node_valid": g.node_valid[:n].cpu(), "node_uid": g.node_uid[:n].cpu()}


def keyframe_step_phase(phase: str, world, frames, n_cams: int, device, reps: int = 10,
                        method: str = "gist", vocabulary=None, kernels: tuple = (),
                        estimation: str = "feature"):
    """Phase 11 (and 14c with another ``method``; ``vocabulary`` for "bow",
    ``kernels`` the method's own, which must launch too; and 15b with
    another ``estimation``, whose kernels replace K16's matching and K7's
    RANSAC for "gicp", K7's for "pnp"): ``Slam.add_frame``
    over the rung's 13 frames in the default configuration: 3 warm-up
    keyframes, then ``reps`` timed keyframes each under CUDA sync debug
    mode "error", the counts set to 0 just before them and read after the
    first and after the last; a profile of one more step; the same frames
    on CPU tensors through the plain path with the draws each card step
    reports in its info (RANSAC triplets or PnP keys).
    Returns (the counts of the first timed step, fields, the Slam, its frame
    inputs)."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.graph import state as gstate
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.recognition import vocabulary as voc

    cfg, pose = step_config(n_cams, device, method, estimation)
    step_kernels = (STEP_KERNELS if estimation == "feature" else
                    FRONTEND_KERNELS + ("bilateral", "icp") + ESTIMATION_KERNELS[estimation])
    warm = KEYFRAME_VGA["warmup"]
    inputs = [frame_inputs(fr, n_cams) for fr in frames]
    slam = pipeline.Slam(cfg, cam=world.cam, cam_pose=pose, device=device, vocabulary=vocabulary)
    slam.optimize_every = 10**9
    infos, times = [], []
    for i in range(warm):
        infos.append(slam.add_frame(*inputs[i], frames[i]["odom_pose"], frames[i]["stamp"]))
    torch.cuda.synchronize()
    kops.reset_launches()
    for i in range(warm, warm + reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            infos.append(slam.add_frame(*inputs[i], frames[i]["odom_pose"], frames[i]["stamp"]))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if i == warm:
            one = dict(kops.launches)
    total = dict(kops.launches)
    counts = {k: total[k] / reps for k in step_kernels + kernels}
    last = len(frames) - 1
    prof, device_ms = device_profile(lambda: pipeline.process_keyframe(
        slam.state, *inputs[last], frames[last]["odom_pose"], frames[last]["stamp"], slam.cam,
        slam.cam_pose, slam.config))
    t = statistics.median(times)
    half = len(frames) // 2
    proposed = [int(i["n_edges_proposed"]) for i in infos]
    struct = slam_structure(slam)
    lc = struct["e_type"] == gstate.EDGE_TYPE_3D_FULL
    fields = {"n_cams": n_cams, "method": method, "estimation": estimation,
              "keyframe_step_ms": 1e3 * t,
              "keyframes_per_s": 1.0 / t,
              "keyframe_step_ms_min": 1e3 * min(times), "keyframe_step_ms_max": 1e3 * max(times),
              "launches_per_step": counts, "sync_free": True,
              "candidates": [int(i["n_candidates"]) for i in infos], "proposed": proposed,
              "features_min": min(int(i["n_features"]) for i in infos), "nodes": struct["n"],
              "edges": struct["ne"], "loop_closure_edges": int(lc.sum()),
              "laser_edges": int((struct["e_type"] == gstate.EDGE_TYPE_2D_LASER).sum())}
    fields.update(prof)
    fields["kernel_device_ms"] = {
        name: sum(ms for key, ms in device_ms.items()
                  if any(f"::{f}(" in key for f in FRONTEND_DEVICE_FUNCTIONS[name]))
        for name in step_kernels + kernels}
    if estimation != "feature":
        fields["library_items"] = library_items(device_ms)
    # the same frames on CPU tensors through the plain path, with the draws
    # each card step reports (its RANSAC triplets or PnP keys)
    cpu_vocab = (None if vocabulary is None
                 else voc.Vocabulary(*(t.cpu() for t in vocabulary)))
    cpu = pipeline.Slam(cfg, cam=world.cam, cam_pose=pose.cpu(), device="cpu",
                        vocabulary=cpu_vocab)
    cpu.optimize_every = 10**9
    check(len(infos) == len(frames), f"{phase}: {len(infos)} steps for {len(frames)} frames")
    cpu_infos = [cpu.add_frame(*inputs[i], frames[i]["odom_pose"], frames[i]["stamp"],
                               **{k: infos[i][k].cpu() for k in ("tri", "pnp_keys")
                                  if k in infos[i]})
                 for i in range(len(frames))]
    ref = slam_structure(cpu)
    same = struct["n"] == ref["n"] and struct["ne"] == ref["ne"] and all(
        torch.equal(struct[k], ref[k]) for k in ("e_from", "e_to", "e_type", "e_valid", "node_valid",
                                                 "node_uid"))
    tf_err = (float((struct["e_transform"] - ref["e_transform"]).abs().max()) if same
              else float("nan"))
    fields["cpu_plain"] = {"same_structure": same, "transform_max_abs_err": tf_err,
                           "proposed": [int(i["n_edges_proposed"]) for i in cpu_infos],
                           "nodes": ref["n"], "edges": ref["ne"]}
    log(phase, **fields)
    check(all(total[k] > 0 for k in step_kernels + kernels),
          f"{phase}: a kernel was not launched: {total}")
    check(not fields.get("library_items"), f"{phase}: library kernels in the profile: "
                                           f"{fields.get('library_items')}")
    check(sum(fields["candidates"][half:]) > 0, f"{phase}: no candidate on the return leg")
    if n_cams == 1:
        # the rig's rear camera is fed the front's frame (the JAX bench's
        # rung): every descriptor has an identical twin in each stored set,
        # best = second, and Lowe's ratio test rejects every match there
        check(sum(proposed[half:]) > 0, f"{phase}: no loop closure proposed on the return leg")
        check(int(lc.sum()) > 0, f"{phase}: no loop-closure edge passed its gates")
    check(same, f"{phase}: the CPU plain path gives another graph: {fields['cpu_plain']}")
    check(tf_err <= KF_TRANSFORM_ATOL, f"{phase}: edge transforms {tf_err} apart")
    check(fields["cpu_plain"]["proposed"] == proposed, f"{phase}: proposed edges differ on the CPU")
    return one, fields, slam, inputs


def record_step_args(slam, inputs, frames) -> dict:
    """K16-K18's arguments in one late keyframe step (candidates exist):
    ``process_keyframe`` on the Slam's state with the last frame, its
    result discarded."""
    from uzliti_slam_tpu_torch import pipeline

    last = len(frames) - 1
    names = tuple(w for k in KEYFRAME_KERNELS for w in KEYFRAME_WRAPPERS[k])
    return record_args(lambda: pipeline.process_keyframe(
        slam.state, *inputs[last], frames[last]["odom_pose"], frames[last]["stamp"], slam.cam,
        slam.cam_pose, slam.config), names)


def ate_run(device, seed: int = 0) -> dict:
    """The JAX bench's ATE rung through the port's Slam on ``device`` with
    RANSAC draws from ``seed``: keyframes gated at 0.2 m, an epoch every 8
    keyframes, a final epoch; ATE of SLAM and of the raw odometry against
    ground truth, and the wall time of the run."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.config import EdgeEstimationConfig, KeyframeConfig, SlamConfig
    from uzliti_slam_tpu_torch.io import simulator, synthetic

    device = torch.device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    a = ATE_RUN
    cfg = SlamConfig(node_capacity=a["node_capacity"], edge_capacity=a["edge_capacity"],
                     feats_per_node=a["feats"], scan_bins=a["scan_bins"],
                     keyframe=KeyframeConfig(new_node_distance=a["gate"]),
                     estimation=EdgeEstimationConfig(min_consensus=8, min_matching_score=6.0))
    world = simulator.WallWorld(img_h=a["img_h"], img_w=a["img_w"])
    frames = simulator.simulate_sequence(world, n_frames=a["n_frames"], odom_drift=a["odom_drift"],
                                         length=a["length"])
    sync()
    t0 = time.perf_counter()
    slam = pipeline.Slam(cfg, cam=world.cam, cam_pose=simulator.cam_extrinsic(device=device),
                         seed=seed, device=device)
    slam.optimize_every = a["optimize_every"]
    for fr in frames:
        slam.add_frame(fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"])
    slam.optimize()
    poses, valid = slam.trajectory()
    sync()
    wall = time.perf_counter() - t0
    v = valid.cpu()
    stamps = slam.state.graph.stamp[: v.shape[0]].cpu()[v].long().tolist()
    gt = torch.from_numpy(np.stack([frames[s]["gt_pose"] for s in stamps]))
    odom = torch.from_numpy(np.stack([frames[s]["odom_pose"] for s in stamps]))
    g = slam.state.graph
    ne = int(g.num_edges)
    return {"seed": seed, "wall_s": wall, "keyframes": len(stamps), "edges": ne,
            "valid_loop_closures": int((g.e_valid[:ne] & (g.e_type[:ne] == 1)).sum()),
            "ate_slam_m": float(synthetic.ate_rmse(poses.cpu()[v], gt)),
            "ate_odometry_m": float(synthetic.ate_rmse(odom, gt))}


def ate_phase(phase: str, device) -> dict:
    """Phase 12: the ATE rung on the card, once for each of ATE_SEEDS; each
    run's ATE below the raw odometry's and at most ATE_BAR_M."""
    runs = [ate_run(device, seed) for seed in ATE_SEEDS]
    fields = {**runs[0], "ate_slam_m_by_seed": [r["ate_slam_m"] for r in runs],
              "wall_s_by_seed": [r["wall_s"] for r in runs], "ate_bar_m": ATE_BAR_M,
              "ate_jax_cpu_max_m": ATE_JAX_CPU_MAX_M}
    log(phase, **fields)
    for r in runs:
        ate, ate_odom = r["ate_slam_m"], r["ate_odometry_m"]
        check(ate < ate_odom, f"{phase}: seed {r['seed']}: ATE {ate} not below odometry's {ate_odom}")
        check(ate <= ATE_BAR_M, f"{phase}: seed {r['seed']}: ATE {ate} above the bar {ATE_BAR_M}")
    return fields


# ---------------------------------------------------------------------------
# Maintenance and calibration timers (phase 13; K19, K20, K15's bin_min_max)
# ---------------------------------------------------------------------------

def with_payload(state, seed: int):
    """``state`` with scans (``with_scans``) and, on its valid nodes, half of
    the descriptor slots filled with random bytes and 3-D points drawn with
    numpy: payloads for the merge to fold together."""
    st = with_scans(state, seed)
    rng = np.random.default_rng(seed + 1)
    n, f = st.desc.shape[:2]
    dev = st.graph.device
    nv = st.graph.node_valid[:, None]
    return st.replace(
        desc=torch.from_numpy(rng.integers(0, 256, (n, f, 32), dtype=np.uint8)).to(dev),
        desc_valid=torch.from_numpy(rng.random((n, f)) < 0.5).to(dev) & nv,
        points=torch.from_numpy(rng.normal(size=(n, f, 3)).astype(np.float32)).to(dev))


def merge_config(cfg):
    """``cfg`` in the global role: node merging with the default gates
    (0.25 m, 15°, a 6 m margin)."""
    import dataclasses

    from uzliti_slam_tpu_torch.config import ScopeConfig

    return dataclasses.replace(cfg, scope=ScopeConfig(merge_nodes=True))


def far_center(device):
    return torch.tensor(FAR_CENTER, device=device)


def maintenance_calls(state, cfg) -> dict:
    """K19's and bin_min_max's arguments in one global-role maintenance epoch
    of ``state`` (``record_args``)."""
    from uzliti_slam_tpu_torch import pipeline

    return record_args(lambda: pipeline.maintenance_epoch(
        state, merge_config(cfg), center=far_center(state.graph.device)),
        ("merge_pairs", "bin_min_max"))


def calib_graphs(device):
    """(graph with its poses at the truth, ground truth) of CALIB_1K's
    biased-odometry problem."""
    from uzliti_slam_tpu_torch.io import synthetic

    c = CALIB_1K
    g, gt = synthetic.biased_odometry_graph(c["p_true"], c["n"], node_capacity=c["node_capacity"],
                                            edge_capacity=c["edge_capacity"], device=device)
    return g.replace(pose=torch.cat([gt, g.pose[c["n"]:]])), gt


def calib_slam(g, cam_pose, device):
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.config import SlamConfig

    c = CALIB_1K
    slam = pipeline.Slam(SlamConfig(node_capacity=c["node_capacity"],
                                    edge_capacity=c["edge_capacity"], project_map=False),
                         cam_pose=cam_pose, device=device)
    slam.state = slam.state.replace(graph=g)
    return slam


def calibration_calls(g, n_cams: int, device) -> dict:
    """K20's arguments in ``Slam.calibrate`` on ``g``: one camera (odometry
    factors, the main path), or the front + rear rig with
    ``update_extrinsics=True`` (the loop closures become sensor factors of
    camera 0: 15 parameters)."""
    _, pose = keyframe_rig(n_cams, device)
    slam = calib_slam(g, pose, device)
    return record_args(lambda: slam.calibrate(update_extrinsics=n_cams > 1), ("calib_gn",))


def maintenance_library(name: str, calls):
    """One PyTorch call per kernel call computing the same function, or
    None: bin_min_max ``scatter_reduce_`` with amin and amax on each scan's
    quantised ranges (the plain version's reduction)."""
    from uzliti_slam_tpu_torch.ops import scan

    if name != "bin_min_max":
        return None
    work = []
    for (rng, ok, bins, n_bins, max_range), _ in calls:
        q = torch.clamp(rng * scan.range_scale(max_range), 0.0, float(scan.Q_MAX)).to(torch.int32)
        slot = torch.where(ok, bins.long(), n_bins)
        lo = torch.full(q.shape[:-1] + (n_bins + 1,), 2**31 - 1, dtype=torch.int32, device=q.device)
        work.append((lo, torch.full_like(lo, -1), slot, q))

    def reduce():
        for lo, hi, slot, q in work:
            lo.scatter_reduce_(-1, slot, q, "amin")
            hi.scatter_reduce_(-1, slot, q, "amax")
    return time_call(reduce)


def compare_maintenance_kernels(calls: dict, label: str, trials: int = 7, calls_per: int = 2):
    """K19, K20 and bin_min_max against their plain versions on the
    arguments the main path gives them: K19 and bin_min_max exactly, K20's
    θ within CALIB_THETA_ATOL and cost history within CALIB_HIST_RTOL."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    rows = {}
    for name in MAINT_KERNELS:
        cl = calls.get(name, [])
        if not cl:
            continue
        kernel_fn, plain_fn = getattr(kops, name), getattr(kops, f"{name}_plain")
        mism, err, hist_rel = 0, 0.0, 0.0
        for args, kw in cl:
            got, ref = kernel_fn(*args, **kw), plain_fn(*args, **kw)
            torch.cuda.synchronize()
            if name == "calib_gn":
                err = max(err, float((got[0] - ref[0]).abs().max()))
                hist_rel = max(hist_rel, float(((got[1] - ref[1]).abs()
                                                / ref[1].abs().clamp(min=1e-30)).max()))
                mism += int(not bool(torch.isfinite(got[0]).all()))
            else:
                mism += sum(int((a != b).sum()) for a, b in zip(got, ref))
        row = {"calls": len(cl), "mismatches": mism,
               "max_abs_err": err if name == "calib_gn" else (0.0 if mism == 0 else float("nan"))}
        if name == "calib_gn":
            row.update(theta_atol=CALIB_THETA_ATOL, cost_history_max_rel_err=hist_rel,
                       cost_history_rtol=CALIB_HIST_RTOL, parameters=6 * cl[0][0][7].shape[0] + 3)

        def run(fn):
            for args, kw in cl:
                fn(*args, **kw)

        # the plain calibration is 20 dense jacfwd steps (~2 s): one trial,
        # warmed by the comparison above
        slow = name == "calib_gn"
        row["ms"], row["plain_ms"] = time_pair(lambda: run(kernel_fn), lambda: run(plain_fn),
                                               trials=1 if slow else trials,
                                               calls=1 if slow else calls_per, warm=not slow)
        row["library_ms"] = maintenance_library(name, cl)
        row.update(bound_calls(name, cl))
        log(f"3 kernel {name} {label}", **row)
        check(mism == 0, f"{name} {label}: {mism} entries differ from the plain version")
        if name == "calib_gn":
            check(err <= CALIB_THETA_ATOL and hist_rel <= CALIB_HIST_RTOL,
                  f"{name} {label}: θ {err:.3g}, cost history {hist_rel:.3g} from the plain version")
        rows[name] = row
    return rows


def timed_sync_free(fn, reps: int):
    """(median seconds, the last result) of ``reps`` calls of ``fn``, each
    under CUDA sync debug mode "error" and synchronised at both ends."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


def edges_consistent(g) -> bool:
    """Every valid edge joins two valid nodes and is no self-loop."""
    ev = g.e_valid
    ef, et = g.e_from.long()[ev], g.e_to.long()[ev]
    return bool(g.node_valid[ef].all() and g.node_valid[et].all() and (ef != et).all())


def merge_phase(phase: str, state, cfg, reps: int = 5):
    """13a: the global role at 500 nodes on phase 8's state after its epoch
    (scans and descriptors added): one ``maintenance_epoch`` with the robot
    100 m away, the counts set to 0 just before it and read just after,
    sync-free and timed; 16 merges; the same maintenance on CPU tensors;
    consistent edges; an epoch after it.  Returns (counts, fields)."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.ops import scan

    dev = state.graph.device
    mcfg, center = merge_config(cfg), far_center(dev)
    state = with_payload(state, SEED + 11)

    def one():
        return pipeline.maintenance_epoch(state, mcfg, center=center)

    one()
    torch.cuda.synchronize()
    kops.reset_launches()
    _, (out, info) = timed_sync_free(one, 1)
    counts = dict(kops.launches)
    t, _ = timed_sync_free(one, reps)
    merged = int(info["merged"])
    g = out.graph
    cpu, info_c = pipeline.maintenance_epoch(state_to(state, "cpu"), mcfg, center=center.cpu())
    gc = cpu.graph
    exact = {k: bool(torch.equal(getattr(g, k).cpu(), getattr(gc, k)))
             for k in ("node_valid", "e_valid", "e_from", "e_to", "merged_into")}
    exact.update({k: bool(torch.equal(getattr(out, k).cpu(), getattr(cpu, k)))
                  for k in ("desc", "desc_valid", "scan_valid")})
    pose_err = max(float((g.pose.cpu() - gc.pose).abs().max()),
                   float((g.e_transform.cpu() - gc.e_transform).abs().max()),
                   float((out.points.cpu() - cpu.points).abs().max()))
    # scans compared in 21-bit quanta (a range is q · fl(1/scale))
    sc, sr = out.scans.cpu(), cpu.scans
    fin = torch.isfinite(sr)
    scale = scan.range_scale(6.0)
    scan_quanta = (int((torch.round(sc[fin] * scale) - torch.round(sr[fin] * scale)).abs().max())
                   if bool(torch.equal(torch.isfinite(sc), fin)) else -1)
    s2, stats = pipeline.optimize_epoch(out, cfg)
    hist = stats.chi2_history.cpu()
    fields = {"n_nodes": int(state.graph.node_valid.sum()), "merged": merged,
              "merged_cpu_plain": int(info_c["merged"]), "live_after": int(g.node_valid.sum()),
              "maintain_ms": 1e3 * t, "sync_free": True,
              "launches": {k: counts[k] for k in ("merge_pairs", "bin_min_max")},
              "cpu_plain_exact": exact, "cpu_plain_pose_points_max_abs_err": pose_err,
              "cpu_plain_scan_max_quanta": scan_quanta,
              "edges_consistent": edges_consistent(g), "epoch_after_chi2_0": float(hist[0]),
              "epoch_after_chi2": float(hist[-1])}
    fields.update(device_profile(one)[0])
    log(phase, **fields)
    check(counts["merge_pairs"] > 0 and counts["bin_min_max"] > 0,
          f"{phase}: a kernel was not launched: {counts}")
    check(merged == 16, f"{phase}: {merged} merges, expected 16")
    check(int(info_c["merged"]) == merged and all(exact.values()),
          f"{phase}: the CPU plain path merges otherwise: {exact}")
    check(pose_err <= MERGE_POSE_ATOL, f"{phase}: poses / points {pose_err} from the CPU path")
    check(0 <= scan_quanta <= 1, f"{phase}: scans {scan_quanta} quanta from the CPU path")
    check(fields["edges_consistent"], f"{phase}: a valid edge touches a dead node or loops")
    check(math.isfinite(fields["epoch_after_chi2"]) and hist[-1] < hist[0],
          f"{phase}: the epoch after merging: χ² {hist[0]} -> {hist[-1]}")
    return counts, fields


def merge_10k_phase(phase: str, state) -> dict:
    """13b: K19 on phase 9's 10k-node state after its epoch (every node
    eligible: ~5·10⁷ pair tests), exactly its plain version's pairs."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    calls = maintenance_calls(state, state_cfg(state))["merge_pairs"]
    args, _ = calls[0]
    got, ref = kops.merge_pairs(*args), kops.merge_pairs_plain(*args)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, ref))
    t = time_call(lambda: kops.merge_pairs(*args), trials=5, calls=2)
    fields = {"n_nodes": int(args[2].sum()), "pairs": int(got[2].sum()), "same_as_plain": same,
              "kernel_ms": t, **bound("merge_pairs", args)}
    log(phase, **fields)
    check(same, f"{phase}: K19 differs from its plain version")
    check(fields["pairs"] == 16, f"{phase}: {fields['pairs']} pairs")
    return fields


def state_cfg(state):
    from uzliti_slam_tpu_torch.config import SlamConfig

    return SlamConfig(node_capacity=state.graph.node_capacity,
                      edge_capacity=state.graph.edge_capacity)


def long_run_phase(phase: str, device) -> dict:
    """13c: tests/test_lifecycle.py's bounded-scope run through ``Slam`` on
    the card: 520 frames, ``maintain()`` every 20 frames in the local role;
    the capacity tier, compactions, the live window, no keyframe dropped,
    then a projection (a full rebuild: compaction dropped the grid) and a
    finite final optimize.  ms per maintain, and per compacting maintain."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.config import (EdgeEstimationConfig, KeyframeConfig,
                                              PlaceRecognitionConfig, ScopeConfig, SlamConfig)
    from uzliti_slam_tpu_torch.io import simulator
    from uzliti_slam_tpu_torch.kernels import ops as kops

    lr = LONG_RUN
    cfg = SlamConfig(node_capacity=lr["node_capacity"], edge_capacity=lr["edge_capacity"],
                     feats_per_node=lr["feats"], scan_bins=lr["scan_bins"],
                     keyframe=KeyframeConfig(new_node_distance=0.0, new_node_angle_deg=0.0,
                                             distance_closure_radius=1.0),
                     recognition=PlaceRecognitionConfig(k_candidates=2),
                     estimation=EdgeEstimationConfig(ransac_hypotheses=32),
                     scope=ScopeConfig(is_sub_graph=True, scope_size_min=8.0))
    world = simulator.WallWorld(img_h=lr["img_h"], img_w=lr["img_w"], f=lr["f"])
    slam = pipeline.Slam(cfg, cam=world.cam, cam_pose=simulator.cam_extrinsic(device=device),
                         device=device)
    slam.optimize_every = 10**9
    maintain_ms, compact_ms, live = [], [], []
    t_run = time.perf_counter()
    for i in range(lr["frames"]):
        ty = i * lr["step"]
        img, dep = world.render(0.0, ty % 30.0)
        odom = np.array([0.0, ty, 0.0, 1.0, 0.0, 0.0, 0.0], np.float32)
        slam.add_frame(img, dep, odom, float(i) * 0.2)
        if (i + 1) % lr["maintain_every"] == 0:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            info = slam.maintain()
            torch.cuda.synchronize()
            dt = 1e3 * (time.perf_counter() - t0)
            (compact_ms if info["compact_perm"] is not None else maintain_ms).append(dt)
            live.append(int(slam.state.graph.node_valid.sum()))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t_run
    kops.reset_launches()
    grid = slam.project_map()
    torch.cuda.synchronize()
    projected = kops.launches["project_rays"]
    stats = slam.optimize()
    g = slam.state.graph
    chi2 = float(stats.chi2_history[-1])
    fields = {"frames": lr["frames"], "run_s": run_s, "node_capacity": slam.config.node_capacity,
              "edge_capacity": slam.config.edge_capacity, "compactions": len(compact_ms),
              "maintains": len(maintain_ms) + len(compact_ms),
              "maintain_ms_median": statistics.median(maintain_ms) if maintain_ms else None,
              "compacting_maintain_ms_median": statistics.median(compact_ms) if compact_ms else None,
              "live_max": max(live), "live_final": int(g.node_valid.sum()),
              "num_nodes": int(g.num_nodes), "keyframes": slam._n_kf_host,
              "project_rays_after_compaction": projected,
              "grid_finite": bool(torch.isfinite(grid.logodds).all()), "final_chi2": chi2}
    log(phase, **fields)
    check(slam.config.node_capacity == lr["node_capacity"]
          and slam.config.edge_capacity == lr["edge_capacity"], f"{phase}: the capacity tier grew")
    check(len(compact_ms) >= 3, f"{phase}: {len(compact_ms)} compactions")
    check(int(g.num_nodes) <= lr["node_capacity"] and fields["live_final"] <= 60,
          f"{phase}: {fields['live_final']} live nodes")
    check(slam._n_kf_host == lr["frames"], f"{phase}: keyframes dropped")
    check(projected == 1 and fields["grid_finite"], f"{phase}: projection after compaction")
    check(math.isfinite(chi2), f"{phase}: final χ² not finite")
    return fields


def reregistration_phase(phase: str, slam) -> tuple[dict, dict]:
    """13d: ``Slam.reregister_scans`` on phase 11's one-camera VGA Slam: the
    counts set to 0 just before it and read after (K18 once, on a batch of
    4), sync-free; laser edges added, invalid until validated; K18 against
    its plain version on the card on these arguments; the same call on CPU
    tensors adds the same edges (endpoints, types, flags)."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.graph import state as gstate
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.ops import lie

    before = slam.state
    ne = int(before.graph.num_edges)
    cpu, n_cpu = pipeline.scan_reregistration(state_to(before, "cpu"), slam.config)
    kops.reset_launches()
    calls = record_args(lambda: timed_sync_free(slam.reregister_scans, 1), ("icp",))
    counts = dict(kops.launches)
    g = slam.state.graph
    n = int(g.num_edges) - ne
    new = slice(ne, ne + n)
    batch = int(calls["icp"][0][0][0].shape[0]) if calls["icp"] else 0
    same = (n == int(n_cpu) and all(bool(torch.equal(getattr(g, k)[:ne + n].cpu(),
                                                     getattr(cpu.graph, k)[:ne + n]))
                                    for k in ("e_from", "e_to", "e_type", "e_valid")))
    # K18 against its plain version on the card, on these arguments
    args, kw = calls["icp"][0]
    got, ref = kops.icp(*args, **kw), kops.icp_plain(*args, **kw)
    kernel_err = float((got[0] - ref[0]).abs().max())
    kernel_same_ok = bool(torch.equal(got[4], ref[4]))
    # the WallWorld's scans are one straight wall (normals along the base's
    # x): point-to-line ICP does not observe the translation along it, whose
    # update is rounding noise over the 1e-9 damping, so the CPU's transforms
    # differ along the wall (and, through the edge's inversion, in x); they
    # are reported, not held
    d2 = (lie.pose_to_pose2(g.e_transform[new].cpu())
          - lie.pose_to_pose2(cpu.graph.e_transform[new])).abs()
    fields = {"edges_added": n, "edges_added_cpu_plain": int(n_cpu), "icp_batch": batch,
              "launches": {"icp": counts["icp"]}, "sync_free": True,
              "new_edges_laser": bool((g.e_type[new] == gstate.EDGE_TYPE_2D_LASER).all()),
              "new_edges_invalid": not bool(g.e_valid[new].any()),
              "icp_kernel_pose_max_abs_err": kernel_err, "icp_kernel_same_ok": kernel_same_ok,
              "cpu_plain_same_edges": same,
              "cpu_plain_pose2_max_abs_err": d2.max(0).values.tolist() if n else []}
    log(phase, **fields)
    check(n >= 1, f"{phase}: no laser edge added")
    check(fields["new_edges_laser"] and fields["new_edges_invalid"], f"{phase}: new edges {fields}")
    check(counts["icp"] == 1 and batch == 4, f"{phase}: K18 launches {counts['icp']}, batch {batch}")
    check(kernel_same_ok and kernel_err <= ICP_POSE_ATOL, f"{phase}: K18 against its plain "
          f"version: pose {kernel_err}, same ok {kernel_same_ok}")
    check(same, f"{phase}: the CPU plain path adds other edges: {fields}")
    return counts, fields


def calibration_phase(phase: str, device, reps: int = 5) -> tuple[dict, dict]:
    """13e: ``Slam.calibrate`` on CALIB_1K's graph with its poses at the
    truth, the counts set to 0 just before it and read after, sync-free and
    timed: p recovered within 2e-2.  Then the solves a robot runs around
    it: ``optimize`` without the drift model (its poses drift to fit the
    biased odometry), and, from those poses, ``optimize`` with
    ``use_odometry_calibration`` and the calibrated p: χ² below 0.2x the
    uncalibrated one, a lower ATE, the same solve on CPU tensors.  (From
    the raw odometry itself neither solve converges at 1k nodes in 15
    iterations: the drifted start is ~2.7 m off.)"""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.io import synthetic
    from uzliti_slam_tpu_torch.kernels import ops as kops

    at_truth, gt = calib_graphs(device)
    slam = calib_slam(at_truth, None, device)
    slam.calibrate()
    torch.cuda.synchronize()
    kops.reset_launches()
    _, res = timed_sync_free(slam.calibrate, 1)
    counts = dict(kops.launches)
    t, _ = timed_sync_free(slam.calibrate, reps)
    p = res.odom_params.cpu()
    p_true = torch.tensor(CALIB_1K["p_true"])
    n = CALIB_1K["n"]
    on = solver.SolverConfig(iterations=15, use_odometry_calibration=True)
    g_off, st_off = solver.optimize(at_truth, solver.SolverConfig(iterations=15))
    start = at_truth.replace(pose=g_off.pose, odom_params=res.odom_params)
    g_on, st_on = solver.optimize(start, on)
    _, st_cpu = solver.optimize(start.to("cpu"), on)
    c_on, c_off = float(st_on.chi2_history[-1]), float(st_off.chi2_history[-1])
    c_cpu, c0 = float(st_cpu.chi2_history[-1]), float(st_on.chi2_history[0])
    ate_on = float(synthetic.ate_rmse(g_on.pose[:n].cpu(), gt.cpu()))
    ate_off = float(synthetic.ate_rmse(g_off.pose[:n].cpu(), gt.cpu()))
    fields = {"n_nodes": n, "edges": int(at_truth.num_edges), "calibrate_ms": 1e3 * t,
              "sync_free": True, "launches": {"calib_gn": counts["calib_gn"]},
              "odom_params": p.tolist(), "p_true": p_true.tolist(),
              "cost_history_first_last": [float(res.cost_history[0]),
                                          float(res.cost_history[-1])],
              "chi2_calibrated": c_on, "chi2_uncalibrated": c_off, "chi2_cpu_plain": c_cpu,
              "ate_calibrated_m": ate_on, "ate_uncalibrated_m": ate_off,
              "raw_measurements_kept": bool(torch.equal(g_on.e_transform, start.e_transform))}
    log(phase, **fields)
    check(counts["calib_gn"] == 1, f"{phase}: K20 launches {counts['calib_gn']}")
    check(float((p - p_true).abs().max()) <= 2e-2, f"{phase}: p {p.tolist()}")
    check(c_on < 0.2 * c_off, f"{phase}: χ² {c_on} not below 0.2 x {c_off}")
    check(ate_on < ate_off, f"{phase}: ATE {ate_on} not below {ate_off}")
    check(abs(c_on - c_cpu) <= CHI2_RTOL * abs(c_cpu) + 1e-6 * c0,
          f"{phase}: χ² {c_on} vs CPU plain path {c_cpu}")
    check(fields["raw_measurements_kept"], f"{phase}: the raw measurements were rewritten")
    return counts, fields


# ---------------------------------------------------------------------------
# Phase 14: the feature-set, repository and bag-of-words recognizers
# ---------------------------------------------------------------------------

def _rand_u8(shape, g, device):
    return torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8)


def _flip_bits(desc, p, g):
    """``desc`` with about a fraction ``p`` of its bytes' one random bit
    flipped (one bit in each chosen byte)."""
    hit = torch.rand(desc.shape, generator=g, device=desc.device) < p
    bit = torch.randint(0, 8, desc.shape, generator=g, device=desc.device, dtype=torch.uint8)
    return desc ^ (hit.to(torch.uint8) << bit)


def feature_bank_inputs(n: int, device, seed: int, F: int = 128) -> tuple:
    """``feature_votes``' arguments on a synthetic n-node bank: each node's F
    descriptors are one of 64 places' with ~3 % of the bytes one bit off,
    10 % invalid, stamps 0..n-1; the query is place 7's with its own
    noise, at stamp n + 10; k 5 and the default gates."""
    g = torch.Generator(device=device).manual_seed(seed)
    places = _rand_u8((64, F, 32), g, device)
    bank = _flip_bits(places[torch.randint(0, 64, (n,), generator=g, device=device)], 0.03, g)
    bank_valid = torch.rand(n, F, generator=g, device=device) > 0.1
    stamp = torch.arange(n, device=device, dtype=torch.float32)
    query = _flip_bits(places[7], 0.03, g)
    return (query, torch.ones(F, dtype=torch.bool, device=device), bank, bank_valid, stamp,
            torch.ones(n, dtype=torch.bool, device=device),
            torch.full((), float(n + 10), device=device), 5, 40.0, 0.2, 5.0)


def repository_inputs(n: int, device, seed: int, F: int = 128, L: int = 8) -> tuple:
    """(``repo_nearest``'s, ``repo_votes``') arguments on a synthetic
    repository of D = 32·n descriptors (90 % filled) with L links each (half
    valid, random nodes): the query is 64 stored descriptors with ~3 % of
    their bytes one bit off and 64 random ones."""
    g = torch.Generator(device=device).manual_seed(seed)
    D = 32 * n
    bank = _rand_u8((D, 32), g, device)
    bank_valid = torch.arange(D, device=device) < int(0.9 * D)
    links = torch.randint(0, n, (D, L), generator=g, device=device, dtype=torch.int32)
    link_valid = torch.rand(D, L, generator=g, device=device) < 0.5
    pick = torch.randint(0, int(0.9 * D), (F // 2,), generator=g, device=device)
    query = torch.cat([_flip_bits(bank[pick], 0.03, g), _rand_u8((F - F // 2, 32), g, device)])
    qvalid = torch.ones(F, dtype=torch.bool, device=device)
    stamp = torch.arange(n, device=device, dtype=torch.float32)
    q_stamp = torch.full((), float(n + 10), device=device)
    return ((query, qvalid, bank, bank_valid, 40.0),
            (query, qvalid, bank, bank_valid, links, link_valid, stamp,
             torch.ones(n, dtype=torch.bool, device=device), q_stamp, 5, 40.0, 5.0, 5.0))


def bow_inputs(n: int, device, seed: int, K: int = 256) -> tuple:
    """``bow_query``'s arguments on a synthetic n-node bank: sparse
    L1-normalised rows (~15 % of the words), the query row 3's with half
    its mass moved, k 5 and the default gates."""
    g = torch.Generator(device=device).manual_seed(seed)
    bank = torch.rand(n, K, generator=g, device=device) * (
        torch.rand(n, K, generator=g, device=device) < 0.15)
    bank = bank / torch.clamp(bank.sum(-1, keepdim=True), min=1e-12)
    q = 0.5 * bank[3] + 0.5 * bank[min(4, n - 1)]
    return (bank, torch.arange(n, device=device, dtype=torch.float32),
            torch.ones(n, dtype=torch.bool, device=device), q,
            torch.full((), float(n + 10), device=device), 5, 0.05, 5.0)


def word_inputs(m: int, device, seed: int, K: int = 256) -> tuple:
    """(``word_assign``'s, ``word_majority``'s) arguments on m clustered
    descriptors (K random prototypes, ~6 % of each member's bytes one bit
    off, 5 % invalid), the words the first K descriptors."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    g = torch.Generator(device=device).manual_seed(seed)
    protos = _rand_u8((K, 32), g, device)
    desc = _flip_bits(protos[torch.randint(0, K, (m,), generator=g, device=device)], 0.06, g)
    valid = torch.rand(m, generator=g, device=device) > 0.05
    centers = desc[:K].contiguous()
    word, _, counts = kops.word_assign_plain(desc, valid, centers)
    return (desc, valid, centers), (desc, valid, word, counts)


def _recognition_mismatches(wrapper: str, args, got, ref) -> tuple[int, float]:
    """(entries of a wrapper's outputs that differ from its plain
    version's, max |score difference|): exact for K21-K23; K24's scores
    within BOW_SCORE_ATOL, its slots equal unless the kernel's slot scores
    within BOW_NEAR_TIE of the plain version's (a near-tie) and its flags
    equal unless the score lies within BOW_SCORE_ATOL of min_score."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    if wrapper != "bow_query":
        return sum(int((a != b).sum()) for a, b in zip(got, ref)), 0.0
    bank, stamp, valid, q, q_stamp, k, min_score, min_dt = args
    (gs, gv, go), (rs, rv, ro) = got, ref
    full = kops.bow_scores_plain(bank, stamp, valid, q, q_stamp, min_dt)
    near = (full[gs.long()] - rv).abs() <= BOW_NEAR_TIE
    flag_near = (rv - min_score).abs() <= BOW_SCORE_ATOL
    mism = int(((gs != rs) & ~near).sum()) + int(((go != ro) & ~flag_near).sum())
    return mism, float((gv - rv).abs().max())


def compare_recognition_kernels(calls: dict, label: str, trials: int = 21,
                                calls_per: int = 10) -> dict:
    """K21-K24 against their plain versions on recorded or generated
    arguments (``calls``: {wrapper: [(args, kwargs), ...]}): K21-K23
    exactly, K24 by ``_recognition_mismatches`` within BOW_SCORE_ATOL;
    times over all the calls of a kernel's wrappers, its library call
    (K24: ``torch.cdist(p=1)``; the others have none) and its bound."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    rows = {}
    for name in RECOGNITION_KERNELS:
        wrappers = [w for w in RECOGNITION_WRAPPERS[name] if calls.get(w)]
        check(bool(wrappers), f"{name} {label}: no call recorded")
        mism, err = 0, 0.0
        for w in wrappers:
            for args, kw in calls[w]:
                got = getattr(kops, w)(*args, **kw)
                ref = getattr(kops, f"{w}_plain")(*args, **kw)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                m, e = _recognition_mismatches(w, (*args, *kw.values()), got, ref)
                mism, err = mism + m, max(err, e)

        def run(plain: bool):
            for w in wrappers:
                fn = getattr(kops, f"{w}_plain" if plain else w)
                for args, kw in calls[w]:
                    fn(*args, **kw)

        row = {"calls": {w: len(calls[w]) for w in wrappers}, "mismatches": mism,
               "max_abs_err": err if name == "bow_query" else float(mism)}
        row["ms"], row["plain_ms"] = time_pair(lambda: run(False), lambda: run(True),
                                               trials=trials, calls=calls_per)
        row["library_ms"] = None
        if name == "bow_query":
            work = [(a[3][None], a[0]) for a, _ in calls["bow_query"]]
            row["library_ms"] = time_call(lambda: [torch.cdist(q, b, p=1) for q, b in work],
                                          trials=trials, calls=calls_per)
        row.update(bound_wrapper_calls(calls, wrappers))
        log(f"14a kernel {name} {label}", **row)
        check(mism == 0, f"{name} {label}: {mism} entries differ from the plain version")
        check(err <= BOW_SCORE_ATOL, f"{name} {label}: scores {err} from the plain version")
        rows[name] = row
    return rows


def recognition_large_calls(device) -> dict:
    """The large shapes of the table: K21 at 10k nodes, K22 at D = 320k
    (10k nodes), K23 at M = 100k clustered descriptors and K = 256, K24 at
    10k nodes."""
    nearest, votes = repository_inputs(10_000, device, SEED + 21)
    assign, majority = word_inputs(100_000, device, SEED + 22)
    return {"feature_votes": [(feature_bank_inputs(10_000, device, SEED + 20), {})],
            "repo_nearest": [(nearest, {})], "repo_votes": [(votes, {})],
            "word_assign": [(assign, {})], "word_majority": [(majority, {})],
            "bow_query": [(bow_inputs(10_000, device, SEED + 23), {})]}


def recognition_cost_phase(phase: str, device) -> dict:
    """14b: each recognizer's kernels per query on synthetic banks of 1k,
    10k and 50k nodes (CUDA events), the bank's bytes on the card, and the
    bytes of the distance matrix the JAX form materialises for one query
    (float32, computed from the shapes); the 1k banks held against the
    plain versions."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    rows = []
    (query_w, *_), _ = word_inputs(1024, device, SEED + 30)
    centers = query_w[:256].contiguous()
    for n in RECOGNITION_SIZES:
        fv = feature_bank_inputs(n, device, SEED + n)
        nearest, votes = repository_inputs(n, device, SEED + n + 1)
        bq = bow_inputs(n, device, SEED + n + 2)
        q128, v128 = fv[0], fv[1]
        if n == RECOGNITION_SIZES[0]:
            for w, args in (("feature_votes", fv), ("repo_nearest", nearest),
                            ("repo_votes", votes), ("bow_query", bq)):
                m, e = _recognition_mismatches(w, args, getattr(kops, w)(*args),
                                               getattr(kops, f"{w}_plain")(*args))
                check(m == 0 and e <= BOW_SCORE_ATOL, f"{phase}: {w} at {n} nodes: {m}, {e}")
        row = {
            "nodes": n,
            "feature_set": {"feature_votes_ms": time_call(lambda: kops.feature_votes(*fv), 7, 3),
                            "bank_bytes": _nbytes(*fv[2:6]),
                            "reference_distance_bytes": 4 * 128 * n * 128},
            "repository": {"repo_votes_ms": time_call(lambda: kops.repo_votes(*votes), 7, 3),
                           "repo_nearest_ms": time_call(lambda: kops.repo_nearest(*nearest), 7, 3),
                           "bank_bytes": _nbytes(*votes[2:8]) + 4,
                           "reference_distance_bytes": 2 * 4 * 128 * 32 * n},
            "bow": {"bow_query_ms": time_call(lambda: kops.bow_query(*bq), 7, 3),
                    "word_assign_ms": time_call(lambda: kops.word_assign(q128, v128, centers),
                                                7, 3),
                    "bank_bytes": _nbytes(*bq[:3])},
        }
        rows.append(row)
        del fv, nearest, votes, bq
        torch.cuda.empty_cache()
    log(phase, sizes=rows)
    return {"sizes": rows}


def build_step_vocabulary(world, frames, device) -> tuple:
    """A 256-word vocabulary built on the card (K23) from the descriptors of
    valid keypoints of every frame of the VGA sequence (one camera), the
    counts set to 0 just before and read just after.  Returns (vocabulary,
    fields, the last word_majority call's arguments)."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.recognition import vocabulary as voc

    cfg, pose = step_config(1, device, "bow")
    outs = [pipeline.keyframe_frontend(*frame_inputs(fr, 1), world.cam, pose, cfg)
            for fr in frames]
    desc = torch.cat([o.desc for o in outs])
    valid = torch.cat([o.kp_valid.reshape(-1) for o in outs])
    gen = torch.Generator(device=device).manual_seed(SEED)
    torch.cuda.synchronize()
    kops.reset_launches()
    t0 = time.perf_counter()
    built = []
    calls = record_args(lambda: built.append(voc.build_vocabulary(desc, valid, k=256,
                                                                  generator=gen)),
                        ("word_majority",))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = kops.launches["bow_words"]
    vocab, (args, _) = built[0], calls["word_majority"][-1]
    fields = {"descriptors": int(desc.shape[0]), "valid": int(valid.sum()), "words": 256,
              "build_s": seconds, "bow_words_launches": launches,
              "words_used": int((kops.word_assign(desc, valid, vocab.centers)[2] > 0).sum())}
    check(launches > 0 and bool(torch.isfinite(vocab.idf).all()), f"vocabulary: {fields}")
    return vocab, fields, args


def pr_world():
    """(world, frames) of tests/test_pr_methods.py: 30 frames at 96x128."""
    from uzliti_slam_tpu_torch.io import simulator

    pr = PR_RUN
    world = simulator.WallWorld(img_h=pr["img_h"], img_w=pr["img_w"])
    return world, simulator.simulate_sequence(world, n_frames=pr["n_frames"],
                                              odom_drift=pr["odom_drift"], length=pr["length"])


def pr_run(method: str, world, frames, device, vocabulary=None) -> dict:
    """14d: tests/test_pr_methods.py's run (its ``_cfg`` and gates) through
    the port's Slam on the card, the counts set to 0 just before it and
    read just after."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.config import (EdgeEstimationConfig, KeyframeConfig,
                                              PlaceRecognitionConfig, SlamConfig)
    from uzliti_slam_tpu_torch.io import simulator
    from uzliti_slam_tpu_torch.kernels import ops as kops

    cfg = SlamConfig(node_capacity=64, edge_capacity=256, feats_per_node=96, scan_bins=180,
                     keyframe=KeyframeConfig(new_node_distance=0.25),
                     estimation=EdgeEstimationConfig(min_consensus=10, min_matching_score=8.0),
                     recognition=PlaceRecognitionConfig(method=method, **PR_GATES[method]))
    slam = pipeline.Slam(cfg, cam=world.cam, cam_pose=simulator.cam_extrinsic(device=device),
                         device=device, vocabulary=vocabulary)
    slam.optimize_every = 10**9
    torch.cuda.synchronize()
    kops.reset_launches()
    infos = [i for i in (slam.add_frame(fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"])
                         for fr in frames) if i is not None]
    torch.cuda.synchronize()
    counts = dict(kops.launches)
    proposed = sum(int(i["n_edges_proposed"]) for i in infos)
    fields = {"method": method, "keyframes": len(infos), "proposed": proposed,
              "launches": {k: counts[k] for k in METHOD_KERNELS[method]}}
    check(all(counts[k] > 0 for k in METHOD_KERNELS[method]),
          f"14d {method}: a kernel was not launched: {counts}")
    check(proposed >= 3, f"14d {method}: {proposed} proposed edges, tests/test_pr_methods.py "
                         "asserts >= 3")
    return fields


def pr_vocabulary(frames, device):
    """tests/test_pr_methods.py's vocabulary, built on the card: 64 words,
    6 rounds, from the descriptors of every sixth frame (96 keypoints)."""
    from uzliti_slam_tpu_torch.ops import features
    from uzliti_slam_tpu_torch.recognition import vocabulary as voc

    descs = [features.detect_and_describe(
        torch.from_numpy(fr["image"]).to(device, torch.float32)[None], max_keypoints=96)[1]
        .reshape(-1, 32) for fr in frames[::6]]
    return voc.build_vocabulary(torch.cat(descs), k=64, iterations=6,
                                generator=torch.Generator(device=device).manual_seed(SEED))


def recognition_phase(world, frames, device) -> tuple[dict, dict, dict]:
    """Phase 14: (c) the keyframe step through ``Slam.add_frame`` per method
    at VGA, 1 camera (phase 11's sequence and settings; for "bow" a
    256-word vocabulary built on the card first), with the method's kernels'
    arguments in a late step recorded; (a) K21-K24 against their plain
    versions on those arguments and at the large shapes; (b) the cost at
    1k, 10k and 50k nodes; (d) tests/test_pr_methods.py's run per method.
    Returns (main rows, large rows, fields)."""
    from uzliti_slam_tpu_torch import pipeline

    vocab, vocab_fields, majority_args = build_step_vocabulary(world, frames, device)
    steps, recorded = {}, {"word_majority": [(majority_args, {})]}
    last = len(frames) - 1
    for method in ("feature_set", "repository", "bow"):
        one, fields, slam, inputs = keyframe_step_phase(
            f"14c keyframe step VGA 1 camera {method}", world, frames, 1, device,
            method=method, vocabulary=vocab if method == "bow" else None,
            kernels=METHOD_KERNELS[method])
        fields["launches_first_step"] = {k: one[k] for k in METHOD_KERNELS[method]}
        steps[method] = fields
        names = tuple(w for k in METHOD_KERNELS[method] for w in RECOGNITION_WRAPPERS[k]
                      if w != "word_majority")
        recorded.update(record_args(lambda: pipeline.process_keyframe(
            slam.state, *inputs[last], frames[last]["odom_pose"], frames[last]["stamp"],
            slam.cam, slam.cam_pose, slam.config), names))
        del slam
    rows = compare_recognition_kernels(recorded, "VGA step")
    rows_large = compare_recognition_kernels(recognition_large_calls(device), "large",
                                             trials=5, calls_per=2)
    cost = recognition_cost_phase("14b recognition cost 1k 10k 50k", device)
    pr_w, pr_frames = pr_world()
    pr_vocab = pr_vocabulary(pr_frames, device)
    proposals = {m: pr_run(m, pr_w, pr_frames, device, pr_vocab if m == "bow" else None)
                 for m in ("feature_set", "repository", "bow")}
    log("14d proposals 96x128", **proposals)
    return rows, rows_large, {"vocabulary": vocab_fields, "steps": steps, "cost": cost,
                              "proposals": proposals}


# ---------------------------------------------------------------------------
# Phase 15: the gicp and pnp registration estimators (K25-K28)
# ---------------------------------------------------------------------------

def _pose_err(a, b):
    """Per pose, the largest difference of (t, q) with q up to sign; 0 where
    both sides are non-finite, inf where one is."""
    dt = (a[..., :3] - b[..., :3]).abs().amax(-1)
    dq = torch.minimum((a[..., 3:] - b[..., 3:]).abs().amax(-1),
                       (a[..., 3:] + b[..., 3:]).abs().amax(-1))
    bad_a, bad_b = ~torch.isfinite(a).all(-1), ~torch.isfinite(b).all(-1)
    err = torch.nan_to_num(torch.maximum(dt, dq), nan=math.inf)
    return torch.where(bad_a & bad_b, 0.0, torch.where(bad_a | bad_b, math.inf, err))


def _hypothesis_mismatch(args, got, ref) -> tuple[int, float, dict]:
    """K28's hypotheses against the plain version's, family by family (see
    PNP_HYP_MEDIAN)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    X, xn, valid, depth, _ = args
    samples = ref[0]
    mism = int((got[0] != samples).sum())
    if mism:
        return mism, 0.0, {"draws_differ": mism}
    B, H, _ = samples.shape
    drawn = kops.pnp_pick(valid, samples).all(-1)
    err = _pose_err(got[1], ref[1]).reshape(B, -1, H)
    fams = {"dlt": drawn, "homography": drawn}
    if depth is not None:
        measured = kops.pnp_pick(valid & (depth > 0.05), samples).sum(-1)
        fams["kabsch"] = drawn & (measured >= 3)
    detail, worst = {}, 0.0
    for f, (fam, used) in enumerate(fams.items()):
        ef = err[:, f]
        far = used & (ef > PNP_HYP_MAX)
        named = torch.zeros_like(far)
        if fam == "dlt" and bool(far.any()):
            b, h = far.nonzero(as_tuple=True)
            s = samples[b, h][:, None]
            A = kops.dlt_system_plain(kops.pnp_pick(X[b], s)[:, 0], kops.pnp_pick(xn[b], s)[:, 0],
                                      kops.pnp_pick(valid[b], s)[:, 0].float())
            sv = torch.linalg.svdvals(A.cpu()).to(far.device)
            named[b, h] = sv[:, -2] <= DLT_NULL_RATIO * sv[:, 0]
        held = ef[used & ~named]
        med = float(held.median()) if held.numel() else 0.0
        mx = float(held.max()) if held.numel() else 0.0
        beyond = int((far & ~named).sum())
        detail[fam] = {"draws": int(used.sum()), "median": med, "max": mx,
                       "named_degenerate": int(named.sum()), "beyond_max": beyond}
        mism += beyond + int(med > PNP_HYP_MEDIAN)
        worst = max(worst, mx)
    return mism, worst, detail


def _registration_mismatch(wrapper: str, args, got, ref) -> tuple[int, float, dict]:
    """(entries that differ beyond their tolerance, max error, details) of
    one call of a K25-K28 wrapper against its plain version (see
    NORMAL_DOT_TOL)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    if wrapper == "voxel_grid":
        return sum(int((a.nan_to_num(-7.0) != b.nan_to_num(-7.0)).sum())
                   for a, b in zip(got, ref)), 0.0, {}
    if wrapper == "knn_normals":
        points, valid = args[:2]
        ev = torch.linalg.eigvalsh(kops.knn_covariance_plain(points, valid).double())
        apart = (ev[..., 1] - ev[..., 0]) >= EIG_GAP * ev[..., 2]
        off = (1.0 - (got * ref).sum(-1).abs())[apart & valid]
        err = float(off.max()) if off.numel() else 0.0
        return int((off > NORMAL_DOT_TOL).sum()), err, {}
    if wrapper == "gicp":
        err = float((got[0] - ref[0]).abs().max())
        return int((got[3] != ref[3]).sum()) + int(err > GICP_POSE_ATOL), err, {}
    if wrapper == "pnp_hypotheses":
        return _hypothesis_mismatch(args, got, ref)
    # pnp_refine: the pose and mse where the plain version's result is ok,
    # the ones the step uses
    ok = ref[3]
    perr = _pose_err(got[0], ref[0])
    err = float(perr[ok].max()) if bool(ok.any()) else 0.0
    rel = ((got[2] - ref[2]).abs() / ref[2].abs().clamp(min=PNP_MSE_FLOOR))[ok]
    mse_rel = float(rel.max()) if rel.numel() else 0.0
    mism = sum(int((a != b).sum()) for a, b in zip(got[1:], ref[1:]) if a.dtype != torch.float32)
    free = [{"candidate": b, "pose_err": float(perr[b]), "ok": bool(ok[b]),
             "ok_kernel": bool(got[3][b]), "consensus": int(ref[1][b]), "best": int(ref[4][b]),
             "best_count": int(ref[5][b, ref[4][b]])}
            for b in (~ok & (perr > PNP_POSE_ATOL)).nonzero()[:, 0].tolist()]
    return (mism + int(err > PNP_POSE_ATOL) + int(mse_rel > PNP_MSE_RTOL), err,
            {"mse_rel_err": mse_rel, "ok": int(ok.sum()), "failed_poses_differing": free})


def compare_registration_kernels(calls: dict, label: str, trials: int = 5,
                                 calls_per: int = 2) -> dict:
    """K25-K28 against their plain versions on recorded or generated
    arguments ({wrapper: [(args, kwargs), ...]}), by
    ``_registration_mismatch``; times over all the calls of a kernel's
    wrappers and the bound.  No single PyTorch call computes any of these
    functions (library_ms None)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    rows = {}
    for name in REGISTRATION_KERNELS:
        wrappers = REGISTRATION_WRAPPERS[name]
        check(all(calls.get(w) for w in wrappers), f"{name} {label}: no call recorded")
        mism, err, details = 0, 0.0, {}
        for w in wrappers:
            for c, (args, kw) in enumerate(calls[w]):
                got, ref = getattr(kops, w)(*args, **kw), getattr(kops, f"{w}_plain")(*args, **kw)
                torch.cuda.synchronize()
                got = got if isinstance(got, tuple) else (got,)
                ref = ref if isinstance(ref, tuple) else (ref,)
                m, e, d = _registration_mismatch(w, args, got[0] if w == "knn_normals" else got,
                                                 ref[0] if w == "knn_normals" else ref)
                mism, err = mism + m, max(err, e)
                if d:
                    details[f"{w}[{c}]"] = d

        def run(plain: bool):
            for w in wrappers:
                fn = getattr(kops, f"{w}_plain" if plain else w)
                for args, kw in calls[w]:
                    fn(*args, **kw)

        row = {"calls": {w: len(calls[w]) for w in wrappers}, "mismatches": mism,
               "max_abs_err": err, **({"checks": details} if details else {})}
        # K28's plain version takes ~1.5 s a call (tens of thousands of small
        # tensor operations): fewer trials of it
        few = name == "pnp"
        row["ms"], row["plain_ms"] = time_pair(lambda: run(False), lambda: run(True),
                                               trials=min(trials, 3) if few else trials,
                                               calls=1 if few else calls_per)
        row["library_ms"] = None
        row.update(bound_wrapper_calls(calls, wrappers))
        log(f"15a kernel {name} {label}", **row)
        check(mism == 0, f"{name} {label}: {mism} entries differ from the plain version "
                         f"(max error {err})")
        rows[name] = row
    return rows


def registration_large_calls(world, frames, device) -> dict:
    """The large shapes: K25 on the front + rear rig's 614,400 pixels into
    V = 1024; K26 and K27 on ten V = 1024 clouds of the sequence against the
    eleventh; K28 on ten synthetic non-planar problems of M = 512
    correspondences (a quarter outliers, measured depth) with 256 draws
    (768 hypotheses)."""
    import dataclasses

    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.config import f32
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.ops import lie, pnp

    def cfg_1024(n_cams):
        cfg, pose = step_config(n_cams, device, estimation="gicp")
        return dataclasses.replace(cfg, estimation=dataclasses.replace(
            cfg.estimation, gicp_max_voxels=1024)), pose

    cfg2, pose2 = cfg_1024(2)
    calls = record_args(lambda: pipeline.keyframe_frontend(
        *frame_inputs(frames[0], 2), world.cam, pose2, cfg2), ("voxel_grid",))
    cfg1, pose1 = cfg_1024(1)
    clouds = [pipeline.keyframe_frontend(*frame_inputs(fr, 1), world.cam, pose1, cfg1).cloud
              for fr in frames[:11]]
    dst = [torch.stack([c[i] for c in clouds[:10]]).contiguous() for i in range(3)]
    normals = kops.knn_normals(dst[0], dst[2])
    calls["knn_normals"] = [((dst[0], dst[2]), {})]
    calls["gicp"] = [((*clouds[10], dst[0], dst[1], dst[2], normals,
                       lie.pose_identity((10,), device), 20, f32(0.2 ** 2), f32(0.002), f32(0.3),
                       1.0, f32(math.pi / 6)), {})]
    g = torch.Generator().manual_seed(SEED + 30)
    B, M, H = 10, 512, 256
    T = lie.se3_exp(torch.tensor([0.2, -0.1, 0.3, 0.1, -0.15, 0.2]))
    X = torch.cat([torch.rand(B, M, 2, generator=g) * 4 - 2,
                   torch.rand(B, M, 1, generator=g) * 5 + 3], -1)
    Xc = lie.pose_apply(T, X)
    xn = Xc[..., :2] / Xc[..., 2:] + 0.001 * torch.randn(B, M, 2, generator=g)
    xn[:, 3 * M // 4:] += 0.2 * torch.randn(B, M // 4, 2, generator=g)
    valid = torch.rand(B, M, generator=g) > 0.1
    args = [t.to(device).contiguous() for t in (X, xn, valid, Xc[..., 2])]
    keys = torch.rand(B, H, M, generator=g).to(device)
    samples, poses = kops.pnp_hypotheses(*args, keys)
    thresh2, f_mean2 = pnp.thresholds(525.0, 525.0, 3.0)
    calls["pnp_hypotheses"] = [((*args, keys), {})]
    calls["pnp_refine"] = [((*args, samples, poses, thresh2, f32(0.04), 10.0, 8, f_mean2), {})]
    return calls


def estimation_run(method: str, device) -> dict:
    """15c: tests/test_estimation_methods.py's run_method (24 frames at
    96x128, its config) through the port's Slam on the card, held to that
    test's bars; the counts set to 0 just before it and read just after."""
    import numpy as np

    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.config import EdgeEstimationConfig, KeyframeConfig, SlamConfig
    from uzliti_slam_tpu_torch.graph import state as gstate
    from uzliti_slam_tpu_torch.io import simulator, synthetic
    from uzliti_slam_tpu_torch.kernels import ops as kops

    er = EST_RUN
    extra = {"gicp_max_voxels": 192} if method == "gicp" else {}
    cfg = SlamConfig(node_capacity=64, edge_capacity=256, feats_per_node=96, scan_bins=180,
                     keyframe=KeyframeConfig(new_node_distance=0.25),
                     estimation=EdgeEstimationConfig(method=method, min_consensus=10,
                                                     min_matching_score=8.0, **extra))
    world = simulator.WallWorld(img_h=er["img_h"], img_w=er["img_w"])
    frames = simulator.simulate_sequence(world, n_frames=er["n_frames"],
                                         odom_drift=er["odom_drift"], length=er["length"])
    slam = pipeline.Slam(cfg, cam=world.cam, cam_pose=simulator.cam_extrinsic(device=device),
                         device=device)
    slam.optimize_every = 12
    torch.cuda.synchronize()
    kops.reset_launches()
    for fr in frames:
        slam.add_frame(fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"])
    slam.optimize()
    torch.cuda.synchronize()
    counts = dict(kops.launches)
    g = slam.state.graph
    n, ne = int(g.num_nodes), int(g.num_edges)
    stamps = g.stamp[:n].cpu().numpy().astype(int)
    gt = torch.from_numpy(np.stack([frames[s]["gt_pose"] for s in stamps]))
    odo = torch.from_numpy(np.stack([frames[s]["odom_pose"] for s in stamps]))
    ate = float(synthetic.ate_rmse(g.pose[:n].cpu(), gt))
    ate_odo = float(synthetic.ate_rmse(odo, gt))
    lc = g.e_type[:ne].cpu() == gstate.EDGE_TYPE_3D_FULL
    validated = int(g.e_valid[:ne].cpu()[lc].sum())
    fields = {"method": method, "nodes": n, "closures": int(lc.sum()), "validated": validated,
              "ate_m": ate, "ate_odometry_m": ate_odo,
              "launches": {k: counts[k] for k in ESTIMATION_KERNELS[method]}}
    if method == "gicp":
        fields["nodes_with_cloud"] = int(slam.state.cloud_valid.any(-1).sum())
    log(f"15c {method} run 96x128", **fields)
    check(all(counts[k] > 0 for k in ESTIMATION_KERNELS[method]),
          f"15c {method}: a kernel was not launched: {counts}")
    check(fields["closures"] >= 3 and validated >= 1,
          f"15c {method}: {fields['closures']} closures, {validated} validated")
    check(ate <= ate_odo + 1e-6, f"15c {method}: ATE {ate} above odometry's {ate_odo}")
    if method == "pnp":
        check(ate < 0.2, f"15c pnp: ATE {ate} m")
    else:
        check(fields["nodes_with_cloud"] >= 10, f"15c gicp: {fields['nodes_with_cloud']} clouds")
    return fields


def estimation_phase(world, frames, device) -> tuple[dict, dict, dict]:
    """Phase 15: (b) the keyframe step of phase 11 (VGA, 1 camera, the same
    frames and settings) with ``estimation.method`` "pnp" and "gicp", and
    "gicp" on the front + rear rig, each sync-free, its kernels launched, no
    library kernel in its profile and the same graph on CPU tensors with
    the card's draws; (a) K25-K28 against their plain versions on a late
    step's arguments and at the large shapes; (c) the reference's
    24-frame run per method.  Returns (main rows, large rows, fields)."""
    from uzliti_slam_tpu_torch import pipeline

    steps, recorded = {}, {}
    last = len(frames) - 1
    for est in ("pnp", "gicp"):
        one, fields, slam, inputs = keyframe_step_phase(
            f"15b keyframe step VGA 1 camera {est}", world, frames, 1, device, estimation=est)
        fields["launches_first_step"] = {k: one[k] for k in ESTIMATION_KERNELS[est]}
        steps[est] = fields
        names = tuple(w for k in ESTIMATION_KERNELS[est] if k in REGISTRATION_WRAPPERS
                      for w in REGISTRATION_WRAPPERS[k])
        recorded.update(record_args(lambda: pipeline.process_keyframe(
            slam.state, *inputs[last], frames[last]["odom_pose"], frames[last]["stamp"],
            slam.cam, slam.cam_pose, slam.config), names))
        del slam
    _, steps["gicp_rig"], slam, _ = keyframe_step_phase(
        "15b keyframe step VGA front + rear gicp", world, frames, 2, device, estimation="gicp")
    del slam
    rows = compare_registration_kernels(recorded, "VGA step")
    rows_large = compare_registration_kernels(registration_large_calls(world, frames, device),
                                              "large", trials=3, calls_per=1)
    runs = {m: estimation_run(m, device) for m in ("pnp", "gicp")}
    return rows, rows_large, {"steps": steps, "runs": runs}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.config import SlamConfig
    from uzliti_slam_tpu_torch.io import synthetic
    from uzliti_slam_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log("1 env", torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
        python=sys.version.split()[0], card=smi)

    t0 = time.perf_counter()
    _build.load()
    ptxas = _build.BUILD_DIR / f"ptxas_{_build.source_hash()}.log"
    log("2 build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.last_build_seconds,
        library=str(_build.library_path().relative_to(_build.BUILD_DIR.parents[1])),
        ptxas=ptxas_summary(ptxas.read_text()) if ptxas.exists() else "no log (prebuilt)")
    reads = lift_sync_check_for_restart_read()
    t0 = time.perf_counter()
    built500 = make_epoch_state(**EPOCH_500, device=dev)
    built10k = make_epoch_state(**EPOCH_10K, device=dev)
    torch.cuda.synchronize()
    log("2 epoch graphs", seconds=time.perf_counter() - t0,
        edges_500=int(built500[1].graph.num_edges), edges_10k=int(built10k[1].graph.num_edges))
    t0 = time.perf_counter()
    kf_world, kf_frames = keyframe_world()
    log("2 keyframe frames", seconds=time.perf_counter() - t0, frames=len(kf_frames),
        shape=list(kf_frames[0]["image"].shape))

    g1k = make_graph(1000, dev)
    g100k = make_graph(100_000, dev)
    rows = compare_kernels(g1k, "1k")
    rows_large = compare_kernels(g100k, "100k")
    rows.update(compare_epoch_kernels(epoch_kernel_inputs(built500[1], built500[0]),
                                      "epoch 500"))
    rows_large.update(compare_epoch_kernels(epoch_kernel_inputs(built10k[1], built10k[0]),
                                            "epoch 10k"))
    # K8's grid route, which the 100k solve takes (the epochs take the CTA route)
    check(components_route(g100k.node_capacity) == "grid", "100k solve: K8 not on its grid route")
    grid = compare_epoch_kernels({"components": components_inputs(g100k)},
                                 "100k solve")["components"]
    # K11 on what the projection after the 500-node epoch gives it (a full
    # rebuild, then 8 new nodes), and on a 10k-node full rebuild of a graph
    # that lies on the grid
    cfg500 = built500[0]
    s500 = with_scans(built500[1], SEED + 5)
    full, args_full = map_args(s500, cfg500, None)
    check(bool(full), "500-node map: the first projection is not a full rebuild")
    rows["project_rays"] = compare_project(args_full, "500 full", large=False)
    _, args_inc = map_args(add_scanned_nodes(s500, 8), cfg500, pipeline.project_map(s500, cfg500))
    check(int(args_inc[6]) == 8, "500-node map: the incremental pass is not over 8 nodes")
    row_inc = compare_project(args_inc, "500 incremental 8", large=False)
    cfg_map10k = SlamConfig(node_capacity=10240, edge_capacity=16384)
    s10k_map = with_scans(pipeline.init_state(cfg_map10k, seed=SEED, device=dev).replace(
        graph=synthetic.make_pose_graph(
            10_000, node_capacity=10240, edge_capacity=16384, radius=2.0,
            generator=torch.Generator().manual_seed(SEED), device=dev)[0]), SEED + 7)
    rows_large["project_rays"] = compare_project(map_args(s10k_map, cfg_map10k, None)[1],
                                                 "10k full", large=True, trials=3, calls=2)
    del s10k_map
    # K12-K15 on the arguments the first VGA keyframe gives them (one camera:
    # the main shapes; the front + rear rig: the large ones)
    for n_cams, target in ((1, rows), (2, rows_large)):
        cfg_kf, pose = keyframe_rig(n_cams, dev)
        calls = record_args(lambda: pipeline.keyframe_frontend(
            *frame_inputs(kf_frames[0], n_cams), kf_world.cam, pose, cfg_kf))
        target.update(compare_frontend(calls, f"VGA {n_cams} camera{'s' if n_cams > 1 else ''}"))

    # K19 and bin_min_max on the arguments a global-role maintenance of the
    # 500-node and 10k-node epoch states gives them (scans and descriptors
    # added); K20 on those Slam.calibrate gives it on the 1k-node biased
    # odometry graph, one camera (6 + 3 parameters) and the rig updating the
    # extrinsics (12 + 3)
    cal_graph = calib_graphs(dev)[0]
    rows.update(compare_maintenance_kernels(
        {**maintenance_calls(with_payload(built500[1], SEED + 11), built500[0]),
         **calibration_calls(cal_graph, 1, dev)}, "main"))
    rows_large.update(compare_maintenance_kernels(
        {**maintenance_calls(with_payload(built10k[1], SEED + 12), built10k[0]),
         **calibration_calls(cal_graph, 2, dev)}, "large", trials=3, calls_per=1))
    del cal_graph

    chi2_oracle_1k = oracle_chi2(g1k, iters=12)
    launches = headline_solve(g1k, chi2_oracle_1k, reps=10)
    solve_against_oracle(g1k, "5 default early-exit 1k", {}, chi2_oracle_1k, reps=5,
                         profile=True)
    g10k = make_graph(10_000, dev)
    solve_against_oracle(g10k, "6 headline 10k", HEADLINE,
                         oracle_chi2(g10k, iters=20, lm=True), reps=3)
    counts100k = solve_against_oracle(g100k, "7 headline 100k", HEADLINE, None, reps=3)
    check(counts100k["components"] > 0, "7 headline 100k: K8's grid route was not launched")
    del g10k, g100k

    counts500, state500 = epoch_phase("8 epoch 500", built500, EPOCH_500["n"], reps=5,
                                      reads=reads, cpu_check=True)
    map500 = map_phase("8 map 500", state500, cfg500, reps=5, cpu_check=True)
    counts10k, state10k = epoch_phase("9 epoch 10k", built10k, EPOCH_10K["n"], reps=3,
                                      reads=reads, cpu_check=False)
    map10k = map_phase("9 map 10k", state10k, built10k[0], reps=3, cpu_check=False)
    del built10k
    kf1, kf1_fields = frontend_phase("10 keyframe front-end VGA 1 camera", kf_world, kf_frames, 1,
                                     dev)
    kf2, kf2_fields = frontend_phase("10 keyframe front-end VGA front + rear", kf_world, kf_frames,
                                     2, dev)
    # the keyframe step through Slam.add_frame in the default configuration,
    # then K16-K18 against their plain versions on a late step's arguments
    step1, step1_fields, slam1, inputs1 = keyframe_step_phase(
        "11 keyframe step VGA 1 camera", kf_world, kf_frames, 1, dev)
    step2, step2_fields, slam2, inputs2 = keyframe_step_phase(
        "11 keyframe step VGA front + rear", kf_world, kf_frames, 2, dev)
    rows.update(compare_keyframe_kernels(record_step_args(slam1, inputs1, kf_frames),
                                         "VGA step 1 camera"))
    rows_large.update(compare_keyframe_kernels(record_step_args(slam2, inputs2, kf_frames),
                                               "VGA step front + rear"))
    del slam2
    ate = ate_phase("12 end to end ATE 96x128", dev)
    # phase 13: the maintenance and calibration timers, each path driven
    # with the counts set to 0 just before it and read just after
    maint500, merge_fields = merge_phase("13a maintain 500 global role", state500, cfg500)
    merge10k = merge_10k_phase("13b K19 10k", state10k)
    del state10k
    long_run = long_run_phase("13c bounded scope 520 frames", dev)
    rereg, rereg_fields = reregistration_phase("13d re-registration VGA 1 camera", slam1)
    del slam1
    calib, calib_fields = calibration_phase("13e calibration 1k", dev)
    # phase 14: the other place recognizers, each method's keyframe step
    # driven with the counts set to 0 just before it and read just after
    rec_rows, rec_rows_large, rec_fields = recognition_phase(kf_world, kf_frames, dev)
    # phase 15: the gicp and pnp estimators, each method's keyframe step
    # driven with the counts set to 0 just before it and read just after
    est_rows, est_rows_large, est_fields = estimation_phase(kf_world, kf_frames, dev)
    # each kernel's main path: the 1k solve for K1-K4, K9, K10; the 500-node
    # epoch for K5-K8; the projection sequence after it for K11; the first
    # timed keyframe step (phase 11, 1 camera) for K12-K18
    launches.update({name: counts500[name] for name in EPOCH_KERNELS})
    launches.update({name: map500[name] for name in MAP_KERNELS})
    launches.update({name: step1[name] for name in FRONTEND_KERNELS + KEYFRAME_KERNELS})
    # K19 and bin_min_max: one maintain (13a); K20: one calibrate (13e)
    launches.update(merge_pairs=maint500["merge_pairs"], bin_min_max=maint500["bin_min_max"],
                    calib_gn=calib["calib_gn"])
    shapes = {**{k: ("1k solve", "100k solve") for k in SOLVE_KERNELS},
              **{k: ("500-node epoch", "10k-node epoch") for k in EPOCH_KERNELS},
              "project_rays": ("500-node full rebuild", "10k-node full rebuild"),
              **{k: ("VGA keyframe, 1 camera", "VGA keyframe, front + rear rig")
                 for k in FRONTEND_KERNELS},
              **{k: ("VGA keyframe step, 1 camera", "VGA keyframe step, front + rear rig")
                 for k in KEYFRAME_KERNELS},
              "merge_pairs": ("500-node maintain", "10k-node maintain"),
              "bin_min_max": ("500-node maintain: 16 merged scans",
                              "10k-node maintain: 16 merged scans"),
              "calib_gn": ("1k-node calibrate, 1 camera (9 parameters)",
                           "1k-node calibrate, front + rear rig with extrinsics (15 parameters)")}

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
         "launches": launches[name], "launches_epoch_500": counts500[name],
         "launches_epoch_10k": counts10k[name], "launches_map_500": map500[name],
         "launches_map_10k": map10k[name], "launches_keyframe_1cam": kf1.get(name, 0),
         "launches_keyframe_2cam": kf2.get(name, 0),
         "launches_step_1cam": step1_fields["launches_per_step"].get(name, 0),
         "launches_step_2cam": step2_fields["launches_per_step"].get(name, 0),
         "launches_maintain_500": maint500[name], "launches_reregistration": rereg[name],
         "launches_calibrate_1k": calib[name],
         "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"], "library_ms": rows[name].get("library_ms"),
         "shapes": shapes[name][0],
         "max_abs_err_large": rows_large[name]["max_abs_err"], "ms_large": rows_large[name]["ms"],
         "plain_ms_large": rows_large[name]["plain_ms"],
         "bound_ms_large": rows_large[name]["bound_ms"],
         "library_ms_large": rows_large[name].get("library_ms"),
         "shapes_large": shapes[name][1]}
        for name in REPLACES
    ]
    # K9's plain version in the reference's float32, beside the float64 one
    kernels[list(REPLACES).index("chain_factor")].update(
        plain_float32_ms=rows["chain_factor"]["plain_float32_ms"],
        plain_float32_ms_large=rows_large["chain_factor"]["plain_float32_ms"])
    # K11 on the incremental pass (8 new nodes) after the 500-node rebuild
    kernels[list(REPLACES).index("project_rays")].update(
        ms_incremental=row_inc["ms"], plain_ms_incremental=row_inc["plain_ms"],
        bound_ms_incremental=row_inc["bound_ms"], max_abs_err_incremental=row_inc["max_abs_err"])
    # K12-K15: device time of one profiled keyframe (phase 10), beside the
    # event-timed wrapper calls of phase 3, which include the host's issue;
    # K12-K18: device time of one profiled keyframe step (phase 11)
    for name in FRONTEND_KERNELS:
        kernels[list(REPLACES).index(name)].update(
            device_ms_keyframe=kf1_fields["kernel_device_ms"].get(name),
            device_ms_keyframe_large=kf2_fields["kernel_device_ms"].get(name))
    for name in FRONTEND_KERNELS + KEYFRAME_KERNELS:
        kernels[list(REPLACES).index(name)].update(
            device_ms_step=step1_fields["kernel_device_ms"].get(name),
            device_ms_step_large=step2_fields["kernel_device_ms"].get(name))
    # K8's second route, from the same source: one grid launch per pass
    # where 12·N bytes exceed one CTA's shared memory; its main path is
    # phase 7's 100k solve
    kernels.append(
        {"name": "components_grid", "route": "cuda", "source": SOURCE["components"],
         "replaces": REPLACES["components"], "launches": counts100k["components"],
         "max_abs_err": grid["max_abs_err"], "ms": grid["ms"], "plain_ms": grid["plain_ms"],
         "bound_ms": grid["bound_ms"], "bound_by": grid["bound_by"], "library_ms": None,
         "shapes": "100k solve"})
    # K21-K24: the main path is each method's first timed keyframe step
    # (14c); the main shapes are a late step's arguments, and for K23's
    # word_majority the vocabulary build's last round
    method_of = {"feature_votes": "feature_set", "repository": "repository", "bow_words": "bow",
                 "bow_query": "bow"}
    shapes14 = {
        "feature_votes": ("VGA keyframe step, feature_set: 256 query descriptors, 512 nodes x 256",
                          "10k nodes x 128 descriptors, 128 queries (synthetic)"),
        "repository": ("VGA keyframe step, repository: 256 descriptors, D = 16,384 x 8 links",
                       "D = 320k descriptors x 8 links, 10k nodes, 128 queries (synthetic)"),
        "bow_words": ("VGA keyframe step, bow: 256 descriptors x 256 words (word_assign); the "
                      "vocabulary build's last round over the sequence (word_majority)",
                      "100k clustered descriptors x 256 words (synthetic)"),
        "bow_query": ("VGA keyframe step, bow: 512 nodes x 256 words",
                      "10k nodes x 256 words (synthetic)")}
    for name in RECOGNITION_KERNELS:
        r, rl, step = rec_rows[name], rec_rows_large[name], rec_fields["steps"][method_of[name]]
        kernels.append(
            {"name": name, "route": "cuda", "source": f"uzliti_slam_tpu_torch/csrc/{name}.cu",
             "replaces": RECOGNITION_REPLACES[name],
             "launches": step["launches_first_step"][name],
             "launches_step_1cam": step["launches_per_step"][name],
             "launches_pr_run": rec_fields["proposals"][method_of[name]]["launches"][name],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "shapes": shapes14[name][0], "device_ms_step": step["kernel_device_ms"].get(name),
             "max_abs_err_large": rl["max_abs_err"], "ms_large": rl["ms"],
             "plain_ms_large": rl["plain_ms"], "bound_ms_large": rl["bound_ms"],
             "library_ms_large": rl["library_ms"], "shapes_large": shapes14[name][1]})
    kernels[-2]["launches_vocabulary_build"] = rec_fields["vocabulary"]["bow_words_launches"]
    # K25-K28: the main path is each estimator's first timed keyframe step
    # (15b, 1 camera); the main shapes are a late step's arguments
    est_of = {"voxel_grid": "gicp", "knn_normals": "gicp", "gicp": "gicp", "pnp": "pnp"}
    shapes15 = {
        "voxel_grid": ("VGA keyframe step, gicp: 307,200 pixels into V = 256",
                       "front + rear rig: 614,400 pixels into V = 1024"),
        "knn_normals": ("VGA keyframe step, gicp: 10 candidate clouds of V = 256",
                        "10 clouds of V = 1024"),
        "gicp": ("VGA keyframe step, gicp: 10 candidates, V = 256, 20 iterations",
                 "10 clouds of V = 1024, 20 iterations"),
        "pnp": ("VGA keyframe step, pnp: 10 candidates x 64 draws (192 hypotheses), M = 256",
                "10 synthetic problems x 256 draws (768 hypotheses), M = 512")}
    for name in REGISTRATION_KERNELS:
        r, rl = est_rows[name], est_rows_large[name]
        step = est_fields["steps"][est_of[name]]
        kernels.append(
            {"name": name, "route": "cuda", "source": REGISTRATION_SOURCE[name],
             "replaces": REGISTRATION_REPLACES[name],
             "launches": step["launches_first_step"][name],
             "launches_step_1cam": step["launches_per_step"][name],
             "launches_run_96x128": est_fields["runs"][est_of[name]]["launches"][name],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "shapes": shapes15[name][0], "device_ms_step": step["kernel_device_ms"].get(name),
             "max_abs_err_large": rl["max_abs_err"], "ms_large": rl["ms"],
             "plain_ms_large": rl["plain_ms"], "bound_ms_large": rl["bound_ms"],
             "library_ms_large": rl["library_ms"], "shapes_large": shapes15[name][1]})
    check(len(kernels) == 30, f"{len(kernels)} kernel entries")
    print(json.dumps({"kernels": kernels, "ate": ate,
                      "maintenance": {"merge_500": merge_fields, "merge_10k": merge10k,
                                      "long_run": long_run, "reregistration": rereg_fields,
                                      "calibration": calib_fields},
                      "recognition": rec_fields, "estimation": est_fields}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
