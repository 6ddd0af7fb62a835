#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one GPU: the pose-graph solve, the
optimization epoch, the occupancy projection that follows it, the keyframe
front-end, the keyframe step through the ``Slam`` shell, an end-to-end
run judged by ATE, and the timers, recognizers, estimators, SIFT, the
fleet, the edge-sharded and planar solves and the local/global scope
protocol.

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
   1k-node and 100k-node graph (K1 also against the atomic kernel it
   replaced, scripts/linearize_atomic.cu, built here: Jᵢ, Jⱼ and W bit for
   bit, and a bit-identical rerun; on the fleet's inputs in phase 17; K3
   and K10 on the 100k chain checked but not timed, the fleet's timed in
   phase 17); K35
   pcg_chain_solve (a whole PCG solve, K2's products and K34's steps, in one
   launch) on the first PCG solve of the 1k, the 500-node epoch's and the
   10k solve and in the generic loop's planar form (x, the stall flag of
   every step, a bit-identical rerun), timed against the 1 + 2·12 calls it
   replaces; K34 pcg_chain (K10's updates around K3's apply, one launch a
   PCG step) on the same solves (a full 12-step solve with the same K2, the
   stall flags, a bit-identical rerun) and a step timed against the three
   calls it replaces; K37 pcg_grid (K34's step above its cap, one
   cooperative launch over the card) on the 20k and 100k solves' first PCG,
   plain, with the planar mask and on a cutoff-1 factor (the start and a
   12-step solve's x, r, p and scal against the plain version, the stall
   flags, a bit-identical rerun, 13 launches and no K3 or K10), a step timed
   (events and device ms) against the three calls it replaces in turns;
   each epoch kernel (K5's entries relax_table, relax_pairs,
   relax_uncertainty and relax_min, K6's cluster_roots and cluster_labels,
   K7 ransac_rigid, K8 components) on the inputs the
   500-node and 10k-node epochs give it (K5 and K6 also on edge cases: a
   hop diameter above the 64 sweeps, a row at its fixed point early, dense
   rows, the global scratch above the shared-memory cut, duplicated edges,
   tied and invalid roots; B = 1, 77, a chain beyond 16 hops, no valid
   candidate, and above the one-CTA form's 256 the grid route at B = 300,
   1,024 and 4,096, timed; K5 within RELAX_MAX_ULP, K6 exactly; K7 with its draw folded in: its
   triplets against the plain mapping of the same uniforms, exact but for
   targets within 4 ulps of a running-sum boundary, then the rest on its
   own triplets; also on a late keyframe step's calls, 1 camera and the
   rig, one of them profiled as one torch.rand and one K7 launch, and on
   edge cases), K8 (labels and gauge in one launch) on the 1k, 10k and
   100k solves' inputs (the cooperative form at 100k) with the rounds it
   ran against n_iters, and its two forms in turns at 10k, and K11
   project_rays on a 500-node full rebuild, an 8-new-node incremental pass,
   a 10k-node full rebuild and the 10k-node radius-40 m graph on a 1024²
   grid of 0.1 m (the culling's case), each with its device and queued ms
   and its bound over the pairs in reach beside the old count over every
   on-grid pair, K12 and K13 on a 10-level VGA pyramid (two launches
   each), and the
   front-end's kernels (K12 fast_nms on all four pyramid levels, K13
   grid_topk's one call for all four, K14 orb_describe's one call for every
   level and the GIST, held row by row, K15 scan_bins) on the arguments one
   VGA keyframe gives them, with one camera and with the front + rear rig
   (K13 also at four other budgets: one keypoint a cell, the global branch,
   padding and passes of 8, each with a bit-identical rerun, and ten
   profiled calls holding K13's kernel alone, no fill; K14 also on a
   synthetic frame pair with keypoints on every corner and edge and off
   the frame, each pattern and the GIST row, with a bit-identical rerun),
   and the keyframe step's kernels (K16
   hamming_top2, both entry points, K17 bilateral, K18 icp) on the
   arguments a late VGA keyframe step of phase 11 gives them (K16 also on
   tie-heavy synthetic cases: equal descriptors, masked rows, one valid
   stored descriptor, and GIST banks of 300 to 100k entries at k from 1 to
   N, each with a bit-identical rerun; K18 also with no valid target and
   one, on a synthetic N = M = 8192 problem at batch 1 and 4, each with a
   bit-identical rerun): error against a stated tolerance, the median time
   of both, and the least time the card could take for the work this data
   needs;
4. the 1k-node headline solve (20 LM x 12 PCG, chain factor refreshed every
   5, fixed iteration count) through ``optimize``: launch counts of one
   solve (its PCG through K35 alone: 20 launches, none of K2, K34, K3 and
   K10), the device launches of a profiled solve, no host synchronisation
   inside the timed solves (CUDA sync debug mode "error"), the 10 timed
   solves' χ² and poses bit-identical, final χ² against the same solve on
   CPU tensors and against the sparse oracle, median solve time, and a
   profile with no cuSOLVER or cuBLAS item;
5. the library default ``SolverConfig()`` (early exit) at 1k nodes against
   the oracle, with the factors K9 actually built against the refreshes
   the reference's loop makes, and a profile;
6. the headline configuration at 10k nodes against the oracle (LM);
7. the headline configuration at 100k nodes: time, finite χ² below χ²₀,
   K8 launched once (its cooperative form), a profile; its PCG through K2
   and K37 (260 K37 launches, no K3 or K10), its launches and device ms by
   kernel, and the same solve with its PCG through the old composition
   (K10 + K3 + K10 a step, called through their wrappers): launches, time,
   device ms by kernel, and the χ² history within 1e-3 of K37's; whether
   two solves give the same bits (if not, the kernels that do not on the
   same inputs); in phases 5-9, 17 and 18 each solve's PCG goes through its
   route alone: K35 for a single solve within K34's cap with no reduce
   hook, K2 and K34 for the edge-sharded solve, K2 and K37 above the cap
   (the 100k solve, sharded or not), K38 in the fleet, K2, K10 and K3 in a
   fleet above K38's cap;
8. the 500-node RGB-D + laser epoch (``pipeline.optimize_epoch`` with the
   live ``SlamConfig``): launch counts per kernel (K5 two a call site: its
   table and one relaxation entry; K6's roots entry once), K5's and K6's
   device ms in a profiled epoch, the public entry points that reach K5's
   rows entry and K6's labels entry (``shortest_paths``,
   ``filter._cluster_labels``) counted and profiled on the same state
   (8b), the factors K9 built
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
   rig: launch counts of one keyframe (K13 exactly once: one call takes
   every level), ms per keyframe over 10 sync-free keyframes after 3
   warm-up ones, a profile, valid keypoints, the scan on
   the wall, and the same frames on CPU tensors through the plain path;
11. the keyframe step in the default configuration (depth refinement, GIST
   recognition, matching + RANSAC, ICP laser edges) through
   ``Slam.add_frame`` on the same 13 frames with the JAX bench's
   ``_make_slam`` settings, one camera and the rig: ms per keyframe step
   over 10 sync-free steps after 3 warm-up ones, launches of K12-K18 and K7
   over them (K13 once a step), a profile of one more step, candidates on
   the return leg
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
   batch of 4, against its plain version with a bit-identical rerun, its
   two launch forms timed, the same edges on CPU tensors); (e) ``Slam.calibrate`` on a
   1k-node biased-odometry graph (K20): the drift recovered within 2e-2,
   then the calibrated solve against the uncalibrated one and on CPU
   tensors.  Phase 3 holds K19 and ``bin_min_max`` (exactly; the latter
   also on NaN, ±inf, range-limit, bin-edge and band-limit points and an
   empty scan) and K20 (θ within 1e-4) against their plain versions on the
   arguments those paths give them;
14. the other place recognizers: (c) the keyframe step of phase 11 (VGA, 1
   camera, the same frames and settings) with ``recognition.method``
   "feature_set" (K21), "repository" (K22) and "bow" (K23 + K24, after a
   256-word vocabulary is built on the card from the sequence's
   descriptors with K23): ms per step, launches, a profile, sync-free steps
   and the same graph on CPU tensors; (a) K21-K24 against their plain
   versions on a late step's arguments (and the vocabulary build's last
   round) and at the large shapes (10k nodes, D = 320k, 100k descriptors):
   K21-K23 exactly, K24's scores within 1e-6; K21 and K22's three entries
   one device launch a call each (whole profiles), a rerun bit for bit, and
   46 edge cases exactly (``recognition_edge_cases``), the first of each
   again after a larger call grew the scratch, and the step's calls again
   after the 50k banks; (b) each recognizer's kernels per query on banks of
   1k, 10k and 50k nodes (K21 and K22 held exactly at each, device ms
   queued), with the bank's bytes, and the default GIST query (K16's ``gist_topk``) at 1k, 10k, 50k
   and 100k nodes with its device ms, held against its plain version; (d)
   tests/test_pr_methods.py's 30-frame 96x128 run per method on the card:
   at least 3 proposed edges each;
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
   by their null space (see PNP_HYP_MEDIAN); K27 also on tied, NaN-Lab and
   all-invalid targets (``gicp_tie_calls``); K27 and K28 each a second time
   on the same arguments (the same bits), and K28's device ms per phase
   from its ``%globaltimer`` stamps; one K28 and one K27 launch a step; (c)
   tests/test_estimation_methods.py's 24-frame run per method on the card,
   held to its bars;
16. the float-descriptor path: ``detect_and_describe(descriptor="sift")``
   (K12, K13, K29) on a VGA frame and on it shifted by 3 px, and
   ``match_descriptors_l2`` (K30) between them: launches, the match held to
   tests/test_frontend.py's bars (>= 10 matches, median shift within 1.5 px
   of 3), the path timed sync-free; K29 against its plain version on every
   level's arguments (angles within 1e-5, descriptors within 1e-5 given its
   angles), K30 on the match's (best within 1e-5, the same indices and
   flags off near-ties), each timed with its bound, K30 beside
   ``cdist`` squared + ``topk``;
17. the fleet: ``parallel.sharded.optimize_batch`` on 4096 distinct
   64-node instances at the JAX bench's rung configuration (20 LM x 8 PCG,
   cutoff 16, fixed iterations): launches of one solve (K1 and K8 on the
   flattened fleet, K4, K9, K36 and K38 with the instance on their grid:
   K38 20, K2, K3 and K10 none; the same counts on 8 instances), solve ms
   and instance-solves/s sync-free, mean χ², a profile, whether two solves
   give the same bits, the χ² ratio against the sparse oracle on 16
   instances, 8 instances against a loop of single solves on CPU tensors,
   each batched entry against its plain version on the fleet's first
   iteration (K38 after the start and 1-3 steps within 1e-4, after 8
   within its plain version's own float32 error plus 1e-4, the stall flags
   of every step, a bit-identical rerun, timed against the K2 + K10 + K3
   solve it replaced; K2, K3 and K10 still held at the fleet's shapes);
   then the default (early-exit) configuration, its factors built against
   the reference's refreshes summed over the instances, a profile; (17c) a
   fleet above K38's cap (16 x 512 nodes): its PCG through K2, K10 and K3,
   χ² below χ²₀, the three against their plain versions on its first
   iteration;
18. the generic loop, the edge-sharded solve and the planar solve: (a)
   the 1k graph through ``parallel.sharded.optimize_sharded`` in a
   one-rank NCCL world made in this process (a ``HashStore``), at the JAX
   bench's sharded-overhead configuration (``mode="pcg"``, fixed
   iterations), against ``optimize`` with the same configuration: 10
   sync-free solves each in alternating turns, the overhead (and, each in
   a process of this script, ``--overhead``, with PyTorch's defaults and
   with c10d's per-collective bookkeeping off, beside the 100k graph's
   time and the launches of its sharded solve), the
   all-reduces counted against their formula, the launches of one solve,
   a profile with its non-port items by name, χ² within the two routes'
   spreads over their turns (+ 1e-6·χ²₀) of the generic solve's and against
   the oracle; (b) the generic loop
   against the fast fixed form at 1k (ms, χ² histories within 1e-3); (c)
   the 100k graph sharded at ``scripts/scaling_bench.py``'s configuration,
   its PCG through K2 and K37, χ² against phase 7's; (d) two gloo ranks on the one card, each a
   process of this script (``--sharded-rank``): poses bit for bit across
   ranks, χ²₀ and χ²₁ against (a)'s, times printed; (e) the planar solve
   (``optimize_xy_only``, early exit) on the 1k graph with z perturbed,
   beside the unprojected solve, K1's column mask against its plain
   version, z and roll/pitch at 0, χ² against the CPU plain path; (f)
   ``multihost.solve_fleet`` in the world of one against
   ``optimize_batch`` on 8 x 64-node instances;
19. the local/global scope protocol (K31 uid_slots, K32 edge_key_match,
   K33 delta_upsert and scope_merge): (a) ``scope.apply_delta`` of a
   32-node / 64-edge delta (16 known uids and 16 new; 24 resent edges, 24
   new, 8 in-delta duplicates, 8 to an unknown uid) into a 100k-node
   graph, then ``apply_ack`` and ``apply_scope`` (32 rows, half known) on
   a 1k-node graph: launches a call, sync-free calls timed, the same calls
   with K31-K33's plain versions in alternating turns, both equal and equal
   to the calls on CPU tensors, a profile; (b) ``runner.LocalGlobalSlam``
   on 48 VGA frames of the keyframe rung's world out and back
   (``step_config``'s settings, a 0.25 m keyframe gate, tests/
   test_runner.py's scope), an exchange every 6 frames and 4 drain rounds
   (the counts set to 0 just before, read just after): ms per round split
   into the local and the global half, host reads per round by site, a
   profiled round, tests/test_runner.py's bars and the ATE against the
   odometry's, the scope functions sync-free on a round's arguments; (c)
   tests/test_runner.py's 96x128 duo on the card, then with its RANSAC
   draws replayed on CPU tensors: without the global's optimization the
   same global graph and poses within 1e-3 m; as the test runs it, its bars,
   the card-card and card-CPU gaps, and whether two card runs end
   bit-identical (if not, the PyTorch ops without a deterministic
   implementation).  K31-K33 against their plain
   versions on a round of (b) and on (a)'s calls, exactly.

Then one JSON line with the kernels' results, the nvidia-smi line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed check raises,
and the exit code is not 0.  Without a CUDA device it exits with code 1
before doing anything.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
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
# The 1k headline's device launches a solve (phase 4's profile): K1 24, K35
# 20, K36 40, K9 4, K4 2, K8 2 and the loop's remaining PyTorch ops (the
# damping, the state's set-up, the final write-back)
MAX_DEVICE_LAUNCHES_1K = 400
# The device-to-device copies an LM loop's state makes at its start
# (kops.lm_state: the iterate's copy of the start poses, χ²₀ into column 0
# of the history); a solve's others are its incidence table build's
LM_STATE_COPIES = 2
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
#     stored in float32); its root is the cyclic reduction continued and
#     expanded back where the plain version takes LU, so the root is held
#     through what the solve uses: the apply on a fixed right-hand side
#     within CHAIN_APPLY_RTOL, and ‖A·root - I‖ printed beside LU's; the
#     damped entry (Hb, damp, free) bit-equal to the entry on the eager
#     damped blocks;
#  K10 1e-4 of max|x| after a 12-step PCG — dots summed in another order —
#     and the same stall flag at every step; K34 (K10's updates around K3's
#     apply) and K35 (K34 with K2's products inside) the same, and
#     bit-identical on a rerun.  K1's node rows within 1e-3 of the plain
#     version's, its Jᵢ, Jⱼ and W bit-equal to the atomic kernel it replaced
#     (scripts/linearize_atomic.cu) and every output bit-identical on a
#     rerun.
# K11 log-odds: within PROJECT_ATOL at 500 nodes; at 10k nodes within
# PROJECT_SUM_RTOL·S + PROJECT_ATOL_LARGE, S the cell's sum of |node terms|
# (free and hit terms of many nodes cancel, and the two sum them in
# another order); ternary classes equal except within TERNARY_NEAR of a
# threshold.
#  K36 lm_candidate: cand within CAND_RTOL of the eager retraction's (the
#     pose algebra's float32 rounding in another order), r and χ² within
#     1e-4 of K4's plain version on the kernel's own cand (K4's tolerance;
#     against the eager cand they move with the cand's last bits, through
#     the log map's lever arms: 1.04e-4 of max|r| on the fleet), and
#     bit-equal to K4 on that cand; lm_accept exactly (the same comparisons
#     and float32 products), every scalar and row of the state over 20
#     iterations in both loop forms.
#  K37 (K34's step above its cap, one cooperative launch) the same: x, r,
#     p and scal within 1e-4 after the start and after a 12-step solve on
#     the kernel's own Hp products, each relative to its largest magnitude
#     over the solve (x's last, r's, p's and rz's at the start: the
#     recurrences subtract from those and round relative to them; the row
#     prints how far r shrank), the same stall flags, and bit-identical on
#     a rerun.
#  K38 (a fleet's whole PCG solve, a CTA an instance) against its plain
#     version after the start and after 1, 2 and 3 steps within 1e-4 of
#     each vector's largest magnitude, and after the fleet's 8 steps within
#     the plain version's own float32 error (its distance from the same
#     solve in float64) plus 1e-4: past ~3 steps float32 PCG on these
#     64-node instances amplifies summation order (tests/test_torch_pcg_fleet.py:
#     JAX's own float32 solve lies 1.8e-3 of max|x| from its float64 one at 8
#     steps on 32-node instances); the same stall flags, and bit-identical
#     over two launches.
KERNEL_TOL = {"linearize": 1e-3, "hvp": 1e-4, "chain_apply": 1e-4, "residual_chi2": 1e-4,
              "chain_factor": 1e-4, "pcg": 1e-4, "pcg_chain": 1e-4, "pcg_chain_solve": 1e-4,
              "lm_candidate": 1e-4, "lm_accept": 0.0, "pcg_grid": 1e-4, "pcg_fleet_solve": 1e-4}
CAND_RTOL = 1e-6
# Phase 7: the 100k solve's χ² history on K37's route against the same solve
# with its PCG through the old composition (K10 + K3 + K10), element by
# element: the same arithmetic with its dots summed in another order
CHI2_HIST_RTOL = 1e-3
CHAIN_APPLY_RTOL = 1e-3
PROJECT_ATOL = 1e-4
PROJECT_SUM_RTOL, PROJECT_ATOL_LARGE = 2e-6, 1e-5
TERNARY_NEAR = 1e-4
RELAX_MAX_ULP = 1
RANSAC_POSE_ATOL = 1e-4      # refit pose, per component
RANSAC_NEAR_REL = 1e-5       # a point this close to the inlier radius may flip
# K7's draw against the plain mapping of the same uniforms on the card: the
# running sums are the kernel's exact double sums rounded against
# torch.cumsum's float32 scan, so a triplet may differ only where the plain
# target lies this many ulps of the row's total from a running-sum boundary
DRAW_BOUNDARY_ULPS = 4
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
    "relax_table": "uzliti_slam_tpu/graph/shortest_path.py:50-55 (shortest_paths' edges, as a"
                   " node-to-edge table)",
    "relax_pairs": "uzliti_slam_tpu/graph/shortest_path.py:60 (pairwise_graph_distance)"
                   " + :29 (shortest_paths)",
    "relax_uncertainty": "uzliti_slam_tpu/graph/shortest_path.py:75 (reevaluate_uncertainty)"
                         " + :29 (shortest_paths)",
    "cluster_labels": "uzliti_slam_tpu/graph/filter.py:66 (_cluster_labels)",
    "cluster_roots": "uzliti_slam_tpu/graph/filter.py:105-154 (filter_loop_closures before"
                     " RANSAC) + :66 (_cluster_labels)",
    "ransac_rigid": "uzliti_slam_tpu/ops/ransac.py:123 (ransac_rigid)"
                    " + :96 (_valid_sample) + :54 (kabsch_quat) + :32 (kabsch)",
    "components": "uzliti_slam_tpu/graph/solver.py:212 (connected_components)"
                  " + :242 (gauge_fix_mask)",
    "chain_factor": "uzliti_slam_tpu/graph/tridiag.py:145 (block_tridiag_factor)"
                    " + :22-72 (_inv3, _inv6) + :75 (_pad_pow2) + :112 (_dense_root_inverse)",
    "pcg": "uzliti_slam_tpu/graph/solver.py:512 (_pcg)",
    "pcg_chain": "uzliti_slam_tpu/graph/solver.py:512 (_pcg, its body minus the Hessian-vector"
                 " product) + graph/tridiag.py:198 (block_tridiag_apply)",
    "pcg_chain_solve": "uzliti_slam_tpu/graph/solver.py:512 (_pcg, the whole loop) + :306"
                       " (_make_hvp) + graph/tridiag.py:198 (block_tridiag_apply)",
    "lm_candidate": "uzliti_slam_tpu/graph/solver.py:981-987 (lie.pose_retract +"
                    " factors.batched_residuals + _robust_chi2_from_r; :918-924, :1163-1169)",
    "lm_accept": "uzliti_slam_tpu/graph/solver.py:988-997 (accept, λ schedule; with the early"
                 " exit :925-946, generic :1170-1181)",
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
    "bin_min_max": "uzliti_slam_tpu/ops/scan.py:166 (points_to_scan) + :72 (cloud_to_scan)"
                   " with :38 (_bin_min_max)",
})
SOURCE = {k: f"uzliti_slam_tpu_torch/csrc/{k}.cu" for k in REPLACES}
SOURCE["project_rays"] = "uzliti_slam_tpu_torch/csrc/occupancy.cu"
SOURCE["relax_table"] = SOURCE["relax_pairs"] = SOURCE["relax_uncertainty"] = SOURCE["relax_min"]
SOURCE["cluster_roots"] = SOURCE["cluster_labels"]
SOURCE["bin_min_max"] = "uzliti_slam_tpu_torch/csrc/scan_bins.cu"
SOURCE["pcg_chain_solve"] = "uzliti_slam_tpu_torch/csrc/pcg_chain.cu"
SOURCE["pcg_fleet_solve"] = "uzliti_slam_tpu_torch/csrc/pcg_fleet.cu"
SOURCE["lm_candidate"] = SOURCE["lm_accept"] = "uzliti_slam_tpu_torch/csrc/lm_step.cu"
SOLVE_KERNELS = ("linearize", "hvp", "chain_apply", "residual_chi2", "chain_factor", "pcg",
                 "pcg_chain", "pcg_chain_solve", "lm_candidate", "lm_accept")
PCG_KERNELS = ("hvp", "chain_apply", "pcg", "pcg_chain", "pcg_chain_solve", "pcg_grid",
               "pcg_fleet_solve")
# The PCG's five routes (solver._pcg): a single solve within K34's cap with
# no reduce hook takes K35 alone; with one (the edge-sharded solve) K2 and
# K34; a single solve above the cap (the 100k solve, sharded or not) K2 and
# K37; a fleet K38 alone; a fleet above K38's cap K2, K10 and K3
FUSED_PATH = ("linearize", "residual_chi2", "chain_factor", "pcg_chain_solve", "lm_candidate",
              "lm_accept")
SPLIT_PCG = ("chain_apply", "pcg")
PCG_ROUTES = {"k35": ("pcg_chain_solve",), "k2_k34": ("hvp", "pcg_chain"),
              "k2_k37": ("hvp", "pcg_grid"), "k38": ("pcg_fleet_solve",),
              "k2_k10_k3": ("hvp",) + SPLIT_PCG}
# K37, phase 3: the solve's PCG step above K34's cap
PCG_GRID_SOURCE = "uzliti_slam_tpu_torch/csrc/pcg_grid.cu"
PCG_GRID_REPLACES = ("uzliti_slam_tpu/graph/solver.py:512 (_pcg, its body minus the"
                     " Hessian-vector product) + graph/tridiag.py:198 (block_tridiag_apply),"
                     " a single solve above K34's cap")
# K38, phase 17: the fleet's whole PCG solve, a CTA an instance
PCG_FLEET_SOURCE = "uzliti_slam_tpu_torch/csrc/pcg_fleet.cu"
PCG_FLEET_REPLACES = ("uzliti_slam_tpu/parallel/sharded.py:115 (optimize_batch) —"
                      " graph/solver.py:512 (_pcg, the whole loop) + :306 (_make_hvp) +"
                      " graph/tridiag.py:198 (block_tridiag_apply) under vmap")
# the A/B reference of K1's Jᵢ, Jⱼ and W: the atomic kernel it replaced,
# built by this script alone
ATOMIC_K1_SOURCE = "scripts/linearize_atomic.cu"
# the epoch's kernels: K5's table, pairs and uncertainty entries, K6's roots
# entry, K7, K8; K5's rows entry and K6's labels entry are reached by the
# public entry points (ENTRY_KERNELS, counted in phase 8)
EPOCH_KERNELS = ("relax_table", "relax_pairs", "relax_uncertainty", "cluster_roots",
                 "ransac_rigid", "components")
ENTRY_KERNELS = ("relax_min", "cluster_labels")
K5_K6 = ("relax_table", "relax_pairs", "relax_uncertainty", "cluster_roots") + ENTRY_KERNELS
MAP_KERNELS = ("project_rays",)
FRONTEND_KERNELS = ("fast_nms", "grid_topk", "orb_describe", "scan_bins")
# each front-end kernel's wrapper (K14's takes every row of a keyframe)
FRONTEND_WRAPPERS = {"fast_nms": "fast_nms", "grid_topk": "grid_topk",
                     "orb_describe": "orb_describe_levels", "scan_bins": "scan_bins"}
# the keyframe step's own kernels; K16 has two wrappers (matching, GIST query)
KEYFRAME_KERNELS = ("hamming_top2", "bilateral", "icp")
KEYFRAME_WRAPPERS = {"hamming_top2": ("hamming_top2", "gist_topk"), "bilateral": ("bilateral",),
                     "icp": ("icp",)}
STEP_KERNELS = FRONTEND_KERNELS + KEYFRAME_KERNELS + ("ransac_rigid",)
# the maintenance and calibration timers' kernels (phase 13): K19, K20 and
# K15's second entry point
MAINT_KERNELS = ("merge_pairs", "calib_gn", "bin_min_max")
# the device functions each front-end kernel's wrapper launches (a template
# with its arguments: K14 and K29 share describe.cuh's blur at radius 2 and 1)
FRONTEND_DEVICE_FUNCTIONS = {"fast_nms": ("fast_nms_levels",),
                             "grid_topk": ("grid_cells", "grid_global"),
                             "orb_describe": ("orb_describe_rows",),
                             "scan_bins": ("scan_grid",),
                             "hamming_top2": ("match_top2_lanes", "gist_topk_cluster"),
                             "bilateral": ("bilateral_tile",), "icp": ("icp_cluster",),
                             "ransac_rigid": ("ransac_draw_fit",),
                             "relax_table": ("relax_table_kernel",),
                             "relax_pairs": ("relax_pairs_kernel",),
                             "relax_uncertainty": ("relax_unc_kernel",),
                             "relax_min": ("relax_rows_kernel",),
                             "cluster_roots": ("cluster_block<true>", "cluster_grid<true>"),
                             "cluster_labels": ("cluster_block<false>", "cluster_grid<false>"),
                             "components": ("components_cta", "components_grid"),
                             "project_rays": ("project_tiles",),
                             "merge_pairs": ("merge_pairs_kernel",),
                             "calib_gn": ("calib_cluster",),
                             "bin_min_max": ("bin_points",),
                             "feature_votes": ("feature_votes_kernel",),
                             "repository": ("repo_nearest_kernel", "repo_votes_kernel"),
                             "bow_words": ("assign_words", "count_bits", "majority_bytes"),
                             "bow_query": ("row_scores", "topk_scores"),
                             "voxel_grid": ("voxel_sort_chunks", "voxel_merge",
                                            "voxel_accumulate", "voxel_finish"),
                             "knn_normals": ("knn_normals_kernel",), "gicp": ("gicp_cluster",),
                             "pnp": ("pnp_cluster",),
                             "sift_describe": ("box_blur<1>", "sift_keypoints"),
                             "l2_top2": ("l2_top2_tiles",),
                             "uid_slots": ("uid_slots_kernel",),
                             "edge_key_match": ("edge_key_kernel",),
                             "delta_upsert": ("delta_upsert_kernel",),
                             "scope_merge": ("scope_merge_kernel",)}
# cuSOLVER / cuBLAS items that must not appear in a profiled solve
LIBRARY_ITEMS = ("getrf", "getrs", "trsm", "gemv")
# The card's published peaks (H100 SXM at 700 W):
# device memory 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s, the
# rate used here for every scalar operation (float32 or int32).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# The card publishes no binary tensor-core rate.  K21's and K22's bit
# operations are stated against the b1 mma's rate as measured on the card
# (scripts/hamming_mma_rates.cu, the .and.popc form, NVIDIA H100 80GB HBM3
# at 700 W: 1,141.39 m16n8k256 mmas a µs an SM over 132 SMs, 4.937·10¹⁵ bit
# products a second), two operations (AND, popcount) a bit product; the
# int8 tensor line (dense) is kept beside it
B1_AND_POPC_OPS_PER_S = 2 * 4.936939327212337e15
TENSOR_INT_OPS_PER_S = 1979e12
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
# BILATERAL_ULPS of the plain version's depth: 0, bit-equal (torch's exp on
# the card is the kernel's expf, and its colour table holds expf's values;
# fma_plain's double rounding did not show in any case); K18's pose within
# ICP_POSE_ATOL and
# covariance within ICP_COV_RTOL of its largest entry (sums in another
# order over 20 Gauss-Newton steps), the same ok flag.
BILATERAL_ULPS = 0
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
# K21's and K22's device function by wrapper: one launch a call each
RECOGNITION_ENTRY_FUNCTIONS = {"feature_votes": ("feature_votes_kernel",),
                               "repo_nearest": ("repo_nearest_kernel",),
                               "repo_votes": ("repo_votes_kernel",)}
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
                         "gicp": ("gicp",), "pnp": ("pnp_ransac",)}
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

# Phase 16: the float-descriptor path, K29 and K30.  A VGA frame of the
# keyframe rung's world and the same frame shifted by 3 px,
# tests/test_frontend.py:311-323's bars (>= 10 matches, median shift within
# 1.5 px of 3).  K29 is held as K14: its angles within ANGLE_ATOL of the
# plain version's (moments summed in another order off level 0), its
# descriptors within SIFT_DESC_ATOL of the plain version's given K29's
# angles (the same samples; the cell sums and norms in another order).  K30:
# best squared distances within L2_BEST_ATOL (dot products summed in
# another order on unit rows), the same index unless the row's two best
# lie within L2_NEAR_REL relative, the same ok unless best lies within
# L2_NEAR_REL of ratio²·second.
SIFT_REPLACES = {
    "sift_describe": "uzliti_slam_tpu/ops/features.py:413 (sift_descriptors) + :171"
                     " (intensity_centroid_angles) + :159 (_sep_blur, radius 1)",
    "l2_top2": "uzliti_slam_tpu/ops/matching.py:136 (l2_matrix) + :80 (knn_match) + :100"
               " (ratio_test) via :154 (match_descriptors_l2)",
}
SIFT_KERNELS = tuple(SIFT_REPLACES)
SIFT_RUN = dict(max_keypoints=300, n_levels=4, shift=3, ratio=0.9, min_matches=10,
                shift_tol=1.5)
SIFT_DESC_ATOL, L2_BEST_ATOL, L2_NEAR_REL = 1e-5, 1e-5, 1e-5
# Phase 17: the fleet, the JAX bench's batched_4096x64n_20it rung
# (bench.py:124-165, 559-563): 4096 distinct circle graphs of 64 nodes,
# closures every 8 (pow2 capacities: 64 node and 128 edge slots), 20 LM x
# 8 PCG steps, cutoff 16, fixed iterations, a refresh every 5; the port's
# sparse oracle on 16 sampled instances; 8 instances against a loop of
# single solves on CPU tensors (χ² within CHI2_RTOL·χ² + 1e-6·χ²₀, poses
# within FLEET_POSE_ATOL: float32 PCG amplifies summation order, and the
# JAX package's own vmapped and single solves differ by 4.3e-4 at 8 PCG
# steps, ``PYTHONPATH=. python tests/test_torch_fleet.py``);
# K3, K4, K9 and K10 at the fleet's batch against their plain versions on
# the fleet's first iteration (KERNEL_TOL of the kernel; K10 launch by
# launch on the same inputs).  The kernels line lists those four at the
# fleet's batch as rows of their own (``*_batch``), with the launches of
# their kernel in the fleet's solve.
FLEET_REPLACES = {
    "residual_chi2_batch": "uzliti_slam_tpu/parallel/sharded.py:115 (optimize_batch: vmap of"
                           " graph/solver.py:1213 optimize) — graph/solver.py:1034"
                           " (_robust_chi2_from_r) + graph/factors.py:72 (batched_residuals)",
    "pcg_batch": "uzliti_slam_tpu/parallel/sharded.py:115 (optimize_batch) — graph/solver.py:512"
                 " (_pcg) under vmap",
    "chain_apply_batch": "uzliti_slam_tpu/parallel/sharded.py:115 (optimize_batch) —"
                         " graph/tridiag.py:198 (block_tridiag_apply) under vmap",
    "chain_factor_batch": "uzliti_slam_tpu/parallel/sharded.py:115 (optimize_batch) —"
                          " graph/tridiag.py:145 (block_tridiag_factor) under vmap",
    "lm_candidate_batch": "uzliti_slam_tpu/parallel/sharded.py:115 (optimize_batch) —"
                          " graph/solver.py:981-987 (retraction, residuals, χ²) under vmap",
    "lm_accept_batch": "uzliti_slam_tpu/parallel/sharded.py:115 (optimize_batch) —"
                       " graph/solver.py:988-997 (accept, λ schedule) under vmap",
}
# K1, K2 and K8 run unchanged on the flattened fleet; their rows (``*_fleet``)
# hold them against their plain versions at the fleet's shapes
FLEET_REPLACES.update({
    "linearize_fleet": "uzliti_slam_tpu/parallel/sharded.py:115 (optimize_batch) —"
                       " graph/solver.py:355 (_make_fused_linearize) under vmap",
    "hvp_fleet": "uzliti_slam_tpu/parallel/sharded.py:115 (optimize_batch) —"
                 " graph/solver.py:306 (_make_hvp) under vmap",
    "components_fleet": "uzliti_slam_tpu/parallel/sharded.py:115 (optimize_batch) —"
                        " graph/solver.py:212 (connected_components) + :242 (gauge_fix_mask)"
                        " under vmap",
})
FLEET_KERNELS = tuple(FLEET_REPLACES)
FLEET_KERNEL = {row: row.removesuffix("_batch").removesuffix("_fleet")
                for row in FLEET_KERNELS}
FLEET_SOURCE = {row: SOURCE.get(name, f"uzliti_slam_tpu_torch/csrc/{name}.cu")
                for row, name in FLEET_KERNEL.items()}
# the kernels the fleet launches: K1 and K8 on the flattened fleet, and K4,
# K9, K36 and K38 with the instance on their grid; K2, K3 and K10 only in a
# fleet above K38's cap (17c, FLEET_ABOVE_CAP: 512 nodes an instance, 5
# levels at cutoff 16, 569 KB of shared memory an instance)
FLEET_PATH = ("residual_chi2", "chain_factor", "lm_candidate", "lm_accept", "linearize",
              "components", "pcg_fleet_solve")
FLEET_SPLIT = ("hvp",) + SPLIT_PCG
FLEET = dict(batch=4096, n_nodes=64, loop_closure_every=8)
FLEET_ABOVE_CAP = dict(batch=16, n_nodes=512, loop_closure_every=8)
FLEET_CONFIG = dict(iterations=20, pcg_iterations=8, chain_dense_cutoff=16, early_exit=False,
                    precond_refresh=5)
FLEET_ORACLE_SAMPLES, FLEET_CPU_INSTANCES, FLEET_POSE_ATOL = 16, 8, 1e-3
# Phase 18: the generic LM loop, the edge-sharded solve (B19) and the planar
# solve.  The JAX bench's sharded-overhead rung (bench.py:168-198) runs the
# generic loop on both sides; scripts/scaling_bench.py's configuration at its
# default 100k nodes; tests/test_constraints.py:172-177's z perturbation.
SHARDED_CONFIG = dict(mode="pcg", early_exit=False)
SHARDED_100K_CONFIG = dict(iterations=20)
SHARDED_REPS, SHARDED_RANKS, RANK_TIMEOUT_S = 10, 2, 300
PLANAR_DZ = 0.2
FLEET_WORLD = dict(batch=8, n_nodes=64)
# the kernels the sharded 1k solve launches: K1, K2, K4 and K36's candidate
# on the rank's shard, K8 on the whole graph, K9, K34 and K36's accept
# replicated (the 100k one K3 and K10)
SHARDED_PATH = ("linearize", "hvp", "residual_chi2", "components", "chain_factor",
                "pcg_chain", "lm_candidate", "lm_accept")
PLANAR_REPLACES = ("uzliti_slam_tpu/graph/solver.py:355 (_make_fused_linearize) with its cmask"
                   " under optimize_xy_only (:369-381)")


# Phase 19: the scope protocol's kernels (K31-K33, K33 with two entries)
SCOPE_REPLACES = {
    "uid_slots": "uzliti_slam_tpu/parallel/scope.py:96 (uid_to_slot)",
    "edge_key_match": "uzliti_slam_tpu/parallel/scope.py:222 (apply_delta's (De, E) edge dedup)"
                      " + :282 (apply_ack's (A, E) compare)",
    "delta_upsert": "uzliti_slam_tpu/parallel/scope.py:170 (apply_delta's node and edge scans,"
                    " in-delta dedup, ACK)",
    "scope_merge": "uzliti_slam_tpu/parallel/scope.py:317 (apply_scope's scan)",
}
SCOPE_KERNELS = tuple(SCOPE_REPLACES)
SCOPE_SOURCE = {"uid_slots": "uzliti_slam_tpu_torch/csrc/scope_match.cu",
                "edge_key_match": "uzliti_slam_tpu_torch/csrc/scope_match.cu",
                "delta_upsert": "uzliti_slam_tpu_torch/csrc/delta_apply.cu",
                "scope_merge": "uzliti_slam_tpu_torch/csrc/delta_apply.cu"}
SCOPE_GLOBAL_N = 100_000     # 19a: the global graph a delta is applied to
# 19b: the duo on the VGA WallWorld, tests/test_runner.py's cadence
SCOPE_DUO = dict(frames=48, drift=0.05, length=6.0, every=6, drain=4,
                 record_round=3)   # K31-K33 held to their plain versions on this round
# 19c: the card's 96x128 duo without the global's optimization against the
# same run on CPU tensors with the card's draws replayed: poses within
# 1e-3 m (tests/test_scope_transport.py's bound; nothing sums in another
# order there, so they agree to the bit)
SCOPE_POSE_ATOL = 1e-3

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


# longer names first: a mangled name takes the first entry it contains (an
# anonymous namespace's mangled name holds its file's name)
DEVICE_FUNCTIONS = ("sift_keypoints", "linearize_rows", "hvp_seed",
                    "hvp_edges", "pcg_chain_kernel", "pcg_solve_kernel", "pcg_grid_kernel",
                    "pcg_fleet_kernel",
                    "chain_forward",
                    "chain_backward",
                    "chain_root", "factor_kernel", "candidate_kernel", "accept_kernel",
                    "pcg_init", "pcg_alpha", "pcg_beta", "grid_dots", "grid_init",
                    "grid_alpha", "grid_beta", "project_tiles",
                    "residual_edges", "sum_partials",
                    "relax_table_kernel", "relax_rows_kernel", "relax_pairs_kernel",
                    "relax_unc_kernel", "cluster_block", "cluster_grid", "ransac_draw_fit",
                    "components_cta", "components_grid", "fast_nms_levels", "grid_global", "grid_cells", "box_blur",
                    "orb_describe_rows", "scan_grid",
                    "match_top2_lanes", "gist_topk_cluster", "bilateral_tile", "icp_cluster",
                    "merge_pairs_kernel", "calib_cluster", "bin_points",
                    "feature_votes_kernel", "repo_nearest_kernel", "repo_votes_kernel",
                    "voxel_sort_chunks", "voxel_merge", "voxel_accumulate", "voxel_finish",
                    "knn_normals_kernel", "gicp_cluster", "pnp_cluster", "l2_top2_tiles",
                    "uid_slots_kernel", "edge_key_kernel",
                    "delta_upsert_kernel", "scope_merge_kernel")


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


# torch.cuda._sleep's kernel (ATen's Sleep.cu): profiled_kernels launches
# PROFILE_MARKERS short ones before the call.  In a long process a trace
# loses a few of its device records, nearly always its first ones (4 at
# this script's phase 3 in one run, none in a fresh process; PERF.md §7,
# scripts/profile_record_loss.py): a trace that holds a marker has, but
# once in those probes, kept every kernel of the call.  WARMUP_SEEN counts
# the profiles that held one, and all profiles.
PROFILE_WARMUP_KERNEL = "spin_kernel"
PROFILE_MARKERS = 32
WARMUP_SEEN = {"held": 0, "profiles": 0}


def profiled_kernels(fn, markers: int = PROFILE_MARKERS) -> tuple[float, list, bool, object]:
    """One profiled call of ``fn`` after ``markers`` sleep kernels of ~0.1
    µs and a synchronisation: (its wall s, the trace's device rows other
    than the markers (``key_averages``), whether the trace held a marker,
    and the profiler)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(markers):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    cuda = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    kernels = [e for e in cuda if PROFILE_WARMUP_KERNEL not in e.key]
    held = len(kernels) < len(cuda)
    WARMUP_SEEN["profiles"] += 1
    WARMUP_SEEN["held"] += held
    return wall, kernels, held, prof


def whole_profile(fn, attempts: int = 8):
    """``profiled_kernels`` of ``fn`` until a trace holds a marker, the
    markers doubled after each that lost them all: (its wall s, device rows
    and profiler, or None where none of ``attempts`` did; the profiles
    taken)."""
    markers = PROFILE_MARKERS
    for attempt in range(1, attempts + 1):
        wall, kernels, held, prof = profiled_kernels(fn, markers)
        if held:
            return (wall, kernels, prof), attempt
        markers *= 2
    return None, attempts


def device_profile(fn) -> tuple[dict, dict]:
    """One profiled call (``profiled_kernels``): (wall ms, summed
    device-kernel ms, the busy share they give, the device launches and the
    five kernels with the most device time; every device kernel's name and
    device ms in the trace)."""
    wall, kernels, _, _ = profiled_kernels(fn)
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us == 0:
        return {"profile": "not measured (no device time in the trace)"}, {}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return ({"profiled_wall_ms": 1e3 * wall, "device_kernel_ms": dev_us / 1e3,
             "device_busy_share": dev_us / 1e6 / wall,
             "device_launches": sum(e.count for e in kernels),
             "memcpy_dtod": sum(e.count for e in kernels if e.key.startswith("Memcpy DtoD")),
             "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top}},
            {e.key: e.self_device_time_total / 1e3 for e in kernels})


def function_hits(key: str, functions) -> list:
    """The device functions among ``functions`` that a profiled kernel's
    name is: a plain name matching with any template arguments
    (``f<...>(``) and a templated one exactly (K29's ``box_blur<1>``)."""
    plain = re.sub(r"<[^()]*>", "", key)
    return [f for f in functions if f"::{f}(" in key or f"::{f}(" in plain]


# the kernels whose device ms this run reported, and the (kernel, device
# function) pairs that matched a profiled kernel
PROFILED_KERNELS: set = set()
MATCHED_FUNCTIONS: set = set()
# device functions that no profiled call launches: K23's word_majority runs
# only in build_vocabulary, before the profiled keyframe steps; K13's global
# pass only where a level's cell candidates (grid²·k_cell) outnumber its
# k_total, which no profiled frame's levels reach
UNPROFILED_FUNCTIONS = ("count_bits", "majority_bytes", "grid_global")


def kernel_device_ms(device_ms: dict, kernels) -> dict:
    """Each kernel's device ms in one profile: the sum over the profiled
    kernels named as one of its device functions, a plain name matching
    with any template arguments (``f<...>(``) and a templated one exactly
    (K29's ``box_blur<1>``); None where no profiled kernel matched (the
    kernel did not launch in the profiled call, or the trace dropped it),
    never a silent 0.0.  Every match is recorded for the run's closing
    check (``unmatched_device_functions``)."""
    out = {}
    PROFILED_KERNELS.update(kernels)
    for name in kernels:
        total = None
        for key, ms in device_ms.items():
            hits = function_hits(key, FRONTEND_DEVICE_FUNCTIONS[name])
            if hits:
                total = (total or 0.0) + ms
                MATCHED_FUNCTIONS.update((name, f) for f in hits)
        out[name] = total
    return out


def unmatched_device_functions() -> list:
    """The device functions of the kernels whose device ms this run
    reported that no profile of the run matched: a renamed function would
    otherwise drop out of its kernel's device time unseen."""
    return sorted((k, f) for k in PROFILED_KERNELS for f in FRONTEND_DEVICE_FUNCTIONS[k]
                  if (k, f) not in MATCHED_FUNCTIONS and f not in UNPROFILED_FUNCTIONS)


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


def queued_device_ms(fn, calls: int = 20) -> float:
    """Device ms a call of ``fn`` with the host ahead of the card: a sleep
    kernel of ~10 ms first, so that the calls queue behind it and run back
    to back; CUDA events around the calls.  For a call whose host path is
    longer than its kernels, where event-timed calls measure the host (and
    where a profile may hold no device time)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


# ---------------------------------------------------------------------------
# Bounds: the least time the card could take for a kernel's work
# ---------------------------------------------------------------------------

def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def describe_read_pixels(img, uv, pattern, angles) -> int:
    """The pixels of ``img`` (C, H, W) that K14's function reads for one row
    of keypoints ``uv``, each counted once: the 5x5 neighbourhood of every
    rotated, rounded and clipped sample (by the plain version's angles where
    the row has none given; the blur's zero padding outside the image is no
    read) and, where the angles are computed, the 15x15 disc of the
    intensity centroid."""
    from uzliti_slam_tpu_torch.ops import features

    C, H, W = img.shape
    dev = img.device
    seen = torch.zeros(C, H * W, dtype=torch.bool, device=dev)

    def mark(ys, xs):
        ys, xs = ys.reshape(C, -1), xs.reshape(C, -1)
        keep = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        cam = torch.arange(C, device=dev)[:, None].expand_as(ys)
        seen[cam[keep], (ys * W + xs)[keep]] = True

    if angles is None:
        angles = features.intensity_centroid_angles(img, uv)
        r = 7
        d = torch.arange(-r, r + 1, device=dev)
        dy, dx = torch.meshgrid(d, d, indexing="ij")
        disc = dx * dx + dy * dy <= r * r
        y0 = torch.clamp(uv[..., 1].to(torch.int32) - r, 0, H - 2 * r - 1).long()
        x0 = torch.clamp(uv[..., 0].to(torch.int32) - r, 0, W - 2 * r - 1).long()
        mark(y0[..., None] + dy[disc] + r, x0[..., None] + dx[disc] + r)
    ca, sa = torch.cos(angles)[..., None, None], torch.sin(angles)[..., None, None]
    px, py = pattern[..., 0], pattern[..., 1]
    xi = torch.clamp(torch.round(uv[..., 0, None, None] + (ca * px - sa * py)), 0, W - 1).long()
    yi = torch.clamp(torch.round(uv[..., 1, None, None] + (sa * px + ca * py)), 0, H - 1).long()
    o = torch.arange(-2, 3, device=dev)
    mark((yi[..., None, None] + o[:, None]).expand(*yi.shape, 5, 5),
         (xi[..., None, None] + o[None, :]).expand(*xi.shape, 5, 5))
    return int(seen.sum())


def frontier_relaxations(dist0, ef, et, w, n_iters: int) -> int:
    """The relaxations K5's function needs on these rows: in each sweep,
    every table entry (an edge of finite weight, not a self-loop, at each
    end) of the nodes whose value changed in the sweep before (in sweep 0,
    those of finite start value), counted from the plain version's values
    sweep by sweep up to the first sweep that changes nothing."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    keep = (w < kops.INF) & (ef != et)
    deg = torch.zeros(dist0.shape[1], dtype=torch.int64, device=dist0.device)
    deg.index_add_(0, ef[keep].long(), torch.ones_like(ef[keep], dtype=torch.int64))
    deg.index_add_(0, et[keep].long(), torch.ones_like(et[keep], dtype=torch.int64))
    d, changed, total = dist0, dist0 < kops.INF, 0
    for _ in range(n_iters):
        n = int((changed.long() * deg).sum())
        if not bool(changed.any()):
            break
        total += n
        nd = kops.relax_min_plain(d, ef, et, w, 1)
        changed, d = nd != d, nd
    return total


def label_work(sf, st, valid, max_dt: float, n_iters: int) -> int:
    """K6's labels' operations on these candidates: the adjacency test
    once for each unordered pair of valid candidates and the diagonal (two
    subtractions, two absolute values, two compares; the test is
    symmetric), then in each round a minimum for each adjacent pair (i, j),
    i != j, whose neighbour j's label changed in the round before (in round
    1, every valid j), counted from the plain version's labels round by
    round up to the first round with nothing changed before it, within
    ``n_iters``: the rule ``frontier_relaxations`` counts K5's sweeps by."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    b, nv = sf.shape[0], int(valid.sum())
    adj = ((torch.abs(sf[:, None] - sf[None, :]) < max_dt)
           & (torch.abs(st[:, None] - st[None, :]) < max_dt) & valid[:, None] & valid[None, :]
           & ~torch.eye(b, dtype=torch.bool, device=sf.device))
    labels, changed, total = kops.cluster_labels_plain(sf, st, valid, max_dt, 0), valid, 0
    for _ in range(n_iters):
        if not bool(changed.any()):
            break
        total += int((adj & changed[None, :]).sum())
        nxt = torch.minimum(labels, torch.where(adj, labels[None, :], b).min(-1).values)
        changed, labels = nxt != labels, nxt
    return 3 * nv * (nv + 1) + total


def reach_pairs(table, size: int, res: float, max_range: float, cx, cy) -> int:
    """K11's (cell, node) pairs on the grid whose centre-table distance is
    within reach, D < max_range + 0.71·res, summed over the nodes (cx, cy)
    by an integral image of that disk over the table."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    D = kops.unpack_center_tables(table)[0].reshape(size, size)
    disk = (D < max_range + 0.71 * res).long()
    S = torch.zeros(size + 1, size + 1, dtype=torch.long, device=D.device)
    S[1:, 1:] = disk.cumsum(0).cumsum(1)
    c0 = size // 2
    r0, r1 = (c0 - cy.long()).clamp(0, size), (c0 - cy.long() + size).clamp(0, size)
    q0, q1 = (c0 - cx.long()).clamp(0, size), (c0 - cx.long() + size).clamp(0, size)
    return int((S[r1, q1] - S[r0, q1] - S[r1, q0] + S[r0, q0]).sum())


def grid_pairs(size: int, cx, cy) -> int:
    """The (cell, node) pairs whose centre-table offset lies on the grid,
    in reach or not: the count K11's bound took before its reach was culled
    (reported beside ``reach_pairs``')."""
    rows = (size - (cy.long() - size // 2).abs()).clamp(min=0)
    cols = (size - (cx.long() - size // 2).abs()).clamp(min=0)
    return int((rows * cols).sum())


def kernel_work(name: str, args) -> tuple[int, int]:
    """(bytes, operations) one call must move and do on these inputs: each
    input read once and each output written once; operations counted from
    the kernel's arithmetic per edge, node, hypothesis or point (rounded
    counts of its multiplies, adds, compares and minima), over only the
    entries this data needs: the relaxations of the edges of the nodes that
    changed in the sweep before (K5, ``frontier_relaxations``), the valid
    candidates' adjacency tests once a pair and the adjacent pairs whose
    neighbour's label changed in the round before (K6, ``label_work``),
    roots with members and their valid points (K7), valid edges (K8)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    if name == "linearize":
        # in: the edge tables and the incidence table; out: Ji, Jj, W (E, 6,
        # 6) and grad, Hb, U (n, 78); ~4500 operations an edge (the kernel
        # computes each edge at both endpoints; the work needs it once)
        r, adj, info, valid, ef, et, free, both_free, is_chain, *_, table = args
        E, n = r.shape[0], free.shape[0]
        return (_nbytes(r, adj, info, valid, free, both_free, is_chain, *table)
                + 4 * (3 * 36 * E + 78 * n), 4500 * E)
    if name == "hvp":
        Ji, Jj, W, ef, et, v, damp, free = args
        return _nbytes(*args) + 4 * v.numel(), 360 * ef.shape[0] + 12 * v.shape[0]
    if name == "chain_apply":
        # per chain of the factor: 372 operations per odd block of a level
        # and the root's matvec
        (levels, root_inv, _), b = args
        B = root_inv.shape[0]
        halves = [lv[0].shape[1] for lv in levels]
        return (_nbytes(root_inv, b, *(m for lv in levels for m in lv)) + 4 * b.numel(),
                B * sum(372 * h for h in halves) + 2 * root_inv.numel())
    if name == "residual_chi2":
        poses, ef, et, meas, info, valid, _, *batch = args
        return (_nbytes(poses, ef, et, meas, info, valid)
                + 4 * (6 * ef.shape[0] + (batch[0] if batch else 1)), 400 * ef.shape[0])
    if name == "lm_candidate":
        # every node's retraction (~150 operations) and every edge's
        # residual and cost (K4's 400); each input read once, cand, r and
        # χ² written once
        poses, dx, free, ef, et, meas, info, valid, _, *batch = args
        B, E = (batch[0] if batch else 1), ef.shape[0]
        return (_nbytes(poses, dx, free, ef, et, meas, info, valid) + 4 * (7 * poses.shape[0]
                + 6 * E + B), 150 * poses.shape[0] + 400 * E)
    if name == "lm_accept":
        # the scalars of every instance; the rows of the accepted ones
        # copied (read from the candidate, written to the iterate)
        state, cand, r_cand, chi2_new, it, rules = args
        B = chi2_new.shape[0]
        active = (~state.done[it] if rules.early_exit and it > 0
                  else torch.ones_like(chi2_new, dtype=torch.bool))
        acc = int(((chi2_new < state.hist[:, it]) & active).sum())
        return (4 * B * 6 + 2 * acc * (_nbytes(cand) + _nbytes(r_cand)) // B, 20 * B)
    if name == "relax_table":
        # the edge table read, row_ptr and the kept edges' two entries
        # written; a test and a count an entry, the scan, the fill
        ef, et, w, n = args
        kept = int(((w < kops.INF) & (ef != et)).sum())
        return _nbytes(ef, et, w) + 4 * (n + 1) + 16 * kept, 3 * ef.shape[0] + 2 * n + 4 * kept
    if name == "relax_min":
        # 4 operations a relaxation (an add, the INF clamp, the compare
        # with the start value, the min)
        dist0, ef, et, w, n_iters = args
        return (2 * _nbytes(dist0) + _nbytes(ef, et, w),
                4 * frontier_relaxations(dist0, ef, et, w, n_iters))
    if name == "relax_pairs":
        sources, targets, ef, et, w, n, n_iters = args
        dist0 = torch.full((sources.shape[0], n), kops.INF, device=w.device).scatter(
            1, sources.long()[:, None], 0.0)
        return (_nbytes(sources, targets, ef, et, w) + 4 * sources.shape[0],
                4 * frontier_relaxations(dist0, ef, et, w, n_iters))
    if name == "relax_uncertainty":
        # the root's argmin (a compare a node), the relaxations, the write-back
        stamp, node_valid, unc, ef, et, w, n_iters = args
        n = stamp.shape[0]
        root = torch.argmin(torch.where(node_valid, stamp, kops.INF))
        dist0 = torch.full((1, n), kops.INF, device=w.device).index_fill(1, root.view(1), 0.0)
        relax = frontier_relaxations(dist0, ef, et, w, n_iters) if bool(node_valid.any()) else 0
        return _nbytes(stamp, node_valid, unc, ef, et, w) + 4 * n, 2 * n + 4 * relax
    if name == "cluster_labels":
        sf, st, valid, max_dt, n_iters = args
        return _nbytes(sf, st, valid) + 4 * sf.shape[0], label_work(sf, st, valid, max_dt, n_iters)
    if name == "cluster_roots":
        # the candidates' slots and their gathered edge ends, masks and
        # stamps read; validity, labels, stamps, the roots and the member
        # masks written; the labels' work, 5 statistics a valid candidate,
        # the gates and compaction a slot, the member tests
        cand, ef, et, e_valid, node_valid, stamp, max_dt, _, _, n_iters, cand_mask = args
        b = cand.shape[0]
        r = kops.cluster_root_count(b, args[7])
        out = kops.cluster_roots_plain(*args[:10], cand_mask=cand_mask)
        nv = int(out.valid.sum())
        # in: 4 + 8 + 1 + 2 + 8 bytes a slot; out: 1 + 4 + 8 a slot, 9 a root row + its mask
        return (36 * b + 9 * r + r * b,
                label_work(out.sf, out.st, out.valid, max_dt, n_iters) + 5 * nv + 6 * b + r * b)
    if name == "ransac_rigid":
        # the tables, flags (and weights) read once, the outputs written
        # once; per root K Horn fits (~1350) and the refit (~2000), per valid
        # point K consensus tests (~40) and the refit's sums (~110).  The
        # draw, where the kernel makes it: the uniforms (and quality) read,
        # the triplets written; per entry its weight (~25 with the exp) and
        # the scan, per uniform a bisection of log2(M) steps
        src, dst, valid, tri, _, _, _, weights, *draw = args + (None,) * (10 - len(args))
        uniforms, quality = draw
        R, M, _ = src.shape
        K = tri.shape[1] if tri is not None else uniforms.shape[1] // 3
        roots, points = int(valid.any(-1).sum()), int(valid.sum())
        table = sum(12 * M * (1 if t.stride(0) == 0 else R) for t in (src, dst))
        inputs = _nbytes(valid, *(t for t in (weights, tri, uniforms, quality) if t is not None))
        nbytes = table + inputs + R * (4 * (7 + 1 + 1 + 36 + 1) + 1) + 4 * R * K
        ops = roots * (1350 * K + 2000) + points * (40 * K + 110)
        if tri is None:
            nbytes += 12 * R * K
            ops += R * M * (25 if quality is not None else 2) + 3 * R * K * (
                2 + 2 * max(M - 1, 1).bit_length())
        return nbytes, ops
    if name == "components":
        # the edge table read once, the nodes' fields read and the labels
        # and gauge written once; per round K8 runs on these inputs (to the
        # first that changes no label) two minima a valid edge and two jumps
        # a node, then ~6 operations a node for the gauge
        ef, et, ev, nv, nf, stamp, n, iters = args
        rounds = torch.zeros((), dtype=torch.int32, device=ef.device)
        kops.components_plain(ef, et, ev, n, iters, rounds=rounds)
        return (_nbytes(ef, et, ev, nv, nf, stamp) + 5 * n,
                int(rounds) * (2 * int(ev.sum()) + 2 * n) + 6 * n)
    if name == "chain_factor":
        # per odd block of a level: two 6x6 Schur inverses (~250 operations
        # each) and eight 6x6 products (432 each); the root: m inverses and
        # 2m products, then 6m column solves of m blocks (216 each).  Only
        # live odd blocks count: those holding a row of the unpadded chain.
        # The same per chain of a batch.
        D, U, cutoff, *batch = args
        B = batch[0] if batch else 1
        n = D.shape[0] // B
        halves, m = kops._factor_shapes(n, cutoff)
        live, n_valid = 0, n
        for _ in halves:
            n_valid = -(-n_valid // 2)
            live += n_valid
        out = 4 * (5 * 36 * sum(halves) + 36 * m * m)
        return (_nbytes(D, U) + B * out,
                B * (live * (2 * 250 + 8 * 432) + m * (250 + 2 * 432) + 6 * m * m * 216))
    if name == "pcg":
        # a 12-step PCG's vector updates: b, z0, and each step's Hp and z
        # read once, x written once; 4 + 12·10 operations per entry
        b, steps = args
        return 4 * b.numel() * (2 + 2 * steps + 1), b.numel() * (4 + 10 * steps)
    if name == "pcg_chain":
        # one step: K3's apply (the factor's products and root read once)
        # and K10's step (p, Hp, x, r and scal read; x, r, p and scal
        # written; 10 operations per entry)
        factor, b = args
        apply_bytes, apply_ops = kernel_work("chain_apply", (factor, b))
        return (apply_bytes - 8 * b.numel() + 4 * 7 * b.numel() + 32,
                apply_ops + 10 * b.numel())
    if name == "pcg_grid":
        # K37's step is K34's: the same bytes and operations
        return kernel_work("pcg_chain", args)
    if name == "pcg_chain_solve":
        # K34's start and `steps` times (K34's step + K2's product): the
        # operations of each; the bytes of the whole solve, each input (the
        # factor, the operator and its table, b) read once and x, r, p and
        # scal written once
        factor, op, b, steps = args
        (levels, root_inv, _) = factor
        apply_bytes, apply_ops = kernel_work("chain_apply", (factor, b))
        _, step_ops = kernel_work("pcg_chain", (factor, b))
        _, hvp_ops = kernel_work("hvp", tuple(op[:5]) + (b,) + tuple(op[5:7]))
        return (_nbytes(root_inv, *(m for lv in levels for m in lv), *op[:7], *op.table, b)
                + 4 * 3 * b.numel() + 16, apply_ops + 4 * b.numel() + steps * (step_ops + hvp_ops))
    if name == "pcg_fleet_solve":
        # K35's count for the whole solve of every instance (the factor, the
        # operator and its table, b read once; x, r, p and scal written
        # once), over the operator's valid edges only (the kernel reads no
        # other): their Jᵢ, Jⱼ, W (432 bytes), endpoints and two table
        # entries, the table's row offsets, damp and free
        factor, op, b, k = args
        valid = int(op.table.row_ptr[-1]) // 2
        op_bytes = (valid * (432 + 8 + 8) + 4 * op.table.row_ptr.numel()
                    + _nbytes(op.damp, op.free))
        hvp_ops = 360 * valid + 12 * b.shape[0]
        levels, root_inv, _ = factor
        _, apply_ops = kernel_work("chain_apply", (factor, b))
        _, step_ops = kernel_work("pcg_chain", (factor, b))
        return (_nbytes(root_inv, *(m for lv in levels for m in lv), b) + op_bytes
                + 4 * 3 * b.numel() + 16 * root_inv.shape[0],
                apply_ops + 4 * b.numel() + k * (step_ops + hvp_ops))
    if name == "project_rays":
        # base, table and the active nodes' scans and scalars read once,
        # the grid written once; ~20 operations per (cell, node) pair on the
        # grid within the node's reach (D < max_range + 0.71·res: the others'
        # terms are 0)
        (logodds, cx, cy, kbin, scans, idx, count, table, res, max_range, *_rest) = args
        c = int(count)
        nodes = idx[:c].long()
        return (_nbytes(logodds, table) + 4 * logodds.numel() + c * (4 * scans.shape[1] + 16),
                20 * reach_pairs(table, logodds.shape[0], res, max_range, cx[nodes], cy[nodes]))
    if name == "fast_nms":
        # every level's image read and its scores written once; per pixel
        # inside the 21-px border 16 differences, 32 compares, ~20 mask
        # operations and the sums (2 per passing ring pixel, counted for all
        # 16), per pixel 11 for the 3x3 maximum and the test
        imgs, _ = args
        nbytes = ops = 0
        for img in [imgs] if isinstance(imgs, torch.Tensor) else imgs:
            C, H, W = img.shape
            inner = C * max(H - 42, 0) * max(W - 42, 0)
            nbytes, ops = nbytes + 2 * _nbytes(img), ops + 100 * inner + 11 * img.numel()
        return nbytes, ops
    if name == "grid_topk":
        # every level's scores read once, its keypoints written once; a
        # compare and a select per score of the grid (one pass selects a
        # cell's k_cell <= 8)
        scores, k_total, grid = args
        levels = [scores] if isinstance(scores, torch.Tensor) else list(scores)
        nbytes = ops = 0
        for score in levels:
            C, H, W = score.shape
            gh, gw, _, _ = kops._grid_shapes(H, W, k_total, grid)
            nbytes += _nbytes(score) + C * k_total * 13
            ops += 2 * C * grid * grid * gh * gw
        return nbytes, ops
    if name == "orb_describe_levels":
        # per row its keypoints, pattern and given angles read once, its
        # angles and descriptors written once, and the pixels of its images
        # that the function reads (describe_read_pixels), each once; per
        # keypoint the moments where the angle is computed (4 operations on
        # each of 177 disc pixels) and 512 samples (~8 for the rotation and
        # rounding, 24 adds and a multiply for the 5x5 sum), and a compare
        # per test
        blocks, = args
        nbytes = ops = 0
        for row in (row for block in blocks for row in block):
            kps = row.uv.shape[0] * row.uv.shape[1]
            nbytes += (4 * describe_read_pixels(*row) + _nbytes(row.uv, row.pattern)
                       + kps * (4 + 32) + (0 if row.angles is None else _nbytes(row.angles)))
            ops += kps * ((4 * 177 if row.angles is None else 0) + 512 * 33 + 256)
        return nbytes, ops
    if name == "scan_bins":
        # depth and transforms read once, near and far written once; ~60
        # operations per pixel (backprojection, extrinsic, range, atan2 as
        # ~20, tests, bin, the two atomics); the cluster's merge: per bin of
        # a camera 16 tables' min and max and the write-back (~36)
        depth, _, xf, n_bins, *_ = args
        return (_nbytes(depth, xf) + 8 * depth.shape[0] * n_bins,
                60 * depth.numel() + 36 * depth.shape[0] * n_bins)
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
        # 3 per entry for the gate, and a compare per entry for each pass of
        # 8 keys taken
        query, bank, stamp, valid, q_stamp, k, min_dt, _ = args
        elig = int((valid & ((stamp - q_stamp).abs() >= min_dt)).sum())
        passes = -(-k // 8)
        return (_nbytes(query, bank, stamp, valid, q_stamp) + 9 * k,
                24 * elig + (3 + 2 * passes) * bank.shape[0])
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
        # poses, stamps and flags read once, the pairs written once; what
        # this data needs (``merge_pair_work``): a stamp compare for every
        # ordered pair of eligible nodes, the distance test (~9 operations)
        # for the pairs whose stamps are in order, the rotation gate (~150)
        # only for those within dist_thresh, then the rounds: 8 a kept key
        # a round
        pose, stamp, elig, dist, angle, max_pairs = args
        w = merge_pair_work(pose, stamp, elig, dist, angle, max_pairs)
        return (_nbytes(pose, stamp, elig) + 9 * max_pairs,
                w["eligible_pairs"] + 9 * w["ordered_pairs"] + 150 * w["near_pairs"]
                + 8 * max_pairs * w["kept_keys"])
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
        # points and flags read once, near and far written once; per valid
        # point the range (abs, max, min, a division, a fused multiply-add,
        # a square root, a product: ~12), the bearing (atan2, ~20), the gates
        # (~6), the bin and quantised range (~8) and the two atomics; per bin
        # the write-back
        points, valid, n_bins, *_ = args
        b = valid.numel() // valid.shape[-1]
        return (_nbytes(points, valid) + 8 * b * n_bins,
                48 * int(valid.sum()) + 4 * b * n_bins)
    if name == "feature_votes":
        # the query and the eligible nodes' descriptors and flags read once,
        # stamps and flags of every node, the top-k written once; the
        # scalar part: k rounds of two compares per node (the pairs' bit
        # operations are tensor_work's)
        query, qvalid, bank, bank_valid, stamp, valid, q_stamp, k, _, _, min_dt = args
        elig = valid & ((stamp - q_stamp).abs() >= min_dt)
        return (_nbytes(query, qvalid, stamp, valid) + 33 * bank.shape[1] * int(elig.sum())
                + 9 * k, 2 * k * stamp.shape[0])
    if name == "repo_nearest":
        # the query flags, the valid queries and the valid stored descriptors
        # read once, the valid queries' nearest and duplicate flags written
        # once (an invalid query's are never read); no scalar part
        query, qvalid, bank, bank_valid, _ = args
        nq, nv = int(qvalid.sum()), int(bank_valid.sum())
        return _nbytes(qvalid, bank_valid) + 32 * (nq + nv) + 9 * nq, 0
    if name == "repo_votes":
        # the query and the valid stored descriptors with their link rows
        # read once, the node stamps and flags, the top-k written once; the
        # scalar part: k rounds of three operations per node
        query, qvalid, bank, bank_valid, links, link_valid, stamp, valid, *_rest = args
        k, nv, L = _rest[1], int(bank_valid.sum()), links.shape[1]
        return (_nbytes(query, qvalid, bank_valid, stamp, valid) + (32 + 5 * L) * nv + 9 * k,
                3 * k * stamp.shape[0])
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
    if name == "pnp_ransac":
        # per draw the selection (2 compares a key), then what a direct SVD
        # of each system costs for its singular values and right vectors
        # (Golub-Reinsch, 4mn² + 8n³ flops: the 12x12 DLT 20,736, the 12x9
        # homography 9,720, the 6x3 plane 432), and the small fits (~3000);
        # the K x M consensus (~40 flops each) and 8 Gauss-Newton steps over
        # the best hypothesis' rows (~300 flops a point: the projection, its
        # 3x6 Jacobian, the 21 + 6 sums); inputs read once, the samples,
        # hypotheses, counts and results written once
        X, xn, valid, depth, keys, *_ = args
        B, H, M = keys.shape
        K = (2 if depth is None else 3) * H
        svd = sum(4 * m * n * n + 8 * n ** 3 for m, n in ((12, 12), (12, 9), (6, 3)))
        return (_nbytes(X, xn, valid, keys, *(() if depth is None else (depth,)))
                + B * H * 24 + B * K * 32 + B * 41,
                B * H * (2 * M + svd + 3000) + B * (40 * K * M + 8 * 300 * M))
    if name == "sift_describe":
        # image, keypoints and window read once, angles and descriptors
        # written once; the blur's 4 adds and a multiply per pixel, and per
        # keypoint the moments (4 operations on each of 177 disc pixels),
        # 324 rotated samples (~10 operations each), 256 gradient samples
        # (differences, magnitude, window, atan2 as ~20, the bin and two
        # votes: ~50 each) and the two normalisations (~6 per entry)
        img, uv, window = args
        kps = uv.shape[0] * uv.shape[1]
        return (_nbytes(img, uv, window) + kps * (4 + 512),
                5 * img.numel() + kps * (4 * 177 + 324 * 10 + 256 * 50 + 128 * 6))
    if name in SCOPE_KERNELS:        # args: (the wrapper's arguments, its keywords)
        return scope_work(name, *args)
    if name == "l2_top2":
        # both tables and masks read once, idx, ok and best written once; a
        # multiply and an add per (query, stored, dimension), the norms, and
        # per pair the distance (4) and the running top-2 (3)
        a, b, va, vb, *_ = args
        (na, d), nb = a.shape, b.shape[0]
        return (_nbytes(a, b, va, vb) + 9 * na,
                2 * na * nb * d + 2 * (na + nb) * d + 7 * na * nb)
    raise KeyError(name)


# bit operations a (query, stored) pair of 256-bit descriptors: AND and
# popcount over 256 bits
PAIR_BIT_OPS = 512
# the scalar form's count, kept beside it: 8 XORs, 8 popcounts, 8 adds a pair
PAIR_SCALAR_OPS = 24


def recognition_pairs(name: str, args) -> int:
    """The (valid query, valid stored) pairs of K21's and K22's entries on
    these inputs: K21 over the eligible nodes, K22's search with the pairs
    of valid queries for the duplicates; 0 for any other kernel."""
    if name == "feature_votes":
        query, qvalid, bank, bank_valid, stamp, valid, q_stamp, *_, min_dt = args
        elig = valid & ((stamp - q_stamp).abs() >= min_dt)
        return int(qvalid.sum()) * int(bank_valid[elig].sum())
    if name == "repo_nearest":
        nq, nv = int(args[1].sum()), int(args[3].sum())
        return nq * nv + nq * (nq - 1) // 2
    if name == "repo_votes":
        return int(args[1].sum()) * int(args[3].sum())
    return 0


def tensor_work(name: str, args) -> int:
    """Operations of a call on the tensor cores' b1 path: K21's and K22's
    pairs at PAIR_BIT_OPS each."""
    return PAIR_BIT_OPS * recognition_pairs(name, args)


def scalar_pair_bound_ms(calls: dict, wrappers) -> float:
    """The bound as stated before K21 and K22 moved to the tensor cores:
    bytes against PAIR_SCALAR_OPS a pair (plus the scalar part) at the
    scalar rate."""
    nbytes = ops = 0
    for w in wrappers:
        for args, kw in calls[w]:
            a = (*args, *kw.values())
            b, o = kernel_work(w, a)
            nbytes, ops = nbytes + b, ops + o + PAIR_SCALAR_OPS * recognition_pairs(w, a)
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S)


def merge_pair_work(pose, stamp, eligible, dist_thresh, angle_thresh, max_pairs) -> dict:
    """The pairs K19's function needs on these inputs, counted with the
    plain version's gates row block by row block: ordered pairs of eligible
    nodes, those whose stamps are in order, those of them within
    dist_thresh, and the keys the rows keep (each row's close pairs, at
    most 2·max_pairs - 1)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    n, t, q = pose.shape[0], pose[:, :3], pose[:, 3:]
    ne = int(eligible.sum())
    out = {"eligible_pairs": ne * (ne - 1), "ordered_pairs": 0, "near_pairs": 0, "kept_keys": 0}
    for r0 in range(0, n, 1024):
        r1 = min(n, r0 + 1024)
        dt, dr = kops.merge_pair_gates_plain(t[r0:r1, None], q[r0:r1, None], t[None], q[None])
        ordered = (eligible[r0:r1, None] & eligible[None, :]
                   & (stamp[r0:r1, None] < stamp[None, :]))
        near = ordered & (dt < dist_thresh)
        close = near & (dr < angle_thresh)
        out["ordered_pairs"] += int(ordered.sum())
        out["near_pairs"] += int(near.sum())
        out["kept_keys"] += int(close.sum(1).clamp(max=2 * max_pairs - 1).sum())
    return out


def merge_pairs_all_pairs_bound(args) -> float:
    """K19's bound as counted before the distance test went first (~150
    operations for each of ne·(ne-1)/2 pairs, the rounds over N·K slots),
    kept beside the recount."""
    pose, _, elig, _, _, max_pairs = args
    ne, n = int(elig.sum()), pose.shape[0]
    ops = 150 * ne * (ne - 1) // 2 + 8 * max_pairs * n * (2 * max_pairs - 1)
    return 1e3 * ops / SCALAR_OPS_PER_S


def device_launch_count(fn, functions, calls: int = 4, reads: int = 2):
    """Device launches a call of the kernels named by ``functions``, read
    from ``reads`` profiles of ``calls`` calls of ``fn`` that held a marker
    (``whole_profile``).  A lost record can only lower a count, so the
    largest is taken: (launches a call, or None where a read found no such
    profile; the profiles taken)."""
    best, taken = 0, 0
    for _ in range(reads):
        whole, n = whole_profile(lambda: [fn() for _ in range(calls)])
        taken += n
        if whole is None:
            return None, taken
        best = max(best, sum(e.count for e in whole[1] if function_hits(e.key, functions)))
    return best / calls, taken


def bound(name: str, args) -> dict:
    """The larger of the bytes over device memory's rate and the operations
    over their rate (the scalar rate; ``tensor_work``'s at the b1 mma's
    measured rate), in ms, and which of the two it is."""
    nbytes, ops = kernel_work(name, args)
    tops = tensor_work(name, args)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / SCALAR_OPS_PER_S + tops / B1_AND_POPC_OPS_PER_S
    return {"bytes": nbytes, "ops": ops + tops, "bound_ms": 1e3 * max(t_bytes, t_ops),
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
    """The inputs each solve kernel gets in the first LM iteration (K10 and
    K35: the first PCG solve's operators and right-hand side; K36: its step
    and the loop's state; "table" the solve's incidence table, which K1 and
    K35 take)."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops

    free = (g.node_valid & ~solver.gauge_fix_mask(g, solver.connected_components(g))).float()
    p = solver._Problem(g, free, cfg)
    gen = torch.Generator().manual_seed(SEED + 1)
    r0, chi2_0 = p.residuals(g.pose)
    Ji, Jj, W, grad, Hb, U = p.linearize(r0)
    lam = torch.full((1,), cfg.lambda_init, device=g.device)
    damp = p.damp(lam, Hb)
    pack = p.build_pack(Hb, U, damp)
    Dm = torch.where(free[:, None, None] > 0, Hb + torch.diag_embed(damp), p.eye6)
    v = torch.randn(g.node_capacity, 6, generator=gen).to(g.device)
    op = kops.HvpOperator(Ji, Jj, W, g.e_from, g.e_to, damp, free, p.table)
    dx = solver._pcg(lambda u: kops.hvp(Ji, Jj, W, g.e_from, g.e_to, u, damp, free), pack, -grad,
                     cfg.pcg_iterations, cfg.pcg_tol, op=op)
    return {
        "chain_factor_damped": (Hb, U, cfg.chain_dense_cutoff, damp, free),
        "lm_candidate": (g.pose, dx, free, g.e_from, g.e_to, g.e_transform, g.e_info, p.valid,
                         cfg.huber_delta),
        "lm_state": (g.pose, r0, chi2_0, cfg.iterations, cfg.lambda_init),
        "lm_rules": p.rules(cfg.early_exit),
        "residual_chi2": (g.pose, g.e_from, g.e_to, g.e_transform, g.e_info, p.valid,
                          cfg.huber_delta),
        "linearize": (r0, p.adj_meas_inv, g.e_info, p.valid, g.e_from, g.e_to, free,
                      p.both_free, p.is_chain, cfg.huber_delta),
        "hvp": (Ji, Jj, W, g.e_from, g.e_to, v, damp, free),
        "chain_apply": (pack, -grad),
        "chain_factor": (Dm, U, cfg.chain_dense_cutoff),
        "pcg": (Ji, Jj, W, g.e_from, g.e_to, damp, free, pack, -grad, cfg.pcg_iterations,
                cfg.pcg_tol),
        "pcg_chain_solve": (pack, kops.HvpOperator(Ji, Jj, W, g.e_from, g.e_to, damp, free,
                                                   p.table), -grad, cfg.pcg_iterations,
                            cfg.pcg_tol),
        "table": p.table,
    }


def compare_kernels(g, label: str, time_split: bool = True):
    """Each solve kernel against its plain version on the same card inputs;
    K3 and K10 (``SPLIT_PCG``) checked but not timed unless ``time_split``
    (only the fleet runs them on a main path; phase 17 times them there)."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops

    inputs = kernel_inputs(g, solver.SolverConfig(**HEADLINE))
    results = {"linearize": compare_linearize(inputs["linearize"], inputs["table"], label)}
    for name in ("residual_chi2", "hvp", "chain_apply"):
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
        if time_split or name not in SPLIT_PCG:
            row["ms"], row["plain_ms"] = time_pair(lambda: kernel_fn(*args),
                                                   lambda: plain_fn(*args))
        row.update(bound(name, args))
        log(f"3 kernel {name} {label}", **row)
        check(rel <= KERNEL_TOL[name],
              f"{name} {label}: rel err {rel:.3g} > {KERNEL_TOL[name]}")
        results[name] = row
    results["chain_factor"] = compare_chain_factor(inputs["chain_factor"], label,
                                                   inputs["chain_factor_damped"])
    results["pcg"] = compare_pcg(inputs["pcg"], label, timed=time_split)
    results.update(compare_lm_step(inputs, label))
    return results


def _states_equal(a, b, early: bool) -> bool:
    """Two ``LmState``s hold the same bits (the early exit's rows from 1 on:
    row 0 is not read)."""
    same = all(bool(torch.equal(getattr(a, f), getattr(b, f)))
               for f in ("poses", "r", "hist", "lam", "acc"))
    if early:
        same = same and bool(torch.equal(a.gain, b.gain)) and all(
            bool(torch.equal(getattr(a, f)[1:], getattr(b, f)[1:]))
            for f in ("done", "stale", "need"))
    return same


def compare_lm_step(inputs: dict, label: str, batch: int = 1) -> dict:
    """K36 against its plain versions on the first LM iteration's step:
    ``lm_candidate`` (cand within CAND_RTOL of the eager retraction's, r and
    χ² within KERNEL_TOL of K4's plain version on the kernel's cand and
    bit-equal to K4 on it; a bit-identical rerun), timed beside its plain
    version and beside what the loop ran before it (the eager retraction,
    then K4); ``lm_accept`` over 20 iterations of seeded χ² in both loop
    forms, every scalar and row of the state equal, one call timed."""
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.ops import lie

    args = inputs["lm_candidate"] + (batch,)
    poses, dx, free, ef, et, meas, info, valid, huber, _ = args
    got, ref = kops.lm_candidate(*args), kops.lm_candidate_plain(*args)
    r4, chi4 = kops.residual_chi2(got[0], ef, et, meas, info, valid, huber, batch)
    on_cand = kops.residual_chi2_plain(got[0], ef, et, meas, info, valid, huber, batch)
    rerun = kops.lm_candidate(*args)
    torch.cuda.synchronize()
    cand_err = _rel(got[0], ref[0])
    errs = [_rel(a, b) for a, b in zip(got[1:], on_cand)]
    eager = [_rel(a, b)[1] for a, b in zip(got[1:], ref[1:])]
    as_k4 = bool(torch.equal(got[1], r4)) and bool(torch.equal(got[2], chi4))
    same = all(bool(torch.equal(a, b)) for a, b in zip(got, rerun))
    row = {"max_abs_err": max([cand_err[0]] + [e for e, _ in errs]),
           "max_rel_err": max(r for _, r in errs), "cand_rel_err": cand_err[1],
           "cand_rtol": CAND_RTOL, "r_rel_err": errs[0][1], "chi2_rel_err": errs[1][1],
           "r_rel_err_vs_eager_cand": eager[0], "chi2_rel_err_vs_eager_cand": eager[1],
           "tol_rel": KERNEL_TOL["lm_candidate"], "r_chi2_bit_equal_to_k4": as_k4,
           "rerun_bit_identical": same, "library_ms": None}
    row["ms"], row["plain_ms"] = time_pair(lambda: kops.lm_candidate(*args),
                                           lambda: kops.lm_candidate_plain(*args))
    row["replaced_ms"] = time_call(lambda: kops.residual_chi2(
        lie.pose_retract(poses, dx * free[:, None]), ef, et, meas, info, valid, huber, batch))
    row.update(bound("lm_candidate", args))
    log(f"3 kernel lm_candidate {label}", **row)
    check(row["max_rel_err"] <= KERNEL_TOL["lm_candidate"] and cand_err[1] <= CAND_RTOL,
          f"lm_candidate {label}: rel err r/χ² {row['max_rel_err']:.3g}, cand {cand_err[1]:.3g}")
    check(as_k4 and same, f"lm_candidate {label}: r, χ² not K4's bits or a rerun differs")
    rows = {"lm_candidate": row}

    cand, r_cand, _ = got
    st_args, rules = inputs["lm_state"], inputs["lm_rules"]
    iterations, chi2_0 = st_args[3], st_args[2]
    scales = (0.2 + 1.6 * torch.rand(iterations, batch,
                                     generator=torch.Generator().manual_seed(SEED + 9)))
    scales = scales.to(cand.device)
    equal = {}
    for early in (False, True):
        rl = rules._replace(early_exit=early)
        sk, sp = kops.lm_state(*st_args, batch), kops.lm_state(*st_args, batch)
        for it in range(iterations):
            kops.lm_accept(sk, cand, r_cand, chi2_0 * scales[it], it, rl)
            kops.lm_accept_plain(sp, cand, r_cand, chi2_0 * scales[it], it, rl)
        equal["early_exit" if early else "fixed"] = _states_equal(sk, sp, early)
        accepted = int(sk.acc.sum())
    sk, sp = kops.lm_state(*st_args, batch), kops.lm_state(*st_args, batch)
    c2 = chi2_0 * scales[0]
    row = {"max_abs_err": 0.0 if all(equal.values()) else math.inf,
           "max_rel_err": 0.0 if all(equal.values()) else math.inf,
           "tol_rel": KERNEL_TOL["lm_accept"], "states_equal": equal,
           "accepted_of_20_early_exit": accepted, "library_ms": None}
    row["ms"], row["plain_ms"] = time_pair(
        lambda: kops.lm_accept(sk, cand, r_cand, c2, 0, rules),
        lambda: kops.lm_accept_plain(sp, cand, r_cand, c2, 0, rules))
    row.update(bound("lm_accept", (sk, cand, r_cand, c2, 0, rules)))
    log(f"3 kernel lm_accept {label}", **row)
    check(all(equal.values()), f"lm_accept {label}: states differ {equal}")
    rows["lm_accept"] = row
    return rows


_ATOMIC_K1 = {}     # the loaded A/B reference of K1 (start_atomic_k1_build, load_atomic_k1)


def start_atomic_k1_build():
    """Start nvcc on K1's A/B reference (the atomic kernel it replaced,
    ATOMIC_K1_SOURCE, with the package's lie.cuh) beside the package's own
    build; ``load_atomic_k1`` waits for it."""
    import os

    from uzliti_slam_tpu_torch.kernels import _build

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), ATOMIC_K1_SOURCE)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / "liblinearize_atomic.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC), "-o",
           str(out), src]
    _ATOMIC_K1["build"] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True), out, cmd)


def load_atomic_k1() -> None:
    import ctypes

    proc, out, cmd = _ATOMIC_K1.pop("build")
    _, err = proc.communicate(timeout=600)
    check(proc.returncode == 0, f"nvcc failed on {ATOMIC_K1_SOURCE}: {' '.join(cmd)}\n{err}")
    lib = ctypes.CDLL(str(out))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.uz_linearize_atomic.argtypes = [P] * 9 + [F, I, I, I] + [P] * 7
    lib.uz_linearize_atomic.restype = ctypes.c_int
    _ATOMIC_K1["lib"] = lib


def atomic_linearize(r, adj, info, valid, ef, et, free, both_free, is_chain, huber_delta,
                     col_mask=None):
    """The atomic kernel K1 replaced, on the same inputs, as its wrapper ran
    it (the node rows zeroed first): (Ji, Jj, W, grad, Hb, U)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    E, n = r.shape[0], free.shape[0]
    J = torch.empty(3, E, 6, 6, device=r.device)
    acc = torch.zeros(78 * n, device=r.device)
    grad, Hb, U = acc[: 6 * n], acc[6 * n: 42 * n], acc[42 * n:]
    err = _ATOMIC_K1["lib"].uz_linearize_atomic(
        *(t.data_ptr() for t in (r, adj, info, valid, ef, et, free, both_free, is_chain)),
        float(huber_delta), E, n, kops._column_bits(col_mask),
        *(t.data_ptr() for t in (J[0], J[1], J[2], grad, Hb, U)),
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, f"uz_linearize_atomic: cudaError_t {err}")
    return J[0], J[1], J[2], grad.view(n, 6), Hb.view(n, 6, 6), U.view(n, 6, 6)


def compare_linearize(args, table, label: str) -> dict:
    """K1 against its plain version (node rows within KERNEL_TOL of each
    output's largest entry: another summation order), its Jᵢ, Jⱼ and W
    against the atomic kernel it replaced bit for bit, a rerun bit for bit;
    timed beside the plain version and, in turns, beside the atomic
    kernel."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    def kernel():
        return kops.linearize(*args, table=table)

    got, again, ref = kernel(), kernel(), kops.linearize_plain(*args)
    old = atomic_linearize(*args)
    torch.cuda.synchronize()
    err = rel = old_rel = 0.0
    for a, b, c in zip(got, ref, old):
        check(bool(torch.isfinite(a).all()), f"linearize {label}: non-finite output")
        e, r = _rel(a, b)
        err, rel, old_rel = max(err, e), max(rel, r), max(old_rel, _rel(c, b)[1])
    row = {"max_abs_err": err, "max_rel_err": rel, "tol_rel": KERNEL_TOL["linearize"],
           "atomic_max_rel_err": old_rel,
           "jacobians_bit_equal_to_atomic": all(bool(torch.equal(a, c))
                                                 for a, c in zip(got[:3], old[:3])),
           "rerun_bit_identical": all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
           "table_entries": int(table.row_ptr[-1]), "library_ms": None}
    row["ms"], row["plain_ms"] = time_pair(kernel, lambda: kops.linearize_plain(*args))
    row["ms_beside_atomic"], row["atomic_ms"] = time_pair(kernel, lambda: atomic_linearize(*args))
    row.update(bound("linearize", tuple(args) + (table,)))
    log(f"3 kernel linearize {label}", **row)
    check(rel <= KERNEL_TOL["linearize"], f"linearize {label}: rel err {rel:.3g}")
    check(row["jacobians_bit_equal_to_atomic"],
          f"linearize {label}: Ji, Jj or W differ from the atomic kernel's")
    check(row["rerun_bit_identical"], f"linearize {label}: a rerun gives other bits")
    return row


def compare_pcg_chain_solve(inputs, label: str, cmask=None, timed: bool = True) -> dict:
    """K35 against its plain version: the whole 12-step solve, x within
    1e-4 of max|x|, the same stall flag at every step (K35 run for 1, 2, ...
    steps: its scal[2] after the last), x and scal bit-identical over two
    launches; with ``cmask`` the generic loop's planar form (b masked, H and
    M⁻¹ wrapped).  ``timed``: against the calls it replaces (K34's start,
    then 12 times K2 and K34's step) in alternating turns, and its plain
    version."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    pack, op, b, steps, tol = inputs
    check(kops.pcg_chain_route(pack), f"pcg_chain_solve {label}: not on K34's route")
    if cmask is not None:
        b = b * cmask

    def fused(k=steps):
        return kops.pcg_chain_solve(pack, op, b, k, tol, cmask)

    st, st2 = fused(), fused()
    ok_k = torch.stack([fused(k).scal[0, 2] for k in range(1, steps + 1)])
    sp, ok_p = kops.pcg_chain_start_plain(pack, b, 1, cmask), []
    for _ in range(steps):
        kops.pcg_chain_step_plain(pack, kops._masked_hvp(op, sp.p, cmask), sp, tol, cmask)
        ok_p.append(sp.scal[0, 2].clone())
    ok_p = torch.stack(ok_p)
    torch.cuda.synchronize()
    err, rel = _rel(st.x, sp.x)
    levels, root_inv, _ = pack
    row = {"max_abs_err": err, "max_rel_err": rel, "tol_rel": KERNEL_TOL["pcg_chain_solve"],
           "rows": int(b.shape[0]), "edges": int(op.e_from.shape[0]),
           "table_entries": int(op.table.row_ptr[-1]), "levels": len(levels),
           "root_blocks": root_inv.shape[-1] // 6, "column_mask": cmask is not None,
           "steps": steps, "ok_pattern": [int(v) for v in ok_k.cpu().tolist()],
           "same_ok_pattern": bool(torch.equal(ok_k, ok_p)),
           "rerun_bit_identical": bool(torch.equal(st.x, st2.x) and torch.equal(st.scal, st2.scal)),
           "library_ms": None}
    if timed:
        def k2(v):
            if cmask is None:
                return kops.hvp(*op[:5], v, op.damp, op.free)
            return kops.hvp(*op[:5], v * cmask, op.damp, op.free) * cmask

        def replaced():
            s = kops.pcg_chain_start(pack, b, 1, cmask)
            for _ in range(steps):
                kops.pcg_chain_step(pack, k2(s.p), s, tol, cmask)

        row["ms"], row["replaced_ms"] = time_pair(fused, replaced)
        row["replaced_over_fused"] = row["replaced_ms"] / row["ms"]
        row["plain_ms"] = time_call(
            lambda: kops.pcg_chain_solve_plain(pack, op, b, steps, tol, cmask), trials=5, calls=2)
        row.update(bound("pcg_chain_solve", (pack, op, b, steps)))
    log(f"3 kernel pcg_chain_solve {label}", **row)
    check(bool(torch.isfinite(st.x).all()), f"pcg_chain_solve {label}: non-finite x")
    check(rel <= KERNEL_TOL["pcg_chain_solve"], f"pcg_chain_solve {label}: rel err {rel:.3g}")
    check(row["same_ok_pattern"], f"pcg_chain_solve {label}: stall flags differ")
    check(row["rerun_bit_identical"], f"pcg_chain_solve {label}: a rerun gives other bits")
    return row


def _flat_factor(factor) -> list:
    return [t for lv in factor[0] for t in lv]


def factor_split(args, sweep: bool = False) -> dict:
    """K9's device ms a call over 10 profiled calls, and the levels' share
    (the launch stopped after its chain levels, ``phase_limit``); the root
    (its reduction, inverse and expansions) the rest.  Also the event-timed
    ms of a call whose refresh flags are all 0 (a skipped early-exit
    refresh), and with ``sweep`` the device ms of the launch stopped after
    each of its phases (levels, root levels, the one block, expansions)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    D, U, cutoff, *batch = args
    B = batch[0] if batch else 1
    levels = len(kops._factor_shapes(D.shape[0] // B, cutoff)[0])

    def device_ms(**kw):
        """None where the profile holds no K9 launch (not measured)."""
        _, names = device_profile(lambda: [kops.chain_factor(*args, **kw) for _ in range(10)])
        hits = [v for k, v in names.items() if "factor_kernel" in k]
        return sum(hits) / 10 if hits else None

    total = device_ms()
    lv = device_ms(phase_limit=levels) if levels else 0.0
    held = kops.chain_factor(*args)
    need0 = torch.zeros(B, dtype=torch.bool, device=D.device)
    out = {"device_ms": total, "levels_device_ms": lv,
           "root_device_ms": None if total is None or lv is None else total - lv,
           "skipped_call_ms": time_call(lambda: kops.chain_factor(*args, held=held, need=need0))}
    if sweep:
        m = held[1].shape[-1] // 6
        phases = levels + 2 * (m.bit_length() - 1) + 1
        out["device_ms_by_phase_limit"] = [device_ms(phase_limit=k) for k in range(1, phases)]
    return out


def compare_chain_factor(args, label: str, damped=None, timed: bool = True) -> dict:
    """K9 against its plain version: every level tensor within 1e-4 of its
    largest entry, the apply (K3 on both factors) on a fixed right-hand side
    within CHAIN_APPLY_RTOL, a bit-identical rerun, and ‖A·root_inv - I‖∞
    of both roots printed; with ``damped`` (Hb, U, cutoff, damp, free) the
    damped entry bit-equal to the factor of the eager damped blocks;
    torch.linalg.inv_ex on the same root timed as the library yardstick.
    Also printed: the plain version's time in float32 (the reference's
    precision), how far K3 on K9's factor and on that float32 factor each
    lands from a solve wholly in float64, and the device split of a call
    (``factor_split``)."""
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
    res_k = float(torch.linalg.matrix_norm(A @ got[1][0].to(A.dtype) - eye, ord=math.inf))
    res_p = float(torch.linalg.matrix_norm(A @ ref[1][0].to(A.dtype) - eye, ord=math.inf))
    row = {"max_abs_err": err, "max_rel_err": rel, "tol_rel": KERNEL_TOL["chain_factor"],
           "levels": len(got[0]), "root_blocks": Dk.shape[0], "apply_rel_err": apply_rel,
           "apply_rtol": CHAIN_APPLY_RTOL, "root_residual_inf_kernel": res_k,
           "root_residual_inf_plain": res_p, "apply_err_vs_float64_solve_kernel": err64_k,
           "apply_err_vs_float64_solve_float32_factor": err64_f32}
    rerun = kops.chain_factor(*args)
    row["rerun_bit_identical"] = all(bool(torch.equal(a, b)) for a, b in zip(
        _flat_factor(got) + [got[1]], _flat_factor(rerun) + [rerun[1]]))
    row["root_rel_err"] = _rel(got[1], ref[1])[1]
    if damped is not None:
        # the damped entry (Hb, damp, free) builds the same float32 blocks
        Hb, Ud, cut, damp, free = damped
        got_d = kops.chain_factor(Hb, Ud, cut, damp=damp, free=free)
        row["damped_entry_bit_equal"] = all(bool(torch.equal(a, b)) for a, b in zip(
            _flat_factor(got) + [got[1]], _flat_factor(got_d) + [got_d[1]]))
        check(row["damped_entry_bit_equal"], f"chain_factor {label}: the damped entry differs")
    if timed:
        row["ms"], row["plain_ms"] = time_pair(lambda: kops.chain_factor(*args),
                                               lambda: kops.chain_factor_plain(*args))
        row["plain_float32_ms"] = time_call(
            lambda: kops.chain_factor_plain(D, U, cutoff, work_dtype=torch.float32))
        row["library_ms"] = time_call(lambda: torch.linalg.inv_ex(A))
    else:
        row["ms"] = time_call(lambda: kops.chain_factor(*args))
    row.update(factor_split(args, sweep=label == "1k"))
    row.update(bound("chain_factor", args))
    log(f"3 kernel chain_factor {label}", **row)
    check(row["rerun_bit_identical"], f"chain_factor {label}: a rerun differs")
    check(rel <= KERNEL_TOL["chain_factor"], f"chain_factor {label}: level rel err {rel:.3g}")
    check(math.isfinite(res_k), f"chain_factor {label}: non-finite root")
    check(apply_rel <= CHAIN_APPLY_RTOL, f"chain_factor {label}: apply rel err {apply_rel:.3g}")
    return row


def compare_pcg(args, label: str, timed: bool = True) -> dict:
    """K10 against its plain version: a full PCG solve with the same K2 and
    K3 operators, x within 1e-4 of max|x| and the same stall flag at every
    step; ``timed``: on the updates alone (fixed Hp and z)."""
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
            oks.append(scal[0, 2].clone())
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
           "route": "cta" if b.numel() <= kops.PCG_CTA_MAX else "grid", "steps": steps,
           "ok_pattern": [int(v) for v in ok_k.cpu().tolist()],
           "same_ok_pattern": bool(torch.equal(ok_k, ok_p))}
    if timed:
        row["ms"], row["plain_ms"] = time_pair(lambda: updates(*kernel),
                                               lambda: updates(*plain))
    row.update(bound("pcg", (b, steps)))
    log(f"3 kernel pcg {label}", **row)
    check(bool(torch.isfinite(x_k).all()), f"pcg {label}: non-finite x")
    check(rel <= KERNEL_TOL["pcg"], f"pcg {label}: rel err {rel:.3g}")
    check(row["same_ok_pattern"], f"pcg {label}: stall flags differ")
    return row


def compare_pcg_chain(args, label: str, cmask=None, timed: bool = True) -> dict:
    """K34 against its plain version: a full PCG solve (the start and every
    step) with the same K2, x within 1e-4 of max|x|, the same stall flag at
    every step, and a rerun on the first run's Hp products giving x bit for
    bit; with ``cmask`` the generic loop's planar form (K2's input and
    output and b masked, as ``_Problem.step`` masks them).  ``timed``: one
    step against the three calls it replaces (K10's alpha, K3, K10's beta)
    on the same vectors in alternating turns, and against its plain
    version."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    Ji, Jj, W, ef, et, damp, free, pack, b, steps, tol = args
    check(kops.pcg_chain_route(pack), f"pcg_chain {label}: not on K34's route")

    def hvp(v):
        if cmask is None:
            return kops.hvp(Ji, Jj, W, ef, et, v, damp, free)
        return kops.hvp(Ji, Jj, W, ef, et, v * cmask, damp, free) * cmask

    if cmask is not None:
        b = b * cmask

    def solve(start, step, products=None):
        st = start(pack, b, 1, cmask)
        oks, hps = [], []
        for i in range(steps):
            hps.append(hvp(st.p) if products is None else products[i])
            step(pack, hps[-1], st, tol, cmask)
            oks.append(st.scal[0, 2].clone())
        return st.x, torch.stack(oks), hps

    x_k, ok_k, hps = solve(kops.pcg_chain_start, kops.pcg_chain_step)
    x_rerun, ok_rerun, _ = solve(kops.pcg_chain_start, kops.pcg_chain_step, hps)
    x_p, ok_p, _ = solve(kops.pcg_chain_start_plain, kops.pcg_chain_step_plain)
    torch.cuda.synchronize()
    err = float((x_k - x_p).abs().max())
    rel = err / max(float(x_p.abs().max()), 1e-30)
    levels, root_inv, _ = pack
    m_root = root_inv.shape[-1] // 6
    row = {"max_abs_err": err, "max_rel_err": rel, "tol_rel": KERNEL_TOL["pcg_chain"],
           "rows": int(b.shape[0]), "levels": len(levels), "root_blocks": m_root,
           "smem_bytes_per_cta": kops.pcg_chain_smem(len(levels), m_root),
           "cluster_ctas": kops.PCG_CHAIN_CLUSTER, "column_mask": cmask is not None,
           "steps": steps, "ok_pattern": [int(v) for v in ok_k.cpu().tolist()],
           "same_ok_pattern": bool(torch.equal(ok_k, ok_p)),
           "rerun_bit_identical": bool(torch.equal(x_k, x_rerun) and torch.equal(ok_k, ok_rerun)),
           "library_ms": None}
    if timed:
        Hp = hvp(b)
        fused = kops.pcg_chain_start(pack, b)
        x, r, p, scal = kops.pcg_init(b, kops.chain_apply(pack, b))
        plain = kops.pcg_chain_start_plain(pack, b)

        def three_calls():
            kops.pcg_alpha(p, Hp, x, r, scal, tol)
            kops.pcg_beta(r, kops.chain_apply(pack, r), p, scal)

        row["ms"], row["three_calls_ms"] = time_pair(
            lambda: kops.pcg_chain_step(pack, Hp, fused, tol), three_calls)
        row["three_calls_over_fused"] = row["three_calls_ms"] / row["ms"]
        row["plain_ms"] = time_call(lambda: kops.pcg_chain_step_plain(pack, Hp, plain, tol))
        row["start_ms"] = time_call(lambda: kops.pcg_chain_start(pack, b))
        row.update(bound("pcg_chain", (pack, b)))
    log(f"3 kernel pcg_chain {label}", **row)
    check(bool(torch.isfinite(x_k).all()), f"pcg_chain {label}: non-finite x")
    check(rel <= KERNEL_TOL["pcg_chain"], f"pcg_chain {label}: rel err {rel:.3g}")
    check(row["same_ok_pattern"], f"pcg_chain {label}: stall flags differ")
    check(row["rerun_bit_identical"], f"pcg_chain {label}: a rerun gives other bits")
    return row


def device_ms_of(fn, calls: int, function: str) -> float | None:
    """Device ms a call of ``function`` (a profiled kernel's name contains
    it) over one profiled run of ``fn`` that makes ``calls`` calls; None
    where the trace holds no such kernel (not measured)."""
    prof, names = device_profile(fn)
    hits = [ms for key, ms in names.items() if function in key]
    if not hits:
        return None
    return sum(hits) / calls


def compare_pcg_grid(args, label: str, cmask=None, pack=None, timed: bool = True) -> dict:
    """K37 against its plain version (K34's) above K34's cap: the start, then
    a 12-step solve through ``pcg_chain_start`` / ``pcg_chain_step`` with K2's
    products (the route a single solve takes there: 13 K37 launches and no
    K3 or K10), recorded; the plain start and steps on the same recorded
    products, x, r, p and scal within KERNEL_TOL["pcg_grid"] of max|·| after
    the start and after the last step, the same stall flags; a rerun on the
    recorded products bit-identical.  ``pack`` another factor of the same
    system (phase 3's cutoff-1 case, K9 on its damped blocks); ``cmask``
    the generic loop's planar
    form.  ``timed``: a step event-timed in turns against the three calls it
    replaces (K10's alpha, K3, K10's beta on the same vectors, called through
    their wrappers here), its device ms over 20 profiled steps, the plain
    step and the start."""
    from uzliti_slam_tpu_torch.kernels import _build
    from uzliti_slam_tpu_torch.kernels import ops as kops

    Ji, Jj, W, ef, et, damp, free, pack0, b, steps, tol = args
    pack = pack0 if pack is None else pack
    levels, root_inv, _ = pack
    check(not kops.pcg_chain_route(pack), f"pcg_grid {label}: within K34's cap")

    def hvp(v):
        if cmask is None:
            return kops.hvp(Ji, Jj, W, ef, et, v, damp, free)
        return kops.hvp(Ji, Jj, W, ef, et, v * cmask, damp, free) * cmask

    if cmask is not None:
        b = b * cmask

    def solve(start, step, products=None):
        st = start(pack, b, 1, cmask)
        first = [t.clone() for t in st[:4]]
        oks, hps = [], []
        for i in range(steps):
            hps.append(hvp(st.p) if products is None else products[i])
            step(pack, hps[-1], st, tol, cmask)
            oks.append(st.scal[0, 2].clone())
        return first, [t.clone() for t in st[:4]], torch.stack(oks), hps

    kops.reset_launches()
    first_k, last_k, ok_k, hps = solve(kops.pcg_chain_start, kops.pcg_chain_step)
    route = {k: kops.launches[k] for k in ("pcg_grid", "chain_apply", "pcg", "pcg_chain")}
    _, last_rerun, ok_rerun, _ = solve(kops.pcg_chain_start, kops.pcg_chain_step, hps)
    first_p, last_p, ok_p, _ = solve(kops.pcg_chain_start_plain, kops.pcg_chain_step_plain, hps)
    torch.cuda.synchronize()

    def rel(got, ref):   # x, r, p against the plain version, scal's [rz, b2, ok]
        out = []
        for i, (a, c) in enumerate(zip(got[:3] + [got[3][:, :3]], ref[:3] + [ref[3][:, :3]])):
            out.append(float((a - c).abs().max()) / max(scale[i], 1e-30))
        return out

    # each vector's scale: its largest magnitude over the solve, the start's
    # or the last step's (x grows from 0; r, p and rz shrink from the
    # start's as the solve converges, and their recurrences round relative
    # to that scale)
    scale = [max(float(a.abs().max()), float(c.abs().max()))
             for a, c in zip(first_p[:3] + [first_p[3][:, :3]], last_p[:3] + [last_p[3][:, :3]])]
    rel_start, rel_last = rel(first_k, first_p), rel(last_k, last_p)
    err = float((last_k[0] - last_p[0]).abs().max())
    m_root = root_inv.shape[-1] // 6
    row = {"max_abs_err": err, "max_rel_err": max(rel_start + rel_last),
           "rel_err_start_x_r_p_scal": rel_start, "rel_err_step12_x_r_p_scal": rel_last,
           "r_last_over_start": float(last_p[1].abs().max()) / max(scale[1], 1e-30),
           "tol_rel": KERNEL_TOL["pcg_grid"], "rows": int(b.shape[0]), "levels": len(levels),
           "root_blocks": m_root, "column_mask": cmask is not None, "steps": steps,
           "route_launches": route, "ok_pattern": [int(v) for v in ok_k.cpu().tolist()],
           "same_ok_pattern": bool(torch.equal(ok_k, ok_p)),
           "rerun_bit_identical": all(torch.equal(a, c) for a, c in zip(last_k, last_rerun))
           and bool(torch.equal(ok_k, ok_rerun)),
           "ctas": _build.load().uz_pcg_grid_ctas() if b.is_cuda else None,
           "library_ms": None}
    if timed:
        Hp = hvp(b)
        fused = kops.pcg_chain_start(pack, b, 1, cmask)
        x, r, p, scal = kops.pcg_init(b, kops._preconditioned(kops.chain_apply, pack, b, cmask))
        plain = kops.pcg_chain_start_plain(pack, b, 1, cmask)

        def three_calls():
            kops.pcg_alpha(p, Hp, x, r, scal, tol)
            kops.pcg_beta(r, kops._preconditioned(kops.chain_apply, pack, r, cmask), p, scal)

        row["ms"], row["three_calls_ms"] = time_pair(
            lambda: kops.pcg_chain_step(pack, Hp, fused, tol, cmask), three_calls)
        row["three_calls_over_fused"] = row["three_calls_ms"] / row["ms"]
        row["device_ms"] = device_ms_of(
            lambda: [kops.pcg_chain_step(pack, Hp, fused, tol, cmask) for _ in range(20)], 20,
            "pcg_grid_kernel")
        replaced = device_ms_of(lambda: [three_calls() for _ in range(20)], 20, "")
        row["three_calls_device_ms"] = replaced
        row["plain_ms"] = time_call(
            lambda: kops.pcg_chain_step_plain(pack, Hp, plain, tol, cmask), trials=5, calls=2)
        row["start_ms"] = time_call(lambda: kops.pcg_chain_start(pack, b, 1, cmask))
        row.update(bound("pcg_grid", (pack, b)))
    log(f"3 kernel pcg_grid {label}", **row)
    check(bool(torch.isfinite(last_k[0]).all()), f"pcg_grid {label}: non-finite x")
    check(route == {"pcg_grid": 1 + steps, "chain_apply": 0, "pcg": 0, "pcg_chain": 0},
          f"pcg_grid {label}: the solve's launches {route}")
    check(row["max_rel_err"] <= KERNEL_TOL["pcg_grid"],
          f"pcg_grid {label}: rel err {row['max_rel_err']:.3g}")
    check(row["same_ok_pattern"], f"pcg_grid {label}: stall flags differ")
    check(row["rerun_bit_identical"], f"pcg_grid {label}: a rerun gives other bits")
    return row


def _state_rel(got, ref, scale) -> list:
    """x, r, p and scal's [rz, b2, ok] of two PCG states apart, each over
    its ``scale``."""
    pairs = zip(list(got[:3]) + [got[3][:, :3]], list(ref[:3]) + [ref[3][:, :3]])
    return [float((a - c).abs().max()) / max(s, 1e-30) for (a, c), s in zip(pairs, scale)]


def _state_scale(*states) -> list:
    """Each vector's (and scal's) largest magnitude over ``states``."""
    return [max(float(t.abs().max()) for t in ts)
            for ts in zip(*[list(st[:3]) + [st[3][:, :3]] for st in states])]


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
    row["device_ms_queued"] = queued_device_ms(lambda: kops.project_rays(*args))
    _, names = device_profile(lambda: [kops.project_rays(*args) for _ in range(10)])
    dms = kernel_device_ms(names, ("project_rays",))["project_rays"]
    row["device_ms"] = None if dms is None else dms / 10
    row.update(bound("project_rays", args))
    # the bound as it was counted before the reach was culled: every pair
    # whose centre-table offset lies on the grid
    logodds, cx, cy, _, scans, idx, count, table, res, max_range = args[:10]
    nodes = idx[:int(count)].long()
    row["pairs_in_reach"] = reach_pairs(table, logodds.shape[0], res, max_range, cx[nodes],
                                        cy[nodes])
    row["pairs_on_grid"] = grid_pairs(logodds.shape[0], cx[nodes], cy[nodes])
    row["bound_ms_on_grid_pairs"] = 1e3 * max(row["bytes"] / HBM_BYTES_PER_S,
                                              20 * row["pairs_on_grid"] / SCALAR_OPS_PER_S)
    log(f"3 kernel project_rays {label}", **row)
    if large:
        check(bool((err <= cell_bound).all()), f"project_rays {label}: beyond 2e-6·S + 1e-5")
    else:
        check(row["max_abs_err"] <= PROJECT_ATOL,
              f"project_rays {label}: err {row['max_abs_err']:.3g} > {PROJECT_ATOL}")
    check(n_diff == n_near, f"project_rays {label}: {n_diff - n_near} ternary classes differ")
    return row


def epoch_kernel_inputs(state, cfg) -> dict:
    """The inputs K5-K8 get in an epoch on ``state``: K5's table, the
    heuristic's pairs and the uncertainty's row (and the heuristic's (B, N)
    rows for K5's rows entry), the candidates for K6's roots entry (and
    their stamps for its labels entry), the roots' RANSAC problems (the
    draw's uniforms from a seeded generator on the card, mapped to triplets
    by K7) and the solve's components."""
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
    u = ransac.draw_uniforms(torch.Generator(device=g.device).manual_seed(SEED),
                             fc.ransac_hypotheses, cr.member)
    w = shortest_path._weights(g, False)
    return {
        "relax_table": (g.e_from, g.e_to, w, n),
        "relax_pairs": (g.e_from[safe], g.e_to[safe], g.e_from, g.e_to, w, n, 64),
        "relax_uncertainty": (g.stamp, g.node_valid, g.uncertainty, g.e_from, g.e_to, w, 64),
        "relax_min": (dist0, g.e_from, g.e_to, w, 64),
        "cluster_roots": (idx, g.e_from, g.e_to, g.e_valid, g.node_valid, g.stamp, fc.max_dt,
                          fc.min_cluster_size, fc.min_time_span, 16, heur),
        "cluster_labels": (cr.sf, cr.st, cr.valid, fc.max_dt, 16),
        "ransac_rigid": (cr.p_pred.expand(R, b, 3), cr.p_act.expand(R, b, 3), cr.member, None,
                         fc.max_error, fc.min_cluster_size, 0.01, None, u, None),
        "components": components_inputs(g),
    }


def components_inputs(g) -> tuple:
    """The inputs K8 gets in a solve on ``g`` (solver.connected_components
    and gauge_fix_mask)."""
    n = g.node_capacity
    return (g.e_from, g.e_to, g.e_valid, g.node_valid, g.node_fixed, g.stamp, n,
            max(2 * math.ceil(math.log2(max(n, 2))), 8))


def components_route(n: int) -> str:
    """Which of K8's forms ``kops.components_gauge`` takes at N nodes: "cta"
    (one CTA) or "grid" (one cooperative launch over the card)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    return kops.components_route(n)


def _components_both(kernel: bool, route=None):
    """K8 as the solves run it: labels and gauge in one call (``route``
    "grid" forces the cooperative form at any N)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    def fn(ef, et, ev, nv, nf, stamp, n, iters):
        if kernel:
            return kops.components_gauge(ef, et, ev, nv, nf, stamp, n, iters, route=route)
        return kops.components_gauge_plain(ef, et, ev, nv, nf, stamp, n, iters)
    return fn


def components_rounds(args) -> dict:
    """The rounds K8 ran on these inputs (read from the kernel) beside the
    plain version's count of them and the reference's ``n_iters``."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    ef, et, ev, nv, nf, stamp, n, iters = args
    got = torch.zeros((), dtype=torch.int32, device=ef.device)
    ref = torch.zeros((), dtype=torch.int32, device=ef.device)
    kops.components_gauge(ef, et, ev, nv, nf, stamp, n, iters, rounds=got)
    kops.components_plain(ef, et, ev, n, iters, rounds=ref)
    return {"rounds": int(got), "rounds_plain": int(ref), "n_iters": int(iters)}


def compare_ransac(got, ref, args, label: str) -> dict:
    """K7 against its plain version: the same best hypothesis, ok flag and
    consensus per root; refit poses within RANSAC_POSE_ATOL on the roots
    that passed; per-hypothesis counts apart only by points within
    RANSAC_NEAR_REL of the inlier radius (counted and printed)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    src, dst, valid, tri, max_error, *_ = args
    pose_k, cons_k, _, _, ok_k, best_k, counts_k, _ = got
    pose_p, cons_p, _, _, ok_p, best_p, counts_p, _ = ref
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


def ransac_draw_check(tri_k, u, valid, quality, label: str) -> dict:
    """K7's triplets against the plain mapping of the same uniforms on the
    card (``ransac.triplets_from_uniforms``): equal, or, where they differ,
    the plain target within DRAW_BOUNDARY_ULPS ulps of the row's total of a
    running-sum boundary (the kernel's running sums are exact sums rounded
    once, torch.cumsum's a float32 scan).  Those cases are counted."""
    from uzliti_slam_tpu_torch.ops import ransac

    tri_p = ransac.triplets_from_uniforms(u, valid, quality)
    cum = torch.cumsum(ransac.draw_weights(valid, quality), dim=-1)
    total = cum[:, -1:]
    target = torch.minimum(u * total, torch.nextafter(total, torch.zeros_like(total)))
    ulp = torch.nextafter(total, torch.full_like(total, math.inf)) - total
    gap = (cum[:, None, :] - target[:, :, None]).abs().amin(-1)        # (R, 3K)
    diff = (tri_k != tri_p).reshape(gap.shape)
    near = gap <= DRAW_BOUNDARY_ULPS * ulp
    row = {"draws": int(diff.numel()), "differ": int(diff.sum()),
           "differ_near_boundary": int((diff & near).sum()),
           "targets_near_boundary": int(near.sum()), "boundary_ulps": DRAW_BOUNDARY_ULPS,
           "in_range": bool(((tri_k >= 0) & (tri_k < valid.shape[1])).all())}
    check(row["in_range"], f"ransac_rigid {label}: a drawn index out of range")
    check(row["differ"] == row["differ_near_boundary"],
          f"ransac_rigid {label}: draws differ away from a running-sum boundary: {row}")
    return row


def compare_ransac_draws(args, label: str) -> dict:
    """K7 with its draw folded in, on (src, dst, valid, None, max_error,
    min_consensus, min_sigma, weights, uniforms, quality): the draw held by
    ``ransac_draw_check``, then everything after it held as
    ``compare_ransac`` against the plain version on the kernel's own
    triplets."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    src, dst, valid, _, max_error, min_cons, min_sigma, weights, u, quality = args
    got = kops.ransac_rigid(*args)
    torch.cuda.synchronize()
    draw = ransac_draw_check(got[7], u, valid, quality, label)
    held = (src, dst, valid, got[7], max_error, min_cons, min_sigma, weights)
    row = compare_ransac(got, kops.ransac_rigid_plain(*held), held, label)
    row["draw"] = draw
    log(f"3 kernel ransac_rigid {label} draw", **draw)
    return row


def ransac_edge_cases(device) -> tuple:
    """K7's arguments on the edge cases, soft-PROSAC draws folded in: K =
    32 (the estimation runs' setting), M = 37 (not a multiple of the
    kernel's 8 lanes), roots with no valid entry, one, two (fewer than
    three), equal qualities, sparse and full."""
    from uzliti_slam_tpu_torch.ops import ransac

    rng = np.random.default_rng(SEED + 19)
    R, M, K = 7, 37, 32
    src = rng.uniform(-3, 3, (M, 3)).astype(np.float32)
    ang = 0.4
    rot = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                   np.float32)
    dst = src @ rot.T + np.float32([0.5, -0.2, 0.1]) + rng.normal(0, 0.01, (M, 3)).astype(
        np.float32)
    dst[:6] += 3.0                                               # outliers
    valid = rng.random((R, M)) < 0.7
    valid[0] = False
    valid[1] = False
    valid[1, 36] = True
    valid[2] = False
    valid[2, [4, 20]] = True
    valid[5] = True
    quality = -rng.integers(0, 65, (R, M)).astype(np.float32)
    quality[3] = -9.0
    t = lambda a: torch.from_numpy(a).to(device)                 # noqa: E731
    valid_t = t(valid)
    u = ransac.draw_uniforms(torch.Generator(device=device).manual_seed(SEED + 19), K, valid_t)
    return (t(src)[None].expand(R, M, 3), t(np.ascontiguousarray(dst))[None].expand(R, M, 3),
            valid_t, None, 0.1, 5, 0.01, None, u, t(quality))


def ransac_launch_profile(args, tries: int = 5) -> dict:
    """One ``ransac_rigid_batch`` call with its draw, profiled: the device
    launches (the uniforms' ``torch.rand`` and K7, nothing between them).
    A late profile may hold no device time (``PERF.md`` §7): up to ``tries``
    profiles, the first that holds any read; "not measured" if none does."""
    from uzliti_slam_tpu_torch.ops import ransac

    src, dst, valid, _, max_error, min_cons, min_sigma, _, u, quality = args
    K = u.shape[1] // 3
    gen = torch.Generator(device=src.device).manual_seed(SEED)
    for attempt in range(1, tries + 1):
        prof, device_ms = device_profile(lambda: ransac.ransac_rigid_batch(
            src, dst, valid, K, max_error, min_cons, min_sigma, generator=gen, quality=quality))
        if device_ms:
            break
    if not device_ms:
        return {"device_launches": "not measured (no device time in the trace)",
                "profiles": tries}
    k7 = kernel_device_ms(device_ms, ("ransac_rigid",))["ransac_rigid"]
    row = {"device_launches": prof.get("device_launches"), "kernels": sorted(device_ms),
           "ransac_rigid_device_ms": k7, "profiles": attempt}
    check(k7 is not None and prof.get("device_launches") <= 2,
          f"ransac_rigid_batch: not one torch.rand and one K7 launch: {row}")
    return row


def compare_ransac_calls(calls, label: str) -> dict:
    """K7 on the calls a keyframe step made (``record_args``), each held by
    ``compare_ransac_draws``; one call profiled by ``ransac_launch_profile``;
    the calls timed against the plain version."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    check(bool(calls), f"ransac_rigid {label}: no call recorded")
    flat = [(*a, *(kw.get(k) for k in ("uniforms", "quality"))) if kw else a
            for a, kw in calls]
    rows = [compare_ransac_draws(a, label) for a in flat]
    row = {"calls": len(flat), "max_abs_err": max(r["max_abs_err"] for r in rows),
           "roots": rows[0]["roots"], "roots_ok": sum(r["roots_ok"] for r in rows),
           "draw": rows[0]["draw"], "launch_profile": ransac_launch_profile(flat[0])}
    row["ms"], row["plain_ms"] = time_pair(
        lambda: [kops.ransac_rigid(*a) for a in flat],
        lambda: [kops.ransac_rigid_plain(*a) for a in flat])
    row.update(bound_wrapper_calls({"ransac_rigid": [(a, {}) for a in flat]}, ("ransac_rigid",)))
    log(f"3 kernel ransac_rigid {label}", **row)
    return row


K5_ENTRIES = ("relax_min", "relax_pairs", "relax_uncertainty")


def relax_table_mismatches(got, ref) -> int:
    """Entries of K5's table that differ from the plain table's: row_ptr
    exactly, and each node's (neighbour, weight bits) entries as a multiset
    (the kernel's fill order within a node is free)."""
    if not torch.equal(got.row_ptr, ref.row_ptr):
        return max(1, int((got.row_ptr != ref.row_ptr).sum()))
    n, total = ref.row_ptr.shape[0] - 1, int(ref.row_ptr[-1])
    node = torch.repeat_interleave(torch.arange(n, device=ref.row_ptr.device),
                                   torch.diff(ref.row_ptr).long())

    def keys(adj):
        a = adj[:total].long()
        return torch.sort((node * n + a[:, 0]) * 2**32 + (a[:, 1] & 0xFFFFFFFF)).values

    return int((keys(got.adj) != keys(ref.adj)).sum())


def compare_epoch_kernels(inputs: dict, label: str, timed: bool = True) -> dict:
    """K5-K8 (the entries in ``inputs``) against their plain versions on
    the inputs an epoch or a solve gives them: K5's relaxations within
    RELAX_MAX_ULP, its table and K6 exactly; with ``timed``, the median
    event ms of both, K5's and K6's device ms a call (10 profiled calls:
    the entry's own kernel) and queued, and the bound."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    fns = {name: (getattr(kops, name), getattr(kops, f"{name}_plain"))
           for name in K5_K6 + ("ransac_rigid",)}
    fns["components"] = (_components_both(True), _components_both(False))
    results = {}
    for name, args in inputs.items():
        kernel_fn, plain_fn = fns[name]
        if name == "ransac_rigid":
            row = compare_ransac_draws(args, label)
        elif name in K5_ENTRIES:
            got, ref = kernel_fn(*args), plain_fn(*args)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite")
            ulp = int((got.view(torch.int32).long() - ref.view(torch.int32).long()).abs().max())
            row = {"max_abs_err": float((got - ref).abs().max()), "max_ulp": ulp,
                   "tol_ulp": RELAX_MAX_ULP,
                   "rows": 1 if name == "relax_uncertainty" else int(got.shape[0]),
                   "unreached": int((ref >= kops.INF).sum())}
            check(ulp <= RELAX_MAX_ULP, f"{name} {label}: {ulp} ulp apart")
        elif name == "relax_table":
            mism = relax_table_mismatches(kernel_fn(*args), plain_fn(*args))
            row = {"max_abs_err": 0.0 if mism == 0 else float("nan"), "mismatches": mism}
            check(mism == 0, f"relax_table {label}: {mism} entries differ from the plain table")
        else:
            got, ref = kernel_fn(*args), plain_fn(*args)
            torch.cuda.synchronize()
            pairs = tuple(zip(got, ref)) if isinstance(got, tuple) else ((got, ref),)
            mism = sum(int((a != b).sum()) for a, b in pairs)
            row = {"max_abs_err": 0.0 if mism == 0 else float("nan"), "mismatches": mism}
            if name == "components":
                row["route"] = components_route(args[6])
                row.update(components_rounds(args))
                check(row["rounds"] == row["rounds_plain"],
                      f"components {label}: {row['rounds']} rounds, the plain version "
                      f"counts {row['rounds_plain']}")
            check(mism == 0, f"{name} {label}: {mism} entries differ from the plain version")
        if timed:
            row["ms"], row["plain_ms"] = time_pair(lambda: kernel_fn(*args),
                                                   lambda: plain_fn(*args))
            if name in K5_K6 + ("ransac_rigid", "components"):
                row["device_ms_queued"] = queued_device_ms(lambda: kernel_fn(*args))
            if name in K5_K6 + ("components",):
                _, names = device_profile(lambda: [kernel_fn(*args) for _ in range(10)])
                dms = kernel_device_ms(names, (name,))[name]
                row["device_ms"] = None if dms is None else dms / 10
        row.update(bound(name, args))
        log(f"3 kernel {name} {label}", **row)
        results[name] = row
    return results


def _ladder(n: int, every: int, span: int, gen, dev, dup: int = 0):
    """K5's edge tables on n nodes: a chain, a closure from every
    ``every``-th node to the node ``span`` ahead, lengths 0.1-1 m, every
    97th edge invalid (INF), ``dup`` duplicated edges and a padded slot
    (0 -> 0, INF) at the end."""
    ef = list(range(n - 1)) + list(range(0, n - span, every))
    et = list(range(1, n)) + [i + span for i in range(0, n - span, every)]
    w = 0.1 + 0.9 * torch.rand(len(ef), generator=gen)
    w[::97] = 3.4e38
    pick = torch.randint(0, len(ef), (dup,), generator=gen).tolist()
    ef, et = ef + [ef[i] for i in pick] + [0], et + [et[i] for i in pick] + [0]
    w = torch.cat([w, w[pick], torch.tensor([3.4e38])])
    i32 = dict(dtype=torch.int32, device=dev)
    return torch.tensor(ef, **i32), torch.tensor(et, **i32), w.to(dev)


def _roots_inputs(sf, st, gen, dev, cand_mask=None, n_bad: int = 0):
    """K6's roots entry on candidates with stamps (sf, st): edge c joins
    two nodes so stamped (shuffled), candidate c names edge c; ``n_bad``
    candidates padded (-1) and as many edges and nodes invalid."""
    b = sf.shape[0]
    n = 2 * b + 8
    perm = torch.randperm(n, generator=gen)
    stamp = 2000.0 * torch.rand(n, generator=gen) - 1000.0
    stamp[perm[:b]], stamp[perm[b:2 * b]] = sf, st
    E = b + 16
    ef = torch.randint(0, n, (E,), generator=gen, dtype=torch.int32)
    et = torch.randint(0, n, (E,), generator=gen, dtype=torch.int32)
    ef[:b], et[:b] = perm[:b].int(), perm[b:2 * b].int()
    cand = torch.arange(b, dtype=torch.int32)
    e_valid, node_valid = torch.ones(E, dtype=torch.bool), torch.ones(n, dtype=torch.bool)
    bad = torch.randperm(b, generator=gen)[:3 * n_bad]
    cand[bad[:n_bad]] = -1
    e_valid[bad[n_bad:2 * n_bad]] = False
    node_valid[et[bad[2 * n_bad:]].long()] = False
    mask = None if cand_mask is None else cand_mask.to(dev)
    return (cand.to(dev), ef.to(dev), et.to(dev), e_valid.to(dev), node_valid.to(dev),
            stamp.to(dev), 5.0, 5, 2.0, 16, mask)


def k5_k6_edge_cases(dev, inputs10k: dict) -> dict:
    """K5's and K6's entries on edge cases, each against its plain version
    (K5 within RELAX_MAX_ULP, its table and K6 exactly): a 3,000-node ladder
    whose hop diameter exceeds the 64 sweeps, with duplicated edges; pairs
    and the uncertainty's root in a 5-node island (a fixed point after two
    sweeps); dense rows (every node finite: every frontier overflows its
    list) on the ladder and on the 10k epoch's graph; a 40,000-node ladder
    above the shared-memory cut (the global scratch); tied oldest stamps and
    no valid node; K6 at B = 1, B = 77, a 256-candidate stamp chain beyond
    16 hops, 256 candidates with none valid, and with the heuristic's mask;
    above 256 (the grid route) B = 300 and 4,096 on chains beyond 16 hops
    and B = 1,024 in clusters, both entries, timed.
    Returns {case: {entry: max_ulp or mismatches}}."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    gen = torch.Generator().manual_seed(SEED + 20)
    out = {}

    def run(case, inputs):
        rows = compare_epoch_kernels(inputs, f"edge case {case}", timed=False)
        out[case] = {k: r.get("max_ulp", r.get("mismatches")) for k, r in rows.items()}

    def k5(ef, et, w, n, sources, targets, stamp, valid, dense=None):
        src = torch.tensor(sources, dtype=torch.int32, device=dev)
        tgt = torch.tensor(targets, dtype=torch.int32, device=dev)
        d0 = torch.full((len(sources), n), 3.4e38, device=dev).scatter(
            1, src.long()[:, None], 0.0) if dense is None else dense
        unc = torch.full((n,), 7.0, device=dev)
        return {"relax_table": (ef, et, w, n), "relax_min": (d0, ef, et, w, 64),
                "relax_pairs": (src, tgt, ef, et, w, n, 64),
                "relax_uncertainty": (stamp, valid, unc, ef, et, w, 64)}

    n = 3000
    ef, et, w = _ladder(n, 60, 100, gen, dev, dup=40)
    stamp = torch.arange(n, dtype=torch.float32, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    run("ladder 3000, hops beyond 64", k5(ef, et, w, n, [0, 1500, 2999, 77, 0, 1500],
                                          [2999, 1540, 2950, 177, 1700, 0], stamp, valid))
    # a 5-node island (nodes 3000-3004) beside the ladder: rows from it stop early
    ie = torch.tensor([3000, 3001, 3002, 3003, 3000], dtype=torch.int32, device=dev)
    je = torch.tensor([3001, 3002, 3003, 3004, 3002], dtype=torch.int32, device=dev)
    efi, eti = torch.cat([ef, ie]), torch.cat([et, je])
    wi = torch.cat([w, torch.full((5,), 0.5, device=dev)])
    st_i = torch.cat([stamp + 10.0, torch.tensor([1.0, 2.0, 1.0, 3.0, 4.0], device=dev)])
    run("island, fixed point early", k5(efi, eti, wi, n + 5, [3000, 3004, 3002], [3003, 0, 3001],
                                        st_i, torch.ones(n + 5, dtype=torch.bool, device=dev)))
    dense = 50.0 * torch.rand(4, n, generator=gen).to(dev)
    run("ladder 3000, dense rows", {"relax_min": (dense, ef, et, w, 64)})
    ef10, et10, w10, n10 = inputs10k["relax_table"]
    dense10 = 50.0 * torch.rand(4, n10, generator=gen).to(dev)
    run("epoch 10k graph, dense rows", {"relax_min": (dense10, ef10, et10, w10, 64)})
    n = 40_000
    ef, et, w = _ladder(n, 60, 100, gen, dev, dup=16)
    tied = torch.randint(0, 1000, (n,), generator=gen).float().to(dev)
    tied[[17, 5, 39_000]] = -1.0                         # the oldest, tied: slot 5
    run("ladder 40000, global scratch, tied oldest", k5(
        ef, et, w, n, [0, 20_000, 39_999, 5], [39_999, 0, 12, 40], tied,
        torch.rand(n, generator=gen).to(dev) < 0.9))
    run("ladder 40000, no valid node", {"relax_uncertainty": (
        tied, torch.zeros(n, dtype=torch.bool, device=dev), torch.full((n,), 7.0, device=dev),
        ef, et, w, 64)})

    def chain_stamps(b):
        sf = 10.0 + 4.9 * torch.arange(b, dtype=torch.float32)
        return sf, sf + 500.0

    run("K6 B = 1", {"cluster_roots": _roots_inputs(*chain_stamps(1), gen, dev)})
    sf = (torch.randint(0, 12, (77,), generator=gen) * 1.5).float()
    st = sf + torch.randint(0, 3, (77,), generator=gen).float()
    run("K6 B = 77", {"cluster_roots": _roots_inputs(sf, st, gen, dev, n_bad=4)})
    run("K6 chain of 256 beyond 16 hops", {"cluster_roots": _roots_inputs(
        *chain_stamps(256), gen, dev)})
    none = _roots_inputs(*chain_stamps(256), gen, dev)
    run("K6 none valid", {"cluster_roots": (torch.full_like(none[0], -1),) + none[1:]})
    sf = torch.cat([1000.0 * k + 0.6 * torch.arange(5) for k in range(51)] + [torch.tensor([9e5])])
    st = torch.cat([-2000.0 * k - 0.6 * torch.arange(5) for k in range(51)] + [torch.tensor([9e5])])
    run("K6 51 roots, negative stamps, the heuristic's mask", {"cluster_roots": _roots_inputs(
        sf, st, gen, dev, cand_mask=torch.rand(256, generator=gen) < 0.95, n_bad=2)})
    labels = _roots_inputs(*chain_stamps(200), gen, dev)
    cr = kops.cluster_roots(*labels[:10], cand_mask=labels[10])
    run("K6 labels entry, chain of 200", {"cluster_labels": (cr.sf, cr.st, cr.valid, 5.0, 16)})
    # above the one-CTA form's 256 candidates, the grid route: a chain beyond
    # 16 hops (B = 300, 4,096) and clusters of ~8 (B = 1,024), both entries,
    # timed; the labels entry on the roots entry's stamps
    out["grid_route"] = {}
    for b in (300, 1024, 4096):
        if b == 1024:
            sf = (torch.randint(0, b // 8, (b,), generator=gen) * 7.0).float()
            st = sf + torch.randint(0, 3, (b,), generator=gen).float()
        else:
            sf, st = chain_stamps(b)
        inputs = _roots_inputs(sf, st, gen, dev, n_bad=b // 64)
        rows = compare_epoch_kernels({"cluster_roots": inputs}, f"K6 B = {b}")
        cr = kops.cluster_roots(*inputs[:10], cand_mask=inputs[10])
        rows.update(compare_epoch_kernels({"cluster_labels": (cr.sf, cr.st, cr.valid, 5.0, 16)},
                                          f"K6 B = {b}"))
        out[f"K6 B = {b}, grid route"] = {k: r["mismatches"] for k, r in rows.items()}
        out["grid_route"][b] = {k: {f: r.get(f) for f in ("ms", "plain_ms", "device_ms",
                                                             "device_ms_queued", "bound_ms",
                                                             "bound_by")}
                                for k, r in rows.items()}
    log("3 kernel K5 K6 edge cases", **out)
    return out


def compare_k8_forms(args, label: str) -> dict:
    """K8's two forms on the same inputs (N within the one-CTA form's
    shared memory): the one CTA and the cooperative grid forced, equal
    outputs, event and queued ms in turns."""
    cta, grid = _components_both(True), _components_both(True, route="grid")
    a, b = cta(*args), grid(*args)
    torch.cuda.synchronize()
    mism = sum(int((x != y).sum()) for x, y in zip(a, b))
    row = {"mismatches": mism}
    row["cta_ms"], row["grid_ms"] = time_pair(lambda: cta(*args), lambda: grid(*args))
    row["cta_device_ms_queued"] = queued_device_ms(lambda: cta(*args))
    row["grid_device_ms_queued"] = queued_device_ms(lambda: grid(*args))
    log(f"3 kernel components forms {label}", **row)
    check(mism == 0, f"components forms {label}: {mism} entries differ")
    return row


def compare_ten_levels(img, label: str) -> dict:
    """K12 and K13 on a 10-level pyramid of ``img`` ((C, H, W) float32 on
    the card; the front-end's resize, 300 features): ⌈10/8⌉ = 2 launches
    each, equal to their plain versions."""
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.ops import features, resize

    C, H, W = img.shape
    shapes = features.pyramid_shapes(H, W, 10, 1.2)
    levels = [img if (h, w) == (H, W) else resize.resize_linear(img, (h, w)).contiguous()
              for _, (h, w) in shapes]
    k_level = 300 // 10
    before = dict(kops.launches)
    maps = kops.fast_nms(levels, 20.0)
    got = kops.grid_topk(maps, k_level, 4)
    torch.cuda.synchronize()
    launched = {k: kops.launches[k] - before[k] for k in ("fast_nms", "grid_topk")}
    ref_maps = kops.fast_nms_plain(levels, 20.0)
    ref = kops.grid_topk_plain(ref_maps, k_level, 4)
    on_ref = kops.grid_topk(ref_maps, k_level, 4)
    row = {"levels": [list(hw) for _, hw in shapes], "launches": launched,
           "fast_nms_mismatches": sum(int((a != b).sum()) for a, b in zip(maps, ref_maps)),
           "grid_topk_mismatches": sum(int((a != b).sum()) for a, b in zip(got, ref))
           + sum(int((a != b).sum()) for a, b in zip(on_ref, ref)),
           "keypoints": int(ref[2].sum()), "max_abs_err": 0.0}
    row["fast_nms_ms"], row["fast_nms_plain_ms"] = time_pair(
        lambda: kops.fast_nms(levels, 20.0), lambda: kops.fast_nms_plain(levels, 20.0))
    row["grid_topk_ms"], row["grid_topk_plain_ms"] = time_pair(
        lambda: kops.grid_topk(ref_maps, k_level, 4),
        lambda: kops.grid_topk_plain(ref_maps, k_level, 4))
    log(f"3 kernel fast_nms grid_topk 10 levels {label}", **row)
    check(launched == {"fast_nms": 2, "grid_topk": 2},
          f"10 levels {label}: launches {launched}, expected 2 of K12 and 2 of K13")
    check(row["fast_nms_mismatches"] == 0 and row["grid_topk_mismatches"] == 0,
          f"10 levels {label}: {row['fast_nms_mismatches']} K12 and "
          f"{row['grid_topk_mismatches']} K13 entries differ from the plain versions")
    return row


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
    # K35: one launch a PCG solve, 20 solves; K2, K34, K3 and K10 none (the
    # 1k solve is within K34's cap and has no reduce hook)
    expected = solve_launches(pcg_chain_solve=20)
    check(counts == expected, f"launch counts {counts} != {expected}")
    finals, poses = [], []
    for _ in range(reps):
        t1, (g2, st) = timed_solves(solver.optimize, g, cfg, reps=1)
        finals.append((t1, float(st.chi2_history[-1])))
        poses.append(g2.pose)
    t = statistics.median(f[0] for f in finals)
    hist = st.chi2_history.cpu()
    chi2_0, chi2 = float(hist[0]), float(hist[-1])
    # K1 and K35 sum without atomics: every solve of one input gives the
    # same bits
    spread = max(f[1] for f in finals) - min(f[1] for f in finals)
    same_poses = all(bool(torch.equal(q, poses[0])) for q in poses[1:])
    _, st_cpu = solver.optimize(g.to("cpu"), cfg)
    chi2_cpu = float(st_cpu.chi2_history[-1])
    prof, names = device_profile(lambda: solver.optimize(g, cfg))
    lib_items = library_items(names)
    log("4 headline 1k", solve_ms=1e3 * t, solves_per_s=1.0 / t, chi2_0=chi2_0,
        device_launches_per_solve=prof.get("device_launches"),
        chi2=chi2, chi2_run_to_run_spread=spread, poses_bit_identical=same_poses,
        chi2_cpu_plain=chi2_cpu,
        chi2_oracle=chi2_oracle, ratio_vs_oracle=chi2 / chi2_oracle, launches=counts,
        accepted=int(st.accepted.sum()), sync_free=True, library_items=lib_items, **prof)
    check(not lib_items, f"1k solve: library kernels in the profile: {lib_items}")
    check(prof.get("device_launches", math.inf) <= MAX_DEVICE_LAUNCHES_1K,
          f"1k solve: {prof.get('device_launches')} device launches > "
          f"{MAX_DEVICE_LAUNCHES_1K}")
    check(spread == 0.0 and same_poses,
          f"1k solve: {reps} solves of one input differ (χ² spread {spread})")
    check(abs(chi2 - chi2_cpu) <= CHI2_RTOL * chi2_cpu + 1e-6 * chi2_0,
          f"1k χ² {chi2} vs CPU plain path {chi2_cpu}")
    check(chi2 <= ORACLE_FACTOR * chi2_oracle + ORACLE_ATOL,
          f"1k χ² {chi2} vs oracle {chi2_oracle}")
    return counts, spread


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


def solve_launches(**counts) -> dict:
    """Every kernel's launch count 0 but the solve's own: K1 24, K4 2 (the
    start's and the final poses' residuals), K36's two entries 20 each (one
    an LM iteration), K8 1 (labels and gauge), K9 4, one launch a factor (the headline
    configuration) and the PCG's ``counts``."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    out = dict.fromkeys(kops.launches, 0)
    out.update(linearize=24, residual_chi2=2, lm_candidate=20, lm_accept=20, components=1,
               chain_factor=4, **counts)
    return out


def pcg_route(n: int, cfg, batch: int = 1, reduce: bool = False, edges: int = 0) -> str:
    """The PCG route a solve of ``batch`` chains of ``n`` rows (and
    ``edges`` edge slots each) takes (``solver._pcg``): "k35", "k2_k34",
    "k2_k37", "k38" or "k2_k10_k3"."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    halves, m_root = kops._factor_shapes(n, cfg.chain_dense_cutoff)
    if batch > 1:
        fits = kops.pcg_fleet_smem(len(halves), m_root, n, edges) <= kops._SMEM_BYTES
        return "k38" if fits and not reduce else "k2_k10_k3"
    if kops.pcg_chain_smem(len(halves), m_root) > kops._SMEM_BYTES:
        return "k2_k37"
    return "k2_k34" if reduce else "k35"


def check_pcg_route(phase: str, counts: dict, n: int, cfg, batch: int = 1,
                    reduce: bool = False, edges: int = 0) -> None:
    """A solve's PCG went through its route's kernels alone: K35 for a
    single solve within K34's cap with no reduce hook, K2 and K34 with one,
    K2 and K37 above the cap, K38 in a fleet, K2, K10 and K3 in a fleet
    above K38's cap."""
    route = pcg_route(n, cfg, batch, reduce, edges)
    on = PCG_ROUTES[route]
    off = {k for r in PCG_ROUTES.values() for k in r} - set(on)
    check(all(counts[k] > 0 for k in on) and all(counts[k] == 0 for k in off),
          f"{phase}: PCG launches {[(k, counts[k]) for k in PCG_KERNELS]}, expected "
          f"{route} alone")


def _tensors(out) -> list:
    """The tensors of a call's output: a tensor, a tuple of them, a named
    tuple or a dataclass (a ``GraphState``), depth first."""
    if isinstance(out, torch.Tensor):
        return [out]
    if dataclasses.is_dataclass(out):
        out = [getattr(out, f.name) for f in dataclasses.fields(out)]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _tensors(o)]
    return []


def solve_bits(solve, calls, label: str) -> dict:
    """Whether two runs of ``solve`` give the same bits in every output
    tensor; if not, the kernels among ``calls()`` (name -> a call on the
    solve's first-iteration inputs) whose two runs on the same inputs give
    other bits.  Printed; not a check (the tolerances hold the solves)."""
    a, b = _tensors(solve()), _tensors(solve())
    same = len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    differ = []
    if not same:
        for name, call in calls().items():
            x, y = _tensors(call()), _tensors(call())
            if not all(torch.equal(u, v) for u, v in zip(x, y)):
                differ.append(name)
    out = {"bit_identical": same, "kernels_that_differ": differ}
    log(f"{label} two solves", **out)
    return out


def single_calls(g, cfg) -> dict:
    """A single solve's kernels on its first iteration's inputs, each a
    zero-argument call (``solve_bits``)."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops

    inp = kernel_inputs(g, cfg)
    Hb, U, cutoff, damp, free = inp["chain_factor_damped"]
    pack, op, b, steps, tol = inp["pcg_chain_solve"]
    return {"linearize": lambda: kops.linearize(*inp["linearize"], None, None, inp["table"]),
            "components": lambda: kops.components_gauge(*components_inputs(g)),
            "chain_factor": lambda: kops.chain_factor(Hb, U, cutoff, damp=damp, free=free),
            "pcg": lambda: solver._pcg(lambda v: kops.hvp(*op[:5], v, op.damp, op.free), pack, b,
                                       steps, tol, op=op),
            "lm_candidate": lambda: kops.lm_candidate(*inp["lm_candidate"]),
            "residual_chi2": lambda: kops.residual_chi2(*inp["residual_chi2"])}


def fleet_calls(fleet, cfg) -> dict:
    """``single_calls`` of the fleet's first iteration."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    inp = fleet_kernel_inputs(fleet, cfg)
    Ji, Jj, W, ef, et, damp, free = inp["hvp"]
    op = kops.HvpOperator(Ji, Jj, W, ef, et, damp, free, inp["table"])
    pack = kops.chain_factor(*inp["chain_factor"])
    return {"linearize": lambda: kops.linearize(*inp["linearize"], None, None, inp["table"]),
            "components": lambda: kops.components_gauge(*inp["components"]),
            "chain_factor": lambda: kops.chain_factor(*inp["chain_factor"]),
            "pcg_fleet_solve": lambda: kops.pcg_fleet_solve(pack, op, inp["b"],
                                                            cfg.pcg_iterations, cfg.pcg_tol),
            "lm_candidate": lambda: kops.lm_candidate(*inp["lm_candidate"], inp["batch"]),
            "residual_chi2": lambda: kops.residual_chi2(*inp["residual_chi2"])}


def solve_against_oracle(g, phase: str, cfg_kw: dict, chi2_oracle, reps: int,
                         profile: bool = False):
    """Phases 5-7: a warm-up solve with the counts (and K9's device count of
    factors built) set to 0 just before it and read just after; timed,
    sync-free solves; χ² against the oracle (if any).  Returns the
    warm-up's launch counts and the phase's fields."""
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
    check_pcg_route(phase, counts, g.node_capacity, cfg)
    if cfg.early_exit:
        check(built == fields["reference_refreshes"],
              f"{phase}: {built} factors built, the reference builds "
              f"{fields['reference_refreshes']}")
    if chi2_oracle is not None:
        check(chi2 <= ORACLE_FACTOR * chi2_oracle + ORACLE_ATOL,
              f"{phase}: χ² {chi2} vs oracle {chi2_oracle}")
    return counts, fields


# the port's kernel that each device function of a solve belongs to (a
# solve's device ms by kernel); PyTorch's own kernels are "other";
# function_kernel_gaps() holds it to the sources' kernels
FUNCTION_KERNEL = {"linearize_rows": "linearize", "hvp_seed": "hvp", "hvp_edges": "hvp",
                   "pcg_grid_kernel": "pcg_grid", "pcg_fleet_kernel": "pcg_fleet_solve",
                   "pcg_chain_kernel": "pcg_chain",
                   "pcg_solve_kernel": "pcg_chain_solve", "chain_forward": "chain_apply",
                   "chain_backward": "chain_apply", "chain_root": "chain_apply",
                   "factor_kernel": "chain_factor", "candidate_kernel": "lm_candidate",
                   "accept_kernel": "lm_accept", "residual_edges": "residual_chi2",
                   "sum_partials": "residual_chi2",
                   **{f: "pcg" for f in ("pcg_init", "pcg_alpha", "pcg_beta", "grid_dots",
                                         "grid_init", "grid_alpha", "grid_beta")},
                   "components_cta": "components", "components_grid": "components"}


def function_kernel_gaps() -> list:
    """The ``__global__`` functions of the sources FUNCTION_KERNEL's kernels
    come from that it does not map, or that DEVICE_FUNCTIONS does not list
    (either would put their device ms under "other")."""
    here = pathlib.Path(__file__).resolve().parent
    sources = {SOURCE.get(k, PCG_GRID_SOURCE) for k in set(FUNCTION_KERNEL.values())}
    gaps = []
    for src in sorted(sources):
        text = (here / src).read_text()
        for f in re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)", text):
            if f not in FUNCTION_KERNEL or f not in DEVICE_FUNCTIONS:
                gaps.append(f"{src}: {f}")
    return gaps


def device_ms_by_kernel(names: dict) -> dict:
    """A profile's device ms summed by the port's kernel (``FUNCTION_KERNEL``,
    the first device function a name contains), the rest as "other"."""
    out: dict = {}
    for key, ms in names.items():
        f = next((f for f in DEVICE_FUNCTIONS if f in key and f in FUNCTION_KERNEL), None)
        name = FUNCTION_KERNEL[f] if f else "other"
        out[name] = out.get(name, 0.0) + ms
    return out


def old_composition_pcg(hvp, factor, b, iterations: int, tol: float, batch: int = 1,
                        cmask=None, op=None):
    """``solver._pcg`` as a single solve above K34's cap ran it before K37:
    K10's init, then per step K2 (``hvp``), K10's alpha, K3 and K10's beta,
    called through their wrappers (phase 7's comparison; the package has no
    switch for it)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    def minv(v):
        return kops._preconditioned(kops.chain_apply, factor, v, cmask)

    x, r, p, scal = kops.pcg_init(b, minv(b), batch)
    for _ in range(iterations):
        kops.pcg_alpha(p, hvp(p), x, r, scal, tol)
        kops.pcg_beta(r, minv(r), p, scal)
    return x


def old_composition_phase(g, phase: str, counts: dict, fields: dict) -> dict:
    """Phase 7's breakdown: the 100k solve's launches and device ms by kernel
    on K37's route, then the same solve with its PCG through the old
    composition (K10 + K3 + K10 a step around K2, ``old_composition_pcg``
    patched into ``solver._pcg``): its launches, timed solves, device ms by
    kernel, and its χ² history against K37's within CHI2_HIST_RTOL."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops

    cfg = solver.SolverConfig(**HEADLINE)
    _, names = device_profile(lambda: solver.optimize(g, cfg))
    _, st = solver.optimize(g, cfg)
    hist = st.chi2_history.cpu()
    new = {"solve_ms": fields["solve_ms"], "launches": {k: v for k, v in counts.items() if v},
           "device_launches": fields.get("device_launches"),
           "device_kernel_ms": fields.get("device_kernel_ms"),
           "device_busy_share": fields.get("device_busy_share"),
           "device_ms_by_kernel": device_ms_by_kernel(names)}
    pcg = solver._pcg
    solver._pcg = old_composition_pcg
    try:
        solver.optimize(g, cfg)                      # warm-up
        kops.reset_launches()
        _, st_old = solver.optimize(g, cfg)
        old_counts = {k: v for k, v in kops.launches.items() if v}
        t_old, _ = timed_solves(solver.optimize, g, cfg, reps=3)
        prof_old, names_old = device_profile(lambda: solver.optimize(g, cfg))
    finally:
        solver._pcg = pcg
    hist_old = st_old.chi2_history.cpu()
    gap = float(((hist - hist_old).abs() / hist_old.abs().clamp(min=1e-30)).max())
    old = {"solve_ms": 1e3 * t_old, "launches": old_counts,
           "device_launches": prof_old.get("device_launches"),
           "device_kernel_ms": prof_old.get("device_kernel_ms"),
           "device_busy_share": prof_old.get("device_busy_share"),
           "device_ms_by_kernel": device_ms_by_kernel(names_old)}
    out = {"k37": new, "old_composition": old, "chi2_history_max_rel_gap": gap,
           "chi2_history_rtol": CHI2_HIST_RTOL}
    log(f"{phase} breakdown", **out)
    check(counts["pcg_grid"] == 20 * 13 and counts["chain_apply"] == counts["pcg"] == 0,
          f"{phase}: PCG launches {[(k, counts[k]) for k in PCG_KERNELS]}, "
          "expected K37 260 and no K3 or K10")
    check(old_counts.get("pcg_grid", 0) == 0 and old_counts.get("chain_apply") == 260,
          f"{phase}: the old composition's launches {old_counts}")
    check(gap <= CHI2_HIST_RTOL, f"{phase}: χ² history {gap:.3g} from the old composition's")
    return out


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

    def recorded(*args, **kw):
        out = lm_loop(*args, **kw)
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


def epoch_phase(phase: str, built, n: int, reps: int, reads: list, cpu_check: bool):
    """Phases 8-9: one optimize_epoch with the counts set to 0 just before
    it and read just after (K5 two launches a call site, K6's roots entry
    once), and the factors K9 built in it against the
    refreshes the reference's loop makes in each of its LM solves; timed
    epochs; the filter's verdict, χ², ATE and
    uncertainty checked; a profile (K5's and K6's device ms in it); with
    ``cpu_check``, the same epoch on CPU tensors through the plain path with
    the same RANSAC draws.  Returns (counts, the state after the epoch,
    K5's and K6's device ms)."""
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
    check(all(counts[k] > 0 for k in FUSED_PATH + EPOCH_KERNELS),
          f"{phase}: a kernel was not launched: {counts}")
    check(counts["components"] == 1, f"{phase}: K8 launched {counts['components']} times, "
          "not once (labels and gauge in one launch)")
    k5_k6 = {k: counts[k] for k in K5_K6}
    check(k5_k6 == {"relax_table": 2, "relax_pairs": 1, "relax_uncertainty": 1,
                    "cluster_roots": 1, "relax_min": 0, "cluster_labels": 0},
          f"{phase}: K5's and K6's launches {k5_k6}: expected the table and one relaxation "
          "a K5 call site, one K6 roots launch")
    check_pcg_route(phase, counts, state.graph.node_capacity, cfg.solver)
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
    prof, names = device_profile(lambda: pipeline.optimize_epoch(state, cfg))
    fields.update(prof, kernel_device_ms=kernel_device_ms(names, K5_K6[:4]))
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
    return counts, state2, fields["kernel_device_ms"]


def entry_point_phase(phase: str, state, cfg) -> tuple[dict, dict]:
    """The public entry points that reach K5's rows entry and K6's labels
    entry, on an epoch's state: ``shortest_path.shortest_paths`` from the
    newest valid node and ``filter._cluster_labels`` on the epoch's
    candidates, with the counts set to 0 just before and read just after,
    and a profile of the same calls.  Returns (counts, device ms)."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.graph import filter as gfilter
    from uzliti_slam_tpu_torch.graph import shortest_path
    from uzliti_slam_tpu_torch.kernels import ops as kops

    g = state.graph
    newest = torch.argmax(torch.where(g.node_valid, g.stamp, -math.inf))
    d0 = torch.full((g.node_capacity,), kops.INF, device=g.device).index_fill(
        0, newest.view(1), 0.0)
    idx, heur = pipeline.epoch_candidates(g, cfg)
    cr = gfilter.cluster_roots(g, idx, cfg.filter, cand_mask=heur)

    def run():
        return (shortest_path.shortest_paths(g, d0),
                gfilter._cluster_labels(cr.sf, cr.st, cr.valid, cfg.filter.max_dt))

    run()
    torch.cuda.synchronize()
    kops.reset_launches()
    dist, labels = run()
    torch.cuda.synchronize()
    counts = dict(kops.launches)
    _, names = device_profile(run)
    dms = kernel_device_ms(names, ("relax_table",) + ENTRY_KERNELS)
    log(phase, launches={k: v for k, v in counts.items() if v}, kernel_device_ms=dms,
        reached=int((dist < kops.INF).sum()), clusters=int((labels == torch.arange(
            labels.shape[0], device=labels.device)).sum()))
    check({k: v for k, v in counts.items() if v} == {"relax_table": 1, "relax_min": 1,
                                                       "cluster_labels": 1},
          f"{phase}: launches {counts}")
    return counts, dms


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


def record_args(fn, names=tuple(FRONTEND_WRAPPERS.values())):
    """Run ``fn()`` with every call's arguments of the wrappers ``names``
    (K12-K15's by default) recorded; returns {wrapper: [(args, kwargs), ...]}."""
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


def bound_wrapper_calls(calls: dict, wrappers,
                        tensor_rate: float = B1_AND_POPC_OPS_PER_S) -> dict:
    """``bound`` summed over all the calls ({wrapper: [(args, kwargs)]}) of
    the wrappers named, ``tensor_work``'s operations at ``tensor_rate``."""
    nbytes = ops = tops = 0
    for w in wrappers:
        for args, kw in calls[w]:
            b, o = kernel_work(w, (*args, *kw.values()))
            nbytes, ops = nbytes + b, ops + o
            tops += tensor_work(w, (*args, *kw.values()))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / SCALAR_OPS_PER_S + tops / tensor_rate
    return {"bytes": nbytes, "ops": ops + tops, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def frontend_library(name: str, calls):
    """One PyTorch call per kernel call that computes the same function, or
    None: K13 ``torch.topk`` over the (C·cells, cell) view of each level's
    scores (one call a level; its tie order is not the reference's); K15
    ``scatter_reduce_`` with amin and amax on each scan's quantised
    ranges."""
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.ops import scan

    if name == "grid_topk":
        views = []
        for (scores, k_total, grid), _ in calls:
            for score in [scores] if isinstance(scores, torch.Tensor) else scores:
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


def describe_against_plain(blocks) -> dict:
    """K14 on ``blocks`` (lists of ``kops.DescribeRow``) against its plain
    version row by row: the angles it computes within ANGLE_ATOL of the
    plain version's (a given row's copied exactly), and its descriptors
    given the plain version's angles (one more call on the same rows, each
    angle given) equal the plain descriptors bit for bit and equal again on
    a rerun.  Returns each row's figures, the largest angle error and the
    mismatches."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    got = kops.orb_describe_levels(blocks)
    ref = kops.orb_describe_levels_plain(blocks)
    cols = [[] for _ in blocks]
    for b, block in enumerate(blocks):
        k0 = 0
        for row in block:
            cols[b].append(slice(k0, k0 + row.uv.shape[1]))
            k0 += row.uv.shape[1]
    given = [[r._replace(angles=ref[b][0][:, c].contiguous()) for r, c in zip(block, cols[b])]
             for b, block in enumerate(blocks)]
    again, twice = kops.orb_describe_levels(given), kops.orb_describe_levels(given)
    torch.cuda.synchronize()
    out = {"rows": [], "angle_max_abs_err": 0.0, "mismatches": 0, "rerun_bit_identical": True}
    for b, block in enumerate(blocks):
        (ang, desc), (ang_ref, desc_ref) = got[b], ref[b]
        same = bool(torch.equal(again[b][1], twice[b][1]))
        for r, c in zip(block, cols[b]):
            is_given = r.angles is not None
            err = float((ang[:, c] - ang_ref[:, c]).abs().max()) if ang[:, c].numel() else 0.0
            mism = int((again[b][1][:, c] != desc_ref[:, c]).sum())
            if is_given:
                mism += int((ang[:, c] != ang_ref[:, c]).sum())
                same &= bool(torch.equal(desc[:, c], again[b][1][:, c]))
            out["rows"].append({"block": b, "shape": list(r.img.shape),
                                "keypoints": list(r.uv.shape[:2]), "given": is_given,
                                "angle_max_abs_err": 0.0 if is_given else err,
                                "mismatches": mism,
                                "equal_with_own_angles": int((desc[:, c] == desc_ref[:, c])
                                                             .all(-1).sum())})
            out["angle_max_abs_err"] = max(out["angle_max_abs_err"], 0.0 if is_given else err)
            out["mismatches"] += mism
        out["rerun_bit_identical"] &= same
    return out


def compare_frontend(calls: dict, label: str) -> dict:
    """K12-K15 against their plain versions on the arguments one keyframe
    gives them: K12, K13 and K15 exactly; K14 (one call, every level and the
    GIST) row by row, its angles within ANGLE_ATOL and its descriptors
    exactly given the plain version's angles (the GIST row takes its angle
    as given).  Times are per keyframe: all of the keyframe's calls of the
    kernel."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    rows = {}
    for name in FRONTEND_KERNELS:
        w = FRONTEND_WRAPPERS[name]
        kernel_fn, plain_fn = getattr(kops, w), getattr(kops, f"{w}_plain")
        cl = calls[w]
        check(len(cl) > 0, f"{name} {label}: no call recorded")
        mism, ang_err, row = 0, 0.0, {"calls": len(cl)}
        for args, kw in cl:
            if name == "orb_describe":
                held = describe_against_plain(*args)
                row["rows"] = held["rows"]
                check(held["rerun_bit_identical"], f"{name} {label}: a rerun gives other bits")
                mism += held["mismatches"]
                ang_err = max(ang_err, held["angle_max_abs_err"])
                continue
            got, ref = kernel_fn(*args, **kw), plain_fn(*args, **kw)
            torch.cuda.synchronize()
            pairs = list(zip(got, ref)) if isinstance(got, (tuple, list)) else [(got, ref)]
            mism += sum(int((a != b).sum()) for a, b in pairs)
        row.update(mismatches=mism,
                   max_abs_err=ang_err if name == "orb_describe" else (0.0 if mism == 0 else
                                                                      float("nan")))
        if name == "orb_describe":
            row["angle_atol"] = ANGLE_ATOL

        def run(fn):
            for args, kw in cl:
                fn(*args, **kw)

        row["ms"], row["plain_ms"] = time_pair(lambda: run(kernel_fn), lambda: run(plain_fn))
        if name == "fast_nms":
            # device ms of the keyframe's calls queued back to back (a profile
            # may drop a kernel)
            row["device_ms_queued"] = queued_device_ms(lambda: run(kernel_fn))
        row["library_ms"] = frontend_library(name, cl)
        row.update(bound_wrapper_calls(calls, (w,)))
        log(f"3 kernel {name} {label}", **row)
        check(mism == 0, f"{name} {label}: {mism} entries differ from the plain version")
        check(ang_err <= ANGLE_ATOL, f"{name} {label}: angles {ang_err:.3g} rad apart")
        rows[name] = row
    return rows


def border_describe_blocks(device) -> list:
    """K14's rows on a synthetic VGA frame pair (seeded uint8 noise with a
    bright square, two cameras), in two blocks: the four pyramid levels with
    keypoints on every corner and edge, one pixel in and off the pixel grid,
    inside, and off the frame (its samples clip to the edge), for each
    binary pattern; and the GIST row of the first camera.  A level's width
    is a multiple of 4 (128-bit loads) at 640 and 444 and not at 533 and
    370."""
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.ops import features, resize

    rng = np.random.default_rng(SEED + 41)
    img = rng.integers(0, 256, (2, 480, 640)).astype(np.float32)
    img[:, 100:220, 300:420] = 250.0
    imgs = torch.from_numpy(img).to(device)
    rows = []
    for lvl, (_, (h, w)) in enumerate(features.pyramid_shapes(480, 640, 4, 1.2)):
        cur = imgs if lvl == 0 else resize.resize_linear(imgs, (h, w)).contiguous()
        pts = [(0, 0), (w - 1, 0), (0, h - 1), (w - 1, h - 1), (w // 2, 0), (0, h // 2),
               (w - 1, h // 2), (w // 2, h - 1), (1, 1), (w - 2, h - 2), (2.5, h - 3.5),
               (w - 0.25, 7.75), (w // 3, h // 3), (18.0, 20.0), (w // 2, h // 2),
               (w - 19, 21), (-30.5, -4.0), (w + 40.0, h // 2), (w // 2, h + 0.5)]
        uv = torch.tensor([pts, pts[::-1]], dtype=torch.float32, device=device)
        for name in ("brief", "brisk", "freak"):
            rows.append(kops.DescribeRow(cur, uv, features.pattern(name, device)))
    return [rows, [features.gist_row(imgs[:1], 0.7)]]


def compare_describe_borders(device) -> dict:
    """K14 on ``border_describe_blocks`` (13 rows, one call) against its
    plain version (``describe_against_plain``)."""
    held = describe_against_plain(border_describe_blocks(device))
    out = {"rows": len(held["rows"]), "angle_max_abs_err": held["angle_max_abs_err"],
           "mismatches": held["mismatches"], "rerun_bit_identical": held["rerun_bit_identical"],
           "angle_atol": ANGLE_ATOL}
    log("3 kernel orb_describe border frame", **out)
    check(out["mismatches"] == 0 and out["rerun_bit_identical"]
          and out["angle_max_abs_err"] <= ANGLE_ATOL, f"orb_describe border frame: {out}")
    return out


def compare_grid_topk_cases(calls, label: str) -> dict:
    """K13 on the keyframe's four levels of scores (its one recorded call)
    at other budgets, each against its plain version entry for entry with
    a bit-identical rerun: one keypoint a cell (k_total 16, the last tied
    index), the global branch (k_total 8 < 16 cells), padding (k_total 75,
    as 300 features over 4 levels give) and passes of 8 (k_total 160, 10 a
    cell); then ten profiled calls of the step's budget: their device
    kernels are K13's alone (no fill launches)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    (scores, k_total, grid), _ = calls[0]
    out = {}
    for name, k in (("one_per_cell", 16), ("global_branch", 8), ("padding", 75),
                    ("passes_of_8", 160)):
        got, again = kops.grid_topk(scores, k, grid), kops.grid_topk(scores, k, grid)
        ref = kops.grid_topk_plain(scores, k, grid)
        torch.cuda.synchronize()
        mism = sum(int((a != b).sum()) for a, b in zip(got, ref))
        same = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
        out[name] = {"k_total": k, "levels": len(scores), "mismatches": mism,
                     "rerun_bit_identical": same}
        check(mism == 0 and same, f"grid_topk {label} {name}: {out[name]}")
    _, names = device_profile(lambda: [kops.grid_topk(scores, k_total, grid) for _ in range(10)])
    out["device_kernels_10_calls"] = names
    log(f"3 kernel grid_topk cases {label}", **out)
    check(len(names) == 1 and "grid_cells" in next(iter(names)),
          f"grid_topk {label}: its calls launched {sorted(names)}")
    return out


def fast_nms_cases(device) -> dict:
    """K12's synthetic cases, each a list of (2, H, W) levels: the four
    pyramid levels of a seeded uint8-noise VGA pair (dense corners: most
    pixels run the full ring), of a flat VGA frame (every pixel rejected by
    the compass test), and of a frame whose 2x2 blobs and 1x3 bars straddle
    the 32-pixel tile edges (equal scores on plateaus across tiles: the NMS
    keeps every tie; level 0 alone holds them exactly); and levels narrower
    or lower than one tile, some of a width no multiple of 4."""
    from uzliti_slam_tpu_torch.ops import features, resize

    rng = np.random.default_rng(SEED + 43)

    def pyramid(img):
        imgs = torch.from_numpy(img).to(device)
        return [imgs if lvl == 0 else resize.resize_linear(imgs, hw).contiguous()
                for lvl, (_, hw) in enumerate(features.pyramid_shapes(480, 640, 4, 1.2))]

    plateau = np.full((2, 480, 640), 60.0, np.float32)
    for y in range(32, 480 - 31, 32):
        for x in range(32, 640 - 31, 32):
            plateau[0, y - 1: y + 1, x - 1: x + 1] = 220.0
            plateau[1, y - 1: y + 1, x - 1: x + 1] = 240.0
            plateau[:, y + 10, x - 1: x + 2] = 200.0
    narrow = [torch.from_numpy(rng.integers(0, 256, (2, h, w)).astype(np.float32)).to(device)
              for h, w in ((30, 20), (20, 50), (45, 31), (64, 29), (50, 60))]
    return {"noise_vga": pyramid(rng.integers(0, 256, (2, 480, 640)).astype(np.float32)),
            "flat_vga": pyramid(np.full((2, 480, 640), 128.0, np.float32)),
            "plateaus_vga": pyramid(plateau), "narrow_levels": narrow}


def nms_ties(score) -> int:
    """Surviving pixels of (C, H, W) scores with a surviving 8-neighbour of
    the same score."""
    pad = torch.nn.functional.pad(score, (1, 1, 1, 1))
    H, W = score.shape[-2:]
    n = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                nb = pad[:, 1 + dy: 1 + dy + H, 1 + dx: 1 + dx + W]
                n += int(((score > 0) & (nb == score)).sum())
    return n


def compare_fast_nms_cases(cases: dict, label: str, threshold: float = 20.0) -> dict:
    """K12 (one call a case, every level) against its plain version level
    by level, exactly, with a bit-identical rerun; each case's corners and
    tied survivors counted from the plain version."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    out = {}
    for name, levels in cases.items():
        kops.reset_launches()
        got, again = kops.fast_nms(levels, threshold), kops.fast_nms(levels, threshold)
        launched = kops.launches["fast_nms"]
        ref = kops.fast_nms_plain(levels, threshold)
        torch.cuda.synchronize()
        row = {"levels": [list(t.shape) for t in levels], "launches": launched,
               "mismatches": sum(int((a != b).sum()) for a, b in zip(got, ref)),
               "rerun_bit_identical": all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
               "corners": sum(int((r > 0).sum()) for r in ref),
               "tied_survivors": sum(nms_ties(r) for r in ref)}
        out[name] = row
        check(row["mismatches"] == 0 and row["rerun_bit_identical"] and launched == 2,
              f"fast_nms {label} {name}: {row}")
        check(name != "plateaus_vga" or row["tied_survivors"] > 0,
              f"fast_nms {label}: the plateau frame holds no tie")
    log(f"3 kernel fast_nms cases {label}", **out)
    return out


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
    fields["kernel_device_ms"] = kernel_device_ms(device_ms, FRONTEND_KERNELS)
    log(phase, **fields)
    check(all(counts[k] > 0 for k in FRONTEND_KERNELS), f"{phase}: a kernel was not launched: "
          f"{counts}")
    check(counts["fast_nms"] == 1, f"{phase}: K12 launched {counts['fast_nms']} times in a "
                                   "keyframe (one call takes every level)")
    check(counts["grid_topk"] == 1, f"{phase}: K13 launched {counts['grid_topk']} times in a "
                                    "keyframe (one call takes every level)")
    check(counts["orb_describe"] == 1, f"{phase}: K14 launched {counts['orb_describe']} times in "
                                       "a keyframe (one call takes every level and the GIST)")
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
        if name == "bilateral":
            # device ms of the step's call queued back to back (a profile
            # may drop a kernel)
            row["device_ms_queued"] = queued_device_ms(lambda: run(wrappers, False))
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


def bilateral_cases(device) -> dict:
    """K17's synthetic cases (depth, guide), (2, 480, 640) float32: depths
    0.5-4 m with 0, -0, -1, NaN and +inf written on every tile corner (the
    32 x 16 tiles' first and last rows and columns), along the image border
    and at random pixels, under a uint8-noise guide (the colour table) and
    under the same guide + 0.5 (fractional: expf at each tap); clean depths
    under a fractional guide; and the integer guide with, in a few tiles
    each, a fractional value, a NaN, an infinity and a value above 255
    (mixed paths; a NaN guide zeroes every pixel whose window holds it)."""
    rng = np.random.default_rng(SEED + 47)
    shape = (2, 480, 640)
    depth = rng.uniform(0.5, 4.0, shape).astype(np.float32)
    special = np.array([0.0, -0.0, -1.0, np.nan, np.inf], np.float32)
    ys = np.array([y for t in range(0, 480, 16) for y in (t, t + 15)])
    xs = np.array([x for t in range(0, 640, 32) for x in (t, t + 31)])
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    depth[:, yy, xx] = special[(yy + xx) % len(special)]
    depth[:, 0, ::7] = depth[:, -1, 3::7] = depth[:, ::5, 0] = depth[:, 2::5, -1] = -0.0
    depth[:, 1, 1::11] = np.nan
    depth[:, -2, ::13] = np.inf
    depth[rng.random(shape) < 0.02] = 0.0
    depth[rng.random(shape) < 0.01] = np.nan
    clean = rng.uniform(0.5, 4.0, shape).astype(np.float32)
    guide = rng.integers(0, 256, shape).astype(np.float32)
    mixed = guide.copy()
    mixed[0, 40, 100] = 17.25
    mixed[0, 200, 333] = np.nan
    mixed[1, 100, 50] = np.inf
    mixed[1, 300, 600] = 300.0
    mixed[1, 479, 639] = -np.inf
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return {"special_depths_table": (t(depth), t(guide)),
            "special_depths_expf": (t(depth), t(guide + 0.5)),
            "fractional_guide": (t(clean), t(guide + rng.uniform(0, 1, shape).astype(np.float32))),
            "mixed_guides": (t(depth), t(mixed))}


def compare_bilateral_cases(cases: dict, label: str, step_args=None) -> dict:
    """K17 against its plain version at ``BILATERAL_ULPS`` (bit-equal) on
    each case, with the same zeros and a bit-identical rerun; which path
    each tile took, read from the kernel, equal to the rule's prediction
    (``kops.bilateral_tile_paths_plain``) and counted; ``step_args`` (the
    step's call) first, as "step"."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    out = {}
    items = ([("step", step_args)] if step_args is not None else []) + list(cases.items())
    for name, (depth, guide) in items:
        got, paths = kops.bilateral(depth, guide, tile_paths=True)
        again = kops.bilateral(depth, guide)
        ref = kops.bilateral_plain(depth, guide)
        rule = kops.bilateral_tile_paths_plain(guide)
        torch.cuda.synchronize()
        row = {"max_ulps": _ulps(got, ref), "zeros_differ": int(((got == 0) != (ref == 0)).sum()),
               "nonfinite": int((~torch.isfinite(got)).sum()),
               "rerun_bit_identical": bool(torch.equal(got, again)),
               "table_tiles": int(paths.sum()), "expf_tiles": int((paths == 0).sum()),
               "paths_as_predicted": bool(torch.equal(paths, rule))}
        out[name] = row
        check(row["max_ulps"] <= BILATERAL_ULPS and row["zeros_differ"] == 0
              and row["rerun_bit_identical"] and row["paths_as_predicted"],
              f"bilateral {label} {name}: {row}")
    log(f"3 kernel bilateral cases {label}", **out)
    if step_args is not None:
        check(out["step"]["expf_tiles"] == 0, f"bilateral {label}: the step's uint8 guide left "
                                              "the colour table")
    for name in ("special_depths_expf", "fractional_guide"):
        check(out[name]["table_tiles"] == 0, f"bilateral {label} {name}: a tile took the table")
    check(out["mixed_guides"]["table_tiles"] > 0 and out["mixed_guides"]["expf_tiles"] > 0,
          f"bilateral {label}: the mixed guides took one path")
    return out


def gist_bank_inputs(n: int, device, seed: int, k: int = 5) -> tuple:
    """``gist_topk``'s arguments on a tie-heavy bank of n entries: each a
    copy of one of 16 base descriptors with a bit flipped in about a fifth
    of its bytes (many exact ties), stamps uniform over 600 s, 90 % valid;
    the query base 3 at 300 s, min_dt 5 s, max_dist 60."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (16, 32), dtype=np.uint8)
    flips = (rng.random((n, 32)) < 0.2).astype(np.uint8) << rng.integers(0, 8, (n, 32),
                                                                          dtype=np.uint8)
    bank = base[rng.integers(0, 16, n)] ^ flips
    stamp = rng.uniform(0.0, 600.0, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return (t(base[3]), t(bank), t(stamp), t(valid), torch.tensor(300.0, device=device), k, 5.0,
            60.0)


def compare_k16_cases(step_calls: dict, device) -> dict:
    """K16 beyond the step's own calls, each entry for entry against its
    plain version with a bit-identical rerun: the step's matching arguments
    with every query and stored descriptor equal, with half the queries and
    the first candidate's stored descriptors masked, with one valid stored
    descriptor a candidate, and with 600 stored descriptors a node (above
    the kernel's tile of 256 and not a multiple of it: three tiles), each
    query's copy in the second tile and again in the first or the third
    (ties across tiles, the lower index first); the GIST query on a 300-entry tie-heavy
    bank at k = 1, 5, 8, 9, 19 and 300, and on banks of 1k, 10k, 50k and
    100k entries (above the 58,112 that the kernel it replaced held in
    shared memory) at k = 5 and 19."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    out = {}

    def held(label, w, args):
        fn, plain = getattr(kops, w), getattr(kops, f"{w}_plain")
        got, again, ref = fn(*args), fn(*args), plain(*args)
        torch.cuda.synchronize()
        row = {"mismatches": sum(int((a != b).sum()) for a, b in zip(got, ref)),
               "rerun_bit_identical": all(bool(torch.equal(a, b)) for a, b in zip(got, again))}
        out[label] = row
        check(row["mismatches"] == 0 and row["rerun_bit_identical"], f"{w} {label}: {row}")

    (query, bank, bank_valid, cslot, valid_a, ratio, max_dist), _ = step_calls["hamming_top2"][0]
    Na, (N, F, _) = query.shape[0], bank.shape
    same_q = query[:1].expand(Na, 32).contiguous()
    held("match_all_equal", "hamming_top2",
         (same_q, query[0].expand(N, F, 32).contiguous(), torch.ones_like(bank_valid), cslot,
          torch.ones_like(valid_a), ratio, max_dist))
    masked_a = valid_a.clone()
    masked_a[: Na // 2] = False
    masked_b = bank_valid.clone()
    masked_b[cslot[0].long()] = False
    held("match_masked_rows", "hamming_top2",
         (query, bank, masked_b, cslot, masked_a, ratio, max_dist))
    one = torch.zeros_like(bank_valid)
    one[torch.arange(N, device=device), torch.arange(N, device=device) % F] = True
    held("match_one_valid_stored", "hamming_top2",
         (query, bank, one, cslot, valid_a, ratio, max_dist))
    rng = np.random.default_rng(SEED + 52)
    wide = torch.from_numpy(rng.integers(0, 256, (N, 600, 32), dtype=np.uint8)).to(device)
    m = min(Na, 256)
    wide[:, 256:256 + m] = query[:m]
    wide[:, :m // 4] = query[:m // 4]
    wide[:, 512:512 + min(m, 88)] = query[:min(m, 88)]
    wide_valid = torch.rand(N, 600, generator=torch.Generator().manual_seed(SEED + 53)) > 0.05
    held("match_f600_ties_across_tiles", "hamming_top2",
         (query, wide, wide_valid.to(device), cslot, valid_a, ratio, max_dist))
    args = gist_bank_inputs(300, device, SEED + 51)
    for k in (1, 5, 8, 9, 19, 300):
        held(f"gist_300_k{k}", "gist_topk", args[:5] + (k,) + args[6:])
    for n in (1000, 10_000, 50_000, 100_000):
        args = gist_bank_inputs(n, device, SEED + n)
        for k in (5, 19):
            held(f"gist_{n}_k{k}", "gist_topk", args[:5] + (k,) + args[6:])
    log("3 kernel hamming_top2 cases", **out)
    return out


def icp_against_plain(args, kw, label: str) -> dict:
    """K18 on ``args`` against its plain version (pose within
    ICP_POSE_ATOL, covariance within ICP_COV_RTOL of its largest entry, the
    same ok flag and valid fraction) and against a second run of itself
    (every output bit-identical); fails the run if either does not hold."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    got, again, ref = kops.icp(*args, **kw), kops.icp(*args, **kw), kops.icp_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((got[0] - ref[0]).abs().max())
    cov_err = float((got[3] - ref[3]).abs().max())
    cov_scale = float(ref[3].abs().max())
    row = {"batch": int(args[0].shape[0]), "M": int(args[0].shape[1]),
           "N": int(args[2].shape[1]), "valid_targets": args[3].sum(-1).tolist(),
           "pose_max_abs_err": err, "cov_max_abs_err": cov_err, "cov_scale": cov_scale,
           "same_ok": bool(torch.equal(got[4], ref[4])),
           "same_fraction": bool(torch.equal(got[1], ref[1])), "ok": got[4].tolist(),
           "rerun_bit_identical": all(bool(torch.equal(a, b)) for a, b in zip(got, again))}
    log(f"3 kernel icp {label}", **row)
    check(row["same_ok"] and row["same_fraction"] and err <= ICP_POSE_ATOL
          and cov_err <= ICP_COV_RTOL * cov_scale,
          f"icp {label}: against its plain version {row}")
    check(row["rerun_bit_identical"], f"icp {label}: a second run gives other bits")
    return row


def icp_room_problem(batch: int, m: int, n: int, device, seed: int = SEED):
    """A synthetic K18 problem at the wrapper's largest target scan: the
    walls x = ±3, y = ±2 of a room seen from the origin (n points, 5 mm
    noise, a tenth invalid at 0), and the same room seen from ``batch``
    offset poses (m points each); (src, src_valid, dst, dst_valid, init)."""
    rng = np.random.default_rng(seed)

    def room(k):
        th = np.linspace(-np.pi, np.pi, k, endpoint=False)
        c, s_ = np.cos(th), np.sin(th)
        t = np.minimum(3.0 / np.maximum(np.abs(c), 1e-9), 2.0 / np.maximum(np.abs(s_), 1e-9))
        return np.stack([t * c, t * s_], -1) + 0.005 * rng.normal(size=(k, 2))

    offs = rng.uniform([-0.15, -0.15, -0.08], [0.15, 0.15, 0.08], (batch, 3))
    src = np.empty((batch, m, 2))
    for b, (x, y, a) in enumerate(offs):
        R = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        src[b] = (room(m) - [x, y]) @ R
    dst = np.broadcast_to(room(n), (batch, n, 2)).copy()
    sv, dv = rng.random((batch, m)) > 0.1, rng.random((batch, n)) > 0.1
    src[~sv], dst[~dv] = 0.0, 0.0
    t = lambda a, dt=torch.float32: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)  # noqa: E731
    return (t(src), t(sv, torch.bool), t(dst), t(dv, torch.bool),
            torch.zeros(batch, 3, device=device))


def compare_icp_cases(args, kw, label: str) -> dict:
    """K18 beyond the step's own call (``args``, B = 1): the few-valid
    target scans (none, and only the first valid target: every pair then
    holds an invalid target at +inf, the reference's lowest-index pick), a
    synthetic problem at N = M = 8192 at batch 1 and 4, each against its
    plain version with a bit-identical rerun."""
    dst_valid = args[3]
    first = torch.zeros_like(dst_valid)
    first[:, int(torch.nonzero(dst_valid[0])[0, 0])] = True
    scalars = args[5:]
    out = {"step": icp_against_plain(args, kw, f"{label} step"),
           "no_valid_target": icp_against_plain(args[:3] + (torch.zeros_like(dst_valid),)
                                                + args[4:], kw, f"{label} no valid target"),
           "one_valid_target": icp_against_plain(args[:3] + (first,) + args[4:], kw,
                                                 f"{label} one valid target")}
    for batch in (1, 4):
        big = icp_room_problem(batch, 8192, 8192, args[0].device) + scalars
        out[f"n8192_b{batch}"] = icp_against_plain(big, kw, f"N = 8192, batch {batch}")
        del big
    return out


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
    fields["kernel_device_ms"] = kernel_device_ms(device_ms, step_kernels + kernels)
    # K16's device ms by entry (the matching, the GIST query)
    fields["hamming_top2_device_ms_by_entry"] = {
        f: sum(ms for key, ms in device_ms.items() if f"::{f}(" in key)
        for f in FRONTEND_DEVICE_FUNCTIONS["hamming_top2"]}
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
    check(one["fast_nms"] == 1, f"{phase}: K12 launched {one['fast_nms']} times in a step "
                                "(one call takes every level)")
    check(one["grid_topk"] == 1, f"{phase}: K13 launched {one['grid_topk']} times in a step "
                                 "(one call takes every level)")
    check(one["orb_describe"] == 1, f"{phase}: K14 launched {one['orb_describe']} times in a "
                                    "step (one call takes every level and the GIST)")
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
    """K16-K18's and K7's arguments in one late keyframe step (candidates
    exist): ``process_keyframe`` on the Slam's state with the last frame,
    its result discarded."""
    from uzliti_slam_tpu_torch import pipeline

    last = len(frames) - 1
    names = tuple(w for k in KEYFRAME_KERNELS for w in KEYFRAME_WRAPPERS[k]) + ("ransac_rigid",)
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


def bin_min_max_cases(device) -> dict:
    """K15's points entry on edge cases: 3,000 points on half the circle (the
    other half's bins empty) led by NaN and ±inf coordinates, points on the
    range limits, on bin edges at bearings 0, ±π/2 and ±π, and heights on
    the band's limits; as one planar scan, one cloud with the band, and a
    batch of 16 scans of 720 points whose last scan has no valid point."""
    rng = np.random.default_rng(SEED + 23)
    n = 3000
    r = rng.uniform(0.0, 7.0, n).astype(np.float32)
    th = rng.uniform(-np.pi, 0.0, n).astype(np.float32)
    pts = np.stack([r * np.cos(th), r * np.sin(th), rng.uniform(-0.2, 1.2, n)], -1)
    pts = pts.astype(np.float32)
    special = np.array([
        [np.nan, 1.0, 0.5], [1.0, np.nan, 0.5], [2.0, 1.0, np.nan],
        [np.inf, 0.0, 0.5], [0.0, -np.inf, 0.5], [np.inf, np.inf, 0.5], [-np.inf, 3.0, 0.5],
        [6.0, 0.0, 0.5], [0.05, 0.0, 0.5], [0.3, 0.0, 0.5], [0.0, 6.0, 0.5],
        [-6.0, 0.0, 0.5], [-2.0, -0.0, 0.5], [0.0, -2.5, 0.5], [4.0, 0.0, 0.5],
        [5.0, 0.0, 0.1], [5.5, 0.0, 1.0], [1.5, 0.0, 0.0999], [1.25, 0.0, 1.0001],
        [0.0, 0.0, 0.5], [6.0000005, 0.0, 0.5]], np.float32)
    pts[: len(special)] = special
    valid = rng.random(n) < 0.9
    valid[: len(special)] = True
    batch = rng.uniform(-7, 7, (16, 720, 2)).astype(np.float32)
    bvalid = rng.random((16, 720)) < 0.8
    bvalid[15] = False
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)   # noqa: E731
    pi = math.pi
    return {"planar_3000": (t(pts[None, :, :2]), t(valid[None]), 360, -pi, pi, 6.0, 0.05),
            "cloud_3000": (t(pts[None]), t(valid[None]), 180, -pi, pi, 6.0, 0.3, (0.1, 1.0)),
            "batch_16x720": (t(batch), t(bvalid), 360, -pi, pi, 6.0, 0.05)}


def compare_bin_min_max_cases(device, label: str) -> dict:
    """``bin_min_max_cases`` through K15's points entry against its plain
    version on the card: every bin equal."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    rows = {}
    for name, args in bin_min_max_cases(device).items():
        got, ref = kops.bin_min_max(*args), kops.bin_min_max_plain(*args)
        torch.cuda.synchronize()
        mism = sum(int((a != b).sum()) for a, b in zip(got, ref))
        rows[name] = {"mismatches": mism, "bins_with_a_range": int(torch.isfinite(ref[0]).sum()),
                      "empty_bins": int(torch.isinf(ref[0]).sum())}
        check(mism == 0, f"bin_min_max {label} {name}: {mism} bins differ from the plain version")
    log(f"3 kernel bin_min_max {label} cases", **rows)
    return rows


def compare_maintenance_kernels(calls: dict, label: str, trials: int = 7, calls_per: int = 2):
    """K19, K20 and bin_min_max against their plain versions on the
    arguments the main path gives them: K19 and bin_min_max exactly, K20's
    θ within CALIB_THETA_ATOL and cost history within CALIB_HIST_RTOL;
    bin_min_max also on ``bin_min_max_cases``, exactly."""
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
        # no one PyTorch call computes any of the three (bin_min_max's
        # scatter_reduce_ pair, timed until the points math moved into its
        # launch, computed only the reduction)
        row["library_ms"] = None
        row.update(bound_calls(name, cl))
        if name in ("merge_pairs", "calib_gn"):
            # one device launch a call, read from a profile; a second launch
            # on the same inputs gives the same bits
            a0, kw0 = cl[0]
            row["rerun_bit_identical"] = same_bits(kernel_fn(*a0, **kw0), kernel_fn(*a0, **kw0))
            per_call, row["launch_profiles"] = device_launch_count(
                lambda: kernel_fn(*a0, **kw0), FRONTEND_DEVICE_FUNCTIONS[name])
            row["device_launches_a_call"] = (
                "not measured (no whole trace)" if per_call is None else per_call)
            if name == "merge_pairs":
                row["bound_ms_all_pairs"] = merge_pairs_all_pairs_bound(a0)
            check(row["rerun_bit_identical"], f"{name} {label}: a rerun gives other bits")
            check(per_call == 1.0, f"{name} {label}: {row['device_launches_a_call']} device "
                  "launches a call")
        log(f"3 kernel {name} {label}", **row)
        if name == "bin_min_max":
            row["cases"] = compare_bin_min_max_cases(cl[0][0][0].device, label)
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
              "kernel_ms": t, **bound("merge_pairs", args),
              "bound_ms_all_pairs": merge_pairs_all_pairs_bound(args),
              "cases": compare_merge_pairs_cases(state.graph.device)}
    log(phase, **fields)
    check(same, f"{phase}: K19 differs from its plain version")
    check(fields["pairs"] == 16, f"{phase}: {fields['pairs']} pairs")
    return fields


def merge_pairs_cases(device) -> dict:
    """K19's edge cases, each (pose, stamp, eligible, dist, angle,
    max_pairs): a 40-node cluster within a few cm (rows with 39 close pairs,
    above K = 31) and a 200-node one (rows above the 128-key buffer), with
    max_pairs 16 and 1; NaN and ±inf poses on three noisy laps; exact dt
    ties on a 0.125 m lattice; three noisy laps with max_pairs 32; and 7,300
    nodes whose ~29k keys all join one of 4 hubs (equal stamps elsewhere: no
    other pair) beside 40 nodes 0.15 m apart on a line, so that the last
    CTA's subset of smallest keys is spent after the hub rounds and the
    rounds search every row."""
    from uzliti_slam_tpu_torch.io import synthetic

    rng = np.random.default_rng(SEED + 24)

    def laps(n, seed, **kw):
        g, _ = synthetic.make_pose_graph(n, node_capacity=n, edge_capacity=4 * n, device=device,
                                         generator=torch.Generator().manual_seed(seed), **kw)
        return g.pose.clone(), g.stamp.clone(), g.node_valid.clone()

    def unit_q(m, scale):
        q = np.array([1.0, 0, 0, 0]) + rng.normal(scale=scale, size=(m, 4))
        return q / np.linalg.norm(q, axis=1, keepdims=True)

    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    cases = {}
    for m in (40, 200):
        pose = np.concatenate([rng.normal(scale=0.02, size=(m, 3)), unit_q(m, 0.01)], 1)
        far = np.concatenate([np.arange(24)[:, None] * [3.0, 0, 0] + [10.0, 0, 0],
                              np.tile([[1.0, 0, 0, 0]], (24, 1))], 1)
        p = t(np.concatenate([pose, far]))
        st = t(rng.permutation(m + 24))
        for mp in (16, 1):
            cases[f"cluster{m}_max_pairs_{mp}"] = (p, st, torch.ones(m + 24, dtype=torch.bool,
                                                                    device=device),
                                                   0.25, 15.0, mp)
    pose, stamp, valid = laps(60, 3, loops=3.0, radius=1.0, loop_closure_every=7)
    bad = pose.clone()
    bad[3, 0], bad[8, 3:] = float("nan"), float("nan")
    bad[11, 1], bad[17, 2], bad[29, 4] = float("inf"), -float("inf"), float("inf")
    cases["nan_inf_poses"] = (bad, stamp, valid, 0.25, 15.0, 16)
    cases["three_laps_max_pairs_32"] = (pose, stamp, valid, 0.3, 25.0, 32)
    xy = np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1).reshape(-1, 2) * 0.125
    lattice = np.concatenate([xy, np.zeros((64, 1)), np.tile([[1.0, 0, 0, 0]], (64, 1))], 1)
    cases["dt_ties_lattice"] = (t(lattice), t(rng.permutation(64)),
                                torch.ones(64, dtype=torch.bool, device=device), 0.2, 15.0, 16)
    m = 7300
    d = rng.uniform(0.01, 0.1, m)
    u = rng.normal(size=(m, 3))
    spoke = u / np.linalg.norm(u, axis=1, keepdims=True) * d[:, None]
    line = np.arange(40)[:, None] * [0.15, 0, 0] + [5.0, 0, 0]
    xyz = np.concatenate([spoke, np.zeros((4, 3)), line])
    ident = np.tile([[1.0, 0, 0, 0]], (len(xyz), 1))
    stamps = np.concatenate([np.zeros(m), np.ones(4), 2.0 + np.arange(40)])
    cases["hubs_subset_spent"] = (t(np.concatenate([xyz, ident], 1)), t(stamps),
                                  torch.ones(len(xyz), dtype=torch.bool, device=device),
                                  0.25, 15.0, 16)
    return cases


def compare_merge_pairs_cases(device) -> dict:
    """``merge_pairs_cases`` through K19 against its plain version on the
    card: exactly, and a second launch bit for bit."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    rows = {}
    for name, args in merge_pairs_cases(device).items():
        got, ref = kops.merge_pairs(*args), kops.merge_pairs_plain(*args)
        again = kops.merge_pairs(*args)
        torch.cuda.synchronize()
        mism = sum(int((a != b).sum()) for a, b in zip(got, ref))
        rows[name] = {"nodes": int(args[0].shape[0]), "pairs": int(ref[2].sum()),
                      "mismatches": mism, "rerun_bit_identical": same_bits(got, again)}
        check(mism == 0, f"merge_pairs {name}: {mism} entries differ from the plain version")
        check(rows[name]["rerun_bit_identical"], f"merge_pairs {name}: a rerun gives other bits")
    return rows


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
    # K18 against its plain version on the card, on these arguments, with a
    # bit-identical rerun; its device ms a call at this batch
    args, kw = calls["icp"][0]
    held = icp_against_plain(args, kw, f"{phase} batch {batch}")
    kernel_err, kernel_same_ok = held["pose_max_abs_err"], held["same_ok"]
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
              "icp_kernel_rerun_bit_identical": held["rerun_bit_identical"],
              "icp_device_ms": device_ms_of(lambda: [kops.icp(*args, **kw) for _ in range(20)],
                                            20, "icp_cluster"),
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
    per_call, launch_profiles = device_launch_count(slam.calibrate,
                                                    FRONTEND_DEVICE_FUNCTIONS["calib_gn"])
    device_launches = "not measured (no whole trace)" if per_call is None else per_call
    rerun = same_bits(tuple(slam.calibrate()), tuple(res))
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
              "calib_gn_device_launches": device_launches, "launch_profiles": launch_profiles,
              "rerun_bit_identical": rerun,
              "odom_params": p.tolist(), "p_true": p_true.tolist(),
              "cost_history_first_last": [float(res.cost_history[0]),
                                          float(res.cost_history[-1])],
              "chi2_calibrated": c_on, "chi2_uncalibrated": c_off, "chi2_cpu_plain": c_cpu,
              "ate_calibrated_m": ate_on, "ate_uncalibrated_m": ate_off,
              "raw_measurements_kept": bool(torch.equal(g_on.e_transform, start.e_transform))}
    log(phase, **fields)
    check(counts["calib_gn"] == 1 and per_call == 1.0,
          f"{phase}: K20 launches {counts['calib_gn']}, device launches {device_launches}")
    check(rerun, f"{phase}: a second calibrate gives other bits")
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


def _flip_first(desc, n: int):
    """``desc`` with its first n bits (LSB first) flipped: n bits away."""
    mask = torch.zeros(32, dtype=torch.uint8, device=desc.device)
    mask[:n // 8] = 255
    if n % 8:
        mask[n // 8] = (1 << (n % 8)) - 1
    return desc ^ mask


def feature_case(Fq: int, Fb: int, N: int, k: int, device, seed: int, case: str = "mixed",
                 ties=(3, 70, 131)) -> tuple:
    """``feature_votes``' arguments at the given shape: half the nodes' rows
    copies of query rows with ~10 % of their bytes one bit off, the rest
    random; node 0's first rows 40 and 41 bits from query 0 (either side of
    the threshold); 20 % of stored and 10 % of query descriptors invalid,
    10 % of nodes.  ``case``: "ineligible" (every node within min_dt),
    "invalid_bank" (no valid stored descriptor), "ties" (the nodes at
    ``ties`` one node, eligible), "thresh_inf" / "thresh_neg" (thresh +inf /
    -1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    query = _rand_u8((Fq, 32), g, device)
    qvalid = torch.rand(Fq, generator=g, device=device) < 0.9
    qvalid[0] = True
    pick = torch.randint(0, Fq, (N, Fb), generator=g, device=device)
    bank = _flip_bits(query[pick], 0.1, g)
    far = torch.rand(N, generator=g, device=device) < 0.5
    bank[far] = _rand_u8((int(far.sum()), Fb, 32), g, device)
    bank[0, 0] = _flip_first(query[0], 40)
    if Fb > 1:
        bank[0, 1] = _flip_first(query[0], 41)
    bank_valid = torch.rand(N, Fb, generator=g, device=device) < 0.8
    valid = torch.rand(N, generator=g, device=device) < 0.9
    valid[0] = True
    if case == "ties":
        for slot in ties[1:]:
            bank[slot], bank_valid[slot] = bank[ties[0]], bank_valid[ties[0]]
        valid[list(ties)] = True
    if case == "invalid_bank":
        bank_valid[:] = False
    stamp = torch.randperm(N, generator=g, device=device).to(torch.float32)
    q_stamp = torch.full((), float(N // 2 if case == "ineligible" else N + 10), device=device)
    thresh = {"thresh_inf": float("inf"), "thresh_neg": -1.0}.get(case, 40.0)
    return (query, qvalid, bank.contiguous(), bank_valid, stamp, valid, q_stamp, k, thresh, 0.2,
            1e9 if case == "ineligible" else 5.0)


def repo_case(F: int, D: int, N: int, k: int, device, seed: int, case: str = "mixed",
              L: int = 3, ties=()) -> tuple:
    """(``repo_nearest``'s, ``repo_votes``') arguments at the given shape: 2F
    stored descriptors copies of query rows with ~10 % of their bytes a bit
    off, the rest random; stored 0 and 1 40 and 41 bits from query 0; query
    3 five bits from query 1 (an in-frame duplicate); 15 % of stored and
    10 % of query descriptors invalid, 40 % of links, 10 % of nodes; copies
    of query 0 at ``ties`` (equal nearest keys in other CTAs' tiles).
    ``case`` as ``feature_case``'s."""
    g = torch.Generator(device=device).manual_seed(seed)
    query = _rand_u8((F, 32), g, device)
    if F > 4:
        query[3] = _flip_first(query[1], 5)
    qvalid = torch.rand(F, generator=g, device=device) < 0.9
    qvalid[0] = True
    bank = _rand_u8((D, 32), g, device)
    near = torch.randint(0, D, (min(D, 2 * F),), generator=g, device=device)
    bank[near] = _flip_bits(query[torch.randint(0, F, (near.numel(),), generator=g,
                                                device=device)], 0.1, g)
    bank[0] = _flip_first(query[0], 40)
    if D > 1:
        bank[1] = _flip_first(query[0], 41)
    bank_valid = torch.rand(D, generator=g, device=device) < 0.85
    for i in ties:
        bank[i], bank_valid[i] = query[0], True
    if case == "invalid_bank":
        bank_valid[:] = False
    links = torch.randint(0, N, (D, L), generator=g, device=device, dtype=torch.int32)
    link_valid = torch.rand(D, L, generator=g, device=device) < 0.6
    stamp = torch.randperm(N, generator=g, device=device).to(torch.float32)
    node_valid = torch.rand(N, generator=g, device=device) < 0.9
    q_stamp = torch.full((), float(N // 2 if case == "ineligible" else N + 10), device=device)
    thresh = {"thresh_inf": float("inf"), "thresh_neg": -1.0}.get(case, 40.0)
    min_dt = 1e9 if case == "ineligible" else 5.0
    return ((query, qvalid, bank, bank_valid, thresh),
            (query, qvalid, bank, bank_valid, links, link_valid, stamp, node_valid, q_stamp, k,
             thresh, 1.0, min_dt))


def recognition_edge_cases(device) -> list:
    """(label, wrapper, arguments) of K21's and K22's edge cases: query
    counts either side of a 16-row strip (1, 17, 255), stored counts either
    side of an 8-column tile and of a stage (1, 9, 300), one node and 133,
    k = N, every node ineligible, a wholly invalid bank, thresholds +inf and
    -1, ties planted in nodes and tiles that other CTAs take, D either side
    of a 64-descriptor tile, one link, and shapes past the shared-memory caps
    the kernels had before (K21 Fq + Fb = 7,100; K22 F = 5,000, two chunks
    of the duplicate test)."""
    out = []
    feat = [("Fq1", 1, 256, 512, 5, "mixed"), ("Fq17", 17, 256, 512, 5, "mixed"),
            ("Fq255", 255, 256, 512, 5, "mixed"), ("Fb1", 256, 1, 133, 5, "mixed"),
            ("Fb9", 256, 9, 133, 5, "mixed"), ("Fb300", 128, 300, 133, 5, "mixed"),
            ("N1", 256, 256, 1, 1, "mixed"), ("N133 k=N", 256, 64, 133, 133, "mixed"),
            ("ineligible", 128, 64, 133, 7, "ineligible"),
            ("invalid bank", 128, 64, 133, 7, "invalid_bank"),
            ("ties", 128, 64, 133, 9, "ties"), ("thresh +inf", 128, 64, 133, 7, "thresh_inf"),
            ("thresh -1", 128, 64, 133, 7, "thresh_neg"), ("Fq4000 Fb3100", 4000, 3100, 3, 3,
                                                            "mixed")]
    for i, (label, Fq, Fb, N, k, case) in enumerate(feat):
        out.append((label, "feature_votes", feature_case(Fq, Fb, N, k, device, SEED + 70 + i, case)))
    repo = [("F1", 1, 16384, 512, 5, "mixed", 3, ()), ("F17", 17, 16384, 512, 5, "mixed", 3, ()),
            ("F255", 255, 16384, 512, 5, "mixed", 3, ()), ("D1", 256, 1, 1, 1, "mixed", 3, ()),
            ("D9", 256, 9, 3, 3, "mixed", 3, ()), ("D63", 64, 63, 9, 9, "mixed", 3, ()),
            ("D64", 64, 64, 9, 9, "mixed", 3, ()), ("D65", 64, 65, 9, 9, "mixed", 3, ()),
            ("D16387 ties", 256, 16387, 512, 5, "mixed", 8, (10, 458, 16386)),
            ("N133 k=N", 256, 4000, 133, 133, "mixed", 3, ()),
            ("ineligible", 128, 4000, 133, 7, "ineligible", 3, ()),
            ("invalid bank", 128, 4000, 133, 7, "invalid_bank", 3, ()),
            ("thresh +inf", 128, 4000, 133, 7, "thresh_inf", 3, ()),
            ("thresh -1", 128, 4000, 133, 7, "thresh_neg", 3, ()),
            ("L1", 128, 4000, 133, 7, "mixed", 1, ()),
            ("F5000", 5000, 2000, 64, 5, "mixed", 3, ())]
    for i, (label, F, D, N, k, case, L, ties) in enumerate(repo):
        nearest, votes = repo_case(F, D, N, k, device, SEED + 90 + i, case, L, ties)
        out.append((label, "repo_nearest", nearest))
        out.append((label, "repo_votes", votes))
    return out


def compare_recognition_cases(device) -> dict:
    """``recognition_edge_cases`` through K21 and K22 against their plain
    versions on the card, every output exactly; each call launched twice
    for the same bits; then the first case of each wrapper again, after a
    call at a larger N and F grew the scratch: the same bits as its first
    call."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    rows, first = {}, {}
    for label, w, args in recognition_edge_cases(device):
        got, again = getattr(kops, w)(*args), getattr(kops, w)(*args)
        ref = getattr(kops, f"{w}_plain")(*args)
        torch.cuda.synchronize()
        mism = sum(int((a != b).sum()) for a, b in zip(got, ref))
        same = same_bits(got, again)
        rows[f"{w} {label}"] = {"mismatches": mism, "rerun_bit_identical": same}
        check(mism == 0, f"{w} {label}: {mism} entries differ from the plain version")
        check(same, f"{w} {label}: a rerun gives other bits")
        first.setdefault(w, (args, got))
    # a larger N and F than any case's grows each entry's scratch
    nearest, votes = repo_case(6000, 8192, 4096, 5, device, SEED + 120)
    for w, args in (("feature_votes", feature_case(64, 32, 4096, 5, device, SEED + 121)),
                    ("repo_nearest", nearest), ("repo_votes", votes)):
        getattr(kops, w)(*args)
    for w, (args, got) in first.items():
        late = getattr(kops, w)(*args)
        torch.cuda.synchronize()
        rows[f"{w} first case after the larger ones"] = {"bit_identical": same_bits(got, late)}
        check(same_bits(got, late), f"{w}: a call after larger ones gives other bits")
    log("14a K21 K22 edge cases", cases=len(rows),
        mismatches=sum(r.get("mismatches", 0) for r in rows.values()))
    return rows


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
        if name in ("feature_votes", "repository"):
            # the bound with the pairs at the int8 tensor line and as
            # stated for the scalar popcount form; each entry's first call:
            # one device launch (whole profiles), its device ms queued back
            # to back, and a rerun's bits
            row["bound_ms_int8_line"] = bound_wrapper_calls(calls, wrappers,
                                                            TENSOR_INT_OPS_PER_S)["bound_ms"]
            row["bound_ms_scalar"] = scalar_pair_bound_ms(calls, wrappers)
            for w in wrappers:
                a0, kw0 = calls[w][0]
                fn = getattr(kops, w)
                per_call, row[f"{w}_launch_profiles"] = device_launch_count(
                    lambda: fn(*a0, **kw0), RECOGNITION_ENTRY_FUNCTIONS[w])
                row[f"{w}_device_launches_a_call"] = (
                    "not measured (no whole trace)" if per_call is None else per_call)
                row[f"{w}_queued_device_ms"] = queued_device_ms(lambda: fn(*a0, **kw0))
                row[f"{w}_rerun_bit_identical"] = same_bits(fn(*a0, **kw0), fn(*a0, **kw0))
                check(per_call == 1.0, f"{w} {label}: {row[f'{w}_device_launches_a_call']} "
                      "device launches a call")
                check(row[f"{w}_rerun_bit_identical"], f"{w} {label}: a rerun gives other bits")
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
        # K21 and K22 held exactly at every size, K24 at the first
        held = {}
        for w, args in (("feature_votes", fv), ("repo_nearest", nearest), ("repo_votes", votes),
                        ("bow_query", bq)):
            if w == "bow_query" and n != RECOGNITION_SIZES[0]:
                continue
            m, e = _recognition_mismatches(w, args, getattr(kops, w)(*args),
                                           getattr(kops, f"{w}_plain")(*args))
            held[w] = m
            check(m == 0 and e <= BOW_SCORE_ATOL, f"{phase}: {w} at {n} nodes: {m}, {e}")
        row = {
            "nodes": n,
            "gist": gist_query_cost(n, device),
            "feature_set": {"feature_votes_ms": time_call(lambda: kops.feature_votes(*fv), 7, 3),
                            "feature_votes_queued_device_ms":
                                queued_device_ms(lambda: kops.feature_votes(*fv), 5),
                            "bound_ms": bound("feature_votes", fv)["bound_ms"],
                            "mismatches": held["feature_votes"],
                            "bank_bytes": _nbytes(*fv[2:6]),
                            "reference_distance_bytes": 4 * 128 * n * 128},
            "repository": {"repo_votes_ms": time_call(lambda: kops.repo_votes(*votes), 7, 3),
                           "repo_nearest_ms": time_call(lambda: kops.repo_nearest(*nearest), 7, 3),
                           "repo_votes_queued_device_ms":
                               queued_device_ms(lambda: kops.repo_votes(*votes), 5),
                           "repo_nearest_queued_device_ms":
                               queued_device_ms(lambda: kops.repo_nearest(*nearest), 5),
                           "repo_votes_bound_ms": bound("repo_votes", votes)["bound_ms"],
                           "repo_nearest_bound_ms": bound("repo_nearest", nearest)["bound_ms"],
                           "mismatches": held["repo_nearest"] + held["repo_votes"],
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
    # the GIST query alone above the largest bank (and the 58,112 entries
    # that the kernel it replaced held in shared memory)
    rows.append({"nodes": 100_000, "gist": gist_query_cost(100_000, device)})
    log(phase, sizes=rows)
    return {"sizes": rows}


def gist_query_cost(n: int, device) -> dict:
    """K16's GIST query (k = 5, the step's) on ``gist_bank_inputs(n)``:
    CUDA-event ms a query, device ms a query over 10 profiled queries (None
    where the profile holds no device time) and queued back to back
    (``queued_device_ms``), the bank's bytes, and the result against the
    plain version entry for entry."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    args = gist_bank_inputs(n, device, SEED + 60 + n)
    got, ref = kops.gist_topk(*args), kops.gist_topk_plain(*args)
    torch.cuda.synchronize()
    mism = sum(int((a != b).sum()) for a, b in zip(got, ref))
    check(mism == 0, f"gist_topk at {n} nodes: {mism} entries differ from the plain version")
    _, dev_ms = device_profile(lambda: [kops.gist_topk(*args) for _ in range(10)])
    return {"gist_topk_ms": time_call(lambda: kops.gist_topk(*args), 7, 3),
            "gist_topk_device_ms": (sum(v for k, v in dev_ms.items() if "gist_topk_cluster" in k)
                                    / 10 if dev_ms else None),
            "gist_topk_queued_device_ms": queued_device_ms(lambda: kops.gist_topk(*args)),
            "bank_bytes": _nbytes(*args[1:4]), "mismatches": mism}


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
    1k, 10k and 50k nodes; (d) tests/test_pr_methods.py's run per method;
    K21's and K22's edge cases (``compare_recognition_cases``), and the
    step's calls again after the 50k banks.  Returns (main rows, large
    rows, fields)."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.kernels import ops as kops

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
    cases = compare_recognition_cases(device)
    cost = recognition_cost_phase("14b recognition cost 1k 10k 50k (GIST to 100k)", device)
    # after the 50k banks: the step's first K21 / K22 calls give the bits
    # they gave before (the scratch grown and left as it was found)
    for w in ("feature_votes", "repo_nearest", "repo_votes"):
        a0, kw0 = recorded[w][0]
        got, ref = getattr(kops, w)(*a0, **kw0), getattr(kops, f"{w}_plain")(*a0, **kw0)
        torch.cuda.synchronize()
        mism = sum(int((a != b).sum()) for a, b in zip(got, ref))
        cases[f"{w} VGA step after 50k"] = {"mismatches": mism}
        check(mism == 0, f"{w}: the step's call after the 50k banks: {mism} entries differ")
    pr_w, pr_frames = pr_world()
    pr_vocab = pr_vocabulary(pr_frames, device)
    proposals = {m: pr_run(m, pr_w, pr_frames, device, pr_vocab if m == "bow" else None)
                 for m in ("feature_set", "repository", "bow")}
    log("14d proposals 96x128", **proposals)
    return rows, rows_large, {"vocabulary": vocab_fields, "steps": steps, "cost": cost,
                              "proposals": proposals, "k21_k22_cases": cases}


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
    if wrapper == "pnp_ransac":
        m1, e1, d1 = _hypothesis_mismatch(args[:5], got[:2], ref[:2])
        m2, e2, d2 = _refine_mismatch(got[2:], ref[2:])
        return m1 + m2, max(e1, e2), {"hypotheses": d1, **d2}
    raise ValueError(f"_registration_mismatch: {wrapper}")


def _refine_mismatch(got, ref) -> tuple[int, float, dict]:
    """K28's consensus and polish (pose, consensus, mse, ok, best, counts)
    against the plain version's on the same hypotheses: the integers
    exactly, the pose and mse where the plain version's result is ok, the
    ones the step uses (see PNP_POSE_ATOL)."""
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


def _bits(t):
    """A tensor as its bits (float32 as int32, so that NaNs compare)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same_bits(a, b) -> bool:
    """Whether two results (tensors or tuples of them) hold the same bits."""
    a, b = (a if isinstance(a, tuple) else (a,)), (b if isinstance(b, tuple) else (b,))
    return len(a) == len(b) and all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a, b))


def _registration_reference(wrapper: str, args, kw, got):
    """What a K25-K28 call is held to: its plain version's result; for K28
    the draws and fits of ``pnp_hypotheses_plain`` and the consensus and
    polish of ``pnp_refine_plain`` on the kernel's own hypotheses (a
    borderline inlier would otherwise move a count with a rounding of the
    pose)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    if wrapper != "pnp_ransac":
        return getattr(kops, f"{wrapper}_plain")(*args, **kw)
    X, xn, valid, depth, keys, *rest = args
    return (*kops.pnp_hypotheses_plain(X, xn, valid, depth, keys),
            *kops.pnp_refine_plain(X, xn, valid, depth, got[0], got[1], *rest))


def pnp_phase_ms(calls, runs: int = 5) -> dict:
    """K28's device ms per phase over its calls, from the kernel's
    ``%globaltimer`` stamps (``kops.pnp_ransac(stamps=)``): the draws and
    fits (the first CTA's start to the last fit's end), the consensus (to
    the last vote), the polish and audit (to the end); medians of ``runs``
    launches, summed over the calls.  The phases overlap across warps, so
    a boundary is the last warp's."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    out = {"fits_ms": 0.0, "consensus_ms": 0.0, "polish_ms": 0.0, "total_ms": 0.0}
    for args, kw in calls:
        stamps = torch.empty(args[0].shape[0], 4, dtype=torch.int64, device=args[0].device)
        per = {k: [] for k in out}
        for _ in range(runs):
            kops.pnp_ransac(*args, **kw, stamps=stamps)
            t = stamps.cpu()
            start, fits = int(t[:, 0].min()), int(t[:, 1].max())
            cons, end = int(t[:, 2].max()), int(t[:, 3].max())
            for k, v in (("fits_ms", fits - start), ("consensus_ms", cons - fits),
                         ("polish_ms", end - cons), ("total_ms", end - start)):
                per[k].append(v / 1e6)
        for k in out:
            out[k] += statistics.median(per[k])
    return out


def compare_registration_kernels(calls: dict, label: str, trials: int = 5,
                                 calls_per: int = 2) -> dict:
    """K25-K28 against their plain versions on recorded or generated
    arguments ({wrapper: [(args, kwargs), ...]}), by
    ``_registration_mismatch``; K27 and K28 also launched a second time on
    the same arguments (the same bits); times over all the calls
    of a kernel's wrappers, the bound, and K28's phases
    (``pnp_phase_ms``).  No single PyTorch call computes any of these
    functions (library_ms None)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    rows = {}
    for name in REGISTRATION_KERNELS:
        wrappers = REGISTRATION_WRAPPERS[name]
        check(all(calls.get(w) for w in wrappers), f"{name} {label}: no call recorded")
        mism, err, details, reruns = 0, 0.0, {}, []
        for w in wrappers:
            for c, (args, kw) in enumerate(calls[w]):
                got = getattr(kops, w)(*args, **kw)
                ref = _registration_reference(w, args, kw, got)
                torch.cuda.synchronize()
                if w in ("gicp", "pnp_ransac"):
                    reruns.append(same_bits(got, getattr(kops, w)(*args, **kw)))
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
        if reruns:
            row["rerun_bit_identical"] = all(reruns)
        # K28's plain version takes ~1.5 s a call (tens of thousands of small
        # tensor operations): fewer trials of it
        few = name == "pnp"
        row["ms"], row["plain_ms"] = time_pair(lambda: run(False), lambda: run(True),
                                               trials=min(trials, 3) if few else trials,
                                               calls=1 if few else calls_per)
        row["library_ms"] = None
        row.update(bound_wrapper_calls(calls, wrappers))
        if name == "pnp":
            row["phases"] = pnp_phase_ms(calls["pnp_ransac"])
        log(f"15a kernel {name} {label}", **row)
        check(mism == 0, f"{name} {label}: {mism} entries differ from the plain version "
                         f"(max error {err})")
        check(row.get("rerun_bit_identical", True),
              f"{name} {label}: a second launch gave other bits")
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
    thresh2, f_mean2 = pnp.thresholds(525.0, 525.0, 3.0)
    calls["pnp_ransac"] = [((*args, keys, thresh2, f32(0.04), 10.0, 8, f_mean2), {})]
    return calls


def gicp_tie_calls(device) -> dict:
    """K27's adversarial arguments: 3 target clouds of N = 60 whose points
    j and j + 15 coincide in position and Lab, for j in 0..14 and 30..44
    (so every source point's distances tie in pairs), with orthogonal
    normals (so a pick of the higher index changes the row).  Twins 15
    apart lie in different lanes for every lane count of 4-32 (a lane scans
    every kLanes-th target), and at csrc/gicp.cu's 16 the higher index sits
    in the lower lane, so only the cross-lane key merge settles the tie.
    Cloud 1 has two valid targets with a NaN Lab, 10 and 21 (lanes 10 and
    5 at 16 lanes): argmin's minimum for every source point is the first
    of them.  Cloud 2 has no valid target.  128 source points near the
    targets; 1 and 20 iterations."""
    from uzliti_slam_tpu_torch.config import f32
    from uzliti_slam_tpu_torch.ops import lie

    g = torch.Generator().manual_seed(SEED + 40)
    B, N, M, U = 3, 60, 128, 30
    base = torch.rand(U, 3, generator=g) * 0.6
    lab = torch.rand(U, 3, generator=g) * 50
    n1 = torch.nn.functional.normalize(torch.randn(U, 3, generator=g), dim=-1)
    n2 = torch.nn.functional.normalize(
        torch.cross(n1, torch.randn(U, 3, generator=g), dim=-1), dim=-1)
    block = torch.arange(15)
    idx = torch.cat([block, block, block + 15, block + 15])           # target -> unique point
    twin = (torch.arange(N) // 15) % 2 == 1                            # the higher of two twins
    dst = base[idx].expand(B, N, 3).contiguous()
    dst_lab = lab[idx].expand(B, N, 3).contiguous()
    normals = torch.where(twin[:, None], n2[idx], n1[idx]).expand(B, N, 3).contiguous()
    dst_valid = torch.ones(B, N, dtype=torch.bool)
    dst_valid[2] = False
    dst_lab[1, 10, 1] = math.nan
    dst_lab[1, 21, 2] = math.nan
    pick = torch.randint(0, U, (M,), generator=g)
    src = base[pick] + 0.01 * torch.randn(M, 3, generator=g)
    src_lab = lab[pick] + torch.randn(M, 3, generator=g)
    src_valid = torch.rand(M, generator=g) > 0.1
    init = lie.se3_exp(0.01 * torch.randn(B, 6, generator=g))
    args = [t.to(device).contiguous() for t in (src, src_lab, src_valid, dst, dst_lab,
                                                dst_valid, normals, init)]
    return {"gicp": [((*args, iters, f32(0.2 ** 2), f32(0.002), f32(0.3), 1.0,
                       f32(math.pi / 6)), {}) for iters in (1, 20)]}


def compare_gicp_ties(device) -> dict:
    """15a: K27 on ``gicp_tie_calls``: each source point's first-iteration
    target (``kops.gicp(matches=)``) the plain version's
    (``gicp_first_matches_plain``: the lower of two tied targets, the first
    NaN Lab's target for every point of cloud 1, target 0 in cloud 2), exactly;
    cloud 0's pose within GICP_POSE_ATOL and its ok flag (clouds 1 and 2
    match every point to one target: their 6x6 systems are singular but for
    the 1e-6 ridge, and their poses are rounding amplified); and a second
    launch of each call (the same bits)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    mism, err, reruns = 0, 0.0, []
    for args, kw in gicp_tie_calls(device)["gicp"]:
        src, src_lab, src_valid, dst, dst_lab, dst_valid, normals, init, *_ = args
        matches = torch.empty(dst.shape[0], src.shape[0], dtype=torch.int32, device=device)
        got, ref = kops.gicp(*args, **kw, matches=matches), kops.gicp_plain(*args, **kw)
        reruns.append(same_bits(got, kops.gicp(*args, **kw)))
        want = kops.gicp_first_matches_plain(src, src_lab, dst, dst_lab, dst_valid, init,
                                             args[10])
        torch.cuda.synchronize()
        mism += int((matches != want).sum())
        e = _pose_err(got[0][:1], ref[0][:1])
        err = max(err, float(e.max()))
        mism += int((e > GICP_POSE_ATOL).sum()) + int(got[3][0] != ref[3][0])
    row = {"mismatches": mism, "max_abs_err": err, "rerun_bit_identical": all(reruns)}
    log("15a kernel gicp ties, NaN Lab, no valid target", **row)
    check(mism == 0, f"gicp tie cases: {mism} entries differ from the plain version ({err})")
    check(all(reruns), "gicp tie cases: a second launch gave other bits")
    return row


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
        # K28's draws, fits, consensus and polish in one launch; K27 one
        k = "pnp" if est == "pnp" else "gicp"
        check(one[k] == 1, f"15b {est}: {one[k]} {k} launches in a step (one expected)")
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
    rows["gicp"]["tie_cases"] = compare_gicp_ties(device)
    rows_large = compare_registration_kernels(registration_large_calls(world, frames, device),
                                              "large", trials=3, calls_per=1)
    runs = {m: estimation_run(m, device) for m in ("pnp", "gicp")}
    return rows, rows_large, {"steps": steps, "runs": runs}


# ---------------------------------------------------------------------------
# Phase 16: the float-descriptor path (K29, K30)
# ---------------------------------------------------------------------------

def compare_sift_kernels(calls: dict) -> dict:
    """K29 against its plain version on each level's recorded arguments,
    K30 on the match's; each timed on its main shapes (K29 level 0, K30 the
    300 x 300 match) beside its bound, and K30 beside the library's
    ``cdist`` squared + ``topk``."""
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.ops import features, matching

    rows, ang_err, desc_err, own_rows = {}, 0.0, 0.0, 0
    for (img, uv, window), _ in calls["sift_describe"]:
        ang, desc = kops.sift_describe(img, uv, window)
        ang_p = features.intensity_centroid_angles(img, uv)
        given = features.sift_descriptors(img, uv, ang, window=window)
        own = kops.sift_describe_plain(img, uv, window)[1]
        check(bool(torch.isfinite(desc).all()), "sift_describe: non-finite descriptor")
        ang_err = max(ang_err, float((ang - ang_p).abs().max()))
        desc_err = max(desc_err, float((desc - given).abs().max()))
        own_rows += int(((desc - own).abs().amax(-1) > SIFT_DESC_ATOL).sum())
    args = calls["sift_describe"][0][0]
    row = {"max_abs_err": desc_err, "angle_max_abs_err": ang_err, "angle_atol": ANGLE_ATOL,
           "desc_atol": SIFT_DESC_ATOL, "rows_apart_on_own_angles": own_rows,
           "levels": [list(a[0].shape) for a, _ in calls["sift_describe"][:SIFT_RUN["n_levels"]]],
           "library_ms": None}
    row["ms"], row["plain_ms"] = time_pair(lambda: kops.sift_describe(*args),
                                           lambda: kops.sift_describe_plain(*args))
    row["ms_all_levels"] = time_call(
        lambda: [kops.sift_describe(*a) for a, _ in calls["sift_describe"][:SIFT_RUN["n_levels"]]])
    row.update(bound("sift_describe", args))
    log("16 kernel sift_describe", **row)
    check(ang_err <= ANGLE_ATOL, f"sift_describe: angle err {ang_err:.3g}")
    check(desc_err <= SIFT_DESC_ATOL, f"sift_describe: descriptor err {desc_err:.3g}")
    rows["sift_describe"] = row

    (a, b, va, vb, ratio_sq, max_sq), _ = calls["l2_top2"][0]
    idx, ok, best = kops.l2_top2(a, b, va, vb, ratio_sq, max_sq)
    idx_p, ok_p, best_p = kops.l2_top2_plain(a, b, va, vb, ratio_sq, max_sq)
    d = torch.where(va[:, None] & vb[None], matching.l2_matrix(a, b), kops.MASKED)
    two = torch.sort(d, dim=1).values[:, :2]
    tie = (two[:, 1] - two[:, 0]) <= L2_NEAR_REL * two[:, 0].clamp(min=1e-30)
    edge = (best_p - ratio_sq * two[:, 1]).abs() <= L2_NEAR_REL * two[:, 1]
    err = float((best - best_p).abs().max())
    row = {"max_abs_err": err, "best_atol": L2_BEST_ATOL,
           "index_mismatches": int((idx != idx_p)[~tie].sum()), "near_ties": int(tie.sum()),
           "ok_mismatches": int((ok != ok_p)[~edge].sum()), "shape": [a.shape[0], b.shape[0],
                                                                       a.shape[1]]}
    row["ms"], row["plain_ms"] = time_pair(lambda: kops.l2_top2(a, b, va, vb, ratio_sq, max_sq),
                                           lambda: kops.l2_top2_plain(a, b, va, vb, ratio_sq,
                                                                      max_sq))

    def library():
        dist = torch.cdist(a, b) ** 2
        return torch.topk(dist, 2, dim=1, largest=False)
    row["library_ms"] = time_call(library)
    row.update(bound("l2_top2", (a, b, va, vb)))
    log("16 kernel l2_top2", **row)
    check(err <= L2_BEST_ATOL, f"l2_top2: best err {err:.3g}")
    check(row["index_mismatches"] == 0 and row["ok_mismatches"] == 0,
          f"l2_top2: {row['index_mismatches']} indices, {row['ok_mismatches']} flags differ")
    rows["l2_top2"] = row
    return rows


def sift_phase(frames, device) -> tuple[dict, dict, dict]:
    """Phase 16: ``detect_and_describe(descriptor="sift")`` on a VGA frame
    and on it shifted by 3 px, ``match_descriptors_l2`` between them, on the
    card: launches (counts set to 0 just before, read just after), the match
    held to tests/test_frontend.py's bars, the path timed sync-free; K29 and
    K30 against their plain versions.  Returns (launches, kernel rows,
    fields)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.ops import features, matching

    img = np.ascontiguousarray(frames[0]["image"])
    pair = [torch.from_numpy(x).to(device)
            for x in (img, np.ascontiguousarray(np.roll(img, SIFT_RUN["shift"], axis=1)))]

    def run():
        (k1, d1), (k2, d2) = (features.detect_and_describe(
            x, SIFT_RUN["max_keypoints"], n_levels=SIFT_RUN["n_levels"], descriptor="sift")
            for x in pair)
        mi, ok, best = matching.match_descriptors_l2(d1, d2, k1.valid, k2.valid,
                                                     ratio=SIFT_RUN["ratio"])
        return k1, k2, d1, mi, ok

    run()                                   # warm-up: the window on the card
    torch.cuda.synchronize()
    kops.reset_launches()
    out = []
    calls = record_args(lambda: out.append(run()), names=SIFT_KERNELS + ("fast_nms",))
    counts = dict(kops.launches)
    k1, k2, d1, mi, ok = out[0]
    n_ok = int(ok.sum())
    du = k2.uv[mi.long()][:, 0] - k1.uv[:, 0]
    med = float(torch.median(du[ok])) if n_ok else math.nan
    t, _ = timed_sync_free(run, reps=10)
    norms = torch.linalg.vector_norm(d1[k1.valid], dim=-1)
    prof, device_ms = device_profile(run)
    fields = {"frame": list(img.shape), "keypoints": [int(k1.valid.sum()), int(k2.valid.sum())],
              "descriptor_shape": list(d1.shape), "matches": n_ok, "median_shift_px": med,
              "launches": counts, "path_ms": 1e3 * t, "sync_free": True,
              "max_norm_err": float((norms - 1).abs().max()), **prof,
              "kernel_device_ms": kernel_device_ms(device_ms, SIFT_KERNELS)}
    log("16 sift + L2 VGA", **fields)
    check(counts["sift_describe"] == 2 * SIFT_RUN["n_levels"] and counts["l2_top2"] == 1
          and counts["fast_nms"] == 2, f"16: launches {counts}")
    fields["fast_nms_pair"] = compare_fast_nms_cases(
        {f"frame_{i}": args[0] for i, (args, _) in enumerate(calls["fast_nms"])}, "SIFT pair")
    check(n_ok >= SIFT_RUN["min_matches"], f"16: {n_ok} matches")
    check(abs(med - SIFT_RUN["shift"]) < SIFT_RUN["shift_tol"], f"16: median shift {med}")
    check(fields["max_norm_err"] < 1e-3, "16: descriptors not unit")
    return counts, compare_sift_kernels(calls), fields


# ---------------------------------------------------------------------------
# Phase 17: the fleet (optimize_batch; K1, K2, K8 and the batched entries)
# ---------------------------------------------------------------------------

def fleet_kernel_inputs(fleet, cfg):
    """The fleet's first-iteration inputs of each batched entry."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops

    B, n = fleet.pose.shape[:2]
    g = solver._flatten_fleet(fleet)
    labels = solver.connected_components(g, solver.component_iterations(n))
    free = (g.node_valid & ~solver.gauge_fix_mask(g, labels)).float()
    p = solver._Problem(g, free, cfg, batch=B)
    r0, chi2_0 = p.residuals(g.pose)
    Ji, Jj, W, grad, Hb, U = p.linearize(r0)
    damp = p.damp(torch.full((B,), cfg.lambda_init, device=g.device), Hb)
    Dm = torch.where(free[:, None, None] > 0, Hb + torch.diag_embed(damp), p.eye6)
    pack = p.build_pack(Hb, U, damp)
    dx = solver._pcg(lambda u: kops.hvp(Ji, Jj, W, g.e_from, g.e_to, u, damp, free), pack,
                     -grad, cfg.pcg_iterations, cfg.pcg_tol, B)
    return {"residual_chi2": (g.pose, g.e_from, g.e_to, g.e_transform, g.e_info, p.valid,
                              cfg.huber_delta, B),
            "lm_candidate": (g.pose, dx, free, g.e_from, g.e_to, g.e_transform, g.e_info,
                             p.valid, cfg.huber_delta),
            "lm_state": (g.pose, r0, chi2_0, cfg.iterations, cfg.lambda_init),
            "lm_rules": p.rules(cfg.early_exit), "batch": B,
            "chain_factor": (Dm, U, cfg.chain_dense_cutoff, B),
            "hvp": (Ji, Jj, W, g.e_from, g.e_to, damp, free), "b": -grad,
            "linearize": (r0, p.adj_meas_inv, g.e_info, p.valid, g.e_from, g.e_to, free,
                          p.both_free, p.is_chain, cfg.huber_delta),
            "table": p.table,
            "components": (g.e_from, g.e_to, g.e_valid, g.node_valid, g.node_fixed, g.stamp,
                           B * n, solver.component_iterations(n))}


def _rel(got, ref) -> tuple[float, float]:
    e = float((got - ref).abs().max())
    return e, e / max(float(ref.abs().max()), 1e-30)


def _factor_to(factor, dtype):
    levels, root_inv, n = factor
    return (tuple(tuple(t.to(dtype) for t in lv) for lv in levels), root_inv.to(dtype), n)


def compare_pcg_fleet_solve(pack, op, b, steps: int, tol: float) -> dict:
    """K38 against its plain version on the fleet's first iteration: after
    the start and 1-3 steps x, r, p and scal within KERNEL_TOL of each
    vector's largest magnitude over the solve; after the fleet's ``steps``
    within the plain version's own float32 error (against the same plain
    solve in float64 on the same inputs) plus KERNEL_TOL of max|x| (float32
    PCG on 64-node instances amplifies summation order past ~3 steps); the
    same stall flags after every step count; bit-identical over two launches.
    Timed in turns against the K2 + K10 + K3 solve it replaces, its device
    ms over 5 profiled launches and queued behind a sleep kernel, the plain
    version, and its bound."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    B = pack[1].shape[0]
    start = kops.pcg_fleet_solve_plain(pack, op, b, 0, tol)
    early = []
    for k in (0, 1, 2, 3):
        got, ref = kops.pcg_fleet_solve(pack, op, b, k, tol), kops.pcg_fleet_solve_plain(
            pack, op, b, k, tol)
        early.append(max(_state_rel(got, ref, _state_scale(start, ref))))
    oks_k = torch.stack([kops.pcg_fleet_solve(pack, op, b, k, tol).scal[:, 2]
                         for k in range(1, steps + 1)])
    oks_p = torch.stack([kops.pcg_fleet_solve_plain(pack, op, b, k, tol).scal[:, 2]
                         for k in range(1, steps + 1)])
    st, st2 = kops.pcg_fleet_solve(pack, op, b, steps, tol), kops.pcg_fleet_solve(
        pack, op, b, steps, tol)
    sp = kops.pcg_fleet_solve_plain(pack, op, b, steps, tol)
    d = torch.float64
    op64 = op._replace(Ji=op.Ji.to(d), Jj=op.Jj.to(d), W=op.W.to(d), damp=op.damp.to(d),
                       free=op.free.to(d))
    s64 = kops.pcg_fleet_solve_plain(_factor_to(pack, d), op64, b.to(d), steps, tol)
    torch.cuda.synchronize()
    scale = float(s64.x.abs().max())
    own = float((sp.x.double() - s64.x).abs().max()) / scale
    err = float((st.x.double() - s64.x).abs().max()) / scale
    per = ((st.x - sp.x).view(B, -1).abs().amax(1)
           / sp.x.view(B, -1).abs().amax(1).clamp(min=1e-30))
    row = {"max_abs_err": float((st.x - sp.x).abs().max()),
           "max_rel_err": float((st.x - sp.x).abs().max()) / scale,
           "rel_err_steps_0_1_2_3": early, "rel_err_vs_float64": err,
           "plain_rel_err_vs_float64": own, "tol_rel": KERNEL_TOL["pcg_fleet_solve"],
           "instance_rel_err_median": float(per.median()), "instance_rel_err_max": float(per.max()),
           "same_ok": bool(torch.equal(oks_k, oks_p)),
           "rerun_bit_identical": all(torch.equal(a, c) for a, c in zip(st[:4], st2[:4])),
           "steps": steps, "smem_bytes_per_cta": kops.pcg_fleet_smem(
               len(pack[0]), pack[1].shape[-1] // 6, b.shape[0] // B, op.e_from.shape[0] // B),
           "library_ms": None}

    def replaced():
        s_ = kops.pcg_chain_start(pack, b, B)
        for _ in range(steps):
            kops.pcg_chain_step(pack, kops.hvp(*op[:5], s_.p, op.damp, op.free), s_, tol)

    row["ms"], row["replaced_ms"] = time_pair(
        lambda: kops.pcg_fleet_solve(pack, op, b, steps, tol), replaced, trials=7, calls=3)
    row["device_ms"] = device_ms_of(
        lambda: [kops.pcg_fleet_solve(pack, op, b, steps, tol) for _ in range(5)], 5,
        "pcg_fleet_kernel")
    row["device_ms_queued"] = queued_device_ms(
        lambda: kops.pcg_fleet_solve(pack, op, b, steps, tol), calls=10)
    row["replaced_device_ms"] = device_ms_of(replaced, 1, "")
    row["plain_ms"] = time_call(lambda: kops.pcg_fleet_solve_plain(pack, op, b, steps, tol),
                                trials=3, calls=1)
    row.update(bound("pcg_fleet_solve", (pack, op, b, steps)))
    log("17 kernel pcg_fleet_solve", **row)
    check(bool(torch.isfinite(st.x).all()), "pcg_fleet_solve: non-finite x")
    check(max(early) <= KERNEL_TOL["pcg_fleet_solve"],
          f"pcg_fleet_solve: rel err {max(early):.3g} after the start and 1-3 steps")
    check(err <= own + KERNEL_TOL["pcg_fleet_solve"],
          f"pcg_fleet_solve: {err:.3g} from the float64 solve, the plain version {own:.3g}")
    check(row["same_ok"], "pcg_fleet_solve: stall flags differ")
    check(row["rerun_bit_identical"], "pcg_fleet_solve: a rerun gives other bits")
    return row


def compare_split_pcg(inputs: dict, fac, steps: int, tol: float, phase: str) -> dict:
    """K2, K3 and K10 (the fleet's PCG above K38's cap) against their plain
    versions on a fleet's first iteration (``fleet_kernel_inputs``, its
    factor ``fac``), timed beside their bounds: rows "hvp_fleet",
    "chain_apply_batch", "pcg_batch"."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    rows = {}
    Ji, Jj, W, ef, et, damp, free = inputs["hvp"]
    B = inputs["batch"]
    args = (Ji, Jj, W, ef, et, inputs["b"], damp, free)
    e, r = _rel(kops.hvp(*args), kops.hvp_plain(*args))
    row = {"max_abs_err": e, "max_rel_err": r, "tol_rel": KERNEL_TOL["hvp"], "library_ms": None}
    row["ms"], row["plain_ms"] = time_pair(lambda: kops.hvp(*args), lambda: kops.hvp_plain(*args))
    row.update(bound("hvp", args))
    rows["hvp_fleet"] = row

    b = inputs["b"]
    got, ref = kops.chain_apply(fac, b), kops.chain_apply_plain(fac, b)
    e, r = _rel(got, ref)
    row = {"max_abs_err": e, "max_rel_err": r, "tol_rel": KERNEL_TOL["chain_apply"],
           "library_ms": None}
    row["ms"], row["plain_ms"] = time_pair(lambda: kops.chain_apply(fac, b),
                                           lambda: kops.chain_apply_plain(fac, b))
    row.update(bound("chain_apply", (fac, b)))
    rows["chain_apply_batch"] = row

    # K10: each launch against its plain version on the same inputs (a full
    # 8-step solve of 4096 instances is reported, not held: float32 PCG
    # amplifies the dots' summation order), then the updates timed
    z = kops.chain_apply(fac, b)
    k_state = kops.pcg_init(b, z, B)
    p_state = kops.pcg_init_plain(b, z, B)
    errs = [_rel(a, c)[1] for a, c in zip(k_state[:3], p_state[:3])]
    errs.append(_rel(k_state[3][:, :3], p_state[3])[1])
    Hp = kops.hvp(Ji, Jj, W, ef, et, k_state[2], damp, free)
    k_copy = [t.clone() for t in k_state]
    p_copy = [t.clone() for t in k_copy[:3]] + [k_copy[3][:, :3].clone()]
    kops.pcg_alpha(k_copy[2], Hp, k_copy[0], k_copy[1], k_copy[3], 1e-8)
    kops.pcg_alpha_plain(p_copy[2], Hp, p_copy[0], p_copy[1], p_copy[3], 1e-8)
    errs += [_rel(k_copy[0], p_copy[0])[1], _rel(k_copy[1], p_copy[1])[1]]
    same_ok = bool(torch.equal(k_copy[3][:, 2], p_copy[3][:, 2]))
    z2 = kops.chain_apply(fac, k_copy[1])
    p_copy = [t.clone() for t in k_copy[:3]] + [k_copy[3][:, :3].clone()]
    kops.pcg_beta(k_copy[1], z2, k_copy[2], k_copy[3])
    kops.pcg_beta_plain(p_copy[1], z2, p_copy[2], p_copy[3])
    errs += [_rel(k_copy[2], p_copy[2])[1], _rel(k_copy[3][:, 0], p_copy[3][:, 0])[1]]

    def solve(init, alpha, beta):
        x, r, p, scal = init(b, z, B)
        for _ in range(steps):
            alpha(p, kops.hvp(Ji, Jj, W, ef, et, p, damp, free), x, r, scal, tol)
            beta(r, kops.chain_apply(fac, r), p, scal)
        return x
    xs = solve(kops.pcg_init, kops.pcg_alpha, kops.pcg_beta)
    xp = solve(kops.pcg_init_plain, kops.pcg_alpha_plain, kops.pcg_beta_plain)
    per = ((xs - xp).view(B, -1).abs().amax(1) / xp.view(B, -1).abs().amax(1).clamp(min=1e-30))

    def updates(init, alpha, beta):
        x, r, p, scal = init(b, z, B)
        for _ in range(steps):
            alpha(p, Hp, x, r, scal, tol)
            beta(r, z, p, scal)

    row = {"max_abs_err": float((k_copy[2] - p_copy[2]).abs().max()),
           "max_rel_err": max(errs), "tol_rel": KERNEL_TOL["pcg"], "same_ok": same_ok,
           "solve_rel_err_median": float(per.median()), "solve_rel_err_max": float(per.max()),
           "steps": steps, "library_ms": None}
    row["ms"], row["plain_ms"] = time_pair(
        lambda: updates(kops.pcg_init, kops.pcg_alpha, kops.pcg_beta),
        lambda: updates(kops.pcg_init_plain, kops.pcg_alpha_plain, kops.pcg_beta_plain))
    row.update(bound("pcg", (b, steps)))
    rows["pcg_batch"] = row
    for name, row in rows.items():
        log(f"{phase} kernel {name}", **row)
        check(row["max_rel_err"] <= row["tol_rel"],
              f"{phase} {name}: rel err {row['max_rel_err']:.3g} > {row['tol_rel']}")
    check(same_ok, f"{phase} pcg_batch: stall flags differ on the same inputs")
    return rows


def compare_fleet_kernels(inputs: dict, steps: int, tol: float) -> dict:
    """Each batched entry against its plain version on the card, on the
    fleet's first iteration, timed beside its bound."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    # K1 and K2 as they run on the flattened fleet: 1e-3 and 1e-4 of each
    # output's largest entry (KERNEL_TOL), K1 also against the atomic kernel
    # it replaced (phase 3's checks, on the fleet's inputs); K8 exactly
    rows = {"linearize_fleet": compare_linearize(inputs["linearize"], inputs["table"], "fleet")}
    Ji, Jj, W, ef, et, damp, free = inputs["hvp"]
    row = compare_epoch_kernels({"components": inputs["components"]}, "fleet")["components"]
    row.update(max_rel_err=0.0, tol_rel=0.0, library_ms=None)
    rows["components_fleet"] = row
    args = inputs["residual_chi2"]
    got, ref = kops.residual_chi2(*args), kops.residual_chi2_plain(*args)
    e1, r1 = _rel(got[0], ref[0])
    e2, r2 = _rel(got[1], ref[1])
    row = {"max_abs_err": max(e1, e2), "max_rel_err": max(r1, r2),
           "tol_rel": KERNEL_TOL["residual_chi2"], "library_ms": None}
    row["ms"], row["plain_ms"] = time_pair(lambda: kops.residual_chi2(*args),
                                           lambda: kops.residual_chi2_plain(*args))
    row.update(bound("residual_chi2", args))
    rows["residual_chi2_batch"] = row

    D, U, cutoff, B = args = inputs["chain_factor"]
    fac, fac_p = kops.chain_factor(*args), kops.chain_factor_plain(*args)
    err = rel = 0.0
    for a, b in zip(_flat_factor(fac), _flat_factor(fac_p)):
        e, r = _rel(a, b)
        err, rel = max(err, e), max(rel, r)
    rhs = torch.randn(D.shape[0], 6, generator=torch.Generator().manual_seed(SEED + 3)).to(D.device)
    x_k, x_p = kops.chain_apply(fac, rhs), kops.chain_apply(fac_p, rhs)
    apply_rel = float((x_k - x_p).abs().max() / x_p.abs().max())
    row = {"max_abs_err": err, "max_rel_err": rel, "tol_rel": KERNEL_TOL["chain_factor"],
           "apply_rel_err": apply_rel, "apply_rtol": CHAIN_APPLY_RTOL,
           "levels": len(fac[0]), "root_blocks": fac[1].shape[1] // 6}
    row["ms"], row["plain_ms"] = time_pair(lambda: kops.chain_factor(*args),
                                           lambda: kops.chain_factor_plain(*args),
                                           trials=7, calls=2)
    # the library yardstick: torch.linalg.inv_ex of the fleet's roots
    _, Dk, Uk = kops.chain_reduce_plain(D.view(B, -1, 6, 6), U.view(B, -1, 6, 6), cutoff)
    A = kops.root_matrix_plain(Dk, Uk)
    row["library_ms"] = time_call(lambda: torch.linalg.inv_ex(A), trials=7, calls=2)
    row.update(factor_split(args))
    row.update(bound("chain_factor", args))
    rows["chain_factor_batch"] = row
    rows.update({f"{k}_batch": v for k, v in
                 compare_lm_step(inputs, "fleet", batch=inputs["batch"]).items()})

    b = inputs["b"]
    rows.update(compare_split_pcg(inputs, fac, steps, tol, "17"))
    op = kops.HvpOperator(Ji, Jj, W, ef, et, damp, free, inputs["table"])
    rows["pcg_fleet_solve"] = compare_pcg_fleet_solve(fac, op, b, steps, tol)
    for name, row in rows.items():
        if name in ("pcg_fleet_solve", "hvp_fleet", "chain_apply_batch", "pcg_batch"):
            continue
        log(f"17 kernel {name}", **row)
        check(row["max_rel_err"] <= row["tol_rel"],
              f"{name}: rel err {row['max_rel_err']:.3g} > {row['tol_rel']}")
    check(rows["chain_factor_batch"]["apply_rel_err"] <= CHAIN_APPLY_RTOL,
          "chain_factor_batch: apply rel err")
    return rows


def fleet_above_cap_phase(device) -> tuple[dict, dict]:
    """Phase 17c: ``optimize_batch`` on FLEET_ABOVE_CAP (16 instances of 512
    nodes: 5 levels at cutoff 16, above K38's cap) at the rung's
    configuration, the counts set to 0 just before one solve and read just
    after: its PCG through K2, K10 and K3 (160 / 340 / 180 launches, no
    K38), χ² below χ²₀, sync-free and timed; K2, K3 and K10 against their
    plain versions on its first iteration.  Returns (fields, launches, kernel
    rows)."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.io import synthetic
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.parallel import sharded

    B, n = FLEET_ABOVE_CAP["batch"], FLEET_ABOVE_CAP["n_nodes"]
    fleet, _ = synthetic.make_pose_graph_batch(
        B, n, loop_closure_every=FLEET_ABOVE_CAP["loop_closure_every"],
        generator=torch.Generator().manual_seed(SEED + 17), capacity_rounding="pow2",
        device=device)
    cfg = solver.SolverConfig(**FLEET_CONFIG)
    sharded.optimize_batch(fleet, cfg)
    torch.cuda.synchronize()
    kops.reset_launches()
    _, st = solver.optimize_batched(fleet, sharded.fleet_config(cfg))
    counts = dict(kops.launches)
    t, _ = timed_solves(sharded.optimize_batch, fleet, cfg, reps=3)
    hist = st.chi2_history
    fields = {"instances": B, "node_slots": n, "edge_slots": fleet.edge_capacity,
              "solve_ms": 1e3 * t, "launches": {k: v for k, v in counts.items() if v},
              "mean_chi2_0": float(hist[:, 0].mean()), "mean_chi2": float(hist[:, -1].mean())}
    log("17c fleet above K38's cap", **fields)
    check(bool((hist[:, -1] < hist[:, 0]).all()), "17c: an instance did not lower its χ²")
    check_pcg_route("17c", counts, n, cfg, batch=B, edges=fleet.edge_capacity)
    check(counts["hvp"] == cfg.iterations * cfg.pcg_iterations
          and counts["pcg"] == cfg.iterations * (1 + 2 * cfg.pcg_iterations)
          and counts["chain_apply"] == cfg.iterations * (1 + cfg.pcg_iterations),
          f"17c: K2 / K10 / K3 launches {[counts[k] for k in FLEET_SPLIT]}")
    fcfg = sharded.fleet_config(cfg)
    inputs = fleet_kernel_inputs(fleet, fcfg)
    rows = compare_split_pcg(inputs, kops.chain_factor(*inputs["chain_factor"]),
                             fcfg.pcg_iterations, fcfg.pcg_tol, "17c")
    return fields, counts, rows


def fleet_phase(device) -> tuple[dict, dict, dict, dict]:
    """Phase 17: ``optimize_batch`` on the 4096 x 64-node fleet at the
    rung's configuration (counts set to 0 just before one solve, read just
    after; the same counts on an 8-instance fleet), timed sync-free, its
    χ² against the oracle on 16 instances, 8 instances against single
    solves on CPU tensors, two solves bit for bit, the batched entries and
    K38 against their plain versions, the default (early-exit) configuration
    once, and (17c) a fleet above K38's cap, whose PCG takes K2, K10 and K3.
    Returns (launches, kernel rows, fields)."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.graph import state as gstate
    from uzliti_slam_tpu_torch.io import synthetic
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.parallel import sharded

    B, n = FLEET["batch"], FLEET["n_nodes"]
    t0 = time.perf_counter()
    fleet, _ = synthetic.make_pose_graph_batch(
        B, n, loop_closure_every=FLEET["loop_closure_every"],
        generator=torch.Generator().manual_seed(SEED), capacity_rounding="pow2", device=device)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    cfg = solver.SolverConfig(**FLEET_CONFIG)
    sharded.optimize_batch(fleet, cfg)                 # warm-up at this size
    torch.cuda.synchronize()
    kops.reset_launches()
    timed_solves(sharded.optimize_batch, fleet, cfg, reps=1)
    counts = dict(kops.launches)
    small = gstate.stack_graphs([gstate.graph_of(fleet, b) for b in range(8)])
    kops.reset_launches()
    sharded.optimize_batch(small, cfg)
    counts_small = dict(kops.launches)
    t, out = timed_solves(sharded.optimize_batch, fleet, cfg, reps=3)
    _, st = solver.optimize_batched(fleet, sharded.fleet_config(cfg))
    chi2_0, chi2 = st.chi2_history[:, 0], st.chi2_history[:, -1]
    prof, names = device_profile(lambda: sharded.optimize_batch(fleet, cfg))
    # the port's sparse oracle on 16 instances
    sample = list(range(0, B, B // FLEET_ORACLE_SAMPLES))
    ratios = [float(chi2[b]) / oracle_chi2(gstate.graph_of(fleet, b), iters=20, lm=True)
              for b in sample]
    # 8 instances: the fleet and a loop of single solves, on CPU tensors
    cpu = gstate.stack_graphs([gstate.graph_of(fleet, b).to("cpu")
                               for b in range(FLEET_CPU_INSTANCES)])
    fcfg = sharded.fleet_config(cfg)
    cpu_out, cpu_st = solver.optimize_batched(cpu, fcfg)
    pose_gap, chi2_excess = 0.0, 0.0
    for i in range(FLEET_CPU_INSTANCES):
        one, st1 = solver.optimize(gstate.graph_of(cpu, i), fcfg)
        pose_gap = max(pose_gap, float((one.pose - cpu_out.pose[i]).abs().max()))
        h0, h1 = float(st1.chi2_history[0]), float(st1.chi2_history[-1])
        chi2_excess = max(chi2_excess, abs(float(cpu_st.chi2_history[i, -1]) - h1)
                          / (CHI2_RTOL * h1 + 1e-6 * h0))
    card_vs_cpu = max(abs(float(chi2[i]) - float(cpu_st.chi2_history[i, -1]))
                      / (CHI2_RTOL * float(cpu_st.chi2_history[i, -1]) + 1e-6 * float(chi2_0[i]))
                      for i in range(FLEET_CPU_INSTANCES))
    fields = {"instances": B, "node_slots": n, "edge_slots": fleet.edge_capacity,
              "edges_per_instance": int(fleet.num_edges[0]), "generate_s": gen_s,
              "solve_ms": 1e3 * t, "instance_solves_per_s": B / t, "sync_free": True,
              "launches": counts, "launches_8_instances": counts_small,
              "mean_chi2_0": float(chi2_0.mean()), "mean_chi2": float(chi2.mean()),
              "accepted_mean": float(st.accepted.float().sum(1).mean()),
              "oracle_instances": sample, "chi2_ratio_vs_oracle_mean": statistics.mean(ratios),
              "chi2_ratio_vs_oracle_max": max(ratios), "chi2_ratio_vs_oracle_min": min(ratios),
              "cpu_singles_pose_gap": pose_gap, "cpu_singles_chi2_excess": chi2_excess,
              "card_vs_cpu_fleet_chi2_excess": card_vs_cpu,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, **prof}
    log("17 fleet 4096x64 rung", **fields)
    check(counts == counts_small, f"17: launches grow with B: {counts} vs {counts_small}")
    for name in FLEET_PATH:
        check(counts[name] > 0, f"17: {name} not launched")
    check_pcg_route("17", counts, n, cfg, batch=B, edges=fleet.edge_capacity)
    check(counts["pcg_fleet_solve"] == cfg.iterations and not any(counts[k] for k in FLEET_SPLIT),
          f"17: K38 {counts['pcg_fleet_solve']} launches, K2 / K3 / K10 "
          f"{[counts[k] for k in FLEET_SPLIT]}")
    fields["bits"] = solve_bits(lambda: sharded.optimize_batch(fleet, cfg),
                                lambda: fleet_calls(fleet, fcfg), "17 fleet")
    check(bool(torch.isfinite(out.pose).all()) and bool((chi2 < chi2_0).all()),
          "17: a fleet instance did not lower its χ²")
    check(not library_items(names), "17: library kernels in the profile")
    check(chi2_excess <= 1.0 and pose_gap <= FLEET_POSE_ATOL,
          f"17: CPU fleet vs single solves: χ² {chi2_excess:.3g}x tol, poses {pose_gap:.3g}")
    check(card_vs_cpu <= 1.0, f"17: card fleet vs CPU fleet χ² {card_vs_cpu:.3g}x tol")
    rows = compare_fleet_kernels(fleet_kernel_inputs(fleet, fcfg), fcfg.pcg_iterations,
                                 fcfg.pcg_tol)

    # the default configuration (early exit, 12 PCG steps, cutoff 16)
    dcfg = sharded.fleet_config(solver.SolverConfig())
    builds = kops.factor_builds(device)
    builds.zero_()
    kops.reset_launches()
    _, st_d = solver.optimize_batched(fleet, dcfg)
    counts_d, built = dict(kops.launches), int(builds)
    hist, acc = st_d.chi2_history.cpu().tolist(), st_d.accepted.cpu().tolist()
    ref_builds = sum(reference_refreshes(hist[b], acc[b], dcfg) for b in range(B))
    t_d, _ = timed_solves(sharded.optimize_batch, fleet, solver.SolverConfig(), reps=3)
    prof_d, _ = device_profile(lambda: sharded.optimize_batch(fleet, solver.SolverConfig()))
    fields_d = {"solve_ms": 1e3 * t_d, "instance_solves_per_s": B / t_d,
                "mean_chi2": float(st_d.chi2_history[:, -1].mean()), "launches": counts_d,
                "factors_built": built, "reference_refreshes": ref_builds, **prof_d}
    log("17 fleet 4096x64 default config", **fields_d)
    check(built == ref_builds, f"17: {built} factors built, the reference builds {ref_builds}")
    check_pcg_route("17 default", counts_d, n, dcfg, batch=B, edges=fleet.edge_capacity)
    check(bool((st_d.chi2_history[:, -1] < st_d.chi2_history[:, 0]).all()),
          "17 default: a fleet instance did not lower its χ²")
    fields["default_config"] = fields_d
    del fleet
    fields["above_cap"], counts_above, rows["above_cap"] = fleet_above_cap_phase(device)
    return counts, counts_above, rows, fields


# ---------------------------------------------------------------------------
# The generic loop, the edge-sharded solve and the planar solve (phase 18)
# ---------------------------------------------------------------------------

def world_of_one(dev) -> None:
    """A one-rank NCCL world in this process: an in-process ``HashStore``
    and the card as its device (its communicator is made here, not inside
    a timed solve); the bootstrap on the loopback interface."""
    import os

    import torch.distributed as dist

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1, device_id=dev)


def sharded_bound(rows: dict, counts: dict, cfg) -> float:
    """B19's least time per solve: each launch of K1, K2, K4, K3, K9, K34,
    K37, K36 at its bound on these shapes (at world size 1 the shard is the
    whole table), plus, where K10 runs, one 12-step K10 bound per LM
    iteration; the collective moves no bytes in a world of one."""
    per_call = ("linearize", "hvp", "residual_chi2", "chain_apply", "chain_factor", "pcg_chain",
                "pcg_grid", "lm_candidate", "lm_accept")
    return (sum(rows[k]["bound_ms"] * counts[k] for k in per_call if counts[k])
            + (rows["pcg"]["bound_ms"] * cfg.iterations if counts["pcg"] else 0.0))


def sharded_world_phase(g1k, g100k, chi2_oracle_1k: float, spread_1k: float, chi2_100k: float,
                        rows: dict, rows_large: dict) -> tuple[dict, dict]:
    """Phase 18 (a)-(c), in a one-rank NCCL world: (a) the 1k graph sharded
    against ``optimize(mode="pcg")``, (b) the generic loop against the
    fast fixed form, (c) the 100k graph sharded.  Returns (the launches of
    one sharded 1k solve, fields)."""
    import torch.distributed as dist

    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.parallel import sharded

    def sharded_fn(g, c):
        return sharded.optimize_sharded(g, config=c)

    cfg, fast = solver.SolverConfig(**SHARDED_CONFIG), solver.SolverConfig(**HEADLINE)
    for _ in range(2):                        # warm-up: the communicator, the caches
        solver.optimize(g1k, fast)
        solver.optimize(g1k, cfg)
        sharded_fn(g1k, cfg)
    torch.cuda.synchronize()
    kops.reset_launches()
    sharded.reset_collectives()
    timed_solves(sharded_fn, g1k, cfg, reps=1)
    counts, collectives = dict(kops.launches), sharded.collectives["all_reduce"]
    expected = sharded.collectives_per_solve(cfg)
    refresh = min(cfg.precond_refresh, cfg.iterations)
    formula = 1 + -(-cfg.iterations // refresh) + cfg.iterations * (1 + cfg.pcg_iterations + 1)
    # (a), (b): the three forms in alternating turns, each solve sync-free
    forms = [("fast", solver.optimize, fast), ("generic", solver.optimize, cfg),
             ("sharded", sharded_fn, cfg)]
    samples, hists = {k: [] for k, _, _ in forms}, {}
    for i in range(SHARDED_REPS):
        for name, fn, c in (forms if i % 2 == 0 else forms[::-1]):
            t, (_, stats) = timed_solves(fn, g1k, c, reps=1)
            hists[name] = (stats if name == "sharded" else stats.chi2_history).cpu()
            samples[name].append((t, float(hists[name][-1])))
    ms = {k: 1e3 * statistics.median(t for t, _ in v) for k, v in samples.items()}
    chi2 = {k: statistics.median(c for _, c in v) for k, v in samples.items()}
    spread = {k: max(c for _, c in v) - min(c for _, c in v) for k, v in samples.items()}
    chi2_0 = float(hists["sharded"][0])
    # the collective alone: as many in-place all-reduces of K1's packed
    # rows as a solve makes, host clock between two synchronisations
    buf = torch.zeros(78 * g1k.node_capacity, device=g1k.device)
    dist.all_reduce(buf)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(expected):
        dist.all_reduce(buf)
    torch.cuda.synchronize()
    all_reduce_us = 1e6 * (time.perf_counter() - t0) / expected
    prof, names = device_profile(lambda: sharded_fn(g1k, cfg))
    # the device-to-device copies an incidence table build makes (inside
    # torch.sort): 10 builds between two of the same solves, less those two
    # (a profile can miss its first records, so nothing is counted alone at
    # either end); the profiled solve builds one table
    builds_prof = device_profile(lambda: (sharded_fn(g1k, cfg), [kops.incidence_table(
        g1k.e_from, g1k.e_to, g1k.e_valid, g1k.node_capacity) for _ in range(10)],
        sharded_fn(g1k, cfg)))[0]
    copies_per_build = (builds_prof.get("memcpy_dtod", 0) - 2 * prof.get("memcpy_dtod", 0)) / 10
    non_port = {k[:90]: ms_ for k, ms_ in sorted(names.items(), key=lambda kv: -kv[1])
                if not any(f in k for f in DEVICE_FUNCTIONS)}
    generic_vs_fast = float(((hists["generic"] - hists["fast"]).abs()
                             / hists["fast"].abs()).max())
    bound_1k = sharded_bound(rows, counts, cfg)
    fields = {"world_size": 1, "backend": "nccl", "config": SHARDED_CONFIG,
              "solve_ms": ms, "overhead_pct_vs_generic": 100 * (ms["sharded"] / ms["generic"] - 1),
              "generic_vs_fast_pct": 100 * (ms["generic"] / ms["fast"] - 1),
              "chi2_0": chi2_0, "chi2_median": chi2, "chi2_spread": spread,
              "chi2_spread_phase_4": spread_1k, "chi2_oracle": chi2_oracle_1k,
              "ratio_vs_oracle": chi2["sharded"] / chi2_oracle_1k,
              "generic_vs_fast_history_rel": generic_vs_fast,
              "collectives": collectives, "collectives_expected": expected,
              "collectives_formula": f"1 + {-(-cfg.iterations // refresh)} + {cfg.iterations}"
                                     f"·(1 + {cfg.pcg_iterations} + 1) = {formula}",
              "collective_bytes_per_solve": 0, "all_reduce_us_per_call": all_reduce_us,
              "launches": counts, "sync_free": True,
              "chi2_history": hists["sharded"].tolist(),
              "bound_ms": bound_1k, "bound_x": ms["sharded"] / bound_1k,
              "library_items": library_items(names),
              "nccl_items": [k for k in non_port if "nccl" in k.lower()],
              # device-to-device copies are counted against the table builds
              "other_items": [k for k in non_port
                              if "at::native::" not in k and "nccl" not in k.lower()
                              and not k.startswith("Memcpy DtoD")],
              "memcpy_dtod_per_table_build": copies_per_build,
              "non_port_items_ms": non_port, **prof}
    log("18a sharded 1k, world of one", **fields)
    check(collectives == expected == formula,
          f"18a: {collectives} all-reduces, expected {expected} = {formula}")
    # the sharded route: K2 for each Hv (its all-reduce between Hv and the
    # dot) and K34 for each PCG step, 20 solves
    expected_counts = solve_launches(hvp=240, pcg_chain=20 * (1 + 12))
    check(counts == expected_counts, f"18a: launches {counts} != {expected_counts}")
    for name in SHARDED_PATH:
        check(counts[name] > 0, f"18a: {name} not launched")
    # besides the port's kernels, only PyTorch's own (the loop's glue) and NCCL's
    check(not fields["library_items"] and not fields["other_items"],
          f"18a: library kernels in the profile: {fields['library_items']} "
          f"{fields['other_items']}")
    check(prof.get("memcpy_dtod") == copies_per_build + LM_STATE_COPIES,
          f"18a: {prof.get('memcpy_dtod')} device-to-device copies in the solve, "
          f"{copies_per_build} in its one incidence table build + {LM_STATE_COPIES} of the LM "
          "state's start")
    # the noise of the two routes compared: each one's own spread over its
    # turns (the generic solve's is 0 since K35; the sharded one keeps K2's
    # atomics and sums Hv in another order)
    tol = max(spread["sharded"], spread["generic"]) + 1e-6 * chi2_0
    check(abs(chi2["sharded"] - chi2["generic"]) <= tol,
          f"18a: sharded χ² {chi2['sharded']} vs generic {chi2['generic']} beyond {tol}")
    check(chi2["sharded"] <= ORACLE_FACTOR * chi2_oracle_1k + ORACLE_ATOL,
          f"18a: χ² {chi2['sharded']} vs oracle {chi2_oracle_1k}")
    check(generic_vs_fast <= 1e-3, f"18b: generic vs fast χ² histories {generic_vs_fast:.3g}")

    # (c) the 100k graph sharded, scripts/scaling_bench.py's configuration
    cfg100 = solver.SolverConfig(**SHARDED_100K_CONFIG)
    kops.reset_launches()
    sharded.reset_collectives()
    sharded_fn(g100k, cfg100)                 # warm-up at this size, counted
    counts100, coll100 = dict(kops.launches), sharded.collectives["all_reduce"]
    t100, out100 = timed_solves(sharded_fn, g100k, cfg100, reps=3)
    hist100 = out100[1].cpu()
    c0, c1 = float(hist100[0]), float(hist100[-1])
    bound_100k = sharded_bound(rows_large, counts100, cfg100)
    f100 = {"n_nodes": int(g100k.num_nodes), "config": SHARDED_100K_CONFIG,
            "solve_ms": 1e3 * t100, "chi2_0": c0, "chi2": c1, "chi2_phase_7": chi2_100k,
            "ratio_vs_phase_7": c1 / chi2_100k, "collectives": coll100, "launches": counts100,
            "bound_ms": bound_100k, "bound_x": 1e3 * t100 / bound_100k, "sync_free": True,
            "components_route": components_route(g100k.node_capacity)}
    log("18c sharded 100k, world of one", **f100)
    check(math.isfinite(c1) and c1 < c0, f"18c: χ² {c1} not below χ²₀ {c0}")
    check(abs(c1 - chi2_100k) <= CHI2_RTOL * chi2_100k + 1e-6 * c0,
          f"18c: χ² {c1} vs phase 7's {chi2_100k}")
    check(coll100 == sharded.collectives_per_solve(cfg100), f"18c: {coll100} all-reduces")
    check_pcg_route("18c", counts100, g100k.node_capacity, cfg100, reduce=True)
    fields["100k"] = f100
    return counts, fields


def sharded_rank(rank: int, world: int, root: str, device: str) -> int:
    """One gloo rank of phase 18 (d) (``chip_smoke.py --sharded-rank RANK
    WORLD DIR DEVICE``, every rank on the same card): the 1k graph, padded
    to the world, solved sharded once to warm up and three times timed; its
    poses and χ² history saved under DIR, one JSON line printed."""
    import os

    import torch.distributed as dist

    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.parallel import sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(root, "store"), world),
                            rank=rank, world_size=world)
    try:
        g = sharded.pad_edges_to_multiple(make_graph(1000, dev), world)
        cfg = solver.SolverConfig(**SHARDED_CONFIG)
        sharded.optimize_sharded(g, config=cfg)
        times = []
        for _ in range(3):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            sharded.reset_collectives()
            out, hist = sharded.optimize_sharded(g, config=cfg)
            sync()
            times.append(time.perf_counter() - t0)
        torch.save({"pose": out.pose.cpu(), "hist": hist.cpu()},
                   os.path.join(root, f"rank{rank}.pt"))
        print("RANK " + json.dumps({"rank": rank, "solve_ms": 1e3 * statistics.median(times),
                                    "collectives": sharded.collectives["all_reduce"],
                                    "edge_slots": g.edge_capacity}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


# c10d's per-collective bookkeeping: the stream records of the inputs in
# the caching allocator and the flight recorder's entries (PyTorch's own
# settings, read when the process group is made)
C10D_LEAN = {"TORCH_NCCL_AVOID_RECORD_STREAMS": "1", "TORCH_NCCL_TRACE_BUFFER_SIZE": "0"}


def overhead_worker(device: str) -> int:
    """Phase 18 (a') in a process of its own (``chip_smoke.py
    --overhead DEVICE``): a world of one, the 1k graph's generic and
    sharded solves in 10 alternating sync-free turns each and the 100k
    graph's in 3 (with a sharded solve's launches: its PCG on K2 and K37),
    and a solve's count of all-reduces alone; one JSON line."""
    import torch.distributed as dist

    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.parallel import sharded

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    graphs = {"1k": make_graph(1000, dev), "100k": make_graph(100_000, dev)}
    world_of_one(dev)
    try:
        cfg = solver.SolverConfig(**SHARDED_CONFIG)

        def sharded_fn(gr, c):
            return sharded.optimize_sharded(gr, config=c)

        out = {}
        for size, turns in (("1k", SHARDED_REPS), ("100k", 3)):
            g = graphs[size]
            for _ in range(2):
                solver.optimize(g, cfg)
                sharded_fn(g, cfg)
            times = {"generic": [], "sharded": []}
            for i in range(turns):
                pair = [("generic", solver.optimize), ("sharded", sharded_fn)]
                for name, fn in (pair if i % 2 == 0 else pair[::-1]):
                    times[name].append(timed_solves(fn, g, cfg, reps=1)[0])
            ms = {k: 1e3 * statistics.median(v) for k, v in times.items()}
            out[size] = {"solve_ms": ms, "overhead_pct": 100 * (ms["sharded"] / ms["generic"] - 1)}
            if size == "100k":
                kops.reset_launches()
                sharded_fn(g, cfg)
                out[size]["sharded_launches"] = {k: v for k, v in kops.launches.items() if v}
        g = graphs["1k"]
        n = sharded.collectives_per_solve(cfg)
        buf = torch.zeros(78 * g.node_capacity, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            dist.all_reduce(buf)
        torch.cuda.synchronize()
        out["all_reduce_us_per_call"] = 1e6 * (time.perf_counter() - t0) / n
        print("OVERHEAD " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def bookkeeping_phase(device) -> dict:
    """Phase 18 (a'): the world of one's overhead with PyTorch's defaults
    and with c10d's per-collective bookkeeping off (``C10D_LEAN``), each in
    a fresh process."""
    import os

    out = {}
    for name, extra in (("default", {}), ("bookkeeping_off", C10D_LEAN)):
        env = {k: v for k, v in os.environ.items() if k not in C10D_LEAN}
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--overhead",
                               str(device)], capture_output=True, text=True, env={**env, **extra},
                              timeout=RANK_TIMEOUT_S)
        check(proc.returncode == 0, f"18a': the {name} run exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("OVERHEAD "))
        out[name] = json.loads(line[len("OVERHEAD "):])
    log("18a' sharded 1k overhead, c10d bookkeeping", settings=C10D_LEAN, **out)
    return out


def two_rank_phase(device, hist_1k: torch.Tensor, chi2_oracle_1k: float) -> dict:
    """Phase 18 (d): two gloo ranks on the one card, each a process of its
    own (NCCL refuses two ranks on one device), joined through a
    ``FileStore`` in a git-ignored directory; their poses bit for bit, χ²₀
    and χ²₁ against the world of one's, the final χ² against the oracle.
    gloo stages every all-reduce through the host: the times are printed,
    not judged."""
    import os
    import tempfile

    from uzliti_slam_tpu_torch.kernels import _build

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as root:
        env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--sharded-rank",
                                   str(r), str(SHARDED_RANKS), root, str(device)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                                  env=env)
                 for r in range(SHARDED_RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=RANK_TIMEOUT_S))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
        for p, (_, err) in zip(procs, outs):
            check(p.returncode == 0, f"18d: a rank exited {p.returncode}: {err[-2000:]}")
        results = [json.loads(next(ln for ln in out.splitlines() if ln.startswith("RANK "))[5:])
                   for out, _ in outs]
        saved = [torch.load(os.path.join(root, f"rank{r}.pt")) for r in range(SHARDED_RANKS)]
    identical = all(torch.equal(s["pose"], saved[0]["pose"])
                    and torch.equal(s["hist"], saved[0]["hist"]) for s in saved[1:])
    hist = saved[0]["hist"]
    ref = hist_1k
    rel01 = float(((hist[:2] - ref[:2]).abs() / ref[:2].abs()).max())
    fields = {"ranks": SHARDED_RANKS, "backend": "gloo on CUDA tensors, one card",
              "solve_ms": [r["solve_ms"] for r in results],
              "collectives": [r["collectives"] for r in results],
              "poses_bit_identical": identical, "chi2_01_rel_vs_world_of_one": rel01,
              "chi2": float(hist[-1]), "ratio_vs_oracle": float(hist[-1]) / chi2_oracle_1k}
    log("18d sharded 1k, two ranks on one card", **fields)
    check(identical, "18d: the ranks' poses or χ² histories differ")
    check(rel01 <= 1e-3, f"18d: χ²₀, χ²₁ {rel01:.3g} from the world of one's")
    check(float(hist[-1]) <= ORACLE_FACTOR * chi2_oracle_1k + ORACLE_ATOL,
          f"18d: χ² {float(hist[-1])} vs oracle {chi2_oracle_1k}")
    return fields


def planar_phase(g1k) -> tuple[dict, dict, dict]:
    """Phase 18 (e): ``optimize_xy_only`` with early exit on the 1k graph, z
    perturbed by 0.2·N(0, 1): the counts set to 0 just before one solve
    and read just after, K9's factors against the reference's refreshes,
    timed sync-free, the JAX test's bars, the CPU plain path; K1's masked
    form against its plain version on the solve's first linearization.
    Returns (launches, K1's masked row, fields)."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops

    dev = g1k.device
    gen = torch.Generator().manual_seed(SEED + 18)
    dz = PLANAR_DZ * torch.randn(g1k.node_capacity, generator=gen)
    pose = g1k.pose.clone()
    pose[:, 2] += dz.to(dev)
    g = g1k.replace(pose=pose)
    cfg = solver.SolverConfig(optimize_xy_only=True)
    solver.optimize(g, cfg)                   # warm-up
    builds = kops.factor_builds(dev)
    builds.zero_()
    kops.reset_launches()
    _, (g2, st) = timed_solves(solver.optimize, g, cfg, reps=1)
    counts, built = dict(kops.launches), int(builds)
    ref_builds = reference_refreshes(st.chi2_history.cpu().tolist(), st.accepted.cpu().tolist(),
                                     cfg)
    # the planar solve and the same graph unprojected, in alternating turns
    plain_cfg = solver.SolverConfig()
    solver.optimize(g, plain_cfg)
    times = {"planar": [], "unprojected": []}
    for i in range(5):
        pair = [("planar", cfg), ("unprojected", plain_cfg)]
        for name, c in (pair if i % 2 == 0 else pair[::-1]):
            t_i, out = timed_solves(solver.optimize, g, c, reps=1)
            times[name].append(t_i)
            if name == "planar":
                g2, st = out
    t = statistics.median(times["planar"])
    prof, _ = device_profile(lambda: solver.optimize(g, cfg))
    valid = g.node_valid
    z = float(g2.pose[valid][:, 2].abs().max())
    roll_pitch = float(g2.pose[valid][:, 4:6].abs().max())
    hist = st.chi2_history.cpu()
    c0, c1 = float(hist[0]), float(hist[-1])
    _, st_cpu = solver.optimize(g.to("cpu"), cfg)
    c_cpu = float(st_cpu.chi2_history[-1])

    # K1's masked form on the solve's first linearization
    gf = g.replace(pose=solver.flatten_planar(g.pose, valid))
    free = (gf.node_valid & ~solver.gauge_fix_mask(gf, solver.connected_components(gf))).float()
    p = solver._Problem(gf, free, cfg)
    r0, _ = p.residuals(gf.pose)
    args = (r0, p.adj_meas_inv, gf.e_info, p.valid, gf.e_from, gf.e_to, free, p.both_free,
            p.is_chain, cfg.huber_delta, p.col_mask)
    got, ref = kops.linearize(*args, table=p.table), kops.linearize_plain(*args)
    err, rel = 0.0, 0.0
    for a, b in zip(got, ref):
        check(bool(torch.isfinite(a).all()), "18e: K1 masked: non-finite output")
        e = float((a - b).abs().max())
        err, rel = max(err, e), max(rel, e / max(float(b.abs().max()), 1e-30))
    masked_zero = not bool(got[0][:, :, 2:5].any() or got[4][:, 2:5].any())
    row = {"max_abs_err": err, "max_rel_err": rel, "tol_rel": KERNEL_TOL["linearize"],
           "masked_columns_zero": masked_zero, "library_ms": None}
    row["ms"], row["plain_ms"] = time_pair(lambda: kops.linearize(*args, table=p.table),
                                           lambda: kops.linearize_plain(*args))
    # K1 without the mask on the same inputs, timed beside the masked form
    row["ms_masked_again"], row["ms_unmasked"] = time_pair(
        lambda: kops.linearize(*args, table=p.table),
        lambda: kops.linearize(*args[:-1], table=p.table))
    row.update(bound("linearize", args + (p.table,)))
    log("18e kernel linearize_xy 1k", **row)
    fields = {"n_nodes": int(g.num_nodes), "dz_sigma": PLANAR_DZ, "solve_ms": 1e3 * t,
              "solve_ms_unprojected": 1e3 * statistics.median(times["unprojected"]), **prof,
              "chi2_0": c0, "chi2": c1, "chi2_cpu_plain": c_cpu, "max_abs_z": z,
              "max_abs_roll_pitch_quat": roll_pitch, "launches": counts,
              "factors_built": built, "reference_refreshes": ref_builds,
              "accepted": int(st.accepted.sum()), "sync_free": True}
    log("18e planar 1k", **fields)
    check(rel <= KERNEL_TOL["linearize"], f"18e: K1 masked rel err {rel:.3g}")
    check(masked_zero, "18e: K1 masked columns are not zero")
    check(z <= 1e-5 and roll_pitch <= 1e-4, f"18e: z {z}, roll/pitch {roll_pitch}")
    check(abs(c1 - c_cpu) <= CHI2_RTOL * c_cpu + 1e-6 * c0, f"18e: χ² {c1} vs CPU {c_cpu}")
    check(math.isfinite(c1) and c1 < c0, f"18e: χ² {c1} not below χ²₀ {c0}")
    check(built == ref_builds, f"18e: {built} factors built, the reference builds {ref_builds}")
    for name in FUSED_PATH + ("components",):
        check(counts[name] > 0, f"18e: {name} not launched")
    check_pcg_route("18e", counts, g.node_capacity, cfg)
    return counts, row, fields


def fleet_world_phase(device) -> dict:
    """Phase 18 (f): ``multihost.solve_fleet`` in the world of one against
    ``sharded.optimize_batch`` on an 8 x 64-node fleet at the fleet rung's
    configuration: the same launches, poses within FLEET_POSE_ATOL and
    each instance's χ² within CHI2_RTOL (K1 and K2's float atomics make
    two runs differ in the last bits, which 20 LM x 8 PCG steps
    amplify)."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.graph import state as gstate
    from uzliti_slam_tpu_torch.io import synthetic
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.parallel import multihost, sharded

    fleet, _ = synthetic.make_pose_graph_batch(
        FLEET_WORLD["batch"], FLEET_WORLD["n_nodes"],
        loop_closure_every=FLEET["loop_closure_every"],
        generator=torch.Generator().manual_seed(SEED + 19), capacity_rounding="pow2",
        device=device)
    cfg = solver.SolverConfig(**FLEET_CONFIG)
    sharded.optimize_batch(fleet, cfg)
    kops.reset_launches()
    got = multihost.solve_fleet(fleet, config=cfg)
    counts_world = dict(kops.launches)
    kops.reset_launches()
    ref = sharded.optimize_batch(fleet, cfg)
    counts_batch = dict(kops.launches)
    pose_gap = float((got.pose - ref.pose).abs().max())
    excess = 0.0
    for b in range(FLEET_WORLD["batch"]):
        one = gstate.graph_of(fleet, b)
        c_got = float(solver.total_chi2(one, got.pose[b], 1.0))
        c_ref = float(solver.total_chi2(one, ref.pose[b], 1.0))
        excess = max(excess, abs(c_got - c_ref) / (CHI2_RTOL * c_ref + 1e-12))
    fields = {"instances": FLEET_WORLD["batch"], "node_slots": FLEET_WORLD["n_nodes"],
              "launches": counts_world, "pose_gap": pose_gap, "chi2_excess": excess,
              "bit_identical": bool(torch.equal(got.pose, ref.pose))}
    log("18f solve_fleet 8x64, world of one", **fields)
    check(counts_world == counts_batch, f"18f: launches {counts_world} vs {counts_batch}")
    check(pose_gap <= FLEET_POSE_ATOL and excess <= 1.0,
          f"18f: solve_fleet vs optimize_batch: poses {pose_gap:.3g}, χ² {excess:.3g}x tol")
    return fields


def sharded_phase(dev, g1k, g100k, chi2_oracle_1k, spread_1k, chi2_100k, rows,
                  rows_large) -> tuple[dict, dict, dict, dict]:
    """Phase 18: the generic loop, the edge-sharded solve and the planar
    solve, each path driven with the counts set to 0 just before it and
    read just after.  Returns (the sharded 1k solve's launches, the planar
    solve's launches, K1's masked row, fields)."""
    import torch.distributed as dist

    world_of_one(dev)
    try:
        counts, fields = sharded_world_phase(g1k, g100k, chi2_oracle_1k, spread_1k, chi2_100k,
                                             rows, rows_large)
        fields["fleet"] = fleet_world_phase(dev)
    finally:
        dist.destroy_process_group()
    fields["bookkeeping"] = bookkeeping_phase(dev)
    fields["two_ranks"] = two_rank_phase(dev, torch.tensor(fields["chi2_history"]),
                                         chi2_oracle_1k)
    planar_counts, row, fields["planar"] = planar_phase(g1k)
    return counts, planar_counts, row, fields


# ---------------------------------------------------------------------------
# Phase 19: the scope protocol (K31 uid_slots, K32 edge_key_match, K33
# delta_upsert and scope_merge)
# ---------------------------------------------------------------------------

def _graph_bits(g) -> dict:
    """A graph's fields on the host, float32 fields as their bit patterns
    (a bit-for-bit compare)."""
    from uzliti_slam_tpu_torch.graph import state as gstate

    out = {}
    for k, v in gstate.to_numpy(g).items():
        out[k] = v.view(np.int32) if v.dtype == np.float32 else v
    return out


def graph_mismatches(a, b) -> list:
    """The fields of two graphs that differ in any bit."""
    ba, bb = _graph_bits(a), _graph_bits(b)
    return [k for k in ba if ba[k].shape != bb[k].shape or not np.array_equal(ba[k], bb[k])]


def nt_mismatches(a, b) -> list:
    """The fields of two structures of ``parallel.scope`` that differ."""
    from uzliti_slam_tpu_torch.parallel import scope

    da, db = scope.to_numpy(a), scope.to_numpy(b)
    return [k for k in da if not np.array_equal(da[k], db[k])]


class plain_scope_kernels:
    """Within it, the scope protocol runs K31-K33's plain versions: the
    wrappers are swapped for them."""

    def __enter__(self):
        from uzliti_slam_tpu_torch.kernels import ops as kops
        self.saved = {n: getattr(kops, n) for n in SCOPE_KERNELS}
        for n in SCOPE_KERNELS:
            setattr(kops, n, getattr(kops, n + "_plain"))

    def __exit__(self, *exc):
        from uzliti_slam_tpu_torch.kernels import ops as kops
        for n, f in self.saved.items():
            setattr(kops, n, f)


def scope_delta_100k(g, device, seed: int = SEED):
    """Phase 19a's delta into the 100k-node global graph: 32 nodes (16 uids
    the graph holds, a resend, and 16 new), 64 edges: 24 resends of table
    edges, 24 new edges each touching a new node, 8 in-delta duplicates of
    those, and 8 with an unknown endpoint."""
    from uzliti_slam_tpu_torch.parallel import scope

    rng = np.random.default_rng(seed)
    n, ne = int(g.num_nodes), int(g.num_edges)
    uid = g.node_uid.cpu().numpy()
    ef, et, ty = (getattr(g, k)[:ne].cpu().numpy() for k in ("e_from", "e_to", "e_type"))
    known = uid[rng.choice(n, 16, replace=False)]
    new = np.arange(200_000, 200_016, dtype=np.int32)
    rows = rng.choice(ne, 24, replace=False)
    resend = [(uid[ef[r]], uid[et[r]], ty[r]) for r in rows]
    fresh = [(new[i % 16], known[i % 16] if i % 2 else new[(i + 1) % 16], (1, 104, 105)[i % 3])
             for i in range(24)]
    dups = fresh[:8]
    unknown = [(9_999_000 + i, known[i], 1) for i in range(8)]
    edges = np.array(resend + fresh + dups + unknown, np.int64).astype(np.int32)
    q = rng.normal(size=(96, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    poses = np.concatenate([rng.normal(size=(96, 3)).astype(np.float32), q], axis=1)
    arrays = dict(
        n_uid=rng.permutation(np.concatenate([known, new])).astype(np.int32),
        n_pose=poses[:32], n_odom_pose=poses[32:64],
        n_stamp=rng.uniform(0, 1e4, 32).astype(np.float32),
        n_uncertainty=rng.uniform(0, 5, 32).astype(np.float32),
        n_gist=rng.integers(0, 256, (32, 32), dtype=np.uint8),
        e_from_uid=edges[:, 0].copy(), e_to_uid=edges[:, 1].copy(), e_type=edges[:, 2].copy(),
        e_transform=np.concatenate([poses[:64, :3], poses[32:96, 3:]], axis=1),
        e_info=rng.normal(size=(64, 6, 6)).astype(np.float32),
        e_score=rng.uniform(0, 50, 64).astype(np.float32), e_valid=rng.uniform(size=64) < 0.5,
        odom_params=np.array([1.0, 0.0, 0.0], np.float32))
    return scope.delta_from_numpy(arrays, device)


def scope_path_check(label: str, fn, cpu_fn, compare) -> dict:
    """One scope function on the card: its launches a call, sync-free calls
    timed, the same call with K31-K33's plain versions on the card in
    alternating turns, both held equal (``compare``) and to the same call on
    CPU tensors, a profile.  Returns fields."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    fn()
    torch.cuda.synchronize()
    kops.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    counts = {k: kops.launches[k] for k in SCOPE_KERNELS}
    with plain_scope_kernels():
        ref = fn()
    bad = compare(out, ref)
    bad_cpu = compare(out, cpu_fn())
    t, _ = timed_sync_free(fn, reps=10)

    def plain():
        with plain_scope_kernels():
            return fn()
    ms, plain_ms = time_pair(fn, plain, trials=5, calls=2)
    # ten calls in one profile: a single call's few short kernels can fall
    # outside what the trace keeps
    prof, device_ms = device_profile(lambda: [fn() for _ in range(10)])
    fields = {"launches_per_call": counts, "ms_sync_free": 1e3 * t, "ms": ms,
              "plain_ms": plain_ms, "mismatches_plain": bad, "mismatches_cpu": bad_cpu,
              "profile_of_10_calls": prof,
              "kernel_device_ms_per_call": {k: v / 10 for k, v in
                                            kernel_device_ms(device_ms, SCOPE_KERNELS).items()
                                            if v is not None}}
    log(f"19a {label}", **fields)
    check(not bad, f"19a {label}: kernels and plain versions differ in {bad}")
    check(not bad_cpu, f"19a {label}: card and CPU tensors differ in {bad_cpu}")
    return fields


def scope_apply_phase(dev) -> tuple[dict, dict]:
    """Phase 19a: ``apply_delta`` of a 32-node / 64-edge delta into a
    100k-node global graph, then ``apply_ack`` and ``apply_scope`` (32 rows,
    half known) on a 1k-node local graph, each through
    ``scope_path_check``.  Returns (fields, the wrappers' recorded
    calls)."""
    from uzliti_slam_tpu_torch.io import synthetic
    from uzliti_slam_tpu_torch.parallel import scope

    cpu = torch.device("cpu")
    g, _ = synthetic.make_pose_graph(SCOPE_GLOBAL_N, loop_closure_every=10,
                                     capacity_rounding="pow2",
                                     generator=torch.Generator().manual_seed(SEED), device=dev)
    d = scope_delta_100k(g, dev)
    g_cpu, d_cpu = g.to(cpu), scope.to_device(d, cpu)

    def cmp_delta(a, b):
        return graph_mismatches(a[0], b[0]) + nt_mismatches(a[1], b[1])

    fields = {"graph": {"nodes": int(g.num_nodes), "node_capacity": g.node_capacity,
                        "edges": int(g.num_edges), "edge_capacity": g.edge_capacity}}
    fields["apply_delta"] = scope_path_check(
        "apply_delta 100k", lambda: scope.apply_delta(g, d),
        lambda: scope.apply_delta(g_cpu, d_cpu), cmp_delta)
    g2, ack = scope.apply_delta(g, d)
    an, af = ack.node_uids.cpu().numpy(), ack.edge_from.cpu().numpy()
    fields["apply_delta"].update(
        nodes_added=int(g2.num_nodes) - int(g.num_nodes),
        edges_added=int(g2.num_edges) - int(g.num_edges), acked_nodes=int((an >= 0).sum()),
        acked_edges=int((af >= 0).sum()))
    check(fields["apply_delta"]["nodes_added"] == 16 and (an >= 0).all(),
          f"19a apply_delta: nodes {fields['apply_delta']}")
    check(fields["apply_delta"]["edges_added"] == 24 and (af[:56] >= 0).all()
          and (af[56:] < 0).all(), f"19a apply_delta: edges {fields['apply_delta']}")

    lg, _ = synthetic.make_pose_graph(1000, loop_closure_every=10, capacity_rounding="pow2",
                                      generator=torch.Generator().manual_seed(SEED + 1),
                                      device=dev)
    rng = np.random.default_rng(SEED + 1)
    ne = int(lg.num_edges)
    uid = lg.node_uid.cpu().numpy()
    rows = rng.choice(ne, 64, replace=False)
    ef, et, ty = (getattr(lg, k).cpu().numpy()[rows] for k in ("e_from", "e_to", "e_type"))
    ack_from = uid[ef].astype(np.int32)
    ack_from[::8] = -1
    ack = scope.ack_from_numpy(dict(node_uids=uid[rng.choice(1000, 32, replace=False)],
                                    edge_from=ack_from, edge_to=uid[et], edge_type=ty), dev)
    ship = scope.ship_state_init(lg)
    lg_cpu = lg.to(cpu)
    fields["apply_ack"] = scope_path_check(
        "apply_ack 1k", lambda: scope.apply_ack(lg, ship, ack),
        lambda: scope.apply_ack(lg_cpu, scope.to_device(ship, cpu), scope.to_device(ack, cpu)),
        nt_mismatches)
    reply_uid = np.concatenate([uid[rng.choice(1000, 16, replace=False)],
                                np.arange(500_000, 500_016)]).astype(np.int32)
    reply_uid[-1] = reply_uid[-2]                 # a repeated unknown uid
    reply_uid[3] = -1
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    reply = scope.reply_from_numpy(dict(
        uid=rng.permutation(reply_uid),
        pose=np.concatenate([rng.normal(size=(32, 3)).astype(np.float32), q], axis=1),
        stamp=rng.uniform(0, 100, 32).astype(np.float32)), dev)
    fields["apply_scope"] = scope_path_check(
        "apply_scope 1k", lambda: scope.apply_scope(lg, reply),
        lambda: scope.apply_scope(lg_cpu, scope.to_device(reply, cpu)), graph_mismatches)
    calls = record_args(lambda: (scope.apply_delta(g, d), scope.apply_ack(lg, ship, ack),
                                 scope.apply_scope(lg, reply)), names=SCOPE_KERNELS)
    return fields, calls


def scope_duo_config(device, img: str):
    """(config, extrinsic) of phase 19's duo: ``step_config``'s settings
    (VGA) or tests/test_runner.py's (96x128), with the keyframe gate at
    0.25 m and the scope of tests/test_runner.py."""
    from uzliti_slam_tpu_torch.config import (EdgeEstimationConfig, KeyframeConfig, ScopeConfig,
                                              SlamConfig)
    from uzliti_slam_tpu_torch.io import simulator

    scope_cfg = ScopeConfig(scope_size_min=2.0, eviction_margin=0.5)
    if img == "vga":
        cfg, pose = step_config(1, device)
        return dataclasses.replace(cfg, keyframe=KeyframeConfig(new_node_distance=0.25),
                                   scope=scope_cfg), pose
    cfg = SlamConfig(node_capacity=64, edge_capacity=256, feats_per_node=64, scan_bins=90,
                     keyframe=KeyframeConfig(new_node_distance=0.25),
                     estimation=EdgeEstimationConfig(min_consensus=8, min_matching_score=6.0),
                     scope=scope_cfg)
    return cfg, simulator.cam_extrinsic(device=device)


def _enclosing_def(filename: str, lineno: int) -> str:
    import linecache

    for i in range(lineno, 0, -1):
        m = re.match(r"\s*def (\w+)", linecache.getline(filename, i))
        if m:
            return m.group(1)
    return "?"


def host_read_sites(fn):
    """(fn(), {"file:function": synchronising calls}) under CUDA sync debug
    mode "warn": each host read of a device value, by where it was made."""
    import warnings
    from collections import Counter
    from pathlib import Path

    from uzliti_slam_tpu_torch.graph import solver

    # the epoch's restart read may run with the sync check lifted
    # (lift_sync_check_for_restart_read): count its calls as well
    decision, restarts = solver._host_decision, []
    solver._host_decision = lambda flag: restarts.append(1) or decision(flag)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
            solver._host_decision = decision
    sites = Counter(f"{Path(r.filename).name}:{_enclosing_def(r.filename, r.lineno)}"
                    for r in rec if "synchroniz" in str(r.message).lower())
    if restarts:
        key = "solver.py:_host_decision"
        sites[key] = max(sites.get(key, 0), len(restarts))
    return out, dict(sites)


def run_duo(duo, frames, rounds: list | None = None, record_round: int | None = None,
            calls: dict | None = None, optimize_global: bool = True):
    """tests/test_runner.py's loop: an exchange every SCOPE_DUO["every"]
    frames, then SCOPE_DUO["drain"] rounds.  Each round's fields go to
    ``rounds`` when given (the local half and the global half timed
    separately, the host reads by site); the K31-K33 wrappers' calls of
    round ``record_round`` go to ``calls``; ``optimize_global`` as
    ``exchange`` takes it.  Returns (evicted, proposed)."""
    from uzliti_slam_tpu_torch import runner

    evicted = proposed = 0
    n_round = 0

    def exchange():
        nonlocal evicted, proposed, n_round
        n_round += 1
        if n_round - 1 == record_round:
            out = {}
            calls.update(record_args(lambda: out.update(ex=one_round()), names=SCOPE_KERNELS))
            ex = out["ex"]
        else:
            ex = one_round()
        evicted += ex["evicted_local"]
        proposed += ex["proposed_global"]

    def one_round():
        if rounds is None:
            ex = duo.exchange(optimize_global)
        else:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (delta, robot, radius), s1 = host_read_sites(duo.local_make_request)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            (ack, reply, info_g), s2 = host_read_sites(lambda: runner.global_exchange_step(
                duo.global_slam, delta, robot, radius, duo.delta_nodes, duo.delta_edges,
                optimize=optimize_global))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            info_l, s3 = host_read_sites(lambda: duo.local_apply_response(ack, reply))
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            sites = {}
            for s in (s1, s2, s3):
                for k, v in s.items():
                    sites[k] = sites.get(k, 0) + v
            rounds.append({"local_ms": 1e3 * (t1 - t0 + t3 - t2), "global_ms": 1e3 * (t2 - t1),
                           "host_reads": sites, "delta_nodes": int((delta.n_uid >= 0).sum()),
                           **{k: v for k, v in info_g.items() if k != "tri"}, **info_l})
            ex = {**info_l, **info_g}
        return ex

    for i, fr in enumerate(frames):
        duo.add_frame(fr["image"], fr["depth"], fr["odom_pose"], fr["stamp"])
        if (i + 1) % SCOPE_DUO["every"] == 0:
            exchange()
    for _ in range(SCOPE_DUO["drain"]):
        exchange()
    return evicted, proposed


def duo_bars(duo, frames, evicted: int, proposed: int) -> dict:
    """tests/test_runner.py's bars on a duo: keyframes by uid, eviction,
    proposals, ATE against the odometry's, the drained resend queue."""
    from uzliti_slam_tpu_torch.io import synthetic
    from uzliti_slam_tpu_torch.parallel import scope

    poses, uids, stamps = duo.global_trajectory()
    kf = uids < 1_000_000
    st = stamps[kf].astype(int)
    gt = torch.from_numpy(np.stack([frames[s]["gt_pose"] for s in st]))
    odo = torch.from_numpy(np.stack([frames[s]["odom_pose"] for s in st]))
    lg = duo.local.state.graph
    rest = scope.make_delta(lg, duo.ship, duo.local.state.gist.desc)
    return {"keyframes_local": duo.local._n_kf_host, "keyframes_global": int(kf.sum()),
            "distinct_keyframe_uids": int(np.unique(uids[kf]).size),
            "global_nodes": int(len(uids)), "live_local": int(lg.node_valid.sum()),
            "evicted_local": evicted, "proposed_global": proposed,
            "ate_global_m": float(synthetic.ate_rmse(torch.from_numpy(poses[kf]), gt)),
            "ate_odometry_m": float(synthetic.ate_rmse(odo, gt)),
            "undelivered_nodes": int((rest.n_uid >= 0).sum()),
            "undelivered_edges": int((rest.e_type >= 0).sum())}


def check_duo_bars(phase: str, bars: dict, ate_bar: bool, ate_max: float = math.inf) -> None:
    check(bars["keyframes_global"] == bars["keyframes_local"] == bars["distinct_keyframe_uids"],
          f"{phase}: keyframes {bars}")
    check(bars["evicted_local"] > 0 and bars["live_local"] < bars["global_nodes"],
          f"{phase}: eviction {bars}")
    check(bars["proposed_global"] > 0, f"{phase}: no closure proposed by the global")
    if ate_bar:
        check(bars["ate_global_m"] < bars["ate_odometry_m"], f"{phase}: ATE {bars}")
    check(bars["ate_global_m"] < ate_max, f"{phase}: ATE {bars['ate_global_m']}")
    check(bars["undelivered_nodes"] == 0 and bars["undelivered_edges"] == 0,
          f"{phase}: resend queue not drained {bars}")


def scope_duo_phase(dev) -> tuple[dict, dict, dict]:
    """Phase 19b: ``LocalGlobalSlam`` on the VGA WallWorld, 48 frames out and
    back, an exchange every 6 frames and 4 drain rounds: launches of K31-K33
    over the run (counts set to 0 just before it, read just after), ms per
    round split into the local and the global half, host reads per round by
    site, a profile of one round, the bars of tests/test_runner.py and the
    ATE against the odometry's; the scope functions on one round's real
    arguments under CUDA sync debug mode "error".  Returns (launches,
    fields, the wrappers' calls of one round)."""
    from uzliti_slam_tpu_torch import pipeline, runner
    from uzliti_slam_tpu_torch.io import simulator
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.parallel import scope

    kv = KEYFRAME_VGA
    world = simulator.WallWorld(img_h=kv["img_h"], img_w=kv["img_w"], f=kv["f"])
    frames = simulator.simulate_sequence(world, n_frames=SCOPE_DUO["frames"],
                                         odom_drift=SCOPE_DUO["drift"],
                                         length=SCOPE_DUO["length"])
    cfg, pose = scope_duo_config(dev, "vga")
    duo = runner.LocalGlobalSlam(cfg, cam=world.cam, cam_pose=pose, device=dev)
    duo.local.optimize_every = 10 ** 9
    rounds, calls = [], {}
    kops.reset_launches()
    t0 = time.perf_counter()
    evicted, proposed = run_duo(duo, frames, rounds, record_round=SCOPE_DUO["record_round"],
                                calls=calls)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: kops.launches[k] for k in SCOPE_KERNELS}
    bars = duo_bars(duo, frames, evicted, proposed)
    busy = [r for r in rounds if r["delta_nodes"] > 0]
    reads = [sum(r["host_reads"].values()) for r in rounds]
    sites = {}
    for r in rounds:
        for k, v in r["host_reads"].items():
            sites[k] = sites.get(k, 0) + v

    # one more round (the queue is empty: the global still recognizes,
    # replies, maintains and optimizes), profiled, with its launches
    kops.reset_launches()
    prof, device_ms = device_profile(duo.exchange)
    round_counts = {k: kops.launches[k] for k in SCOPE_KERNELS}
    # the scope functions on a round's real arguments, sync-free: a delta
    # from the local, applied to the global, acknowledged and replied to
    ls, gslam = duo.local.state, duo.global_slam
    lg = ls.graph
    ship0 = scope.ship_state_init(lg)
    args = dict(max_nodes=duo.delta_nodes, max_edges=duo.delta_edges, desc=ls.desc,
                desc_valid=ls.desc_valid, points=ls.points, scans=ls.scans,
                scan_valid=ls.scan_valid)

    def sync_free_round():
        delta = scope.make_delta(lg, ship0, ls.gist.desc, **args)
        gg, ack = scope.apply_delta(gslam.state.graph, delta)
        st, slots, fresh = runner._absorb_payloads(gslam.state.replace(graph=gg), delta)
        st, n_prop, _ = pipeline.recognize_absorbed(st, slots, fresh, gslam.config)
        reply = scope.scope_reply(st.graph, lg.pose[0], torch.full((), 3.0, device=dev))
        ship = scope.apply_ack(lg, ship0, ack)
        return scope.apply_scope(lg, reply), ship, n_prop

    t_round, _ = timed_sync_free(sync_free_round, reps=3)
    fields = {"frames": SCOPE_DUO["frames"], "image": [KEYFRAME_VGA["img_h"], KEYFRAME_VGA["img_w"]],
              "wall_s": wall, "rounds": len(rounds), "launches_run": counts,
              "launches_round": round_counts,
              "round_ms_median": statistics.median(r["local_ms"] + r["global_ms"] for r in busy),
              "local_ms_median": statistics.median(r["local_ms"] for r in busy),
              "global_ms_median": statistics.median(r["global_ms"] for r in busy),
              "host_reads_per_round_max": max(reads), "host_reads_by_site": sites,
              "sync_free_scope_round_ms": 1e3 * t_round, **bars,
              "round_profile": prof,
              "kernel_device_ms_round": kernel_device_ms(device_ms, SCOPE_KERNELS),
              "per_round": rounds}
    log("19b duo VGA", **{k: v for k, v in fields.items() if k != "per_round"})
    check_duo_bars("19b", bars, ate_bar=True)
    check(all(counts[k] > 0 for k in SCOPE_KERNELS), f"19b: a scope kernel never launched {counts}")
    check(round_counts == {"uid_slots": 4, "edge_key_match": 2, "delta_upsert": 1,
                           "scope_merge": 1}, f"19b: launches of a round {round_counts}")
    check(max(reads) <= 6, f"19b: {max(reads)} host reads in a round ({sites})")
    return counts, fields, calls


def _draws(a, kw) -> bool:
    """Whether a ``ransac_rigid_batch`` call draws its triplets (none given)."""
    return len(a) <= 7 and kw.get("tri") is None


def draws_recorded(fn):
    """(fn(), every RANSAC draw it made, in order): the triplets each
    drawing ``ransac.ransac_rigid_batch`` call reports (K7's, on the card)."""
    from uzliti_slam_tpu_torch.ops import ransac

    saved, draws = ransac.ransac_rigid_batch, []

    def recorded(*a, **kw):
        res = saved(*a, **kw)
        if _draws(a, kw):
            draws.append(res.tri.clone())
        return res

    ransac.ransac_rigid_batch = recorded
    try:
        return fn(), draws
    finally:
        ransac.ransac_rigid_batch = saved


def draws_replayed(fn, draws: list):
    """fn() with each RANSAC draw replaced, in order, by ``draws``, handed
    to the drawing call through ``tri=`` (moved to its device)."""
    from uzliti_slam_tpu_torch.ops import ransac

    saved, it = ransac.ransac_rigid_batch, iter(draws)

    def replayed(*a, **kw):
        if _draws(a, kw):
            t, valid = next(it), a[2]
            k_hyp = a[3] if len(a) > 3 else kw.get("n_hypotheses", 128)
            check(tuple(t.shape) == tuple(valid.shape[:-1]) + (k_hyp, 3),
                  f"replayed draw of shape {tuple(t.shape)} for {tuple(valid.shape)}")
            kw = {**kw, "tri": t.to(valid.device)}
        return saved(*a, **kw)

    ransac.ransac_rigid_batch = replayed
    try:
        return fn()
    finally:
        ransac.ransac_rigid_batch = saved


def graph_gaps(ga, gb) -> tuple[dict, float]:
    """({field: equal} over the structure of two global graphs: the counts,
    live uids, edge endpoints, types and validity; the largest pose gap of
    the live nodes)."""
    ga, gb = ga.to("cpu"), gb.to("cpu")
    n, ne = int(ga.num_nodes), int(ga.num_edges)
    same = {"num_nodes": n == int(gb.num_nodes), "num_edges": ne == int(gb.num_edges)}
    for k in ("node_valid", "node_uid"):
        same[k] = bool(torch.equal(getattr(ga, k)[:n], getattr(gb, k)[:n]))
    for k in ("e_from", "e_to", "e_type", "e_valid"):
        same[k] = bool(torch.equal(getattr(ga, k)[:ne], getattr(gb, k)[:ne]))
    live = ga.node_valid[:n] & gb.node_valid[:n]
    return same, float((ga.pose[:n][live] - gb.pose[:n][live]).abs().max())


def nondeterministic_ops(fn) -> list:
    """The first lines of the warnings PyTorch gives, while ``fn()`` runs
    under ``torch.use_deterministic_algorithms(True, warn_only=True)``, for
    ops with no deterministic implementation on the card."""
    import warnings

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted({str(w.message).splitlines()[0][:200] for w in caught
                   if "determinis" in str(w.message)})


def scope_replay_phase(dev) -> dict:
    """Phase 19c: tests/test_runner.py's 96x128 duo (24 frames) on the card,
    its RANSAC draws recorded, then again with those draws replayed on the
    card and on CPU tensors.  (i) Without the global's optimization every
    step is deterministic: the card and CPU global graphs must have the
    same structure (live uids, edge endpoints, types, validity) and poses
    within SCOPE_POSE_ATOL.  (ii) As tests/test_runner.py runs it (the
    global optimizes every round): its bars on the card, the structure and
    pose gaps card-card and card-CPU reported, and whether the two card
    runs end bit-identical (ROADMAP C5: the epochs' solves take K1 and K35,
    which sum without atomics); if they do not, the PyTorch ops that have
    no deterministic implementation, named by a third card run under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``."""
    from uzliti_slam_tpu_torch import runner
    from uzliti_slam_tpu_torch.io import simulator

    world = simulator.WallWorld(img_h=96, img_w=128)
    frames = simulator.simulate_sequence(world, n_frames=24, odom_drift=0.05, length=5.0)
    cpu = torch.device("cpu")

    def runs(names, optimize: bool, draws=None):
        out = {}
        for name, device in names:
            cfg, pose = scope_duo_config(device, "96x128")
            duo = runner.LocalGlobalSlam(cfg, cam=world.cam, cam_pose=pose, device=device)
            duo.local.optimize_every = 10 ** 9
            t0 = time.perf_counter()
            if draws is None:
                r, draws = draws_recorded(lambda: run_duo(duo, frames, optimize_global=optimize))
            else:
                r = draws_replayed(lambda: run_duo(duo, frames, optimize_global=optimize), draws)
            out[name] = (duo, r, time.perf_counter() - t0)
        return out, draws

    fixed, draws = runs((("card", dev), ("cpu", cpu)), optimize=False)
    n_draws = len(draws)
    same, pose_err = graph_gaps(fixed["card"][0].global_slam.state.graph,
                                fixed["cpu"][0].global_slam.state.graph)
    fields = {"without_optimization": {
        "card_s": fixed["card"][2], "cpu_s": fixed["cpu"][2], "draws": n_draws, "same": same,
        "pose_max_abs_err": pose_err, "pose_atol": SCOPE_POSE_ATOL,
        "counts": [fixed["card"][1], fixed["cpu"][1]]}}
    log("19c duo 96x128 without the global's optimization, card vs CPU",
        **fields["without_optimization"])
    check(all(same.values()), f"19c: card and CPU global graphs differ: {same}")
    check(pose_err <= SCOPE_POSE_ATOL, f"19c: poses {pose_err:.3g} apart")
    check(fixed["card"][1] == fixed["cpu"][1], f"19c: counts {fields['without_optimization']}")

    full, draws = runs((("card", dev), ("card_again", dev), ("cpu", cpu)), optimize=True)
    n_draws = len(draws)
    dc, (evc, prc), tc = full["card"]
    bars = duo_bars(dc, frames, evc, prc)
    gaps = {}
    for other in ("card_again", "cpu"):
        s, e = graph_gaps(dc.global_slam.state.graph, full[other][0].global_slam.state.graph)
        gaps[other] = {"same": s, "pose_max_abs_err": e, "counts": full[other][1]}
    again = gaps["card_again"]
    identical = all(again["same"].values()) and again["pose_max_abs_err"] == 0.0
    fields["test_runner"] = {"card_s": tc, "draws": n_draws, **bars, "gaps": gaps,
                             "card_runs_bit_identical": identical}
    if not identical:
        fields["test_runner"]["nondeterministic_ops"] = nondeterministic_ops(
            lambda: runs((("card_deterministic", dev),), optimize=True, draws=draws))
    log("19c duo 96x128 as tests/test_runner.py runs it", **fields["test_runner"])
    check_duo_bars("19c", bars, ate_bar=False, ate_max=0.3)
    return fields


def scope_work(name: str, args, kw: dict) -> tuple[int, int]:
    """(bytes, operations) one call of a scope kernel needs on these inputs:
    K31 reads each table row's uid and flag (5 bytes) and the queries, and
    writes a slot a query; a compare per live row and query.  K32 reads 12
    bytes a compared row (16 in uid space) and a query, writes a flag a
    query and a row; three compares per row and query.  K33 reads the
    delta's rows and K31/K32's results, writes the rows it inserts and the
    ACK; its compares are the in-delta ones (rows²)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    if name == "uid_slots":
        node_uid, node_valid, uids = args
        return 5 * node_uid.shape[0] + 8 * uids.shape[0], int(node_valid.sum()) * uids.shape[0]
    if name == "edge_key_match":
        qa, _, _, ra = args[:4]
        num_rows, node_uid = kw.get("num_rows"), kw.get("node_uid")
        E, Q = ra.shape[0], qa.shape[0]
        rows = E if num_rows is None else int(num_rows)
        per_row = 16 if node_uid is not None else 12
        return per_row * rows + 12 * Q + Q + E, 3 * rows * Q
    if name == "delta_upsert":
        g, delta, node_found, ef, et, dup, *first = args
        Dn, De = delta.n_uid.shape[0], delta.e_type.shape[0]
        g2, _, _ = kops.delta_upsert(*args, **kw)
        ins = int(g2.num_nodes) - int(g.num_nodes)
        app = int(g2.num_edges) - int(g.num_edges)
        read = Dn * (4 + 28 + 28 + 4 + 4 + 4) + De * (12 + 28 + 144 + 4 + 1 + 8 + 1)
        return read + ins * 70 + app * 205 + 4 * (Dn + De), Dn * Dn + De * De + De * Dn
    if name == "scope_merge":
        g, uid, pose, stamp, found = args
        K = uid.shape[0]
        g2 = kops.scope_merge(*args, **kw)
        ins = int(g2.num_nodes) - int(g.num_nodes)
        return K * 40 + ins * 70 + K * 29, K * K
    raise KeyError(name)


def compare_scope_kernels(calls: dict, label: str, trials: int = 11) -> dict:
    """K31-K33 against their plain versions on every recorded call: integer
    outputs exactly, copied floats bit for bit; each timed on its first call
    (K33's plain version loops over the rows on the host: fewer trials)
    beside its bound.  ``max_abs_err`` is the largest difference of any
    output (0 when every bit agrees)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    def diff(a, b) -> float:
        if isinstance(a, tuple):
            return max(diff(x, y) for x, y in zip(a, b))
        if hasattr(a, "node_uid"):
            bad = graph_mismatches(a, b)
            return 0.0 if not bad else max(
                float((getattr(a, k).cpu().double() - getattr(b, k).cpu().double()).abs().max())
                for k in bad) or math.inf
        if not torch.equal(a, b):
            return max(float((a.double() - b.double()).abs().max()), 1.0)
        return 0.0

    rows = {}
    for name in SCOPE_KERNELS:
        err = 0.0
        for args, kw in calls[name]:
            err = max(err, diff(getattr(kops, name)(*args, **kw),
                                getattr(kops, name + "_plain")(*args, **kw)))
        args, kw = calls[name][0]
        heavy = name in ("delta_upsert", "scope_merge")
        ms, plain_ms = time_pair(lambda: getattr(kops, name)(*args, **kw),
                                 lambda: getattr(kops, name + "_plain")(*args, **kw),
                                 trials=3 if heavy else trials, calls=1 if heavy else 10)
        row = {"max_abs_err": err, "calls_compared": len(calls[name]), "ms": ms,
               "plain_ms": plain_ms, "library_ms": None, **bound(name, (args, kw))}
        log(f"19 kernel {name} {label}", **row)
        check(err == 0.0, f"{name} {label}: kernel and plain version differ ({err})")
        rows[name] = row
    return rows


def scope_phase(dev) -> tuple[dict, dict, dict, dict]:
    """Phase 19: (a) the delta apply at 100k nodes, (b) the VGA duo (the
    main path, counts set to 0 just before it and read just after), (c) the
    96x128 duo on the card against CPU tensors; K31-K33 against their plain
    versions on (b)'s and (a)'s arguments.  Returns (launches, rows, large
    rows, fields)."""
    t0 = time.perf_counter()
    apply_fields, calls_a = scope_apply_phase(dev)
    counts, duo_fields, calls_b = scope_duo_phase(dev)
    replay = scope_replay_phase(dev)
    rows = compare_scope_kernels(calls_b, "VGA duo round")
    rows_large = compare_scope_kernels(calls_a, "100k apply_delta, 1k apply_ack / apply_scope")
    fields = {"apply": apply_fields, "duo_vga": duo_fields, "duo_96x128_replay": replay,
              "seconds": time.perf_counter() - t0}
    log("19 scope protocol", seconds=fields["seconds"])
    return counts, rows, rows_large, fields


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.config import SlamConfig
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.io import synthetic
    from uzliti_slam_tpu_torch.kernels import _build
    from uzliti_slam_tpu_torch.kernels import ops as kops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log("1 env", torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
        python=sys.version.split()[0], card=smi)

    t0 = time.perf_counter()
    start_atomic_k1_build()
    _build.load()
    load_atomic_k1()
    ptxas = _build.BUILD_DIR / f"ptxas_{_build.source_hash()}.log"
    log("2 build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.last_build_seconds,
        library=str(_build.library_path().relative_to(_build.BUILD_DIR.parents[1])),
        ptxas=ptxas_summary(ptxas.read_text()) if ptxas.exists() else "no log (prebuilt)")
    gaps = function_kernel_gaps()
    check(not gaps, f"device functions missing from FUNCTION_KERNEL / DEVICE_FUNCTIONS: {gaps}")
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
    g10k = make_graph(10_000, dev)
    g100k = make_graph(100_000, dev)
    rows = compare_kernels(g1k, "1k")
    rows_large = compare_kernels(g100k, "100k", time_split=False)
    # K3 and K10 on a single 100k chain: checked, not timed (no path runs
    # them there since K37); their rows' main fields are the fleet's
    single100k = {name: rows_large.pop(name) for name in SPLIT_PCG}
    # K35 and K34 on the first PCG solve of the 1k, the 500-node epoch's and
    # the 10k solve (each within the cap), and in the generic loop's planar
    # form at 1k; the 100k solve is above the cap and takes K2, K10 and K3
    hcfg = solver.SolverConfig(**HEADLINE)
    xy = solver._xy_mask(torch.float32, dev)
    in1k, in10k = kernel_inputs(g1k, hcfg), kernel_inputs(g10k, hcfg)
    in500 = kernel_inputs(built500[1].graph, built500[0].solver)
    rows["pcg_chain_solve"] = compare_pcg_chain_solve(in1k["pcg_chain_solve"], "1k")
    compare_pcg_chain_solve(in1k["pcg_chain_solve"], "1k planar column mask", cmask=xy,
                            timed=False)
    compare_pcg_chain_solve(in500["pcg_chain_solve"], "epoch 500")
    rows_large["pcg_chain_solve"] = compare_pcg_chain_solve(in10k["pcg_chain_solve"], "10k")
    # K9 at the 10k solve's and the 500-node epoch's first factor (the
    # 1k and 100k ones are in compare_kernels)
    rows["chain_factor_10k"] = compare_chain_factor(in10k["chain_factor"], "10k",
                                                    in10k["chain_factor_damped"], timed=False)
    rows["chain_factor_epoch500"] = compare_chain_factor(in500["chain_factor"], "epoch 500",
                                                         in500["chain_factor_damped"],
                                                         timed=False)
    rows["pcg_chain"] = compare_pcg_chain(in1k["pcg"], "1k")
    compare_pcg_chain(in1k["pcg"], "1k planar column mask", cmask=xy, timed=False)
    compare_pcg_chain(in500["pcg"], "epoch 500")
    rows_large["pcg_chain"] = compare_pcg_chain(in10k["pcg"], "10k")
    del in1k, in10k, in500
    # K37 above K34's cap: the 20k and 100k solves' first PCG, plain, in the
    # generic loop's planar form and on a cutoff-1 factor (a one-block root)
    for n_nodes, target in ((20_000, rows), (100_000, rows_large)):
        g_n = g100k if n_nodes == 100_000 else make_graph(n_nodes, dev)
        in_n = kernel_inputs(g_n, hcfg)
        label = f"{n_nodes // 1000}k"
        target["pcg_grid"] = compare_pcg_grid(in_n["pcg"], label)
        compare_pcg_grid(in_n["pcg"], f"{label} planar column mask", cmask=xy, timed=False)
        Dm, U, _ = in_n["chain_factor"]
        target["pcg_grid"]["cutoff_1"] = compare_pcg_grid(
            in_n["pcg"], f"{label} cutoff 1", pack=kops.chain_factor(Dm, U, 1), timed=False)
        del g_n, in_n
    rows.update(compare_epoch_kernels(epoch_kernel_inputs(built500[1], built500[0]),
                                      "epoch 500"))
    inputs10k = epoch_kernel_inputs(built10k[1], built10k[0])
    rows_large.update(compare_epoch_kernels(inputs10k, "epoch 10k"))
    k5_k6_cases = k5_k6_edge_cases(dev, inputs10k)
    del inputs10k
    # K8's grid route, which the 100k solve takes (the epochs take the CTA route)
    check(components_route(g100k.node_capacity) == "grid", "100k solve: K8 not on its grid route")
    grid = compare_epoch_kernels({"components": components_inputs(g100k)},
                                 "100k solve")["components"]
    k8_solves = {n: compare_epoch_kernels({"components": components_inputs(g)},
                                          f"{n} solve")["components"]
                 for n, g in (("1k", g1k), ("10k", g10k))}
    k8_solves["100k"] = grid
    k8_forms_10k = compare_k8_forms(components_inputs(g10k), "10k solve")
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
    # a covering grid: the 10k-node radius-40 m graph on 1024² cells of 0.1 m
    # (102.4 m), where each node reaches ~62 cells a side and the culling
    # decides the time
    cfg_cover = SlamConfig(node_capacity=10240, edge_capacity=16384,
                           grid=dataclasses.replace(SlamConfig().grid, size=1024, resolution=0.1))
    s_cover = with_scans(pipeline.init_state(cfg_cover, seed=SEED, device=dev).replace(
        graph=synthetic.make_pose_graph(
            10_000, node_capacity=10240, edge_capacity=16384, radius=40.0,
            generator=torch.Generator().manual_seed(SEED), device=dev)[0]), SEED + 9)
    row_cover = compare_project(map_args(s_cover, cfg_cover, None)[1], "10k covering grid",
                                large=True, trials=5, calls=3)
    del s_cover
    # K12-K15 on the arguments the first VGA keyframe gives them (one camera:
    # the main shapes; the front + rear rig: the large ones)
    for n_cams, target in ((1, rows), (2, rows_large)):
        cfg_kf, pose = keyframe_rig(n_cams, dev)
        calls = record_args(lambda: pipeline.keyframe_frontend(
            *frame_inputs(kf_frames[0], n_cams), kf_world.cam, pose, cfg_kf))
        label = f"VGA {n_cams} camera{'s' if n_cams > 1 else ''}"
        check(len(calls["fast_nms"]) == 1 and len(calls["fast_nms"][0][0][0]) == 4,
              f"{label}: K12 not one call on four levels")
        check(len(calls["grid_topk"]) == 1 and len(calls["grid_topk"][0][0][0]) == 4,
              f"{label}: K13 not one call on four levels")
        check(len(calls["orb_describe_levels"]) == 1
              and [len(b) for b in calls["orb_describe_levels"][0][0][0]] == [4, 1],
              f"{label}: K14 not one call on four levels and the GIST")
        target.update(compare_frontend(calls, label))
        target["grid_topk"]["cases"] = compare_grid_topk_cases(calls["grid_topk"], label)
    rows["orb_describe"]["border_frame"] = compare_describe_borders(dev)
    ten_levels = compare_ten_levels(torch.as_tensor(
        np.asarray(kf_frames[0]["image"]), dtype=torch.float32, device=dev)[None], "VGA")
    rows["fast_nms"]["cases"] = compare_fast_nms_cases(fast_nms_cases(dev), "synthetic VGA")

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
    launches, spread_1k = headline_solve(g1k, chi2_oracle_1k, reps=10)
    headline_counts = dict(launches)
    solve_against_oracle(g1k, "5 default early-exit 1k", {}, chi2_oracle_1k, reps=5,
                         profile=True)
    solve_against_oracle(g10k, "6 headline 10k", HEADLINE,
                         oracle_chi2(g10k, iters=20, lm=True), reps=3)
    counts100k, fields100k = solve_against_oracle(g100k, "7 headline 100k", HEADLINE, None, reps=3,
                                                  profile=True)
    check(counts100k["components"] == 1,
          f"7 headline 100k: K8 launched {counts100k['components']} times, not once")
    breakdown100k = old_composition_phase(g100k, "7 headline 100k", counts100k, fields100k)
    breakdown100k["bits"] = solve_bits(
        lambda: solver.optimize(g100k, hcfg), lambda: single_calls(g100k, hcfg),
        "7 headline 100k")
    del g10k

    counts500, state500, k5k6_500 = epoch_phase("8 epoch 500", built500, EPOCH_500["n"], reps=5,
                                                reads=reads, cpu_check=True)
    entry500, entry500_ms = entry_point_phase("8b public entry points 500", built500[1],
                                              built500[0])
    map500 = map_phase("8 map 500", state500, cfg500, reps=5, cpu_check=True)
    counts10k, state10k, k5k6_10k = epoch_phase("9 epoch 10k", built10k, EPOCH_10K["n"], reps=3,
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
    step_calls = record_step_args(slam1, inputs1, kf_frames)
    rows.update(compare_keyframe_kernels(step_calls, "VGA step 1 camera"))
    # K7 with its draw on the step's calls (5 roots x 256 x 128, soft
    # PROSAC), the rig's, and the edge cases; the epoch's are in its row
    ransac_step = compare_ransac_calls(step_calls["ransac_rigid"], "VGA step 1 camera")
    ransac_edges = compare_ransac_draws(ransac_edge_cases(dev), "edge cases")
    rows["hamming_top2"]["cases"] = compare_k16_cases(step_calls, dev)
    rows["bilateral"]["cases"] = compare_bilateral_cases(
        bilateral_cases(dev), "VGA step 1 camera", step_args=step_calls["bilateral"][0][0])
    # K18 beyond the step's call: few valid targets, N = 8192 at batch 1 and
    # 4, bit-identical reruns, and its two launch forms timed
    icp_cases = compare_icp_cases(*step_calls["icp"][0], "VGA step 1 camera")
    del step_calls
    step_calls2 = record_step_args(slam2, inputs2, kf_frames)
    rows_large.update(compare_keyframe_kernels(step_calls2, "VGA step front + rear"))
    ransac_rig = compare_ransac_calls(step_calls2["ransac_rigid"], "VGA step front + rear")
    del step_calls2
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
    # phase 16: the float-descriptor path (K29, K30) on a VGA frame pair;
    # phase 17: the fleet (K1, K2, K8 and the batched entries of K3, K4, K9,
    # K10); each driven with the counts set to 0 just before it, read after
    sift_counts, sift_rows, sift_fields = sift_phase(kf_frames, dev)
    fleet_counts, above_counts, fleet_rows, fleet_fields = fleet_phase(dev)
    # phase 18: the generic loop, the edge-sharded solve (B19, in a world of
    # one and two ranks on the card) and the planar solve (K1's column mask)
    sharded_counts, planar_counts, xy_row, sharded_fields = sharded_phase(
        dev, g1k, g100k, chi2_oracle_1k, spread_1k, fields100k["chi2"], rows, rows_large)
    del g100k
    # phase 19: the scope protocol (K31-K33); its main path is the VGA duo
    scope_counts, scope_rows, scope_rows_large, scope_fields = scope_phase(dev)
    # each kernel's main path: the 1k solve for K1, K4, K9, K35; the 100k
    # solve for K2 and K37 (above K34's cap; the 1k solve's PCG runs on
    # K35); the fleet (17) for K38, the fleet above K38's cap (17c) for K3
    # and K10; the sharded 1k solve (18a) for K34; the 500-node epoch for
    # K5-K8; the projection sequence after it for K11; the first timed
    # keyframe step (phase 11, 1 camera) for K12-K18
    launches["hvp"] = counts100k["hvp"]
    launches.update({name: above_counts[name] for name in SPLIT_PCG})
    launches["pcg_chain"] = sharded_counts["pcg_chain"]
    launches.update({name: counts500[name] for name in EPOCH_KERNELS})
    launches.update({name: entry500[name] for name in ENTRY_KERNELS})
    launches.update({name: map500[name] for name in MAP_KERNELS})
    launches.update({name: step1[name] for name in FRONTEND_KERNELS + KEYFRAME_KERNELS})
    # K19 and bin_min_max: one maintain (13a); K20: one calibrate (13e)
    launches.update(merge_pairs=maint500["merge_pairs"], bin_min_max=maint500["bin_min_max"],
                    calib_gn=calib["calib_gn"])
    # K3's and K10's main shapes are the fleet's above K38's cap (17c), the
    # only path that runs them, and the 4096 x 64 fleet's (17) their large
    # ones; the single 1k chain's beside them
    split_1k = {name: rows.pop(name) for name in SPLIT_PCG}
    rows.update({name: fleet_rows["above_cap"][f"{name}_batch"] for name in SPLIT_PCG})
    rows_large.update({name: fleet_rows[f"{name}_batch"] for name in SPLIT_PCG})
    shapes = {**{k: ("1k solve", "100k solve") for k in SOLVE_KERNELS},
              **{k: ("16 instances x 512 nodes, 1024 edges, cutoff 16 (17c, first iteration)",
                     "4096 instances x 64 nodes, 128 edges, cutoff 16 (first iteration)")
                 for k in SPLIT_PCG},
              "pcg_chain": ("1k solve: one PCG step", "10k solve: one PCG step"),
              "pcg_chain_solve": ("1k solve: one 12-step PCG solve",
                                  "10k solve: one 12-step PCG solve"),
              **{k: ("500-node epoch", "10k-node epoch") for k in EPOCH_KERNELS},
              "relax_min": ("500-node epoch: the heuristic's 256 rows as (B, N) start rows",
                            "10k-node epoch: the heuristic's 256 rows as (B, N) start rows"),
              "cluster_labels": ("500-node epoch's candidates", "10k-node epoch's candidates"),
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
    # K2, K3 and K10: K2's main path is the 100k solve (its main fields the
    # 100k inputs', the 1k ones' beside), K3's and K10's the fleet above
    # K38's cap (17c; the 4096 x 64 fleet takes K38), the single chains'
    # checks beside
    for name in SPLIT_PCG + ("hvp",):
        row = kernels[list(REPLACES).index(name)]
        row.update(launches_headline_1k=headline_counts[name],
                   launches_headline_100k=counts100k[name],
                   launches_fleet_4096x64=fleet_counts[name],
                   launches_fleet_above_cap=above_counts[name])
        if name == "hvp":
            for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms", "shapes"):
                row[f"{k}_1k"] = row[k]
                row[k] = row.pop(f"{k}_large")
            row.update(bound_by=rows_large[name]["bound_by"], launches_from="7 headline 100k",
                       launches_sharded_100k=sharded_fields["100k"]["launches"]["hvp"])
            continue
        row.update({f"{k}_1k": split_1k[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                                           "bound_ms")},
                   launches_from="17c fleet above K38's cap",
                   max_rel_err_single_100k=single100k[name]["max_rel_err"])
    # K34: a step beside the three calls it replaces (K10, K3, K10) on the
    # same vectors, and its start; its main path is the sharded 1k solve
    kernels[list(REPLACES).index("pcg_chain")].update(
        {f"{k}{sfx}": r[k] for sfx, r in (("", rows["pcg_chain"]),
                                          ("_large", rows_large["pcg_chain"]))
         for k in ("three_calls_ms", "start_ms", "smem_bytes_per_cta")},
        launches_from="18a sharded 1k, world of one",
        launches_headline_1k=headline_counts["pcg_chain"])
    # K35: a whole PCG solve beside the calls it replaces (K34's start, then
    # 12 times K2 and K34's step) in turns
    kernels[list(REPLACES).index("pcg_chain_solve")].update(
        {f"{k}{sfx}": r[k] for sfx, r in (("", rows["pcg_chain_solve"]),
                                          ("_large", rows_large["pcg_chain_solve"]))
         for k in ("replaced_ms", "replaced_over_fused", "ok_pattern")})
    # K1: beside the atomic kernel it replaced, in turns
    kernels[list(REPLACES).index("linearize")].update(
        {f"{k}{sfx}": r[k] for sfx, r in (("", rows["linearize"]),
                                          ("_large", rows_large["linearize"]))
         for k in ("ms_beside_atomic", "atomic_ms", "jacobians_bit_equal_to_atomic",
                   "rerun_bit_identical")})
    # K9's plain version in the reference's float32, beside the float64 one
    kernels[list(REPLACES).index("chain_factor")].update(
        plain_float32_ms=rows["chain_factor"]["plain_float32_ms"],
        plain_float32_ms_large=rows_large["chain_factor"]["plain_float32_ms"])
    # K11 on the incremental pass (8 new nodes) after the 500-node rebuild
    kernels[list(REPLACES).index("project_rays")].update(
        ms_incremental=row_inc["ms"], plain_ms_incremental=row_inc["plain_ms"],
        bound_ms_incremental=row_inc["bound_ms"], max_abs_err_incremental=row_inc["max_abs_err"],
        # the device and queued ms, and the bound as counted over every
        # on-grid pair (in reach or not) beside the reach-culled one
        **{f"{k}{sfx}": r[k] for sfx, r in (("", rows["project_rays"]),
                                            ("_large", rows_large["project_rays"]),
                                            ("_incremental", row_inc))
           for k in ("device_ms", "device_ms_queued", "pairs_in_reach", "pairs_on_grid",
                     "bound_ms_on_grid_pairs")},
        # the covering grid: 10k nodes on 1024² cells of 0.1 m
        cover={k: row_cover.get(k) for k in (
            "ms", "plain_ms", "device_ms", "device_ms_queued", "bound_ms", "bound_by",
            "bound_ms_on_grid_pairs", "pairs_in_reach", "pairs_on_grid", "max_abs_err",
            "worst_cell_err", "worst_cell_bound", "ternary_differ", "nodes")})
    # K8: the rounds it ran against n_iters, the 1k / 10k / 100k solves'
    # calls, and its two forms at 10k (one CTA; the cooperative grid forced)
    kernels[list(REPLACES).index("components")].update(
        {f"{k}{sfx}": r.get(k) for sfx, r in (("", rows["components"]),
                                              ("_large", rows_large["components"]))
         for k in ("rounds", "n_iters", "device_ms", "device_ms_queued")},
        form=rows["components"]["route"], form_large=rows_large["components"]["route"],
        solves={n: {k: r.get(k) for k in ("ms", "plain_ms", "device_ms", "device_ms_queued",
                                          "bound_ms", "rounds", "n_iters", "route")}
                for n, r in k8_solves.items()},
        forms_10k=k8_forms_10k)
    # K12 and K13 on ten pyramid levels (two launches each)
    for name in ("fast_nms", "grid_topk"):
        kernels[list(REPLACES).index(name)]["ten_levels"] = ten_levels
    # K6's grid route (B > 256): B = 300, 1,024 and 4,096
    for name in ("cluster_roots", "cluster_labels"):
        kernels[list(REPLACES).index(name)]["grid_route"] = {
            b: r[name] for b, r in k5_k6_cases["grid_route"].items()}
    # K12-K15: device time of one profiled keyframe (phase 10), beside the
    # event-timed wrapper calls of phase 3, which include the host's issue;
    # K12-K18: device time of one profiled keyframe step (phase 11)
    for name in FRONTEND_KERNELS:
        kernels[list(REPLACES).index(name)].update(
            device_ms_keyframe=kf1_fields["kernel_device_ms"].get(name),
            device_ms_keyframe_large=kf2_fields["kernel_device_ms"].get(name))
    for name in FRONTEND_KERNELS + KEYFRAME_KERNELS + ("ransac_rigid",):
        kernels[list(REPLACES).index(name)].update(
            device_ms_step=step1_fields["kernel_device_ms"].get(name),
            device_ms_step_large=step2_fields["kernel_device_ms"].get(name))
    # K7: the step's calls, the rig's and the edge cases beside its epoch
    # rows (its draw in each); the epoch's calls queued back to back
    kernels[list(REPLACES).index("ransac_rigid")].update(
        step=ransac_step, rig=ransac_rig, edge_cases=ransac_edges,
        draw=rows["ransac_rigid"]["draw"], draw_large=rows_large["ransac_rigid"]["draw"],
        device_ms_queued=rows["ransac_rigid"]["device_ms_queued"],
        device_ms_queued_large=rows_large["ransac_rigid"]["device_ms_queued"])
    kernels[list(REPLACES).index("bin_min_max")].update(
        cases=rows["bin_min_max"]["cases"])
    # K13's other budgets on the keyframe's four levels; K18's device ms at
    # the re-registration's B = 4 and its held cases
    kernels[list(REPLACES).index("grid_topk")].update(
        cases={k: v for k, v in rows["grid_topk"]["cases"].items()
               if k != "device_kernels_10_calls"})
    # K12: its synthetic cases, the SIFT pair's levels (launches a pair), and
    # the keyframe's calls queued back to back; K17: its cases and paths
    kernels[list(REPLACES).index("fast_nms")].update(
        cases=rows["fast_nms"]["cases"], sift_pair=sift_fields["fast_nms_pair"],
        launches_sift_pair=sift_counts["fast_nms"],
        device_ms_queued=rows["fast_nms"]["device_ms_queued"],
        device_ms_queued_large=rows_large["fast_nms"]["device_ms_queued"])
    kernels[list(REPLACES).index("bilateral")].update(
        cases=rows["bilateral"]["cases"], max_ulps=rows["bilateral"]["max_ulps"],
        device_ms_queued=rows["bilateral"]["device_ms_queued"],
        device_ms_queued_large=rows_large["bilateral"]["device_ms_queued"])
    # K14: its one call's rows and the border frame; K16: its device ms by
    # entry in the profiled step, its tie-heavy cases, and the GIST query's
    # cost up to a 100k-node bank (14b)
    kernels[list(REPLACES).index("orb_describe")].update(
        rows=rows["orb_describe"]["rows"], rows_large=rows_large["orb_describe"]["rows"],
        border_frame=rows["orb_describe"]["border_frame"])
    kernels[list(REPLACES).index("hamming_top2")].update(
        device_ms_step_by_entry=step1_fields["hamming_top2_device_ms_by_entry"],
        device_ms_step_by_entry_large=step2_fields["hamming_top2_device_ms_by_entry"],
        cases=rows["hamming_top2"]["cases"],
        gist_query_by_nodes={r["nodes"]: r["gist"] for r in rec_fields["cost"]["sizes"]})
    kernels[list(REPLACES).index("icp")].update(
        device_ms_b4=rereg_fields["icp_device_ms"],
        cases={k: {f: v[f] for f in ("batch", "N", "pose_max_abs_err", "same_ok",
                                     "rerun_bit_identical")}
               for k, v in icp_cases.items()})
    # K37: its main path is phase 7's 100k solve, its main shapes that
    # solve's first PCG step, beside the three calls it replaces (K10, K3,
    # K10) in turns; the 20k solve's beside it
    r37, r37_20k = rows_large["pcg_grid"], rows["pcg_grid"]
    kernels.append(
        {"name": "pcg_grid", "route": "cuda", "source": PCG_GRID_SOURCE,
         "replaces": PCG_GRID_REPLACES, "launches": counts100k["pcg_grid"],
         "launches_from": "7 headline 100k",
         "launches_sharded_100k": sharded_fields["100k"]["launches"]["pcg_grid"],
         "max_abs_err": r37["max_abs_err"], "ms": r37["ms"], "plain_ms": r37["plain_ms"],
         "bound_ms": r37["bound_ms"], "bound_by": r37["bound_by"], "library_ms": None,
         "shapes": "100k solve: one PCG step (11 levels, a 64-block root)",
         "device_ms": r37["device_ms"], "three_calls_ms": r37["three_calls_ms"],
         "three_calls_device_ms": r37["three_calls_device_ms"], "start_ms": r37["start_ms"],
         "ctas": r37["ctas"],
         "max_rel_err_cutoff_1": r37["cutoff_1"]["max_rel_err"],
         "max_abs_err_large": r37_20k["max_abs_err"], "ms_large": r37_20k["ms"],
         "plain_ms_large": r37_20k["plain_ms"], "bound_ms_large": r37_20k["bound_ms"],
         "device_ms_large": r37_20k["device_ms"],
         "three_calls_ms_large": r37_20k["three_calls_ms"], "library_ms_large": None,
         "shapes_large": "20k solve: one PCG step (9 levels, a 64-block root)"})
    # K38: its main path is phase 17's fleet solve, its shapes the fleet's
    # first PCG solve, beside the K2 + K10 + K3 solve it replaces in turns
    r38 = fleet_rows["pcg_fleet_solve"]
    kernels.append(
        {"name": "pcg_fleet_solve", "route": "cuda", "source": PCG_FLEET_SOURCE,
         "replaces": PCG_FLEET_REPLACES, "launches": fleet_counts["pcg_fleet_solve"],
         "launches_from": "17 fleet",
         "launches_default_config":
             fleet_fields["default_config"]["launches"]["pcg_fleet_solve"],
         "max_abs_err": r38["max_abs_err"], "ms": r38["ms"], "plain_ms": r38["plain_ms"],
         "bound_ms": r38["bound_ms"], "bound_by": r38["bound_by"], "library_ms": None,
         "shapes": "4096 instances x 64 nodes, 128 edges, cutoff 16: one 8-step PCG solve",
         **{k: r38[k] for k in ("device_ms", "device_ms_queued", "replaced_ms",
                                "replaced_device_ms",
                                "rel_err_steps_0_1_2_3", "rel_err_vs_float64",
                                "plain_rel_err_vs_float64", "rerun_bit_identical",
                                "smem_bytes_per_cta")}})
    # K8's second form, from the same source: one cooperative launch over
    # the card where 12·N + 4·⌈N/32⌉ bytes exceed one CTA's shared memory;
    # its main path is phase 7's 100k solve
    kernels.append(
        {"name": "components_grid", "route": "cuda", "source": SOURCE["components"],
         "replaces": REPLACES["components"], "launches": counts100k["components"],
         "max_abs_err": grid["max_abs_err"], "ms": grid["ms"], "plain_ms": grid["plain_ms"],
         "bound_ms": grid["bound_ms"], "bound_by": grid["bound_by"], "library_ms": None,
         "device_ms_call": grid.get("device_ms"), "device_ms_queued": grid.get("device_ms_queued"),
         "rounds": grid.get("rounds"), "n_iters": grid.get("n_iters"),
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
             "library_ms_large": rl["library_ms"], "shapes_large": shapes14[name][1],
             # K21 / K22: one device launch a call, the bound at the int8
             # tensor line and as stated for the scalar form, the edge
             # cases' mismatches
             **{f"{key}{suffix}": row[key] for suffix, row in (("", r), ("_large", rl))
                for key in row if key.endswith(("device_launches_a_call", "queued_device_ms"))
                or key in ("bound_ms_int8_line", "bound_ms_scalar")}})
    for e in kernels[-4:-2]:
        e["edge_case_mismatches"] = sum(
            c.get("mismatches", 0) for key, c in rec_fields["k21_k22_cases"].items()
            if key.split()[0] in RECOGNITION_WRAPPERS[e["name"]])
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
    # K29, K30: the main path is phase 16's frame pair; the main shapes
    # level 0's keypoints (K29) and the 300 x 300 match (K30)
    shapes16 = {"sift_describe": "VGA level 0: 480x640, 75 keypoints (4 levels: 8 calls a pair)",
                "l2_top2": "300 x 300 SIFT descriptors of 128 floats"}
    for name in SIFT_KERNELS:
        r = sift_rows[name]
        kernels.append(
            {"name": name, "route": "cuda", "source": f"uzliti_slam_tpu_torch/csrc/{name}.cu",
             "replaces": SIFT_REPLACES[name], "launches": sift_counts[name],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "shapes": shapes16[name],
             "device_ms_path": sift_fields["kernel_device_ms"][name]})
    kernels[-2]["ms_all_levels"] = sift_rows["sift_describe"]["ms_all_levels"]
    # the batched entries: the main path is phase 17's fleet solve at the
    # rung's configuration; the shapes the fleet's first iteration
    for name in FLEET_KERNELS:
        r = fleet_rows[name]
        kernels.append(
            {"name": name, "route": "cuda", "source": FLEET_SOURCE[name],
             "replaces": FLEET_REPLACES[name],
             # K2, K3 and K10 run only in a fleet above K38's cap (17c)
             "launches": (above_counts if FLEET_KERNEL[name] in FLEET_SPLIT
                          else fleet_counts)[FLEET_KERNEL[name]],
             "launches_fleet_4096x64": fleet_counts[FLEET_KERNEL[name]],
             "launches_default_config":
                 fleet_fields["default_config"]["launches"][FLEET_KERNEL[name]],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
             "shapes": "4096 instances x 64 nodes, 128 edges, cutoff 16 (first iteration)"})
    # the solve kernels' launches in one sharded 1k solve and one planar one
    for entry in kernels:
        if entry["name"] in SOLVE_KERNELS + ("components",):
            entry.update(launches_sharded_1k=sharded_counts[entry["name"]],
                         launches_planar_1k=planar_counts[entry["name"]])
    # K1's column mask: the main path is phase 18's planar solve
    kernels.append(
        {"name": "linearize_xy", "route": "cuda", "source": SOURCE["linearize"],
         "replaces": PLANAR_REPLACES, "launches": planar_counts["linearize"],
         "max_abs_err": xy_row["max_abs_err"], "ms": xy_row["ms"], "plain_ms": xy_row["plain_ms"],
         "bound_ms": xy_row["bound_ms"], "bound_by": xy_row["bound_by"], "library_ms": None,
         "shapes": "1k planar solve, first linearization (column mask 1, 1, 0, 0, 0, 1)"})
    # K31-K33: the main path is phase 19b's VGA duo (48 frames, 12 rounds);
    # the main shapes a round of it, the large ones 19a's 100k apply_delta
    # and the 1k apply_ack / apply_scope
    shapes19 = ("VGA duo round: 32-row delta into the global (512 slots), 32-row reply",
                "32-node / 64-edge delta into a 100k-node global graph; 32-row ACK and reply "
                "on a 1k-node local graph")
    for name in SCOPE_KERNELS:
        r, rl = scope_rows[name], scope_rows_large[name]
        kernels.append(
            {"name": name, "route": "cuda", "source": SCOPE_SOURCE[name],
             "replaces": SCOPE_REPLACES[name], "launches": scope_counts[name],
             "launches_round": scope_fields["duo_vga"]["launches_round"][name],
             "launches_apply_delta_100k":
                 scope_fields["apply"]["apply_delta"]["launches_per_call"][name],
             "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
             "shapes": shapes19[0],
             "device_ms_round": scope_fields["duo_vga"]["kernel_device_ms_round"].get(name),
             "max_abs_err_large": rl["max_abs_err"], "ms_large": rl["ms"],
             "plain_ms_large": rl["plain_ms"], "bound_ms_large": rl["bound_ms"],
             "library_ms_large": None, "shapes_large": shapes19[1]})
    # K5's and K6's entries: device ms in a profiled epoch (500 / 10k), a
    # call's device ms (10 profiled calls) and queued; K5's rows entry and
    # K6's labels entry counted and profiled on the public entry points
    # (8b); the edge cases
    for name in K5_K6:
        entry = kernels[list(REPLACES).index(name)]
        entry.update(device_ms_call=rows[name]["device_ms"],
                     device_ms_call_large=rows_large[name]["device_ms"],
                     device_ms_queued=rows[name]["device_ms_queued"],
                     device_ms_queued_large=rows_large[name]["device_ms_queued"])
        if name in ENTRY_KERNELS:
            entry.update(launches_from="8b public entry points on the 500-node epoch's state",
                         device_ms_entry_points=entry500_ms[name])
        else:
            entry.update(device_ms_epoch_500=k5k6_500[name], device_ms_epoch_10k=k5k6_10k[name])
    kernels[list(REPLACES).index("relax_pairs")]["edge_cases"] = k5_k6_cases
    check(len(kernels) == 56, f"{len(kernels)} kernel entries")
    check(all(e["launches"] > 0 for e in kernels
              if e["name"] in SOLVE_KERNELS + ("pcg_grid", "pcg_fleet_solve")),
          f"a solve kernel's main path did not launch it: "
          f"{[(e['name'], e['launches']) for e in kernels if e['name'] in SOLVE_KERNELS]}")
    unmatched = unmatched_device_functions()
    log("device functions", profiled_kernels=sorted(PROFILED_KERNELS), unmatched=unmatched,
        profiles_holding_the_warmup_kernel=WARMUP_SEEN)
    check(not unmatched, f"device functions no profile matched: {unmatched}")
    print(json.dumps({"kernels": kernels, "ate": ate,
                      "maintenance": {"merge_500": merge_fields, "merge_10k": merge10k,
                                      "long_run": long_run, "reregistration": rereg_fields,
                                      "calibration": calib_fields},
                      "recognition": rec_fields, "estimation": est_fields,
                      "sift": sift_fields, "fleet": fleet_fields, "sharded": sharded_fields,
                      "scope": scope_fields, "solve_100k": breakdown100k}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sys.exit(sharded_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]))
    if sys.argv[1:2] == ["--overhead"]:
        sys.exit(overhead_worker(sys.argv[2]))
    sys.exit(main())
