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
   the JAX package's largest CPU result over seeds.

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
SOURCE = {k: f"uzliti_slam_tpu_torch/csrc/{k}.cu" for k in REPLACES}
SOURCE["project_rays"] = "uzliti_slam_tpu_torch/csrc/occupancy.cu"
SOLVE_KERNELS = ("linearize", "hvp", "chain_apply", "residual_chi2", "chain_factor", "pcg")
EPOCH_KERNELS = ("relax_min", "cluster_labels", "ransac_rigid", "components")
MAP_KERNELS = ("project_rays",)
FRONTEND_KERNELS = ("fast_nms", "grid_topk", "orb_describe", "scan_bins")
# the keyframe step's own kernels; K16 has two wrappers (matching, GIST query)
KEYFRAME_KERNELS = ("hamming_top2", "bilateral", "icp")
KEYFRAME_WRAPPERS = {"hamming_top2": ("hamming_top2", "gist_topk"), "bilateral": ("bilateral",),
                     "icp": ("icp",)}
STEP_KERNELS = FRONTEND_KERNELS + KEYFRAME_KERNELS + ("ransac_rigid",)
# the device functions each front-end kernel's wrapper launches
FRONTEND_DEVICE_FUNCTIONS = {"fast_nms": ("fast_nms_tile",), "grid_topk": ("cell_topk", "global_topk"),
                             "orb_describe": ("box_blur", "describe"),
                             "scan_bins": ("init_table", "scan_pixels", "finalize"),
                             "hamming_top2": ("match_top2", "gist_rounds"),
                             "bilateral": ("bilateral_tile",), "icp": ("icp_problems",),
                             "ransac_rigid": ("ransac_roots",)}
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
ATE_JAX_CPU_MAX_M = 0.012344205752015114
ATE_BAR_M = 1.1 * ATE_JAX_CPU_MAX_M


def log(phase: str, **fields) -> None:
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

def time_pair(kernel_fn, plain_fn, trials: int = 21, calls: int = 10):
    """Median ms per call of two functions on the card, in alternating
    trials (plain, kernel, kernel, plain, ...) timed with CUDA events."""
    def one(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    for fn in (kernel_fn, plain_fn):
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
                    "gist_rounds", "bilateral_tile", "icp_problems")


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
                **{k: 0 for k in FRONTEND_KERNELS + KEYFRAME_KERNELS}}
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
        s_cpu, st_cpu = pipeline.optimize_epoch(to_cpu(state), cfg, tri=tri.cpu())
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


def to_cpu(state):
    """A SlamState's graph and scans on CPU tensors (a fresh generator)."""
    return state.replace(graph=state.graph.to("cpu"), generator=torch.Generator(),
                         scans=state.scans.cpu(), scan_valid=state.scan_valid.cpu())


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
            grid_c = pipeline.project_map(to_cpu(st), cfg, grid_c)
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
    nbytes = ops = 0
    for args, kw in calls:
        b, o = kernel_work(name, (*args, *kw.values()))
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
        nbytes = ops = 0
        for w in wrappers:
            for args, kw in calls[w]:
                b_, o_ = kernel_work(w, (*args, *kw.values()))
                nbytes, ops = nbytes + b_, ops + o_
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
        row.update({"bytes": nbytes, "ops": ops, "bound_ms": 1e3 * max(t_bytes, t_ops),
                    "bound_by": "bytes" if t_bytes >= t_ops else "operations"})
        log(f"3 kernel {name} {label}", **row)
        check(mism == 0, f"{name} {label}: {mism} entries differ from the plain version")
        if name == "bilateral":
            check(err <= BILATERAL_ULPS, f"{name} {label}: {err} ulps from the plain version")
        if name == "icp":
            check(ok_same and err <= ICP_POSE_ATOL, f"{name} {label}: pose {err}, same ok {ok_same}")
        rows[name] = row
    return rows


def step_config(n_cams: int, device):
    """(config, extrinsics) of the JAX bench's keyframe rungs in the default
    configuration (``_make_slam``, bench.py:283-309): 256 features, 360 bins,
    node capacity 512, edge capacity 2048, keyframe gate 0 m / 0°,
    min_consensus 10, min_matching_score 8."""
    from uzliti_slam_tpu_torch.config import EdgeEstimationConfig, KeyframeConfig, SlamConfig

    _, pose = keyframe_rig(n_cams, device)
    cfg = SlamConfig(node_capacity=512, edge_capacity=2048, feats_per_node=KEYFRAME_VGA["feats"],
                     scan_bins=KEYFRAME_VGA["scan_bins"],
                     keyframe=KeyframeConfig(new_node_distance=0.0, new_node_angle_deg=0.0),
                     estimation=EdgeEstimationConfig(min_consensus=10, min_matching_score=8.0))
    return cfg, pose


def recorded_draws(draws: list, replay: list | None = None):
    """A stand-in for ``ransac._valid_sample`` that records each draw into
    ``draws``, or, given ``replay``, returns those draws in order (on the
    caller's device)."""
    from uzliti_slam_tpu_torch.ops import ransac

    original = ransac._valid_sample

    def sample(generator, k_hyp, valid, quality=None, beta=4.0):
        if replay is not None:
            return replay.pop(0).to(valid.device)
        out = original(generator, k_hyp, valid, quality, beta)
        draws.append(out)
        return out
    return original, sample


def slam_structure(slam) -> dict:
    """Nodes, edges and flags of a Slam's graph, on the host."""
    g = slam.state.graph
    n, ne = int(g.num_nodes), int(g.num_edges)
    return {"n": n, "ne": ne, **{k: getattr(g, k)[:ne].cpu() for k in
                                 ("e_from", "e_to", "e_type", "e_valid", "e_transform")},
            "node_valid": g.node_valid[:n].cpu(), "node_uid": g.node_uid[:n].cpu()}


def keyframe_step_phase(phase: str, world, frames, n_cams: int, device, reps: int = 10):
    """Phase 11: ``Slam.add_frame`` over the rung's 13 frames in the default
    configuration: 3 warm-up keyframes, then ``reps`` timed keyframes each
    under CUDA sync debug mode "error", the counts set to 0 just before
    them and read after the first and after the last; a profile of one
    more step; the same frames on CPU tensors through the plain path with
    the card's RANSAC draws. Returns (the counts of the first timed step,
    fields, the Slam, its frame inputs)."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.graph import state as gstate
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.ops import ransac

    cfg, pose = step_config(n_cams, device)
    warm = KEYFRAME_VGA["warmup"]
    inputs = [frame_inputs(fr, n_cams) for fr in frames]
    slam = pipeline.Slam(cfg, cam=world.cam, cam_pose=pose, device=device)
    slam.optimize_every = 10**9
    draws: list = []
    original, sample = recorded_draws(draws)
    ransac._valid_sample = sample
    infos, times = [], []
    try:
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
    finally:
        ransac._valid_sample = original
    counts = {k: total[k] / reps for k in STEP_KERNELS}
    last = len(frames) - 1
    prof, device_ms = device_profile(lambda: pipeline.process_keyframe(
        slam.state, *inputs[last], frames[last]["odom_pose"], frames[last]["stamp"], slam.cam,
        slam.cam_pose, slam.config))
    t = statistics.median(times)
    half = len(frames) // 2
    proposed = [int(i["n_edges_proposed"]) for i in infos]
    struct = slam_structure(slam)
    lc = struct["e_type"] == gstate.EDGE_TYPE_3D_FULL
    fields = {"n_cams": n_cams, "keyframe_step_ms": 1e3 * t, "keyframes_per_s": 1.0 / t,
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
        for name in STEP_KERNELS}
    # the same frames on CPU tensors through the plain path, with the card's draws
    cpu = pipeline.Slam(cfg, cam=world.cam, cam_pose=pose.cpu(), device="cpu")
    cpu.optimize_every = 10**9
    replay = list(draws)
    original, sample = recorded_draws([], replay)
    ransac._valid_sample = sample
    try:
        cpu_infos = [cpu.add_frame(*inputs[i], frames[i]["odom_pose"], frames[i]["stamp"])
                     for i in range(len(frames))]
    finally:
        ransac._valid_sample = original
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
    check(all(total[k] > 0 for k in STEP_KERNELS), f"{phase}: a kernel was not launched: {total}")
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
    del built10k, state10k
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
    del slam1, slam2
    ate = ate_phase("12 end to end ATE 96x128", dev)
    # each kernel's main path: the 1k solve for K1-K4, K9, K10; the 500-node
    # epoch for K5-K8; the projection sequence after it for K11; the first
    # timed keyframe step (phase 11, 1 camera) for K12-K18
    launches.update({name: counts500[name] for name in EPOCH_KERNELS})
    launches.update({name: map500[name] for name in MAP_KERNELS})
    launches.update({name: step1[name] for name in FRONTEND_KERNELS + KEYFRAME_KERNELS})
    shapes = {**{k: ("1k solve", "100k solve") for k in SOLVE_KERNELS},
              **{k: ("500-node epoch", "10k-node epoch") for k in EPOCH_KERNELS},
              "project_rays": ("500-node full rebuild", "10k-node full rebuild"),
              **{k: ("VGA keyframe, 1 camera", "VGA keyframe, front + rear rig")
                 for k in FRONTEND_KERNELS},
              **{k: ("VGA keyframe step, 1 camera", "VGA keyframe step, front + rear rig")
                 for k in KEYFRAME_KERNELS}}

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
         "launches": launches[name], "launches_epoch_500": counts500[name],
         "launches_epoch_10k": counts10k[name], "launches_map_500": map500[name],
         "launches_map_10k": map10k[name], "launches_keyframe_1cam": kf1.get(name, 0),
         "launches_keyframe_2cam": kf2.get(name, 0),
         "launches_step_1cam": step1_fields["launches_per_step"].get(name, 0),
         "launches_step_2cam": step2_fields["launches_per_step"].get(name, 0),
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
    print(json.dumps({"kernels": kernels, "ate": ate}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
