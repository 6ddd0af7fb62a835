#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port on one GPU: the pose-graph solve and the
optimization epoch.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (Hopper,
``sm_90a``) and ``nvcc``.  It builds the port's kernels from ``csrc/`` (one
``nvcc`` per source, all at once) into ``build/uzliti_slam_tpu_torch/`` and
runs, in order, each phase printing lines of its own:

1. the environment: torch and CUDA versions, nvcc, the card's name and
   power limit (nvidia-smi);
2. the kernels' build, timed, and the two epoch graphs;
3. each solve kernel (K1 linearize, K2 hvp, K3 chain_apply, K4
   residual_chi2) against its plain PyTorch version on the card, on the
   inputs the solve gives it on a generated 1k-node and 100k-node graph,
   and each epoch kernel (K5 relax_min, K6 cluster_labels, K7 ransac_rigid,
   K8 components) on the inputs the 500-node and 10k-node epochs give it,
   and K8's grid route on the 100k-node solve's inputs: error against a
   stated tolerance, the median time of both, and the least time the card
   could take for the work this data needs;
4. the 1k-node headline solve (20 LM x 12 PCG, chain factor refreshed every
   5, fixed iteration count) through ``optimize``: launch counts of one
   solve, no host synchronisation inside the timed solves (CUDA sync debug
   mode "error"), final χ² against the same solve on CPU tensors and
   against the sparse oracle, median solve time;
5. the library default ``SolverConfig()`` (early exit) at 1k nodes against
   the oracle;
6. the headline configuration at 10k nodes against the oracle (LM);
7. the headline configuration at 100k nodes: time, finite χ² below χ²₀,
   K8 launched on its grid route;
8. the 500-node RGB-D + laser epoch (``pipeline.optimize_epoch`` with the
   live ``SlamConfig``): launch counts per kernel, sync-free timed epochs
   except the one restart read, the planted bad laser edge rejected, laser
   edges validated, χ² and ATE against ground truth and odometry, and the
   same epoch on CPU tensors through the plain path with the same RANSAC
   draws;
9. the same epoch at 10k nodes: time, finite, χ² below χ²₀.

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
KERNEL_TOL = {"linearize": 1e-3, "hvp": 1e-4, "chain_apply": 1e-4, "residual_chi2": 1e-4}
RELAX_MAX_ULP = 1
RANSAC_POSE_ATOL = 1e-4      # refit pose, per component
RANSAC_NEAR_REL = 1e-5       # a point this close to the inlier radius may flip
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
}
SOURCE = {k: f"uzliti_slam_tpu_torch/csrc/{k}.cu" for k in REPLACES}
SOLVE_KERNELS = ("linearize", "hvp", "chain_apply", "residual_chi2")
EPOCH_KERNELS = ("relax_min", "cluster_labels", "ransac_rigid", "components")
# The card's published peaks (H100 SXM at 700 W):
# device memory 3.35 TB/s; float32 outside the tensor cores 67 TFLOP/s, the
# rate used here for every scalar operation (float32 or int32).
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# The JAX bench's epoch rung (bench.py:393-422), and 10k nodes at the same
# ~0.5 m keyframe spacing (radius scaled by 20)
EPOCH_500 = dict(n=500, node_capacity=512, edge_capacity=4096, radius=2.0)
EPOCH_10K = dict(n=10_000, node_capacity=10240, edge_capacity=32768, radius=40.0)


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
                    "chain_forward", "chain_backward", "residual_edges", "sum_partials",
                    "relax_rows", "cluster_rounds", "ransac_roots", "components_cta",
                    "gauge_cta", "k_init_labels", "k_scatter_min", "k_jump_out", "k_jump",
                    "k_gauge_init", "k_gauge_reduce_stamp", "k_gauge_reduce_slot",
                    "k_gauge_write")


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


def device_profile(fn) -> dict:
    """One profiled call: wall ms, summed device-kernel ms, the busy share
    they give, and the five kernels with the most device time."""
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
        return {"profile": "not measured (no device time in the trace)"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {"profiled_wall_ms": 1e3 * wall, "device_kernel_ms": dev_us / 1e3,
            "device_busy_share": dev_us / 1e6 / wall,
            "device_launches": sum(e.count for e in kernels),
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top}}


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
    """The inputs each solve kernel gets in the first LM iteration."""
    from uzliti_slam_tpu_torch.graph import solver

    free = (g.node_valid & ~solver.gauge_fix_mask(g, solver.connected_components(g))).float()
    p = solver._Problem(g, free, cfg)
    gen = torch.Generator().manual_seed(SEED + 1)
    r0, _ = p.residuals(g.pose)
    Ji, Jj, W, grad, Hb, U = p.linearize(r0)
    lam = torch.full((), cfg.lambda_init, device=g.device)
    damp = p.damp(lam, Hb)
    pack = p.build_pack(Hb, U, damp)
    v = torch.randn(g.node_capacity, 6, generator=gen).to(g.device)
    return {
        "residual_chi2": (g.pose, g.e_from, g.e_to, g.e_transform, g.e_info, p.valid,
                          cfg.huber_delta),
        "linearize": (r0, p.adj_meas_inv, g.e_info, p.valid, g.e_from, g.e_to, free,
                      p.both_free, p.is_chain, cfg.huber_delta),
        "hvp": (Ji, Jj, W, g.e_from, g.e_to, v, damp, free),
        "chain_apply": (pack, -grad),
    }


def compare_kernels(g, label: str):
    """Each solve kernel against its plain version on the same card inputs."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops

    inputs = kernel_inputs(g, solver.SolverConfig(**HEADLINE))
    results = {}
    for name, args in inputs.items():
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
    return results


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
    expected = {"linearize": 24, "hvp": 240, "chain_apply": 260, "residual_chi2": 22,
                "relax_min": 0, "cluster_labels": 0, "ransac_rigid": 0, "components": 2}
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
    log("4 headline 1k", solve_ms=1e3 * t, solves_per_s=1.0 / t, chi2_0=chi2_0,
        chi2=chi2, chi2_run_to_run_spread=spread, chi2_cpu_plain=chi2_cpu,
        chi2_oracle=chi2_oracle, ratio_vs_oracle=chi2 / chi2_oracle, launches=counts,
        accepted=int(st.accepted.sum()), sync_free=True,
        **device_profile(lambda: solver.optimize(g, cfg)))
    check(abs(chi2 - chi2_cpu) <= CHI2_RTOL * chi2_cpu + 1e-6 * chi2_0,
          f"1k χ² {chi2} vs CPU plain path {chi2_cpu}")
    check(chi2 <= ORACLE_FACTOR * chi2_oracle + ORACLE_ATOL,
          f"1k χ² {chi2} vs oracle {chi2_oracle}")
    return counts


def oracle_chi2(g, **kw) -> float:
    from uzliti_slam_tpu_torch.graph import oracle, solver

    g_cpu = g.to("cpu")
    return float(solver.total_chi2(g_cpu, oracle.sparse_gn_oracle(g_cpu, **kw), 1.0))


def solve_against_oracle(g, phase: str, cfg_kw: dict, chi2_oracle, reps: int):
    """Phases 5-7: a warm-up solve with the counts set to 0 just before it
    and read just after; timed, sync-free solves; χ² against the oracle (if
    any).  Returns the warm-up's launch counts."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops

    cfg = solver.SolverConfig(**cfg_kw)
    kops.reset_launches()
    solver.optimize(g, cfg)                  # warm-up at this size
    counts = dict(kops.launches)
    t, (g2, st) = timed_solves(solver.optimize, g, cfg, reps=reps)
    hist = st.chi2_history.cpu()
    chi2_0, chi2 = float(hist[0]), float(hist[-1])
    chi2_poses = float(solver.total_chi2(g, g2.pose, cfg.huber_delta))
    fields = dict(n_nodes=int(g.num_nodes), solve_ms=1e3 * t, solves_per_s=1.0 / t,
                  chi2_0=chi2_0, chi2=chi2, chi2_of_poses=chi2_poses,
                  accepted=int(st.accepted.sum()), launches=counts,
                  components_route=components_route(g.node_capacity))
    if chi2_oracle is not None:
        fields.update(chi2_oracle=chi2_oracle, ratio_vs_oracle=chi2 / chi2_oracle)
    log(phase, **fields)
    check(torch.isfinite(g2.pose).all().item() and chi2 == chi2, f"{phase}: non-finite")
    check(chi2 < chi2_0, f"{phase}: χ² {chi2} not below χ²₀ {chi2_0}")
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
    it and read just after; timed epochs; the filter's verdict, χ², ATE and
    uncertainty checked; with ``cpu_check``, the same epoch on CPU tensors
    through the plain path with the same RANSAC draws, and a profile."""
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.graph import state as gstate
    from uzliti_slam_tpu_torch.io import synthetic
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.ops import ransac

    cfg, state, gt, bad_slot = built
    timed_epochs(state, cfg, reps=1)                 # warm-up at this size
    kops.reset_launches()
    reads.clear()
    timed_epochs(state, cfg, reps=1)
    counts, restart = dict(kops.launches), list(reads)
    check(all(counts[k] > 0 for k in REPLACES), f"{phase}: a kernel was not launched: {counts}")
    check(len(restart) == 1, f"{phase}: {len(restart)} restart reads, expected 1")
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
                  uncertainty_max=float(unc.max()), sync_free_but_restart_read=True)
    same_valid, c_gpu, c_cpu = True, 0.0, 0.0
    if cpu_check:
        member = pipeline.epoch_ransac_members(state, cfg)
        tri = ransac._valid_sample(torch.Generator(device=member.device).manual_seed(SEED + 2),
                                   cfg.filter.ransac_hypotheses, member)
        s_gpu, st_gpu = pipeline.optimize_epoch(state, cfg, tri=tri)
        s_cpu, st_cpu = pipeline.optimize_epoch(
            pipeline.SlamState(graph=state.graph.to("cpu"), generator=torch.Generator()), cfg,
            tri=tri.cpu())
        c_gpu, c_cpu = float(st_gpu.chi2_history[-1]), float(st_cpu.chi2_history[-1])
        same_valid = torch.equal(s_gpu.graph.e_valid.cpu(), s_cpu.graph.e_valid)
        fields.update(cpu_plain_same_e_valid=same_valid, chi2_injected_draws=c_gpu,
                      chi2_cpu_plain=c_cpu)
        fields.update(device_profile(lambda: pipeline.optimize_epoch(state, cfg)))
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
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
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

    chi2_oracle_1k = oracle_chi2(g1k, iters=12)
    launches = headline_solve(g1k, chi2_oracle_1k, reps=10)
    solve_against_oracle(g1k, "5 default early-exit 1k", {}, chi2_oracle_1k, reps=5)
    g10k = make_graph(10_000, dev)
    solve_against_oracle(g10k, "6 headline 10k", HEADLINE,
                         oracle_chi2(g10k, iters=20, lm=True), reps=3)
    counts100k = solve_against_oracle(g100k, "7 headline 100k", HEADLINE, None, reps=3)
    check(counts100k["components"] > 0, "7 headline 100k: K8's grid route was not launched")
    del g10k, g100k

    counts500 = epoch_phase("8 epoch 500", built500, EPOCH_500["n"], reps=5, reads=reads,
                            cpu_check=True)
    counts10k = epoch_phase("9 epoch 10k", built10k, EPOCH_10K["n"], reps=3, reads=reads,
                            cpu_check=False)
    # each kernel's main path: the 1k solve for K1-K4, the 500-node epoch for K5-K8
    launches.update({name: counts500[name] for name in EPOCH_KERNELS})

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
         "launches": launches[name], "launches_epoch_500": counts500[name],
         "launches_epoch_10k": counts10k[name],
         "max_abs_err": rows[name]["max_abs_err"], "ms": rows[name]["ms"],
         "plain_ms": rows[name]["plain_ms"], "bound_ms": rows[name]["bound_ms"],
         "bound_by": rows[name]["bound_by"], "library_ms": None,
         "shapes": "1k solve" if name in SOLVE_KERNELS else "500-node epoch",
         "max_abs_err_large": rows_large[name]["max_abs_err"], "ms_large": rows_large[name]["ms"],
         "plain_ms_large": rows_large[name]["plain_ms"],
         "bound_ms_large": rows_large[name]["bound_ms"],
         "shapes_large": "100k solve" if name in SOLVE_KERNELS else "10k-node epoch"}
        for name in REPLACES
    ]
    # K8's second route, from the same source: one grid launch per pass
    # where 12·N bytes exceed one CTA's shared memory; its main path is
    # phase 7's 100k solve
    kernels.append(
        {"name": "components_grid", "route": "cuda", "source": SOURCE["components"],
         "replaces": REPLACES["components"], "launches": counts100k["components"],
         "max_abs_err": grid["max_abs_err"], "ms": grid["ms"], "plain_ms": grid["plain_ms"],
         "bound_ms": grid["bound_ms"], "bound_by": grid["bound_by"], "library_ms": None,
         "shapes": "100k solve"})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
