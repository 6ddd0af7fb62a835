#!/usr/bin/env python3
"""Time the port's headline solve in two checkouts on the same CUDA card.

    python3 scripts/torch_ab_solve.py --base build/parent [--pairs 5]

``--base`` is another checkout of the repository (for example the parent
commit unpacked with ``git archive`` into a git-ignored directory); the
change is the checkout this script lies in.  Each side runs in a process of
its own, which builds that checkout's kernels into its own ``build/``, and
the sides take turns: base, change, then change, base, and so on for
``--pairs`` pairs.  A process warms up, then times ``chip_smoke.HEADLINE``
solves (20 LM x 12 PCG, chain preconditioner, fixed iterations) of
``chip_smoke.make_graph`` graphs at each size, host clock around each solve
between two synchronisations, and profiles one more (device launches,
busy share, and the device ms a solve of K1, K2, the fused PCG kernels,
K4, K9 and K36); the size "fleet" times ``parallel.sharded.optimize_batch``
on ``chip_smoke.FLEET`` at ``chip_smoke.FLEET_CONFIG`` instead, and
"epoch500" / "epoch10k" ``pipeline.optimize_epoch`` on
``chip_smoke.EPOCH_500`` / ``EPOCH_10K`` (early exit, the odometry
restart's one host read allowed).  At every size the chain factor (K9) of
the first LM iteration is timed alone: CUDA events around 10 calls, and
its device ms a call over 10 profiled calls, split into its levels and
its root.  Where the
size takes K34 (``pcg_chain_route``), it also runs
``chip_smoke.compare_pcg_chain`` on the first PCG solve (K34 against its
plain version; one step timed with CUDA events beside the three calls it
replaces) and profiles 100 steps on the same vectors for K34's device ms a
step, and, in a checkout that has it, ``compare_pcg_chain_solve`` (K35).
Above K34's cap it times a step of the route the checkout takes there (K37,
or K10 + K3 + K10 before it) on the same vectors: CUDA events and device ms
a step.  Every size reports the device ms of K2, K3, K10, K37 and K38 in
the profiled call.  The size "step" times ``Slam.add_frame`` at phase 11's cell (the
VGA keyframe rung, 10 steps after 3 warm-up ones, 1 camera and the front +
rear rig: entries "step_1cam", "step_2cam") and "rereg" 13d's
``Slam.reregister_scans`` on the 1-camera Slam (its state restored before
each call); each reports wall ms, a profiled call's device ms, device
launches and busy share, and K12's, K17's, K18's, K13's, K14's and K16's
(by entry) device ms in it; "step" also times K12's, K14's, K16's and K17's
wrapper calls of that profiled step with CUDA events (ms a step, K16 by
entry, K12's and K14's calls) and K12's and K17's calls queued back to back
(device ms a step that no profile can drop); K7's and K15's the same.
"epoch500" also times K7 on the epoch's inputs (``chip_smoke.epoch_kernel_inputs``:
CUDA events and queued device ms a call); both epochs report K5's and K6's
device ms in the profiled epoch and their calls of one epoch replayed (CUDA
events, and queued device ms an epoch), and "maintain" phase 13a's
``pipeline.maintenance_epoch`` on the 500-node state after its epoch (wall,
device ms, device launches, K19's and K15's points entry's device ms).
Each solve size and epoch also times K8's call on its graph (the
checkout's entry: ``components_gauge``, or ``components`` then
``gauge_fix``; CUDA events, queued device ms, launches) and reports K8's
and K11's device ms in the profile; "map500" times phase 8's projections
(``pipeline.project_map`` after the 500-node epoch: the full rebuild,
"map500_full", and 8 new nodes, "map500_inc"; wall, device ms, launches,
and K11's call alone); "step_gicp" and "step_pnp" time phase 15b's keyframe
step (the VGA rung, 1 camera) with ``estimation.method`` "gicp" or "pnp":
wall ms, device ms, busy share, device launches and K25-K28's device ms in
a profiled step (K28's by function: the parent's two launches apart), and
K27's or K28's wrapper calls of that step replayed (CUDA events, queued
device ms):

    python3 scripts/torch_ab_solve.py --base build/parent --sizes step_gicp,step_pnp --pairs 3

    python3 scripts/torch_ab_solve.py --base build/parent --sizes 1000,100000,epoch500,epoch10k,map500 --pairs 3

    python3 scripts/torch_ab_solve.py --base build/parent --sizes step,rereg --pairs 3
    python3 scripts/torch_ab_solve.py --base build/parent --sizes step,epoch500,maintain --pairs 3
    python3 scripts/torch_ab_solve.py --base build/parent --sizes epoch500,epoch10k --pairs 3
Prints one JSON line a process, then per size each side's medians and how
many pairs the change won.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

WORKER = r'''
import inspect, json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from uzliti_slam_tpu_torch.graph import solver
from uzliti_slam_tpu_torch.kernels import _build, ops as kops
dev = torch.device("cuda", 0)
_build.load()
cfg = solver.SolverConfig(**cs.HEADLINE)

def timed(fn, g, c, reps):
    for _ in range(2):
        fn(g, c)
    torch.cuda.synchronize()
    kops.reset_launches()
    fn(g, c)
    torch.cuda.synchronize()
    launches = dict(kops.launches)
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(g, c)
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t0))
    prof, names = cs.device_profile(lambda: fn(g, c))
    by_kernel = {k: sum(v for name, v in names.items() if any(f in name for f in fs))
                 for k, fs in (("k1", ("linearize",)), ("k2", ("hvp_",)),
                               ("k3", ("chain_forward", "chain_backward", "chain_root")),
                               ("k10", ("pcg_init", "pcg_alpha", "pcg_beta", "grid_dots",
                                        "grid_init", "grid_alpha", "grid_beta")),
                               ("k34", ("pcg_chain_kernel",)), ("k35", ("pcg_solve_kernel",)),
                               ("k37", ("pcg_grid_kernel",)),
                               ("k38", ("pcg_fleet_kernel",)), ("k4", ("residual_edges",)),
                               ("k4_sum", ("sum_partials",)), ("k9", ("factor_",)),
                               ("k36", ("candidate_kernel",)), ("k36_accept", ("accept_kernel",)),
                               ("k7", ("ransac_roots", "ransac_draw_fit")),
                               ("k5", ("relax_rows", "relax_table", "relax_pairs", "relax_unc")),
                               ("k6", ("cluster_rounds", "cluster_block")),
                               ("k15_points", ("bin_rows", "bin_points")),
                               ("k19", ("row_keys", "greedy_rounds")),
                               ("k8", ("components_", "gauge_cta", "k_init_labels",
                                       "k_scatter_min", "k_jump", "k_gauge_")),
                               ("k11", ("project_cells", "project_tiles")))}
    by_kernel["eager_ops"] = sum(v for name, v in names.items() if "at::native" in name)
    return res, {"ms_median": statistics.median(ts), "ms": ts,
                 "port_launches": {k: v for k, v in launches.items() if v},
                 "device_launches": prof.get("device_launches"),
                 "device_kernel_ms": prof.get("device_kernel_ms"),
                 "device_busy_share": prof.get("device_busy_share"),
                 "device_ms_by_kernel": by_kernel}


def factor_times(args):
    """K9 on the first LM iteration's blocks: ms a call (CUDA events, host
    launch cost included), device ms a call, and its levels' share of it: a
    checkout whose K9 runs one launch a call stops the launch after the
    chain levels (``phase_limit``); one with a launch per level times its
    level kernels apart from its root kernel."""
    ms = cs.time_call(lambda: kops.chain_factor(*args), trials=11, calls=10)

    def device_ms(**kw):
        _, names = cs.device_profile(lambda: [kops.chain_factor(*args, **kw) for _ in range(10)])
        return {k: v / 10 for k, v in names.items() if "factor_" in k}

    total = device_ms()
    out = {"k9_ms": ms, "k9_device_ms": sum(total.values())}
    if "phase_limit" in inspect.signature(kops.chain_factor).parameters:
        D, U, cutoff, *batch = args
        levels = len(kops._factor_shapes(D.shape[0] // (batch[0] if batch else 1), cutoff)[0])
        out["k9_levels_device_ms"] = sum(device_ms(phase_limit=levels).values()) if levels else 0.0
    else:
        out["k9_levels_device_ms"] = sum(v for k, v in total.items() if "factor_level" in k)
    out["k9_root_device_ms"] = out["k9_device_ms"] - out["k9_levels_device_ms"]
    return out


STEP_FUNCTIONS = {
    "k7": ("ransac_roots", "ransac_draw_fit"),
    "k15": ("init_table", "scan_pixels", "finalize", "scan_grid"),
    "k12": ("fast_nms",),
    "k17": ("bilateral",),
    "k18": ("icp_problems", "icp_cluster"),
    "k13": ("cell_topk", "global_topk", "grid_cells", "grid_global"),
    "k14": ("box_blur<2>", "::describe(", "orb_describe_rows"),
    "k16_match": ("match_top2",),
    "k16_gist": ("gist_rounds", "gist_topk_cluster")}


def step_kernel_ms(names):
    """K12's, K17's, K18's, K13's, K14's and K16's (by entry) device ms in a
    profile (either checkout's function names); None where the profile holds
    none of the kernel's functions."""
    out = {}
    for k, fs in STEP_FUNCTIONS.items():
        hits = [v for key, v in names.items() if any(f in key for f in fs)]
        out[f"{k}_device_ms"] = sum(hits) if hits else None
    # K15's device functions in the profile: its launches a call
    out["k15_device_functions"] = sum(any(f in key for f in STEP_FUNCTIONS["k15"])
                                      for key in names)
    parts = (out["k16_match_device_ms"], out["k16_gist_device_ms"])
    out["k16_device_ms"] = None if None in parts else sum(parts)
    return out


def step_kernel_event_ms(calls):
    """K12's, K14's, K16's, K17's, K7's and K15's wrapper calls of one step
    (either checkout's wrappers) timed with CUDA events: ms a step, and
    K12's and K14's calls; K12's, K17's, K7's and K15's also queued back to
    back behind a sleep kernel (``chip_smoke.queued_device_ms``: device ms a
    step that no profile can drop).  K7's calls are those of the step's
    wrapper, whose triplets a checkout draws before the call (the parent)
    or inside it."""
    k14 = [w for w in ("orb_describe", "orb_describe_levels") if w in calls]

    def run(ws):
        for w in ws:
            for a, kw in calls[w]:
                getattr(kops, w)(*a, **kw)

    return {"k12_ms": cs.time_call(lambda: run(["fast_nms"])),
            "k12_calls": len(calls["fast_nms"]),
            "k12_queued_device_ms": cs.queued_device_ms(lambda: run(["fast_nms"])),
            "k17_ms": cs.time_call(lambda: run(["bilateral"])),
            "k17_queued_device_ms": cs.queued_device_ms(lambda: run(["bilateral"])),
            "k14_ms": cs.time_call(lambda: run(k14)), "k14_calls": sum(len(calls[w]) for w in k14),
            "k16_match_ms": cs.time_call(lambda: run(["hamming_top2"])),
            "k16_gist_ms": cs.time_call(lambda: run(["gist_topk"])),
            "k16_ms": cs.time_call(lambda: run(["hamming_top2", "gist_topk"])),
            "k7_ms": cs.time_call(lambda: run(["ransac_rigid"])),
            "k7_queued_device_ms": cs.queued_device_ms(lambda: run(["ransac_rigid"])),
            "k15_ms": cs.time_call(lambda: run(["scan_bins"])),
            "k15_queued_device_ms": cs.queued_device_ms(lambda: run(["scan_bins"]))}


def k8_call(args):
    """K8 as the checkout's solve calls it (labels and gauge: one entry, or
    the two wrappers before it): CUDA events around 10 calls, device ms a
    call queued back to back, and the port's launches of one call."""
    ef, et, ev, nv, nf, stamp, n, iters = args

    def call():
        if hasattr(kops, "components_gauge"):
            return kops.components_gauge(*args)
        labels = kops.components(ef, et, ev, n, iters)
        return labels, kops.gauge_fix(labels, nv, nf, stamp)
    kops.reset_launches()
    call()
    launches = kops.launches["components"]
    return {"k8_ms": cs.time_call(call), "k8_queued_device_ms": cs.queued_device_ms(call),
            "k8_calls_launches": launches}


def map_entries(reps):
    """Phase 8's projections after the 500-node epoch: ``pipeline.project_map``
    as a full rebuild and as an incremental pass over 8 new nodes (wall,
    profiled device ms and launches), and K11's calls alone (CUDA events,
    queued device ms)."""
    from uzliti_slam_tpu_torch import pipeline
    ecfg, state, _, _ = cs.make_epoch_state(**cs.EPOCH_500, device=dev)
    _, (state, _) = cs.timed_epochs(state, ecfg, 1)
    s500 = cs.with_scans(state, cs.SEED + 5)
    grid = pipeline.project_map(s500, ecfg)
    s508 = cs.add_scanned_nodes(s500, 8)
    out = {}
    for name, st, gr in (("map500_full", s500, None), ("map500_inc", s508, grid)):
        _, out[name] = timed(lambda s, c: pipeline.project_map(s, c, gr), st, ecfg, reps)
        args = cs.map_args(st, ecfg, gr)[1]
        out[name]["k11_ms"] = cs.time_call(lambda: kops.project_rays(*args))
        out[name]["k11_queued_device_ms"] = cs.queued_device_ms(lambda: kops.project_rays(*args))
    return out


def epoch_k5_k6(state, ecfg):
    """K5's and K6's calls of one epoch (either checkout's entries, the
    call sites' wrappers: K5's table launches inside its relaxation
    entries), replayed: CUDA events around them (ms an epoch) and queued
    back to back (device ms an epoch that no profile can drop)."""
    wrappers = {"k5": [w for w in ("relax_min", "relax_pairs", "relax_uncertainty")
                       if hasattr(kops, w)],
                "k6": [w for w in ("cluster_labels", "cluster_roots") if hasattr(kops, w)]}
    calls = cs.record_args(lambda: cs.timed_epochs(state, ecfg, 1),
                           wrappers["k5"] + wrappers["k6"])
    out = {}
    for k, ws in wrappers.items():
        def run():
            for w in ws:
                for a, kw in calls[w]:
                    getattr(kops, w)(*a, **kw)
        out[f"{k}_calls"] = sum(len(calls[w]) for w in ws)
        out[f"{k}_ms"] = cs.time_call(run)
        out[f"{k}_queued_device_ms"] = cs.queued_device_ms(run)
    return out


def step_entries(do_step, do_rereg, reps):
    """The keyframe step (phase 11's cell: ``Slam.add_frame`` on the
    rung's 13 VGA frames, 3 warm-up steps, 10 timed; 1 camera and the rig)
    and the re-registration (13d's call on the 1-camera Slam, its state
    restored before each call): wall ms, a profile of one more call (device
    ms, launches, busy share) and K18's and K13's device ms in it."""
    from uzliti_slam_tpu_torch import pipeline
    world, frames = cs.keyframe_world()
    warm = cs.KEYFRAME_VGA["warmup"]
    res, slam1 = {}, None
    for n_cams in (1, 2) if do_step else (1,):
        cfg, pose = cs.step_config(n_cams, dev)
        inputs = [cs.frame_inputs(fr, n_cams) for fr in frames]
        slam = pipeline.Slam(cfg, cam=world.cam, cam_pose=pose, device=dev)
        slam.optimize_every = 10**9
        for i in range(warm):
            slam.add_frame(*inputs[i], frames[i]["odom_pose"], frames[i]["stamp"])
        torch.cuda.synchronize()
        kops.reset_launches()
        ts = []
        for i in range(warm, len(frames)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slam.add_frame(*inputs[i], frames[i]["odom_pose"], frames[i]["stamp"])
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        launches = {k: v / len(ts) for k, v in kops.launches.items() if v}
        last = len(frames) - 1
        def late_step():
            return pipeline.process_keyframe(
                slam.state, *inputs[last], frames[last]["odom_pose"], frames[last]["stamp"],
                slam.cam, slam.cam_pose, slam.config)

        prof, names = cs.device_profile(late_step)
        if do_step:
            wrappers = tuple(w for w in ("fast_nms", "bilateral", "orb_describe",
                                         "orb_describe_levels", "hamming_top2", "gist_topk",
                                         "ransac_rigid", "scan_bins")
                             if hasattr(kops, w))
            res[f"step_{n_cams}cam"] = {
                "ms_median": statistics.median(ts), "ms": ts, "port_launches": launches,
                **{k: prof.get(k) for k in ("device_launches", "device_kernel_ms",
                                            "device_busy_share")}, **step_kernel_ms(names),
                **step_kernel_event_ms(cs.record_args(late_step, wrappers))}
        if n_cams == 1:
            slam1 = slam
    if do_rereg:
        before = slam1.state

        def rereg():
            slam1.state = before
            return slam1.reregister_scans()

        rereg()
        torch.cuda.synchronize()
        kops.reset_launches()
        rereg()
        torch.cuda.synchronize()
        launches = {k: v for k, v in kops.launches.items() if v}
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rereg()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        prof, names = cs.device_profile(rereg)
        res["rereg"] = {"ms_median": statistics.median(ts), "ms": ts, "port_launches": launches,
                        **{k: prof.get(k) for k in ("device_launches", "device_kernel_ms",
                                                    "device_busy_share")},
                        **step_kernel_ms(names)}
    return res


ESTIMATION_FUNCTIONS = {
    "k25": ("voxel_sort_chunks", "voxel_merge", "voxel_accumulate", "voxel_finish"),
    "k26": ("knn_normals_kernel",),
    "k27": ("gicp_problems", "gicp_cluster"),
    "k28": ("pnp_hypotheses_kernel", "pnp_refine_kernel", "pnp_cluster"),
    "k28_hypotheses": ("pnp_hypotheses_kernel",),
    "k28_refine": ("pnp_refine_kernel",),
    "k16": ("match_top2", "gist_rounds", "gist_topk_cluster")}


def estimation_entries(methods, reps):
    """Phase 15b's keyframe step (the VGA rung's 13 frames, 1 camera, 3
    warm-up steps and 10 timed) with ``estimation.method`` "gicp" or "pnp":
    wall ms a step, a profiled late step (device ms, launches, busy share,
    K25-K28's and K16's device ms; K28's by function, which splits the
    parent's two launches), and K27's or K28's wrapper calls of that step
    replayed (either checkout's wrappers): CUDA events around them (ms a
    step) and queued back to back (device ms a step)."""
    from uzliti_slam_tpu_torch import pipeline
    world, frames = cs.keyframe_world()
    warm = cs.KEYFRAME_VGA["warmup"]
    inputs = [cs.frame_inputs(fr, 1) for fr in frames]
    last = len(frames) - 1
    res = {}
    for method in methods:
        cfg, pose = cs.step_config(1, dev, estimation=method)
        slam = pipeline.Slam(cfg, cam=world.cam, cam_pose=pose, device=dev)
        slam.optimize_every = 10**9
        for i in range(warm):
            slam.add_frame(*inputs[i], frames[i]["odom_pose"], frames[i]["stamp"])
        torch.cuda.synchronize()
        kops.reset_launches()
        ts = []
        for i in range(warm, len(frames)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slam.add_frame(*inputs[i], frames[i]["odom_pose"], frames[i]["stamp"])
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        launches = {k: v / len(ts) for k, v in kops.launches.items() if v}

        def late_step():
            return pipeline.process_keyframe(
                slam.state, *inputs[last], frames[last]["odom_pose"], frames[last]["stamp"],
                slam.cam, slam.cam_pose, slam.config)

        prof, names = cs.device_profile(late_step)
        row = {"ms_median": statistics.median(ts), "ms": ts, "port_launches": launches,
               **{k: prof.get(k) for k in ("device_launches", "device_kernel_ms",
                                           "device_busy_share")}}
        for k, fs in ESTIMATION_FUNCTIONS.items():
            hits = [v for key, v in names.items() if any(f in key for f in fs)]
            row[f"{k}_device_ms"] = sum(hits) if hits else None
        k = "k27" if method == "gicp" else "k28"
        wrappers = [w for w in (("gicp",) if method == "gicp" else
                                ("pnp_hypotheses", "pnp_refine", "pnp_ransac"))
                    if hasattr(kops, w)]
        calls = cs.record_args(late_step, wrappers)
        ws = [w for w in wrappers if calls[w]]

        def run():
            for w in ws:
                for a, kw in calls[w]:
                    getattr(kops, w)(*a, **kw)

        row[f"{k}_wrappers"] = {w: len(calls[w]) for w in ws}
        row[f"{k}_ms"] = cs.time_call(run)
        row[f"{k}_queued_device_ms"] = cs.queued_device_ms(run)
        res[f"step_{method}"] = row
        del slam
    return res


out, lifted = {}, False
sizes = sys.argv[2].split(",")
est = [m for m in ("gicp", "pnp") if f"step_{m}" in sizes]
if est:
    out.update(estimation_entries(est, int(sys.argv[3])))
if "step" in sizes or "rereg" in sizes:
    out.update(step_entries("step" in sizes, "rereg" in sizes, int(sys.argv[3])))
if "map500" in sizes:
    if not lifted:
        cs.lift_sync_check_for_restart_read()
        lifted = True
    out.update(map_entries(int(sys.argv[3])))
for size in sizes:
    if size in ("step", "rereg", "map500", "step_gicp", "step_pnp"):
        continue
    if size.startswith("epoch"):
        if not lifted:
            cs.lift_sync_check_for_restart_read()
            lifted = True
        spec = cs.EPOCH_500 if size == "epoch500" else cs.EPOCH_10K
        ecfg, state, _, _ = cs.make_epoch_state(**spec, device=dev)
        _, out[size] = timed(lambda s, c: cs.timed_epochs(s, c, 1)[1], state, ecfg,
                             max(3, int(sys.argv[3]) // 3))
        out[size].update(factor_times(cs.kernel_inputs(state.graph, ecfg.solver)["chain_factor"]))
        # K7 on the epoch's inputs (either checkout's form: triplets drawn
        # before the call, or its uniforms): CUDA events around 10 calls,
        # and device ms a call queued back to back
        k7 = cs.epoch_kernel_inputs(state, ecfg)["ransac_rigid"]
        out[size]["k7_ms"] = cs.time_call(lambda: kops.ransac_rigid(*k7))
        out[size]["k7_queued_device_ms"] = cs.queued_device_ms(lambda: kops.ransac_rigid(*k7))
        out[size].update(epoch_k5_k6(state, ecfg))
        out[size].update(k8_call(cs.components_inputs(state.graph)))
        del state
        continue
    if size == "maintain":
        # phase 13a: the global role on the 500-node state after its epoch,
        # scans and descriptors added, the robot 100 m away
        from uzliti_slam_tpu_torch import pipeline
        if not lifted:
            cs.lift_sync_check_for_restart_read()
            lifted = True
        ecfg, state, _, _ = cs.make_epoch_state(**cs.EPOCH_500, device=dev)
        _, (state, _) = cs.timed_epochs(state, ecfg, 1)
        mstate, center = cs.with_payload(state, cs.SEED + 11), cs.far_center(dev)
        _, out[size] = timed(lambda s, c: pipeline.maintenance_epoch(s, c, center=center),
                             mstate, cs.merge_config(ecfg), int(sys.argv[3]))
        del state, mstate
        continue
    if size == "fleet":
        from uzliti_slam_tpu_torch.io import synthetic
        from uzliti_slam_tpu_torch.parallel import sharded
        fleet, _ = synthetic.make_pose_graph_batch(
            cs.FLEET["batch"], cs.FLEET["n_nodes"], loop_closure_every=cs.FLEET["loop_closure_every"],
            generator=torch.Generator().manual_seed(cs.SEED), capacity_rounding="pow2", device=dev)
        res, out[size] = timed(sharded.optimize_batch, fleet, solver.SolverConfig(**cs.FLEET_CONFIG),
                               max(3, int(sys.argv[3]) // 5))
        fcfg = sharded.fleet_config(solver.SolverConfig(**cs.FLEET_CONFIG))
        out[size]["mean_chi2"] = float(solver.optimize_batched(fleet, fcfg)[1]
                                       .chi2_history[:, -1].mean())
        out[size].update(factor_times(cs.fleet_kernel_inputs(fleet, fcfg)["chain_factor"]))
        del fleet
        continue
    n = int(size)
    g = cs.make_graph(n, dev)
    (_, st), out[n] = timed(solver.optimize, g, cfg, int(sys.argv[3]))
    out[n]["chi2"] = float(st.chi2_history[-1])
    out[n].update(k8_call(cs.components_inputs(g)))
    inputs = cs.kernel_inputs(g, cfg)
    out[n].update(factor_times(inputs["chain_factor"]))
    args = inputs["pcg"]
    Ji, Jj, W, ef, et, damp, free, pack, b, steps, tol = args
    if kops.pcg_chain_route(pack):
        row = cs.compare_pcg_chain(args, str(n))
        Hp = kops.hvp(Ji, Jj, W, ef, et, b, damp, free)
        state = kops.pcg_chain_start(pack, b)
        _, dev_ms = cs.device_profile(
            lambda: [kops.pcg_chain_step(pack, Hp, state, tol) for _ in range(100)])
        out[n]["pcg_chain"] = {
            **{k: row[k] for k in ("ms", "three_calls_ms", "start_ms", "plain_ms", "bound_ms",
                                   "max_rel_err", "rerun_bit_identical", "smem_bytes_per_cta")},
            "device_ms_per_step": sum(v for k, v in dev_ms.items()
                                      if "pcg_chain_kernel" in k) / 100}
        if hasattr(cs, "compare_pcg_chain_solve"):
            row = cs.compare_pcg_chain_solve(inputs["pcg_chain_solve"], str(n))
            out[n]["pcg_chain_solve"] = {k: row[k] for k in (
                "ms", "replaced_ms", "plain_ms", "bound_ms", "max_rel_err", "rerun_bit_identical")}
    else:
        # above K34's cap: a step of the route the checkout's solve takes, on
        # the same vectors (the first PCG solve's b and one Hp); CUDA events
        # around 10 steps, and device ms a step over 20 profiled steps
        Hp = kops.hvp(Ji, Jj, W, ef, et, b, damp, free)
        state = kops.pcg_chain_start(pack, b)
        kops.reset_launches()
        kops.pcg_chain_step(pack, Hp, state, tol)
        step_launches = {k: v for k, v in kops.launches.items() if v}
        ms = cs.time_call(lambda: kops.pcg_chain_step(pack, Hp, state, tol), trials=11)
        _, dev_ms = cs.device_profile(
            lambda: [kops.pcg_chain_step(pack, Hp, state, tol) for _ in range(20)])
        out[n]["pcg_step"] = {"ms": ms, "device_ms_per_step": sum(dev_ms.values()) / 20,
                              "launches": step_launches}
print(json.dumps(out))
'''


# the step's per-kernel figures each side reports
STEP_KEYS = ("k12_device_ms", "k17_device_ms", "k18_device_ms", "k13_device_ms",
             "k14_device_ms", "k16_device_ms", "k16_match_device_ms", "k16_gist_device_ms",
             "k12_ms", "k12_calls", "k12_queued_device_ms", "k17_ms", "k17_queued_device_ms",
             "k14_ms", "k14_calls", "k16_ms", "k16_match_ms", "k16_gist_ms",
             "k7_device_ms", "k7_ms", "k7_queued_device_ms", "k15_device_ms",
             "k15_device_functions", "k15_ms", "k15_queued_device_ms",
             "k5_calls", "k5_ms", "k5_queued_device_ms", "k6_calls", "k6_ms",
             "k6_queued_device_ms", "k8_ms", "k8_queued_device_ms", "k8_calls_launches",
             "k11_ms", "k11_queued_device_ms",
             "k25_device_ms", "k26_device_ms", "k27_device_ms", "k28_device_ms",
             "k28_hypotheses_device_ms", "k28_refine_device_ms", "k27_ms", "k27_queued_device_ms",
             "k28_ms", "k28_queued_device_ms", "device_busy_share")


def run_side(tree: Path, sizes: str, reps: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", WORKER, str(tree), sizes, str(reps)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{tree}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", required=True, type=Path, help="the other checkout")
    ap.add_argument("--pairs", type=int, default=5)
    ap.add_argument("--sizes", default="1000,10000",
                    help="node counts, 'fleet', 'epoch500', 'epoch10k', 'step' (the VGA "
                         "keyframe step, 1 camera and the rig), 'rereg' (its re-registration), "
                         "'maintain' (phase 13a's maintenance on the 500-node state), 'map500' "
                         "(the projections after the 500-node epoch: full and 8 new nodes), "
                         "'step_gicp' / 'step_pnp' (phase 15b's VGA step, 1 camera, by "
                         "estimator)")
    ap.add_argument("--reps", type=int, default=15, help="timed solves a size and process")
    args = ap.parse_args()
    sides = {"base": args.base.resolve(), "change": Path(__file__).resolve().parents[1]}
    medians = {side: [] for side in sides}
    for i in range(args.pairs):
        order = ("base", "change") if i % 2 == 0 else ("change", "base")
        for side in order:
            res = run_side(sides[side], args.sizes, args.reps)
            medians[side].append({str(n): r["ms_median"] for n, r in res.items()})
            medians[side][-1].update({f"{n}:{k}": r["pcg_chain"][k] for n, r in res.items()
                                      if "pcg_chain" in r
                                      for k in ("ms", "device_ms_per_step")})
            medians[side][-1].update({f"{n}:step_{k}": r["pcg_step"][k] for n, r in res.items()
                                      if "pcg_step" in r
                                      for k in ("ms", "device_ms_per_step")})
            medians[side][-1].update({f"{n}:{k}": r[k] for n, r in res.items()
                                      for k in ("k9_ms", "k9_device_ms", "k9_levels_device_ms",
                                                "k9_root_device_ms", "device_kernel_ms",
                                                "device_launches", *STEP_KEYS) if k in r})
            medians[side][-1].update({f"{n}:{k}_device_ms": r["device_ms_by_kernel"][k]
                                      for n, r in res.items() if "device_ms_by_kernel" in r
                                      for k in ("k7", "k15_points", "k19", "k5", "k6", "k8",
                                                "k11", "k2", "k3", "k10", "k37", "k38")})
            print(json.dumps({"pair": i, "side": side, **res}), flush=True)
    names = [n for n in args.sizes.split(",") if n not in ("step", "rereg", "map500")]
    # step_gicp / step_pnp are entries of their own (their names kept)
    names += ["step_1cam", "step_2cam"] if "step" in args.sizes.split(",") else []
    names += ["map500_full", "map500_inc"] if "map500" in args.sizes.split(",") else []
    names += ["rereg"] if "rereg" in args.sizes.split(",") else []
    for n in names:
        base = [m[n] for m in medians["base"]]
        change = [m[n] for m in medians["change"]]
        wins = sum(c < b for b, c in zip(base, change))
        k34 = {f"{side}_pcg_chain_{k}": [m[f"{n}:{k}"] for m in medians[side]]
               for side in sides for k in ("ms", "device_ms_per_step")
               if f"{n}:{k}" in medians[side][0]}
        k34.update({f"{side}_pcg_step_{k}": [m[f"{n}:step_{k}"] for m in medians[side]]
                    for side in sides for k in ("ms", "device_ms_per_step")
                    if f"{n}:step_{k}" in medians[side][0]})
        k34.update({f"{side}_{k}": [m[f"{n}:{k}"] for m in medians[side]]
                    for side in sides for k in ("k9_ms", "k9_device_ms", "k9_levels_device_ms",
                                                "k9_root_device_ms", "device_kernel_ms",
                                                "device_launches", *STEP_KEYS,
                                                "k7_device_ms", "k15_points_device_ms",
                                                "k19_device_ms", "k5_device_ms", "k6_device_ms",
                                                "k8_device_ms", "k11_device_ms", "k2_device_ms",
                                                "k3_device_ms", "k10_device_ms", "k37_device_ms",
                                                "k38_device_ms")
                    if f"{n}:{k}" in medians[side][0]})
        print(json.dumps({"size": n, "base_medians_ms": base, "change_medians_ms": change,
                          "base_median_ms": statistics.median(base),
                          "change_median_ms": statistics.median(change),
                          "change_wins": wins, "pairs": args.pairs, **k34}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
