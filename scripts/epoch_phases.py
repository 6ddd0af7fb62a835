#!/usr/bin/env python3
"""Host-clock ms of the optimization epoch's phases in one checkout of the
repository, on one CUDA card.

    python3 scripts/epoch_phases.py <checkout>      # e.g. . or build/parent

On ``chip_smoke.EPOCH_500`` and ``EPOCH_10K`` (``chip_smoke.make_epoch_state``)
it times ``pipeline.epoch_candidates`` (the heuristic's shortest paths),
``filter.filter_loop_closures``, ``solver.optimize`` on the filtered graph,
``shortest_path.reevaluate_uncertainty`` on the solved one and the whole
``pipeline.optimize_epoch``, each call between two synchronisations (the
odometry restart's one host read allowed), median of 7 after 2 warm-ups, and
prints one JSON line.  Run it for two checkouts in turns (parent, change,
change, parent) to compare them on one card.
"""
import json
import statistics
import sys
import time

sys.path.insert(0, sys.argv[1])
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
from uzliti_slam_tpu_torch import pipeline  # noqa: E402
from uzliti_slam_tpu_torch.graph import filter as gfilter, shortest_path, solver  # noqa: E402
from uzliti_slam_tpu_torch.kernels import _build  # noqa: E402

dev = torch.device("cuda", 0)
_build.load()
cs.lift_sync_check_for_restart_read()
out = {}
for size, spec in (("epoch500", cs.EPOCH_500), ("epoch10k", cs.EPOCH_10K)):
    cfg, state, _, _ = cs.make_epoch_state(**spec, device=dev)
    g = state.graph
    idx, heur = pipeline.epoch_candidates(g, cfg)
    keep = gfilter.filter_loop_closures(g, idx, state.generator, cfg.filter, cand_mask=heur)
    g2 = g.replace(e_valid=gfilter.write_validity(g.e_valid, idx, keep))
    g3, _ = solver.optimize(g2, cfg.solver)
    phases = {
        "candidates": lambda: pipeline.epoch_candidates(g, cfg),
        "filter": lambda: gfilter.filter_loop_closures(g, idx, state.generator, cfg.filter,
                                                       cand_mask=heur),
        "solve": lambda: solver.optimize(g2, cfg.solver),
        "uncertainty": lambda: shortest_path.reevaluate_uncertainty(g3),
        "epoch": lambda: pipeline.optimize_epoch(state, cfg),
    }
    row = {}
    for name, fn in phases.items():
        ts = []
        for rep in range(9):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if rep >= 2:
                ts.append(1e3 * (time.perf_counter() - t0))
        row[name] = statistics.median(ts)
    out[size] = row
print(json.dumps({"tree": sys.argv[1], **out}))
