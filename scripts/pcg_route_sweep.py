#!/usr/bin/env python3
"""Time both PCG routes of a single solve by size, in one process.

    python3 scripts/pcg_route_sweep.py [--sizes 1000,2000,...] [--rounds 4]

A single solve within K34's cap with no reduce hook takes K35, one launch a
PCG solve.  The route it replaces is K34's start, then per step K2 (across
the card) and K34's step: 1 + 2 x 12 launches.  K35's Hv runs on the
cluster's 8 SMs, so its device time grows faster with the graph than
K2's.  For each size, on ``chip_smoke.make_graph`` graphs at
``chip_smoke.HEADLINE`` (20 LM x 12 PCG, fixed iterations):

- the kernel: ``chip_smoke.compare_pcg_chain_solve`` on the first PCG solve,
  K35 against the calls it replaces, CUDA events, in turns;
- the solve: ``solver.optimize`` on each route (the K2 + K34 route forced
  by handing ``solver._pcg`` no operator), ``--rounds`` rounds of
  ``--reps`` sync-free solves a route in alternating order, host clock
  around each solve, the median of each route's round medians; and one
  profiled solve a route (device ms, device launches).

``--epochs`` also times ``chip_smoke.EPOCH_500`` and ``EPOCH_10K``
(``pipeline.optimize_epoch``, early exit) both ways in turns.  Needs one
CUDA card.  Prints one JSON line a size or epoch.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from uzliti_slam_tpu_torch.graph import solver  # noqa: E402
from uzliti_slam_tpu_torch.kernels import _build  # noqa: E402
from uzliti_slam_tpu_torch.kernels import ops as kops  # noqa: E402

PCG = solver._pcg


def _pcg_without_operator(hvp, factor, b, iterations, tol, batch=1, cmask=None, op=None):
    """``solver._pcg`` on the K2 + K34 route: no operator, so each step's Hv
    is the caller's ``hvp`` (K2)."""
    return PCG(hvp, factor, b, iterations, tol, batch, cmask, None)


ROUTES = {"k35": PCG, "k2_k34": _pcg_without_operator}


def in_turns(run, rounds: int, reps: int) -> dict:
    """``run(reps)`` -> median seconds, on each route in alternating order;
    each route's median of its round medians (ms) and one profiled call."""
    med = {route: [] for route in ROUTES}
    out = {}
    try:
        for route, fn in ROUTES.items():        # warm up, launches counted
            solver._pcg = fn
            kops.reset_launches()
            run(1)
            torch.cuda.synchronize()
            out[f"{route}_launches"] = {k: v for k, v in kops.launches.items()
                                        if v and k in ("hvp", "pcg_chain", "pcg_chain_solve")}
        for i in range(rounds):
            for route in (("k35", "k2_k34") if i % 2 == 0 else ("k2_k34", "k35")):
                solver._pcg = ROUTES[route]
                med[route].append(1e3 * run(reps))
        for route, fn in ROUTES.items():
            solver._pcg = fn
            prof, _ = cs.device_profile(lambda: run(1))
            out[f"{route}_device_ms"] = prof.get("device_kernel_ms")
            out[f"{route}_device_launches"] = prof.get("device_launches")
    finally:
        solver._pcg = PCG
    for route in ROUTES:
        out[f"{route}_ms"] = statistics.median(med[route])
        out[f"{route}_round_ms"] = med[route]
    out["k35_wins_rounds"] = sum(a < b for a, b in zip(med["k35"], med["k2_k34"]))
    out["rounds"] = rounds
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="1000,2000,3000,4000,5000,6000,8000,10000")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5, help="timed solves a route and round")
    ap.add_argument("--epochs", action="store_true", help="also the 500 and 10k epochs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pcg_route_sweep: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _build.load()
    cfg = solver.SolverConfig(**cs.HEADLINE)
    cs.lift_sync_check_for_restart_read()     # the epoch's one host read
    print(cs.nvidia_smi_line(), flush=True)
    for n in (int(v) for v in args.sizes.split(",")):
        g = cs.make_graph(n, dev)
        inputs = cs.kernel_inputs(g, cfg)
        k = cs.compare_pcg_chain_solve(inputs["pcg_chain_solve"], f"sweep {n}")
        del inputs
        row = {"solve": n, "levels": k["levels"], "table_entries": k["table_entries"],
               "kernel_k35_ms": k["ms"], "kernel_replaced_ms": k["replaced_ms"],
               **in_turns(lambda reps: cs.timed_solves(solver.optimize, g, cfg, reps)[0],
                          args.rounds, args.reps)}
        print(json.dumps(row, default=float), flush=True)
        del g
    for name, spec in (("epoch_500", cs.EPOCH_500), ("epoch_10k", cs.EPOCH_10K)):
        if not args.epochs:
            break
        ecfg, state, _, _ = cs.make_epoch_state(**spec, device=dev)
        row = {"epoch": name, "n": spec["n"], "node_capacity": spec["node_capacity"],
               **in_turns(lambda reps: cs.timed_epochs(state, ecfg, reps)[0],
                          args.rounds, args.reps)}
        print(json.dumps(row, default=float), flush=True)
        del state
    return 0


if __name__ == "__main__":
    sys.exit(main())
