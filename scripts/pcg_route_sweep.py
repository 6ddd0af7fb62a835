#!/usr/bin/env python3
"""Time the PCG routes of a single solve by size, in one process.

    python3 scripts/pcg_route_sweep.py [--sizes 1000,2000,...] [--rounds 4]

A single solve within K34's cap with no reduce hook takes K35, one launch a
PCG solve.  The routes it could take instead: K34's start, then per step K2
(across the card) and K34's step (1 + 2 x 12 launches); or K37's start and
per step K2 and K37's step, one cooperative launch over the whole card (the
route above the cap, forced here below it).  K35's Hv runs on the
cluster's 8 SMs, so its device time grows faster with the graph than
K2's.  For each size, on ``chip_smoke.make_graph`` graphs at
``chip_smoke.HEADLINE`` (20 LM x 12 PCG, fixed iterations):

- the kernel: within the cap ``chip_smoke.compare_pcg_chain_solve`` on the
  first PCG solve, K35 against the calls it replaces, CUDA events, in
  turns, and K37's step against K34's on the same vectors in turns; above
  it ``chip_smoke.compare_pcg_grid`` (K37 against the K10 + K3 + K10 it
  replaces);
- the solve: ``solver.optimize`` on each route the size can take (K35 and
  K2 + K34 within the cap, K2 + K37 at every size: K2 + K34 forced by
  handing ``solver._pcg`` no operator, K2 + K37 by a ``_pcg`` that starts
  with ``kops.pcg_grid_start``), ``--rounds`` rounds of ``--reps``
  sync-free solves a route in rotating order, host clock around each solve,
  the median of each route's round medians; and one profiled solve a route
  (device ms, device launches).

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


def _pcg_on_k37(hvp, factor, b, iterations, tol, batch=1, cmask=None, op=None):
    """``solver._pcg`` on the K2 + K37 route at any size: K37's start, then
    per step the caller's ``hvp`` (K2) and K37's step."""
    state = kops.pcg_grid_start(factor, b, cmask)
    for _ in range(iterations):
        kops.pcg_chain_step(factor, hvp(state.p), state, tol, cmask)
    return state.x


ROUTES = {"k35": PCG, "k2_k34": _pcg_without_operator, "k2_k37": _pcg_on_k37}
PCG_KERNELS = ("hvp", "pcg_chain", "pcg_chain_solve", "pcg_grid")


def in_turns(run, rounds: int, reps: int, routes) -> dict:
    """``run(reps)`` -> median seconds, on each of ``routes`` in rotating
    order; each route's median of its round medians (ms) and one profiled
    call."""
    med = {route: [] for route in routes}
    out = {}
    try:
        for route in routes:                    # warm up, launches counted
            solver._pcg = ROUTES[route]
            kops.reset_launches()
            run(1)
            torch.cuda.synchronize()
            out[f"{route}_launches"] = {k: v for k, v in kops.launches.items()
                                        if v and k in PCG_KERNELS}
        for i in range(rounds):
            for route in routes[i % len(routes):] + routes[:i % len(routes)]:
                solver._pcg = ROUTES[route]
                med[route].append(1e3 * run(reps))
        for route in routes:
            solver._pcg = ROUTES[route]
            prof, _ = cs.device_profile(lambda: run(1))
            out[f"{route}_device_ms"] = prof.get("device_kernel_ms")
            out[f"{route}_device_launches"] = prof.get("device_launches")
    finally:
        solver._pcg = PCG
    for route in routes:
        out[f"{route}_ms"] = statistics.median(med[route])
        out[f"{route}_round_ms"] = med[route]
    for other in routes[1:] if routes[0] == "k35" else ():
        out[f"k35_wins_rounds_against_{other}"] = sum(a < b for a, b in zip(med["k35"],
                                                                             med[other]))
    out["rounds"] = rounds
    return out


def step_in_turns(args) -> dict:
    """K37's step against K34's on the same vectors (the first PCG solve's
    b and one Hp), CUDA events in alternating turns, and each one's device
    ms a step over 20 profiled steps."""
    Ji, Jj, W, ef, et, damp, free, pack, b, steps, tol = args
    Hp = kops.hvp(Ji, Jj, W, ef, et, b, damp, free)
    k34, k37 = kops.pcg_chain_start(pack, b), kops.pcg_grid_start(pack, b)
    ms37, ms34 = cs.time_pair(lambda: kops.pcg_chain_step(pack, Hp, k37, tol),
                              lambda: kops.pcg_chain_step(pack, Hp, k34, tol))
    return {"k37_step_ms": ms37, "k34_step_ms": ms34,
            "k37_step_device_ms": cs.device_ms_of(
                lambda: [kops.pcg_chain_step(pack, Hp, k37, tol) for _ in range(20)], 20,
                "pcg_grid_kernel"),
            "k34_step_device_ms": cs.device_ms_of(
                lambda: [kops.pcg_chain_step(pack, Hp, k34, tol) for _ in range(20)], 20,
                "pcg_chain_kernel")}


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
        pack = inputs["pcg"][7]
        row = {"solve": n, "levels": len(pack[0])}
        if kops.pcg_chain_route(pack):
            k = cs.compare_pcg_chain_solve(inputs["pcg_chain_solve"], f"sweep {n}")
            row.update(table_entries=k["table_entries"], kernel_k35_ms=k["ms"],
                       kernel_replaced_ms=k["replaced_ms"], **step_in_turns(inputs["pcg"]))
            routes = ("k35", "k2_k34", "k2_k37")
        else:
            k = cs.compare_pcg_grid(inputs["pcg"], f"sweep {n}")
            row.update(k37_step_ms=k["ms"], k37_step_device_ms=k["device_ms"],
                       k10_k3_k10_step_ms=k["three_calls_ms"])
            routes = ("k2_k37",)
        del inputs
        row.update(in_turns(lambda reps: cs.timed_solves(solver.optimize, g, cfg, reps)[0],
                            args.rounds, args.reps, routes))
        print(json.dumps(row, default=float), flush=True)
        del g
    for name, spec in (("epoch_500", cs.EPOCH_500), ("epoch_10k", cs.EPOCH_10K)):
        if not args.epochs:
            break
        ecfg, state, _, _ = cs.make_epoch_state(**spec, device=dev)
        row = {"epoch": name, "n": spec["n"], "node_capacity": spec["node_capacity"],
               **in_turns(lambda reps: cs.timed_epochs(state, ecfg, reps)[0],
                          args.rounds, args.reps, ("k35", "k2_k34"))}
        print(json.dumps(row, default=float), flush=True)
        del state
    return 0


if __name__ == "__main__":
    sys.exit(main())
