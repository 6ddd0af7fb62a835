#!/usr/bin/env python3
"""How many of a profile's first device records the trace loses, on one card.

    python3 scripts/profile_record_loss.py [--where fresh|phase3] [--rounds 4]

Profiles four calls of K19 (``kops.merge_pairs``) and four of K20
(``kops.calib_gn``) after 1, 4, 8 and 32 marker kernels
(``chip_smoke.profiled_kernels``), ``--rounds`` times each, and prints one
JSON line a profile: whether the trace held a marker and how many of the
four calls' kernels it held.  ``--where fresh`` does so in a process that
has run nothing else (K19 on ``chip_smoke.EPOCH_500``'s state after one
epoch, K20 on the 1k calibrate with 1 camera); ``--where phase3`` runs
``chip_smoke.py`` itself up to phase 3's K19 / K20 rows and probes there, on
the arguments phase 3 holds (main and large), then stops.  Ends with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

FUNCTIONS = {"merge_pairs": ("merge_pairs_kernel",), "calib_gn": ("calib_cluster",)}
MARKERS = (1, 4, 8, 32)


def probe(calls: dict, label: str, rounds: int) -> None:
    from uzliti_slam_tpu_torch.kernels import ops as kops

    for name, functions in FUNCTIONS.items():
        if not calls.get(name):
            continue
        args, kw = calls[name][0]
        fn = getattr(kops, name)
        fn(*args, **kw)
        torch.cuda.synchronize()
        for markers in MARKERS:
            for _ in range(rounds):
                _, kernels, held, _ = cs.profiled_kernels(
                    lambda: [fn(*args, **kw) for _ in range(4)], markers)
                got = sum(e.count for e in kernels if cs.function_hits(e.key, functions))
                print(json.dumps({"where": label, "kernel": name, "markers": markers,
                                  "held_a_marker": held, "calls_held": got,
                                  "other_kernels": sum(e.count for e in kernels) - got}),
                      flush=True)


def card() -> None:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--where", choices=("fresh", "phase3"), default="fresh")
    ap.add_argument("--rounds", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.where == "phase3":
        compare, seen = cs.compare_maintenance_kernels, []

        def probed(calls, label, *a, **kw):
            probe(calls, f"phase3 {label}", args.rounds)
            out = compare(calls, label, *a, **kw)
            seen.append(label)
            if len(seen) == 2:   # main and large: stop the smoke run here
                card()
                os._exit(0)
            return out

        cs.compare_maintenance_kernels = probed
        return cs.main()
    dev = torch.device("cuda", 0)
    cs.lift_sync_check_for_restart_read()
    g, _ = cs.calib_graphs(dev)
    calls = {"calib_gn": cs.calibration_calls(g, 1, dev)["calib_gn"]}
    ecfg, state, _, _ = cs.make_epoch_state(**cs.EPOCH_500, device=dev)
    _, (state, _) = cs.timed_epochs(state, ecfg, 1)
    st = cs.with_payload(state, cs.SEED + 11)
    calls["merge_pairs"] = cs.maintenance_calls(st, cs.state_cfg(st))["merge_pairs"]
    probe(calls, "fresh", args.rounds)
    card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
