#!/usr/bin/env python3
"""K19 (``csrc/merge_pairs.cu``) and K20 (``csrc/calib_gn.cu``) of one
checkout on one card: their device split, launches and idle gaps.

    python3 scripts/k19_k20_split.py [--tree build/parent] [--trials 11]

``--tree`` is the checkout whose package and ``chip_smoke.py`` are used (by
default the one this script lies in; the parent commit unpacked with
``git archive`` into a git-ignored directory gives the parent's kernels).
The arguments are phase 13's: K20's call in ``Slam.calibrate`` on
``chip_smoke.CALIB_1K``'s graph with 1 camera (9 parameters) and with the
front + rear rig and ``update_extrinsics`` (15 parameters); K19's call in
the global-role ``maintenance_epoch`` on the 500-node and the 10k-node
epoch states (``chip_smoke.EPOCH_500`` / ``EPOCH_10K`` after one epoch).
For each call: the result against the plain version (K19 exactly, K20's θ
and cost history as phase 3 holds them), two launches' bits, CUDA events
around the calls (median of ``--trials`` windows), and one profiled call
read from its trace: every device kernel's name, start and duration, the
device µs by device function, the device launches and the idle µs between
the first kernel's start and the last one's end.  Then registers and
spilled bytes of each K19 / K20 device function from the build's
``ptxas -v`` log.  Prints one JSON line a call, the ptxas line and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
# the device functions of either checkout's K19 and K20 (the parent's
# row_keys / greedy_rounds / init_theta / calib_edges / calib_solve)
K19_FUNCTIONS = ("row_keys", "greedy_rounds", "merge_pairs_kernel")
K20_FUNCTIONS = ("init_theta", "calib_edges", "calib_solve", "calib_cluster")


def trace_kernels(fn) -> list:
    """(name, start µs, duration µs) of every device kernel of one profiled
    call of ``fn``, in start order, from the chrome trace of a whole
    profile (``chip_smoke.whole_profile`` of this checkout, whichever
    ``--tree`` is measured)."""
    if "smoke_here" not in sys.modules:
        spec = importlib.util.spec_from_file_location("smoke_here", ROOT / "chip_smoke.py")
        sys.modules["smoke_here"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules["smoke_here"])
    whole, taken = sys.modules["smoke_here"].whole_profile(fn)
    if whole is None:
        raise RuntimeError(f"no whole trace in {taken} profiles")
    with tempfile.NamedTemporaryFile(suffix=".json") as f:
        whole[2].export_chrome_trace(f.name)
        events = json.loads(Path(f.name).read_text()).get("traceEvents", [])
    out = [(e["name"], float(e["ts"]), float(e["dur"])) for e in events
           if e.get("cat") == "kernel" and "spin_kernel" not in e.get("name", "")]
    return sorted(out, key=lambda k: k[1])


def split(kernels: list, functions) -> dict:
    """Device µs by device function, device launches, and the idle µs
    between the K19 / K20 kernels of one trace."""
    mine = [k for k in kernels if any(f in k[0] for f in functions)]
    by_fn = {}
    for name, _, dur in mine:
        f = next(f for f in functions if f in name)
        row = by_fn.setdefault(f, {"launches": 0, "device_us": 0.0})
        row["launches"] += 1
        row["device_us"] += dur
    gaps = [b[1] - (a[1] + a[2]) for a, b in zip(mine, mine[1:])]
    span = (mine[-1][1] + mine[-1][2] - mine[0][1]) if mine else None
    return {"by_function": by_fn, "device_launches": len(mine),
            "device_us": sum(k[2] for k in mine), "span_us": span,
            "idle_us": sum(gaps) if gaps else 0.0,
            "largest_gap_us": max(gaps) if gaps else None,
            "other_kernels": len(kernels) - len(mine)}


def ptxas_rows(tree: Path) -> dict:
    """Registers and spill bytes of the K19 / K20 entries in the build's
    ptxas log (the newest one in the checkout's build directory)."""
    logs = sorted((tree / "build" / "uzliti_slam_tpu_torch").glob("ptxas_*.log"),
                  key=lambda p: p.stat().st_mtime)
    if not logs:
        return {"ptxas": "no log (the library was built elsewhere)"}
    out, name = {}, None
    for ln in logs[-1].read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1) if any(f in m.group(1) for f in
                                     K19_FUNCTIONS + K20_FUNCTIONS) else None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out.setdefault(name, {}).update(stack_bytes=int(m.group(1)),
                                            spill_store_bytes=int(m.group(2)),
                                            spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", ln)
        if m:
            out.setdefault(name, {})["static_smem_bytes"] = int(m.group(1))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--trials", type=int, default=11)
    ap.add_argument("--skip-10k", action="store_true", help="leave out K19 at 10k nodes")
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path.insert(0, str(tree))
    import chip_smoke as cs
    from uzliti_slam_tpu_torch.kernels import _build
    from uzliti_slam_tpu_torch.kernels import ops as kops

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    _build.load()
    cs.lift_sync_check_for_restart_read()
    calls = {}
    g, _ = cs.calib_graphs(dev)
    for cams in (1, 2):
        calls[f"k20_calibrate_{cams}cam"] = ("calib_gn",
                                             cs.calibration_calls(g, cams, dev)["calib_gn"][0])
    sizes = [("500", cs.EPOCH_500)] + ([] if args.skip_10k else [("10k", cs.EPOCH_10K)])
    for label, spec in sizes:
        ecfg, state, _, _ = cs.make_epoch_state(**spec, device=dev)
        _, (state, _) = cs.timed_epochs(state, ecfg, 1)
        st = cs.with_payload(state, cs.SEED + 11)
        calls[f"k19_maintain_{label}"] = ("merge_pairs",
                                          cs.maintenance_calls(st, cs.state_cfg(st))
                                          ["merge_pairs"][0])
        del state, st
    for label, (name, (a, kw)) in calls.items():
        fn = getattr(kops, name)
        got, again = fn(*a, **kw), fn(*a, **kw)
        ref = getattr(kops, f"{name}_plain")(*a, **kw)
        torch.cuda.synchronize()
        row = {"call": label, "same_bits_twice": all(bool(torch.equal(x, y))
                                                      for x, y in zip(got, again))}
        if name == "calib_gn":
            row["theta_max_abs_err"] = float((got[0] - ref[0]).abs().max())
            row["cost_history_max_rel_err"] = float(
                ((got[1] - ref[1]).abs() / ref[1].abs().clamp(min=1e-30)).max())
            row["parameters"] = int(got[0].numel())
            row["edges"] = int(a[0].shape[0])
            row["residual_groups"] = int(a[3].sum()) + int(a[4].sum())
            functions = K20_FUNCTIONS
        else:
            row["mismatches"] = sum(int((x != y).sum()) for x, y in zip(got, ref))
            row["nodes"], row["eligible"] = int(a[0].shape[0]), int(a[2].sum())
            row["pairs"] = int(got[2].sum())
            functions = K19_FUNCTIONS
        row["event_ms"] = cs.time_call(lambda: fn(*a, **kw), trials=args.trials,
                                       calls=3 if name == "calib_gn" else 10)
        kops.reset_launches()
        fn(*a, **kw)
        row["port_launches"] = kops.launches[name]
        row.update(split(trace_kernels(lambda: fn(*a, **kw)), functions))
        row.update(cs.bound(name, (*a, *kw.values())))
        print(json.dumps(row), flush=True)
    print(json.dumps({"ptxas": ptxas_rows(tree)}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
