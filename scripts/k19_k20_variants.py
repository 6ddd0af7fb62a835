#!/usr/bin/env python3
"""Time K19 (``csrc/merge_pairs.cu``) and K20 (``csrc/calib_gn.cu``) built or
launched otherwise, on one card.

    python3 scripts/k19_k20_variants.py [--variants k20,k20:stamps=1,k20:ctas=8,k19]

Each variant is a copy of the package's source, with preprocessor
definitions or text substitutions, compiled by ``nvcc`` with the package's
flags into a library of its own under ``build/k19_k20_variants/`` and
called through the package's wrapper (``kops.calib_gn`` /
``kops.merge_pairs``, with ``_build.load`` pointed at the variant's
library).  A spec is "k20" or "k19" (the shipped source) with, after
colons: ``ctas=<1..16>`` (K20 built with ``-DUZ_CALIB_CTAS``, its cluster
size: called through the C entry with a scratch sized for that cluster);
``warps=<n>``, ``tile=<columns>``, ``minblocks=<n>`` (K19's rows a CTA,
columns staged a pass, and CTAs an SM in its launch bounds);
``stamps=1`` (K20 built with ``-DUZ_CALIB_STAMPS``: the leader's thread 0
reads ``%globaltimer`` around each phase of every step and writes the
phases' ns, summed over the steps, into the first 64 bytes of its scratch:
``K20_PHASES``; K19 built with ``-DUZ_MERGE_STAMPS``: its last CTA's
``%globaltimer`` at its start, after the histogram's threshold, after the
gather and at its end, over its first key slots).  The
arguments are those of ``scripts/k19_k20_split.py``: K20 on the 1k
calibrate with 1 camera and with the rig, K19 at 500 and 10k nodes.  Every
variant is held against the plain version first (K19 exactly; K20's θ and
cost history as phase 3 holds them: one that fails is reported and timed all
the same), then timed: CUDA events around the calls (median of
``--trials``) and the device µs of one profiled call.  Prints one JSON line
a variant and call, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

K20_PHASES = ("item_lists", "extrinsics", "edge_pass_and_sums", "slices_and_barrier",
              "leader_reduce", "solve", "barrier_and_theta", "total")
SOURCES = {"k20": ("calib_gn.cu", "uz_calib_gn", "calib_gn"),
           "k19": ("merge_pairs.cu", "uz_merge_pairs", "merge_pairs")}
# option: (source, its text, the text with the option's value)
SUBSTITUTIONS = {
    "warps": ("merge_pairs.cu", "constexpr int kWarps = 16;", "constexpr int kWarps = {};"),
    "tile": ("merge_pairs.cu", "constexpr int kTile = 3072;", "constexpr int kTile = {};"),
    "minblocks": ("merge_pairs.cu", "__launch_bounds__(kThreads, 2)",
                  "__launch_bounds__(kThreads, {})"),
}


def parse(spec: str) -> tuple[str, dict]:
    kernel, *opts = spec.split(":")
    if kernel not in SOURCES:
        raise SystemExit(f"unknown kernel in {spec!r}")
    return kernel, dict(o.split("=", 1) for o in opts)


def build(nvcc: str, spec: str, kernel: str, opts: dict):
    from uzliti_slam_tpu_torch.kernels import _build

    src_name, entry, _ = SOURCES[kernel]
    text = (_build.CSRC / src_name).read_text()
    for key, (fname, old, new) in SUBSTITUTIONS.items():
        if key in opts and fname == src_name:
            if old not in text:
                raise SystemExit(f"{spec}: {old!r} not in {src_name}")
            text = text.replace(old, new.format(opts[key]))
    out = ROOT / "build" / "k19_k20_variants" / spec.replace(":", "_").replace("=", "-")
    out.mkdir(parents=True, exist_ok=True)
    (out / src_name).write_text(text)
    for header in _build.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    stamps = {"k20": "-DUZ_CALIB_STAMPS=1", "k19": "-DUZ_MERGE_STAMPS=1"}[kernel]
    flags = list(_build.NVCC_FLAGS) + ([stamps] if opts.get("stamps") else [])
    if kernel == "k20" and "ctas" in opts:
        flags.append(f"-DUZ_CALIB_CTAS={int(opts['ctas'])}")
    lib = out / "lib.so"
    proc = subprocess.run([nvcc, *flags, "-shared", "-o", str(lib), str(out / src_name)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{spec}: nvcc failed\n{proc.stderr}")
    regs = [ln.strip() for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]
    cdll = ctypes.CDLL(str(lib))
    fn = getattr(cdll, entry)
    fn.argtypes = _build.SIGNATURES[entry]
    fn.restype = ctypes.c_int
    return cdll, regs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="k20,k20:stamps=1,k20:ctas=8,k19")
    ap.add_argument("--trials", type=int, default=11)
    ap.add_argument("--skip-10k", action="store_true")
    args = ap.parse_args()
    import chip_smoke as cs
    import k19_k20_split as split
    from uzliti_slam_tpu_torch.kernels import _build
    from uzliti_slam_tpu_torch.kernels import ops as kops

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    nvcc = _build.find_nvcc()
    cs.lift_sync_check_for_restart_read()
    calls = {}
    g, _ = cs.calib_graphs(dev)
    for cams in (1, 2):
        calls[f"calibrate_{cams}cam"] = ("k20", cs.calibration_calls(g, cams, dev)["calib_gn"][0])
    sizes = [("500", cs.EPOCH_500)] + ([] if args.skip_10k else [("10k", cs.EPOCH_10K)])
    for label, spec in sizes:
        ecfg, state, _, _ = cs.make_epoch_state(**spec, device=dev)
        _, (state, _) = cs.timed_epochs(state, ecfg, 1)
        st = cs.with_payload(state, cs.SEED + 11)
        calls[f"maintain_{label}"] = ("k19", cs.maintenance_calls(st, cs.state_cfg(st))
                                      ["merge_pairs"][0])
    load = _build.load
    for spec in args.variants.split(","):
        kernel, opts = parse(spec)
        lib, regs = build(nvcc, spec, kernel, opts)
        print(json.dumps({"variant": spec, "ptxas": regs}), flush=True)
        wrapper = SOURCES[kernel][2]
        _build.load = lambda lib=lib: lib
        try:
            for label, (k, (a, kw)) in calls.items():
                if k != kernel:
                    continue
                fn = getattr(kops, wrapper)
                if "ctas" in opts:   # another cluster size: a scratch sized for it
                    call = lambda: calib_direct(lib, a, int(opts["ctas"]))[:2]   # noqa: E731
                else:
                    call = lambda: fn(*a, **kw)   # noqa: E731
                got, again = call(), call()
                ref = getattr(kops, f"{wrapper}_plain")(*a, **kw)
                torch.cuda.synchronize()
                row = {"variant": spec, "call": label,
                       "same_bits_twice": all(bool(torch.equal(x, y)) for x, y in zip(got, again))}
                if kernel == "k20":
                    row["theta_max_abs_err"] = float((got[0] - ref[0]).abs().max())
                    row["cost_history_max_rel_err"] = float(
                        ((got[1] - ref[1]).abs() / ref[1].abs().clamp(min=1e-30)).max())
                    row["within_bars"] = (row["theta_max_abs_err"] <= cs.CALIB_THETA_ATOL and
                                          row["cost_history_max_rel_err"] <= cs.CALIB_HIST_RTOL)
                else:
                    row["mismatches"] = sum(int((x != y).sum()) for x, y in zip(got, ref))
                row["event_ms"] = cs.time_call(call, trials=args.trials,
                                               calls=3 if kernel == "k20" else 10)
                row.update(split.split(split.trace_kernels(call),
                                       split.K20_FUNCTIONS + split.K19_FUNCTIONS))
                if opts.get("stamps") and kernel == "k20":
                    row["phases_us"] = stamped_phases(lib, a, int(opts.get("ctas", 0)) or None)
                if opts.get("stamps") and kernel == "k19":
                    row["last_cta_us"] = merge_stamps(lib, a)
                print(json.dumps(row), flush=True)
        finally:
            _build.load = load
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    return 0


def merge_stamps(lib, a) -> dict:
    """One call of a stamps build of K19 as ``kops.merge_pairs`` makes it,
    its scratch kept: the last CTA's phases in µs."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    pose, stamp, elig, dist, angle, max_pairs = a
    n, K = pose.shape[0], 2 * max_pairs - 1
    scratch = torch.empty(n * K, dtype=torch.int64, device=pose.device)
    out = torch.empty(3 * max_pairs, dtype=torch.int32, device=pose.device)
    hist = kops.merge_pairs_scratch(pose.device).data_ptr()
    err = lib.uz_merge_pairs(pose.data_ptr(), stamp.data_ptr(), elig.data_ptr(), n, float(dist),
                             kops.merge_dist_bound(float(dist))[1], float(angle), max_pairs,
                             scratch.data_ptr(), hist, hist + 4 * kops.MERGE_HIST_BINS,
                             out.data_ptr(), out[max_pairs:].data_ptr(),
                             out[2 * max_pairs:].view(torch.bool).data_ptr(),
                             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"merge_pairs stamps build: cudaError_t {err}")
    t = scratch[:4].cpu().tolist()
    return {"histograms": (t[1] - t[0]) / 1e3, "gather": (t[2] - t[1]) / 1e3,
            "rounds": (t[3] - t[2]) / 1e3, "total": (t[3] - t[0]) / 1e3}


def calib_direct(lib, a, ctas=None):
    """K20 called through its C entry as ``kops.calib_gn`` calls it, with
    the scratch sized for a build's cluster of ``ctas`` CTAs (the shipped
    size if None; ``kops.calib_scratch_ints``'s count for that size):
    (theta, cost history, the scratch)."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    Xi, Xj, meas, is_s, is_o, sf, st, L0, iters, prior, damping = a
    E, S = Xi.shape[0], L0.shape[0]
    ctas = ctas or kops.CALIB_CLUSTER_CTAS
    P = 6 * S + 3
    items = torch.empty(ctas * (30 * (-(-E // ctas)) + 1), dtype=torch.int32, device=Xi.device)
    out = torch.empty(P + iters + 1, dtype=torch.float32, device=Xi.device)
    err = lib.uz_calib_gn(*(t.data_ptr() for t in (Xi, Xj, meas, is_s, is_o, sf, st, L0)), E, S,
                          int(iters), kops.calib_sqrt_prior(prior), float(damping),
                          items.data_ptr(), out.data_ptr(), out[P:].data_ptr(),
                          torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"calib_gn variant: cudaError_t {err}")
    return out[:P], out[P:], items


def stamped_phases(lib, a, ctas) -> dict:
    """One call of a stamps build of K20, its scratch kept: the phases' µs
    summed over the steps."""
    items = calib_direct(lib, a, ctas)[2]
    ns = items[:16].view(torch.int64).cpu().tolist()
    return {name: v / 1e3 for name, v in zip(K20_PHASES, ns)}


if __name__ == "__main__":
    sys.exit(main())
