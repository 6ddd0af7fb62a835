#!/usr/bin/env python3
"""Check K7 (``csrc/ransac_rigid.cu``) and K15 (``csrc/scan_bins.cu``)
against their plain versions on one card, and time variants of them beside
the shipped kernels.

    python3 scripts/k7_k15_variants.py [--variants k7:lanes=4,k15:cluster=8]
        [--trials 11]

A variant is "<k7|k15>:<knob>=<value>[,<knob>=<value>...]", a copy of the
package's source with the knobs' constants substituted: K7's ``lanes=N``
(N lanes a hypothesis's consensus at every K: ``kLanes``; the shipped 0
takes 1024 / K' of the K' a CTA tests), ``cluster=N`` (CTAs a root at
most: ``kMaxCluster``; 1 is one CTA a root) and ``stamps=1``
(``%globaltimer`` stamps at the kernel's start and after each phase,
written over the first 7 counts of every root: the phases' ns, printed as
the median over roots, in place of the check); K15's ``pixels=N`` (pixels
a thread: ``kPixelsPerThread``) and ``threads=N`` (a CTA's threads:
``kThreads``); and "k15:cluster", not a copy but
``scripts/k15_cluster.cu``, the form of one thread-block cluster a camera
(no device scratch).  Each is written into ``build/k7_k15_variants/``,
compiled by ``nvcc`` with the package's flags into a library of its own and
bound with ctypes like the package's library; the wrappers
(``kops.ransac_rigid``, ``kops.scan_bins``) run it with ``_build.load``
pointed at it (the cluster form through its own entry).  The shipped kernels come from the package's
library (its ptxas registers printed first).  Inputs: K7 on the 500-node
epoch's roots (``chip_smoke.epoch_kernel_inputs``: uniform draws), a
step-shaped call (5 roots x 256 correspondences x 128 hypotheses with
soft-PROSAC quality, 60 % valid, 30 % of them outliers) and
``chip_smoke.ransac_edge_cases``; K15 on the depth one VGA keyframe gives
it (the JAX bench's WallWorld frame, 1 camera and the front + rear rig)
and its points entry on ``chip_smoke.bin_min_max_cases``.  Every build is
first held against the plain version (K7 by
``chip_smoke.compare_ransac_draws``, K15's scans with at most
``chip_smoke.MAX_MOVED_BINS`` moved bins, its points entry exactly), then
timed in turns: CUDA events around 10 calls (median of ``--trials``), and
device ms a call queued behind a sleep kernel
(``chip_smoke.queued_device_ms``).  Prints one JSON line a variant and
input, and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCES = {"k7": ("ransac_rigid.cu", "uz_ransac_rigid"), "k15": ("scan_bins.cu", "uz_scan_bins")}
# each knob: a pattern matching the shipped text once, and the variant's
# text with {} for the value
KNOBS = {
    ("k7", "lanes"): (r"constexpr int kLanes = \d+;", "constexpr int kLanes = {};"),
    ("k7", "cluster"): (r"constexpr int kMaxCluster = \d+;", "constexpr int kMaxCluster = {};"),
    ("k15", "pixels"): (r"constexpr int kPixelsPerThread = \d+;",
                        "constexpr int kPixelsPerThread = {};"),
    ("k15", "threads"): (r"constexpr int kThreads = \d+;", "constexpr int kThreads = {};"),
}
CLUSTER_SOURCE = ROOT / "scripts" / "k15_cluster.cu"
# K7's stamps=1: (anchor text, the text put after it); stamp i at the start
# and after loading, the draw, the fits, the consensus, the argmax, the refit
# and the end
STAMP_DEF = ("  __shared__ float s_fit[7];\n",
             "  __shared__ long long s_t[8];\n"
             "  auto stamp = [&](int i) {\n"
             "    __syncthreads();\n"
             "    if (threadIdx.x == 0) {\n"
             "      long long t;\n"
             "      asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
             "      s_t[i] = t;\n"
             "    }\n"
             "  };\n"
             "  stamp(0);\n")
STAMPS = (
    ("  if (p.uniforms != nullptr)\n    draw_triplets(", "", "  stamp(1);\n"),
    ("  // 1: one Horn fit per hypothesis", "", "  stamp(2);\n"),
    ("  // 2: the consensus, `lanes` lanes a hypothesis\n", "", "  stamp(3);\n"),
    ("  // 3: the first argmax", "", "  stamp(4);\n"),
    ("  // 4: the refit.", "", "  stamp(5);\n"),
    ("  // 5: consensus and mse under the refit", "", "  stamp(6);\n"),
    ("      p.ok[r] = consensus >= p.min_consensus && best_count > 0;\n    }\n  }\n",
     "  stamp(7);\n  if (threadIdx.x == 0)\n"
     "    for (int i = 0; i < 7; ++i) p.counts[r * K + i] = static_cast<int>(s_t[i + 1] - s_t[i]);\n",
     ""),
)


def variant_source(spec: str) -> str:
    """The source of variant ``spec``."""
    from uzliti_slam_tpu_torch.kernels import _build

    kernel, _, knobs = spec.partition(":")
    if spec == "k15:cluster":
        return CLUSTER_SOURCE.read_text()
    src = (_build.CSRC / SOURCES[kernel][0]).read_text()
    for knob, value in (kv.split("=") for kv in knobs.split(",") if kv):
        if (kernel, knob) == ("k7", "stamps"):
            for anchor, after, before in (STAMP_DEF + ("",),) + STAMPS:
                if src.count(anchor) != 1:
                    raise ValueError(f"k7_k15_variants: {anchor!r} is not once in "
                                     "ransac_rigid.cu")
                src = src.replace(anchor, before + anchor + after)
            continue
        pattern, new = KNOBS[(kernel, knob)]
        src, n = re.subn(pattern, new.replace("{}", value), src)
        if n != 1:
            raise ValueError(f"k7_k15_variants: {pattern!r} matched {n} times in "
                             f"{SOURCES[kernel][0]}")
    return src


def _specs(text: str) -> list:
    """Variant specs from a comma list: a "knob=value" without a colon
    belongs to the spec before it."""
    out = []
    for part in text.split(","):
        if not part:
            continue
        if "=" in part and ":" not in part:
            out[-1] += "," + part
        else:
            out.append(part)
    return out


def build(nvcc: str, out_dir: Path, spec: str) -> ctypes.CDLL:
    """The library of variant ``spec`` (its source and the headers it
    includes, compiled alone)."""
    from uzliti_slam_tpu_torch.kernels import _build

    entry = "uz_scan_bins_cluster" if spec == "k15:cluster" else SOURCES[spec.partition(":")[0]][1]
    name = spec.replace(":", "_").replace(",", "_").replace("=", "")
    cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(variant_source(spec))
    cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    ptxas = [ln for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]
    print(json.dumps({"variant": spec, "ptxas": ptxas}), flush=True)
    handle = ctypes.CDLL(str(lib))
    getattr(handle, entry).argtypes = (_build.SIGNATURES["uz_scan_bins"][:19] + [ctypes.c_void_p] * 2
                                       if spec == "k15:cluster" else _build.SIGNATURES[entry])
    getattr(handle, entry).restype = ctypes.c_int
    return handle


def step_shaped(dev, seed: int = 0) -> tuple:
    """K7's arguments in the shape of a keyframe step's call: 5 candidate
    nodes' 256 correspondences, 128 hypotheses, soft-PROSAC quality (minus
    Hamming distances), 60 % valid, 30 % of the points outliers."""
    import chip_smoke as cs
    from uzliti_slam_tpu_torch.ops import ransac

    rng = np.random.default_rng(seed)
    R, M, K = 5, 256, 128
    src = rng.uniform(-3, 3, (M, 3)).astype(np.float32)
    dst = np.empty((R, M, 3), np.float32)
    for r in range(R):
        ang = rng.uniform(-0.5, 0.5)
        rot = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                        [0, 0, 1]], np.float32)
        dst[r] = src @ rot.T + rng.normal(0, 0.5, 3) + rng.normal(0, 0.01, (M, 3))
    out = rng.random((R, M)) < 0.3
    dst[out] += rng.uniform(-2, 2, (int(out.sum()), 3)).astype(np.float32)
    valid = torch.from_numpy(rng.random((R, M)) < 0.6).to(dev)
    quality = torch.from_numpy(-rng.integers(0, 65, (R, M)).astype(np.float32)).to(dev)
    u = ransac.draw_uniforms(torch.Generator(device=dev).manual_seed(cs.SEED), K, valid)
    return (torch.from_numpy(src).to(dev)[None].expand(R, M, 3),
            torch.from_numpy(dst).to(dev), valid, None, 0.05, 12, 0.01, None, u, quality)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="k7:lanes=4,k7:lanes=16,k7:stamps=1,k15:cluster,"
                                          "k15:pixels=1,k15:pixels=8,k15:threads=512")
    ap.add_argument("--trials", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_k15_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.kernels import _build
    from uzliti_slam_tpu_torch.kernels import ops as kops

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    shipped = _build.load()
    log = _build.BUILD_DIR / f"ptxas_{_build.source_hash()}.log"
    if log.exists():
        summary = cs.ptxas_summary(log.read_text())
        print(json.dumps({"variant": "shipped", "ptxas": {
            f: summary.get(f) for f in ("ransac_draw_fit", "scan_grid", "bin_points")}}),
              flush=True)
    out_dir = _build.BUILD_DIR.parent / "k7_k15_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    libs = {spec: build(nvcc, out_dir, spec) for spec in _specs(args.variants)}

    def with_lib(lib, fn):
        def run():
            saved = _build.load
            _build.load = lambda: lib
            try:
                return fn()
            finally:
                _build.load = saved
        return run

    ecfg, state, _, _ = cs.make_epoch_state(**cs.EPOCH_500, device=dev)
    k7_inputs = {"epoch500": cs.epoch_kernel_inputs(state, ecfg)["ransac_rigid"],
                 "step_shaped": step_shaped(dev), "edge_cases": cs.ransac_edge_cases(dev)}
    del state
    world, frames = cs.keyframe_world()
    k15_inputs = {}
    for n_cams in (1, 2):
        cfg, pose = cs.step_config(n_cams, dev)
        calls = cs.record_args(lambda: pipeline.keyframe_frontend(
            *cs.frame_inputs(frames[0], n_cams), world.cam, pose, cfg), ("scan_bins",))
        k15_inputs[f"vga_{n_cams}cam"] = calls["scan_bins"][0][0]

    def events(fn, calls=10):
        out = []
        for _ in range(args.trials):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            b.synchronize()
            out.append(a.elapsed_time(b) / calls)
        return out

    def k15_check(got, ref) -> int:
        moved = sum(int((g != r).sum()) for g, r in zip(got, ref))
        cs.check(moved <= cs.MAX_MOVED_BINS * ref[0].shape[0], f"scan_bins: {moved} bins moved")
        return moved

    # the points entry (the shipped library): exact on its edge cases
    print(json.dumps({"kernel": "bin_min_max", "variant": "shipped",
                      "cases": cs.compare_bin_min_max_cases(dev, "variants")}), flush=True)
    def cluster_scan(lib, depth, cam, xf, n_bins, angle_min, angle_max, band, max_range,
                     min_range):
        """The cluster form's one call, as ``kops.scan_bins`` makes the
        shipped one (no scratch)."""
        from uzliti_slam_tpu_torch.ops import scan

        C, H, W = depth.shape
        out = torch.empty(2, C, n_bins, dtype=torch.float32, device=dev)
        scale = scan.range_scale(max_range)
        err = lib.uz_scan_bins_cluster(
            depth.data_ptr(), xf.data_ptr(), C, H, W, float(cam.fx), float(cam.fy),
            float(cam.cx), float(cam.cy), n_bins, float(angle_min), float(angle_max),
            scan.bin_factor(n_bins, angle_min, angle_max), float(band[0]), float(band[1]),
            float(min_range), float(max_range), scale, scan.f32_reciprocal(scale),
            out.data_ptr(), kops._stream(dev))
        kops._raise_on(err, "scan_bins_cluster")
        return out[0], out[1]

    for kernel, wrapper, inputs in (("k7", kops.ransac_rigid, k7_inputs),
                                    ("k15", kops.scan_bins, k15_inputs)):
        for name, a in inputs.items():
            call = lambda a=a: wrapper(*a)               # noqa: E731
            runs = {"shipped": with_lib(shipped, call)}
            runs.update({v: (lambda a=a, lib=lib: cluster_scan(lib, *a)) if v == "k15:cluster"
                         else with_lib(lib, call) for v, lib in libs.items()
                         if v.startswith(kernel + ":")})
            held = {}
            for v, fn in runs.items():
                if "stamps=1" in v:
                    got = fn()
                    torch.cuda.synchronize()
                    held[v] = {"phase_ns_median_over_roots": [
                        float(x) for x in got[6][:, :7].float().median(dim=0).values],
                        "phases": ["load", "draw", "fits", "consensus", "argmax", "refit",
                                   "final consensus"]}
                elif kernel == "k7":
                    saved = _build.load
                    _build.load = lambda lib=(shipped if v == "shipped" else libs[v]): lib
                    try:
                        row = cs.compare_ransac_draws(a, f"{v} {name}")
                    finally:
                        _build.load = saved
                    held[v] = {"max_abs_err": row["max_abs_err"],
                               "draws_differ": row["draw"]["differ"]}
                else:
                    held[v] = {"moved_bins": k15_check(fn(), kops.scan_bins_plain(*a))}
            times = {k: [] for k in runs}
            for t in range(2):   # two rounds, the order reversed in the second
                for k in (list(runs) if t == 0 else list(runs)[::-1]):
                    times[k] += events(runs[k])
            for v, fn in runs.items():
                print(json.dumps({"kernel": kernel, "variant": v, "input": name, **held[v],
                                  "ms": statistics.median(times[v]),
                                  "device_ms_queued": cs.queued_device_ms(fn)}), flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
