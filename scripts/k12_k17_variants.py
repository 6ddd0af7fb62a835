#!/usr/bin/env python3
"""Time variants of K12 (``csrc/fast_nms.cu``) and K17
(``csrc/bilateral.cu``) beside the shipped kernels on one card, and probe
how often a profile drops K17.

    python3 scripts/k12_k17_variants.py [--variants k12:reject=0,k17:table=0]
        [--trials 11] [--profiles 20]

A variant is "<k12|k17>:<knob>=<value>[,<knob>=<value>...]", a copy of the
package's source with the knobs' constants substituted: K12's ``reject=0``
(no early rejection: ``kEarlyReject``), ``tiley=16`` (a 32 x 16 output
tile: ``kTileY``) and ``minblocks=N`` (``__launch_bounds__``' CTAs an SM:
``kMinBlocks``); K17's ``table=0`` (no colour table: ``kColourTable``),
``rows=4`` (a 32 x 32 tile, four rows a thread: ``kTy``), ``minblocks=N``
and ``index=int`` (the colour table indexed from an integer tile of the
guides, converted once a loaded pixel, not by converting |g' - g| at each
tap).  Each is written into ``build/k12_k17_variants/``,
compiled by ``nvcc`` with the package's flags into a library of its own and
bound with ctypes like the package's library; the wrappers
(``kops.fast_nms``, ``kops.bilateral``) run it with ``_build.load`` pointed
at it.  The shipped kernels come from the package's library (its ptxas
registers printed first).  Inputs: the arguments one VGA keyframe gives
K12 (its four levels) and K17 (the step's default configuration: the uint8
guide) on the JAX bench's WallWorld frame, 1 camera and the front + rear rig
(``chip_smoke.keyframe_world``, ``step_config``); K12 also on
``chip_smoke.fast_nms_cases``' noise and flat pyramids, K17 on
``chip_smoke.bilateral_cases``' fractional guide (where both builds take
expf at each tap).  Every variant is first held against the plain version
(K12 exactly, K17 at 0 ulps).  Each is timed in turns: CUDA events around
10 calls (median of ``--trials``), device ms a call queued behind a sleep
kernel (``chip_smoke.queued_device_ms``), and device ms a call over 20
profiled calls (null where the trace holds no such kernel).

The probe: ``--profiles`` profiles of one K17 call on the step's arguments,
and as many with a warm-up kernel (``torch.cuda._sleep``) and a
synchronisation inside the profile before the call: in how many the trace
holds ``bilateral_tile``; the same for one ``pipeline.keyframe_frontend``
call of the default configuration.  Prints one JSON line a variant and
input, the probe's counts, and the card's name and power limit.
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

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCES = {"k12": ("fast_nms.cu", "uz_fast_nms_levels"), "k17": ("bilateral.cu", "uz_bilateral")}
# each knob: a pattern matching the shipped text once, and the variant's
# text with {} for the value
KNOBS = {
    ("k12", "reject"): (r"constexpr bool kEarlyReject = \w+;",
                        "constexpr bool kEarlyReject = {};"),
    ("k12", "tiley"): (r"constexpr int kTileX = 32, kTileY = \d+;",
                       "constexpr int kTileX = 32, kTileY = {};"),
    ("k12", "minblocks"): (r"constexpr int kMinBlocks = \d+;", "constexpr int kMinBlocks = {};"),
    ("k17", "table"): (r"constexpr bool kColourTable = \w+;",
                       "constexpr bool kColourTable = {};"),
    ("k17", "rows"): (r"constexpr int kTx = 32, kTy = \d+;", "constexpr int kTx = 32, kTy = {};"),
    ("k17", "minblocks"): (r"constexpr int kMinBlocks = \d+;", "constexpr int kMinBlocks = {};"),
}
# K17's index=int: the colour table indexed by |g' - g| of an integer tile of
# the guides (one conversion a loaded pixel) in place of a conversion of the
# float difference at each tap
INT_INDEX = (
    ("  __shared__ float wc[kLevels];",
     "  __shared__ int si[kSh][kSw];\n  __shared__ float wc[kLevels];"),
    ("    sg[ty][tx] = g;\n",
     "    sg[ty][tx] = g;\n"
     "    si[ty][tx] = g >= 0.f && g <= 255.f && g == truncf(g) ? static_cast<int>(g) : 0;\n"),
    ("const float (*sg)[kSw],\n", "const float (*sg)[kSw], const int (*si)[kSw],\n"),
    ("  const float gc = sg[cy][cx];\n",
     "  const float gc = sg[cy][cx];\n  const int gi = si[cy][cx];\n"),
    ("wc[__float2int_rn(fabsf(t))]", "wc[abs(si[cy - dy][cx - dx] - gi)]"),
    ("filter_pixel<true>(sd, sg, wc,", "filter_pixel<true>(sd, sg, si, wc,"),
    ("filter_pixel<false>(sd, sg, wc,", "filter_pixel<false>(sd, sg, si, wc,"),
)


def variant_source(spec: str) -> str:
    """The source of variant ``spec``."""
    from uzliti_slam_tpu_torch.kernels import _build

    kernel, _, knobs = spec.partition(":")
    src = (_build.CSRC / SOURCES[kernel][0]).read_text()
    for knob, value in (kv.split("=") for kv in knobs.split(",") if kv):
        if (kernel, knob) == ("k17", "index"):
            if value != "int":
                raise ValueError(f"k12_k17_variants: index={value}, only index=int")
            for old, text in INT_INDEX:
                if src.count(old) != 1:
                    raise ValueError(f"k12_k17_variants: {old!r} is not once in bilateral.cu")
                src = src.replace(old, text)
            continue
        pattern, new = KNOBS[(kernel, knob)]
        if knob in ("reject", "table"):
            value = "true" if value == "1" else "false"
        elif knob == "rows":
            value = str(8 * int(value))
        src, n = re.subn(pattern, new.replace("{}", value), src)
        if n != 1:
            raise ValueError(f"k12_k17_variants: {pattern!r} matched {n} times in "
                             f"{SOURCES[kernel][0]}")
    return src


def _specs(text: str) -> list:
    """Variant specs from a comma list: a "knob=value" without a colon
    belongs to the spec before it."""
    out = []
    for part in text.split(","):
        if "=" in part and ":" not in part:
            out[-1] += "," + part
        else:
            out.append(part)
    return out


def build(nvcc: str, out_dir: Path, spec: str) -> ctypes.CDLL:
    """The library of variant ``spec``."""
    from uzliti_slam_tpu_torch.kernels import _build

    entry = SOURCES[spec.partition(":")[0]][1]
    name = spec.replace(":", "_").replace(",", "_").replace("=", "")
    cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(variant_source(spec))
    cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    ptxas = [ln for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]
    print(json.dumps({"variant": spec, "ptxas": ptxas}), flush=True)
    handle = ctypes.CDLL(str(lib))
    getattr(handle, entry).argtypes = _build.SIGNATURES[entry]
    getattr(handle, entry).restype = ctypes.c_int
    return handle


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="k12:reject=0,k12:minblocks=1,k12:minblocks=8,"
                                          "k17:table=0,k17:index=int,k17:minblocks=8")
    ap.add_argument("--trials", type=int, default=11)
    ap.add_argument("--profiles", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k12_k17_variants: no CUDA card", file=sys.stderr)
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
            f: summary.get(f) for f in ("fast_nms_levels", "bilateral_tile")}}), flush=True)
    out_dir = _build.BUILD_DIR.parent / "k12_k17_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    libs = {spec: build(nvcc, out_dir, spec) for spec in _specs(args.variants)}

    world, frames = cs.keyframe_world()
    k12_inputs, k17_inputs, frontend = {}, {}, {}
    for n_cams in (1, 2):
        cfg, pose = cs.step_config(n_cams, dev)
        inputs = cs.frame_inputs(frames[0], n_cams)
        frontend[n_cams] = (lambda i=inputs, p=pose, c=cfg:
                            pipeline.keyframe_frontend(*i, world.cam, p, c))
        calls = cs.record_args(frontend[n_cams], ("fast_nms", "bilateral"))
        k12_inputs[f"step_{n_cams}cam"] = calls["fast_nms"][0][0][0]
        k17_inputs[f"step_{n_cams}cam"] = calls["bilateral"][0][0]
    cases = cs.fast_nms_cases(dev)
    k12_inputs.update(noise_vga=cases["noise_vga"], flat_vga=cases["flat_vga"])
    k17_inputs["fractional_guide"] = cs.bilateral_cases(dev)["fractional_guide"]

    def with_lib(lib, fn):
        def run():
            saved = _build.load
            _build.load = lambda: lib
            try:
                return fn()
            finally:
                _build.load = saved
        return run

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

    kernels = (("fast_nms", "k12", k12_inputs, "fast_nms_levels"),
               ("bilateral", "k17", k17_inputs, "bilateral_tile"))
    for wrapper, kernel, inputs, function in kernels:
        for name, a in inputs.items():
            call = ((lambda a=a: kops.fast_nms(a, 20.0)) if wrapper == "fast_nms"
                    else (lambda a=a: kops.bilateral(*a)))
            runs = {"shipped": with_lib(shipped, call)}
            runs.update({v: with_lib(lib, call) for v, lib in libs.items()
                         if v.startswith(kernel)})
            ref = (kops.fast_nms_plain(a, 20.0) if wrapper == "fast_nms"
                   else kops.bilateral_plain(*a))
            for v, fn in runs.items():
                got = fn()
                torch.cuda.synchronize()
                if wrapper == "fast_nms":
                    bad = sum(int((x != y).sum()) for x, y in zip(got, ref))
                else:
                    bad = cs._ulps(got, ref)
                if bad:
                    raise AssertionError(f"{v} {name}: {bad} apart from the plain version")
            times = {k: [] for k in runs}
            for t in range(2):   # two rounds, the order reversed in the second
                for k in (list(runs) if t == 0 else list(runs)[::-1]):
                    times[k] += events(runs[k])
            for v, fn in runs.items():
                print(json.dumps({"kernel": wrapper, "variant": v, "input": name,
                                  "ms": statistics.median(times[v]),
                                  "device_ms_queued": cs.queued_device_ms(fn),
                                  "device_ms": cs.device_ms_of(lambda: [fn() for _ in range(20)],
                                                               20, function)}), flush=True)

    # the probe: does a profile hold K17's kernel, with and without a warm-up
    def held(fn, warm: bool) -> bool:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            if warm:
                torch.cuda._sleep(1000)
                torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        return any("bilateral_tile" in e.key for e in prof.key_averages()
                   if e.device_type.name == "CUDA")

    step = k17_inputs["step_1cam"]
    probe = {}
    for label, fn in (("bilateral_call", lambda: kops.bilateral(*step)),
                      ("keyframe_frontend", frontend[1])):
        for warm in (False, True):
            probe[f"{label}{'_warm' if warm else ''}"] = sum(held(fn, warm)
                                                             for _ in range(args.profiles))
    print(json.dumps({"probe_profiles_holding_bilateral_tile": probe,
                      "profiles": args.profiles}), flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
