#!/usr/bin/env python3
"""Time K27 (``csrc/gicp.cu``) and K28 (``csrc/pnp.cu``) built with other
launch shapes, on one card.

    python3 scripts/k27_k28_variants.py [--variants k27:8x256,k27:16x256:lanes=16,k28:8x4,k28:8x4:polish=1]

Each variant is a copy of the package's source with text substitutions,
written into ``build/k27_k28_variants/``, compiled by ``nvcc`` with the
package's flags into a library of its own and bound with ctypes like the
package's library.  A spec is "k27:<CTAs>x<threads>" (the cluster's CTAs a
target cloud and each CTA's threads) with, after a colon, ``lanes=<4|8|16|32>``
(lanes that split one source point's search) and ``stamps=1`` (the leader's
thread 0 reads ``%globaltimer`` around every phase and writes the phases'
ns, summed over the iterations, in place of the first-iteration matches:
``K27_PHASES``); or "k28:<CTAs>x<draws>" (the
cluster's CTAs a candidate and the draws a CTA takes a pass: 3 warps a
draw) with ``polish=<CTAs>`` (the Gauss-Newton polish spread over the
cluster, its sums through a cluster barrier a step; ``polish=1``, the
leader CTA alone, is the shipped form), and ``sweeps=<n>`` (at most n one-sided Jacobi
sweeps in place of 12: a probe of how much of the fits' time the
sweeps' cap holds; such a variant fails the check and is timed all the
same, its ``max_abs_err`` null).  "k27:8x512" and "k28:8x8" alone are the shipped
kernels (K27 with 16 lanes a point, K28's polish in the leader CTA).  The arguments are phase 15's: a late VGA keyframe step's K27 and
K28 calls (phase 11's 13 frames, 1 camera, ``estimation.method`` "gicp" or
"pnp") and the large rows (``chip_smoke.registration_large_calls``: 10
clouds of V = 1,024; 10 problems x 256 draws at M = 512).  Each variant is
first held against the package's plain version as phase 15a holds the
kernel (``chip_smoke._registration_mismatch``; one that fails is reported
and timed all the same), then the variants of a kernel are timed in turns: CUDA events around 10 calls (median of
``--trials``), and device ms a call over 20 profiled calls (null where the
trace holds no such kernel); K28's also report their ``%globaltimer``
phases.  Prints one JSON line a variant and shape, and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

# (source, the shipped shape's text, its form with the spec's numbers)
SHAPES = {
    "k27": ("gicp.cu", "constexpr int kClusterCtas = 8, kCtaThreads = 512;",
            "constexpr int kClusterCtas = {0}, kCtaThreads = {1};"),
    "k28": ("pnp.cu", "constexpr int kClusterCtas = 8, kDraws = 8, kPolishCtas = 1;",
            "constexpr int kClusterCtas = {0}, kDraws = {1}, kPolishCtas = 1;"),
}


# K27's stamps build (``k27:...:stamps=1``): (text of the shipped source,
# what replaces it); thread 0 of each cluster's leader reads %globaltimer
# around every phase, sums each phase over the iterations, and writes the
# ns into the first-iteration matches buffer in place of the matches: the
# search and its rows, the warp and CTA sums, the cluster barrier, the
# cluster sums, the solve, the prologue before the first iteration, and
# the launch's total
K27_PHASES = ("search_and_rows", "cta_sums", "cluster_barrier", "cluster_sums", "solve_lu",
              "solve_exp_and_handout", "prologue", "total")
K27_STAMPS = (
    ("namespace {\n",
     "namespace {\n\n__device__ __forceinline__ unsigned long long now_ns() {\n"
     "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  const unsigned long long t_start = now_ns();\n"
     "  cg::cluster_group cluster = cg::this_cluster();\n"),
    ("  for (int it = 0; it <= iterations; ++it) {\n",
     "  unsigned long long stamp = now_ns(), phase[7] = {};\n  phase[6] = stamp - t_start;\n"
     "  const auto lap = [&](int q) {\n    const unsigned long long t = now_ns();\n"
     "    phase[q] += t - stamp;\n    stamp = t;\n  };\n"
     "  for (int it = 0; it <= iterations; ++it) {\n"),
    ("    // the sums: a warp tree", "    lap(0);\n    // the sums: a warp tree"),
    ("    cluster.sync();\n    if (tid < kSums) {",
     "    lap(1);\n    cluster.sync();\n    lap(2);\n    if (tid < kSums) {"),
    ("      tot[tid] = t;\n    }\n    if (!audit) {\n",
     "      tot[tid] = t;\n    }\n    lap(3);\n    if (!audit) {\n"),
    ("        uz::lu_solve6(H, g, x);\n", "        uz::lu_solve6(H, g, x);\n        lap(4);\n"),
    ("      for (int k = 0; k < 7; ++k) pose[k] = spose[k];\n      continue;",
     "      for (int k = 0; k < 7; ++k) pose[k] = spose[k];\n      lap(5);\n      continue;"),
    ("      ok_out[b] = fraction > min_fraction && dt <= max_t && dr <= max_r && finite;\n",
     "      ok_out[b] = fraction > min_fraction && dt <= max_t && dr <= max_r && finite;\n"
     "      if (matches) {\n"
     "        for (int q = 0; q < 7; ++q) matches[static_cast<size_t>(b) * M + q] = "
     "static_cast<int>(phase[q]);\n"
     "        matches[static_cast<size_t>(b) * M + 7] = static_cast<int>(now_ns() - t_start);\n"
     "      }\n"),
)


def substitute(src: str, old: str, new: str, name: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"k27_k28_variants: {old!r} is not once in csrc/{name}")
    return src.replace(old, new)


def variant_source(spec: str) -> tuple[str, str]:
    """(kernel, source) of variant ``spec``: "k27:<CTAs>x<threads>[:knob=value,...]"
    or "k28:<CTAs>x<draws>[:knob=value,...]"."""
    from uzliti_slam_tpu_torch.kernels import _build

    kernel, shape, *rest = spec.split(":")
    knobs = rest[0] if rest else ""
    name, old, new = SHAPES[kernel]
    a, b = (int(v) for v in shape.split("x"))
    src = substitute((_build.CSRC / name).read_text(), old, new.format(a, b), name)
    for k, v in (kv.split("=") for kv in knobs.split(",") if kv):
        if kernel == "k27" and k == "lanes":
            src = substitute(src, "constexpr int kLanes = 16,",
                             f"constexpr int kLanes = {int(v)},", name)
        elif kernel == "k27" and k == "stamps" and v == "1":
            for old_text, new_text in K27_STAMPS:
                src = substitute(src, old_text, new_text, name)
        elif kernel == "k28" and k == "polish":
            src = substitute(src, "kPolishCtas = 1;", f"kPolishCtas = {int(v)};", name)
        elif kernel == "k28" and k == "sweeps":
            src = substitute(src, "constexpr int kSvdSweeps = 12;",
                             f"constexpr int kSvdSweeps = {int(v)};", name)
        else:
            raise ValueError(f"k27_k28_variants: unknown knob {kernel}:{k}={v}")
    return kernel, src


def build(nvcc: str, out_dir: Path, spec: str) -> tuple[str, ctypes.CDLL]:
    """The kernel and library of variant ``spec``."""
    from uzliti_slam_tpu_torch.kernels import _build

    kernel, src = variant_source(spec)
    stem = spec.replace(":", "_").replace(",", "_").replace("=", "")
    cu, lib = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
    cu.write_text(src)
    # the sources include their headers by relative path
    cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    ptxas = [ln for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]
    print(json.dumps({"variant": spec, "ptxas": ptxas}), flush=True)
    handle = ctypes.CDLL(str(lib))
    for fn in (("uz_gicp",) if kernel == "k27" else ("uz_pnp_ransac",)):
        getattr(handle, fn).argtypes = _build.SIGNATURES[fn]
        getattr(handle, fn).restype = ctypes.c_int
    return kernel, handle


def _specs(text: str) -> list:
    """Variant specs from a comma list: a "knob=value" without a colon
    belongs to the spec before it."""
    out = []
    for part in text.split(","):
        if "=" in part and not part.startswith("k2"):
            out[-1] += "," + part
        else:
            out.append(part)
    return out


def step_calls(dev) -> dict:
    """A late VGA keyframe step's K27 and K28 arguments (phase 11's frames,
    1 camera, the gicp and the pnp estimator)."""
    import chip_smoke as cs
    from uzliti_slam_tpu_torch import pipeline

    world, frames = cs.keyframe_world()
    inputs = [cs.frame_inputs(fr, 1) for fr in frames]
    last = len(frames) - 1
    calls = {}
    for est, w in (("gicp", "gicp"), ("pnp", "pnp_ransac")):
        cfg, pose = cs.step_config(1, dev, estimation=est)
        slam = pipeline.Slam(cfg, cam=world.cam, cam_pose=pose, device=dev)
        slam.optimize_every = 10**9
        for i in range(last):
            slam.add_frame(*inputs[i], frames[i]["odom_pose"], frames[i]["stamp"])
        calls.update(cs.record_args(lambda: pipeline.process_keyframe(
            slam.state, *inputs[last], frames[last]["odom_pose"], frames[last]["stamp"],
            slam.cam, slam.cam_pose, slam.config), (w,)))
    return calls, world, frames


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="k27:8x512,k27:8x512:lanes=8,k27:8x256:lanes=8,"
                                          "k27:16x512,k27:4x512,k27:8x512:stamps=1,k28:8x8,"
                                          "k28:8x8:polish=8,k28:4x8,k28:16x8,k28:8x8:sweeps=6")
    ap.add_argument("--trials", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k27_k28_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from uzliti_slam_tpu_torch.kernels import _build
    from uzliti_slam_tpu_torch.kernels import ops as kops

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    nvcc = _build.find_nvcc()
    calls, world, frames = step_calls(dev)
    large = cs.registration_large_calls(world, frames, dev)
    torch.cuda.synchronize()   # a fault before the variants shows here
    shapes = {"k27": {"step": calls["gicp"][0][0], "large": large["gicp"][0][0]},
              "k28": {"step": calls["pnp_ransac"][0][0], "large": large["pnp_ransac"][0][0]}}
    out_dir = _build.BUILD_DIR.parent / "k27_k28_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {v: build(nvcc, out_dir, v) for v in _specs(args.variants)}
    stream = torch.cuda.current_stream(dev).cuda_stream

    def gicp_call(lib, a, matches=None):
        src, sl, sv, dst, dl, dv, nrm, init, iters, mc2, cw, mf, mt, mr = a
        B, N, M = dst.shape[0], dst.shape[1], src.shape[0]
        out = (torch.empty(B, 7, device=dev), torch.empty(B, device=dev),
               torch.empty(B, device=dev), torch.empty(B, dtype=torch.bool, device=dev))
        err = lib.uz_gicp(*(t.data_ptr() for t in (src, sl, sv, dst, dl, dv, nrm, init)), B, M,
                          N, iters, mc2, cw, mf, mt, mr, *(t.data_ptr() for t in out),
                          None if matches is None else matches.data_ptr(), stream)
        if err:
            raise RuntimeError(f"uz_gicp: cudaError_t {err}")
        return out

    def pnp_call(lib, a, stamps=None):
        X, xn, valid, depth, keys, thresh2, depth_tol, min_cons, iters, f_mean2 = a
        B, M, H = X.shape[0], X.shape[1], keys.shape[1]
        K = (2 if depth is None else 3) * H
        i32 = torch.int32
        out = (torch.empty(B, H, 6, dtype=i32, device=dev), torch.empty(B, K, 7, device=dev),
               torch.empty(B, 7, device=dev), torch.empty(B, dtype=i32, device=dev),
               torch.empty(B, device=dev), torch.empty(B, dtype=torch.bool, device=dev),
               torch.empty(B, dtype=i32, device=dev), torch.empty(B, K, dtype=i32, device=dev))
        if stamps is not None:
            stamps.copy_(torch.tensor([-1, 0, 0, 0], dtype=torch.int64).expand(B, 4))
        err = lib.uz_pnp_ransac(*(t.data_ptr() for t in (X, xn, valid)),
                                None if depth is None else depth.data_ptr(), keys.data_ptr(), B,
                                M, H, thresh2, depth_tol, min_cons, iters, f_mean2,
                                *(t.data_ptr() for t in out),
                                None if stamps is None else stamps.data_ptr(), stream)
        if err:
            raise RuntimeError(f"uz_pnp_ransac: cudaError_t {err}")
        return out

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

    for kernel in ("k27", "k28"):
        mine = {v: lib for v, (k, lib) in libs.items() if k == kernel}
        if not mine:
            continue
        wrapper = "gicp" if kernel == "k27" else "pnp_ransac"
        call = gicp_call if kernel == "k27" else pnp_call
        for shape, a in shapes[kernel].items():
            runs = {}
            for v, lib in mine.items():
                got = call(lib, a)
                torch.cuda.synchronize()
                ref = cs._registration_reference(wrapper, a, {}, got)
                mism, err, _ = cs._registration_mismatch(wrapper, a, got, ref)
                same = cs.same_bits(got, call(lib, a))
                held = not mism and same   # a variant that fails is timed all the same
                if not held:
                    print(json.dumps({"variant": v, "shape": shape, "FAILED": True,
                                      "mismatches": mism, "max_abs_err": err,
                                      "rerun_bit_identical": same}), flush=True)
                runs[v] = (lambda lib=lib, a=a: call(lib, a), err if held else None)
            if kernel == "k27":   # stamps builds time their own runs only
                runs = {v: r for v, r in runs.items() if "stamps=1" not in v} | {
                    v: r for v, r in runs.items() if "stamps=1" in v}
            times = {k: [] for k in runs}
            for t in range(2):   # two rounds, the order reversed in the second
                for k in (list(runs) if t == 0 else list(runs)[::-1]):
                    times[k] += events(runs[k][0])
            for v, (fn, err) in runs.items():
                row = {"variant": v, "shape": shape, "max_abs_err": err,
                       "ms": statistics.median(times[v]),
                       "device_ms": cs.device_ms_of(lambda: [fn() for _ in range(20)], 20,
                                                    "gicp_cluster" if kernel == "k27"
                                                    else "pnp_cluster")}
                if "stamps=1" in v:
                    buf = torch.zeros(a[3].shape[0], a[0].shape[0], dtype=torch.int32,
                                      device=dev)
                    per = []
                    for _ in range(5):
                        gicp_call(mine[v], a, buf)
                        per.append(buf[0, :8].tolist())
                    row["phases_us"] = {k: statistics.median(p[i] for p in per) / 1e3
                                        for i, k in enumerate(K27_PHASES)}
                if kernel == "k28":
                    stamps = torch.empty(a[0].shape[0], 4, dtype=torch.int64, device=dev)
                    per = []
                    for _ in range(5):
                        pnp_call(mine[v], a, stamps)
                        s = stamps.cpu()
                        start, fits = int(s[:, 0].min()), int(s[:, 1].max())
                        cons, end = int(s[:, 2].max()), int(s[:, 3].max())
                        per.append((fits - start, cons - fits, end - cons, end - start))
                    row["phases_us"] = {k: statistics.median(p[i] for p in per) / 1e3
                                        for i, k in enumerate(("fits", "consensus", "polish",
                                                               "total"))}
                print(json.dumps(row), flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
