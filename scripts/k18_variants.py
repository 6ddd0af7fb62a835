#!/usr/bin/env python3
"""Time K18 (``csrc/icp.cu``) built with other cluster shapes, on one card.

    python3 scripts/k18_variants.py [--variants 1x1024,8x512,16x512:lanes=32,16x256:stamps=1]

Each variant is a copy of the package's ``csrc/icp.cu`` with text
substitutions, written into ``build/k18_variants/``, compiled by ``nvcc``
with the package's flags into a library of its own and bound with ctypes
like the package's library.  A spec is "<CTAs>x<threads>" (the cluster's
CTAs and each CTA's threads: ``1x1024`` is one CTA of 1,024 threads a
problem, 32 warps over the points) and, after a colon, ``lanes=<8|16|32>``
(lanes that split one point's search) and ``stamps=1`` (thread 0 of each
cluster reads ``%globaltimer`` around every phase and writes the phases'
ns, summed over the iterations, in place of the covariance); "16x256"
alone is the shipped kernel.  On ``chip_smoke.icp_room_problem`` problems
(the walls of a room seen from offset poses: B = 1 and 4 at M = N = 360,
the VGA step's and the re-registration's shapes, and B = 1 at N = M =
8192) with the step's ICP settings, the variants are timed in turns: CUDA
events around 10 calls (2 at N = 8192; median of ``--trials``), and device
ms a call over 20 profiled calls (5 at N = 8192; null where the trace
holds no K18 kernel).  Each variant is first held against the package's
plain version (pose within chip_smoke.ICP_POSE_ATOL, the same ok flag).
Prints one JSON line a variant and shape, and the card's name and power
limit.
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


PHASES = ("search_and_terms", "cta_sums", "cluster_barrier", "cluster_sums", "solve",
          "prologue", "total")

# the stamps build: (text of the shipped source, what replaces it); the
# phases are the search and its terms, the CTA sums, the cluster barrier,
# the cluster sums, the solve, and the prologue before the first iteration
STAMPS = (
    ("namespace {\n",
     "namespace {\n\n__device__ __forceinline__ unsigned long long now_ns() {\n"
     "  unsigned long long t;\n  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  const unsigned long long t_start = now_ns();\n"
     "  cg::cluster_group cluster = cg::this_cluster();\n"),
    ("  for (int it = 0; it <= iterations; ++it) {\n",
     "  unsigned long long stamp = now_ns(), phase[6] = {};\n  phase[5] = stamp - t_start;\n"
     "  const auto lap = [&](int q) {\n    const unsigned long long t = now_ns();\n"
     "    phase[q] += t - stamp;\n    stamp = t;\n  };\n"
     "  for (int it = 0; it <= iterations; ++it) {\n"),
    ("    // the sums: a warp tree", "    lap(0);\n    // the sums: a warp tree"),
    ("    cluster.sync();\n    if (tid < kSums) {",
     "    lap(1);\n    cluster.sync();\n    lap(2);\n    if (tid < kSums) {"),
    ("      tot[tid] = t;\n    }\n    __syncthreads();\n",
     "      tot[tid] = t;\n    }\n    __syncthreads();\n    lap(3);\n"),
    ("      th = __fadd_rn(th, -x[2]);\n", "      th = __fadd_rn(th, -x[2]);\n      lap(4);\n"),
    ("      for (int q = 0; q < 9; ++q) cov_out[9 * b + q] = cov[q / 3][q % 3];\n",
     "      for (int q = 0; q < 9; ++q) cov_out[9 * b + q] = cov[q / 3][q % 3];\n"
     "      for (int q = 0; q < 6; ++q) cov_out[9 * b + q] = static_cast<float>(phase[q]);\n"
     "      cov_out[9 * b + 6] = static_cast<float>(now_ns() - t_start);\n"),
)


def substitute(src: str, old: str, new: str) -> str:
    if src.count(old) != 1:
        raise ValueError(f"k18_variants: {old!r} is not once in csrc/icp.cu")
    return src.replace(old, new)


def variant_source(spec: str) -> str:
    """``csrc/icp.cu`` as variant ``spec``: "<CTAs>x<threads>[:knob=value,...]"."""
    from uzliti_slam_tpu_torch.kernels import _build

    shape, _, knobs = spec.partition(":")
    ctas, threads = (int(v) for v in shape.split("x"))
    src = (_build.CSRC / "icp.cu").read_text()
    src = substitute(src, "constexpr int kClusterCtas = 16, kThreads = 256;",
                     f"constexpr int kClusterCtas = {ctas}, kThreads = {threads};")
    for k, v in (kv.split("=") for kv in knobs.split(",") if kv):
        if k == "lanes":
            src = substitute(src, "constexpr int kLanes = 8,", f"constexpr int kLanes = {int(v)},")
        elif k == "stamps" and v == "1":
            for old, new in STAMPS:
                src = substitute(src, old, new)
        else:
            raise ValueError(f"k18_variants: unknown knob {k}={v}")
    return src


def build(nvcc: str, out_dir: Path, spec: str) -> ctypes.CDLL:
    """The library of variant ``spec``."""
    from uzliti_slam_tpu_torch.kernels import _build

    stem = f"k18_{spec.replace(':', '_').replace(',', '_').replace('=', '')}"
    cu, lib = out_dir / f"{stem}.cu", out_dir / f"lib{stem}.so"
    cu.write_text(variant_source(spec))
    cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    ptxas = [ln for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]
    print(json.dumps({"variant": spec, "ptxas": ptxas}), flush=True)
    handle = ctypes.CDLL(str(lib))
    handle.uz_icp.argtypes = _build.SIGNATURES["uz_icp"]
    handle.uz_icp.restype = ctypes.c_int
    return handle


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="16x256,16x256:lanes=16,16x512,8x512,1x1024,"
                                          "16x256:stamps=1")
    ap.add_argument("--trials", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k18_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from uzliti_slam_tpu_torch.kernels import _build
    from uzliti_slam_tpu_torch.kernels import ops as kops

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    nvcc = _build.find_nvcc()
    scal = (20, float(0.5) ** 2, 0.25, 1.5, 0.8, 0.02 ** 2)
    shapes = {"b1_n360": (1, 360, 360), "b4_n360": (4, 360, 360), "b1_n8192": (1, 8192, 8192)}
    problems = {k: cs.icp_room_problem(*v, dev) + scal for k, v in shapes.items()}
    refs = {k: kops.icp_plain(*p) for k, p in problems.items()}
    out_dir = _build.BUILD_DIR.parent / "k18_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for v in _specs(args.variants):
        libs[v] = build(nvcc, out_dir, v)

    def call(lib, p):
        src, sv, dst, dv, init, iters, mc2, mf, mt, mr, s2 = p
        B, M, N = src.shape[0], src.shape[1], dst.shape[1]
        out = (torch.empty(B, 3, device=dev), torch.empty(B, device=dev),
               torch.empty(B, device=dev), torch.empty(B, 3, 3, device=dev),
               torch.empty(B, dtype=torch.bool, device=dev))
        err = lib.uz_icp(src.data_ptr(), sv.data_ptr(), dst.data_ptr(), dv.data_ptr(),
                         init.data_ptr(), B, M, N, iters, mc2, mf, mt, mr, s2,
                         *(t.data_ptr() for t in out), torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError(f"uz_icp: cudaError_t {err}")
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

    for name, p in problems.items():
        runs = {}
        for v, lib in libs.items():
            got = call(lib, p)
            torch.cuda.synchronize()
            err = float((got[0] - refs[name][0]).abs().max())
            same_ok = bool(torch.equal(got[4], refs[name][4]))
            if not (same_ok and err <= cs.ICP_POSE_ATOL):
                raise AssertionError(f"{v} {name}: pose {err}, same ok {same_ok}")
            runs[v] = (lambda lib=lib: call(lib, p), err)
        times = {k: [] for k in runs}
        for t in range(2):   # two rounds, the order reversed in the second
            for k in (list(runs) if t == 0 else list(runs)[::-1]):
                times[k] += events(runs[k][0], calls=2 if "8192" in name else 10)
        for v, (fn, err) in runs.items():
            calls = 5 if "8192" in name else 20
            row = {"variant": v, "shape": name, "pose_max_abs_err": err,
                   "ms": statistics.median(times[v]),
                   "device_ms": cs.device_ms_of(lambda: [fn() for _ in range(calls)], calls,
                                                "icp_cluster")}
            if "stamps=1" in v:
                cov = fn()[3].reshape(-1, 9)[0].tolist()
                row["phases_us"] = {k: cov[i] / 1e3 for i, k in enumerate(PHASES)}
            print(json.dumps(row), flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
