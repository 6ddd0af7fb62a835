#!/usr/bin/env python3
"""Where K37's time goes: its phases' device times, from instrumented copies.

    python3 scripts/k37_phase_stamps.py [--variants as_is,no_prefetch,...]

K37 (``uzliti_slam_tpu_torch/csrc/pcg_grid.cu``) runs a PCG step as one
cooperative launch whose phases are separated by grid barriers.  This
script copies its source into ``build/``, has CTA 0's first thread read the
card's global timer (``%globaltimer``, ns) at the launch's start and after
every grid barrier, builds each copy with the package's nvcc flags into a
library of its own, and runs the step on the 100k headline solve's first
PCG inputs (``chip_smoke.make_graph`` + ``kernel_inputs``): the median of 5
steps' phase durations, in µs, one JSON line a variant.  The phases of a
step are: pHp, forward levels 0..L-1, the root, back levels L-1..0 (the
last with the rᵀz sums), then β and p.  Each variant is a list of text
substitutions on the source (the experiments run when K37 was designed;
one whose text no longer matches is reported and skipped).  It also times
a bare ``grid.sync()`` at 528, 396, 264 and 132 CTAs.  Needs one CUDA card.
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

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
from uzliti_slam_tpu_torch.graph import solver  # noqa: E402
from uzliti_slam_tpu_torch.kernels import _build  # noqa: E402
from uzliti_slam_tpu_torch.kernels import ops as kops  # noqa: E402

INSTRUMENT = '''#include <cuda_runtime.h>
__device__ unsigned long long g_stamps[256];
__device__ int g_n;
#define STAMP() do { if (blockIdx.x == 0 && threadIdx.x == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); g_stamps[g_n++] = t_; } } while (0)
'''
EXTRA = '''
__global__ void k_sync(int n) { cg::grid_group g = cg::this_grid(); for (int i = 0; i < n; ++i) g.sync(); }
extern "C" int k37_reset() { int z = 0; return (int)cudaMemcpyToSymbol(g_n, &z, sizeof(int)); }
extern "C" int k37_read(unsigned long long* out, int* n) {
  cudaMemcpyFromSymbol(n, g_n, sizeof(int)); return (int)cudaMemcpyFromSymbol(out, g_stamps, 256 * 8); }
extern "C" float k37_sync_us(int grid, int threads, int n) {
  void* args[] = {&n}; cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaLaunchCooperativeKernel((void*)k_sync, grid, threads, args, 0, 0);
  cudaEventRecord(a); cudaLaunchCooperativeKernel((void*)k_sync, grid, threads, args, 0, 0);
  cudaEventRecord(b); cudaEventSynchronize(b); float ms; cudaEventElapsedTime(&ms, a, b);
  return 1e3f * ms / n; }
'''
# the experiments: the kernel as it is; without issuing the next level's
# first tile ahead of a barrier; with forward level 0's first tile issued
# across the pHp pass; 32 warps an SM in CTAs of 512 or 1024 threads;
# 4 CTAs of 256 an SM, so a register cap of 64 rather than 85 (it spills)
VARIANTS = {
    "as_is": [],
    "no_prefetch": [("  if (w0 * kTile >= half_of(f, l)) return false;", "  return false;")],
    "start_prefetch": [("  bool staged = false;", "  bool staged = prefetch(f, 0, false, gw, st);")],
    "ctas512x2": [("constexpr int kThreads = 256;", "constexpr int kThreads = 512;"),
                  ("constexpr int kMinCtas = 3;", "constexpr int kMinCtas = 2;")],
    "ctas1024x1": [("constexpr int kThreads = 256;", "constexpr int kThreads = 1024;"),
                   ("constexpr int kMinCtas = 3;", "constexpr int kMinCtas = 1;")],
    "ctas256x4": [("constexpr int kMinCtas = 3;", "constexpr int kMinCtas = 4;")],
}


def instrumented(src: str) -> str:
    src = src.replace("#include <cuda_runtime.h>\n", INSTRUMENT, 1)
    src = src.replace("grid.sync();", "grid.sync(); STAMP();")
    src = src.replace("  cg::grid_group grid = cg::this_grid();\n",
                      "  cg::grid_group grid = cg::this_grid();\n  STAMP();\n", 1)
    src = src.replace("  if (blockIdx.x == 0 && tid == 0) v.scal[0] = ok ? rz_new : rz;\n}",
                      "  if (blockIdx.x == 0 && tid == 0) v.scal[0] = ok ? rz_new : rz;\n"
                      "  __syncthreads(); STAMP();\n}")
    return src + EXTRA


def build(names) -> dict:
    """Each variant's library, built in parallel."""
    base = instrumented((_build.CSRC / "pcg_grid.cu").read_text())
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        src = base
        for old, new in VARIANTS[name]:
            if old not in src:
                print(json.dumps({"variant": name, "skipped": f"no longer in the source: {old}"}))
                break
            src = src.replace(old, new)
        else:
            cu = _build.BUILD_DIR / f"k37_stamps_{name}.cu"
            cu.write_text(src)
            so = _build.BUILD_DIR / f"libk37_stamps_{name}.so"
            jobs.append((name, so, subprocess.Popen(
                [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    libs = {}
    for name, so, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{err}")
        lib = ctypes.CDLL(str(so))
        lib.uz_pcg_grid_step.argtypes = _build.SIGNATURES["uz_pcg_grid_step"]
        lib.k37_sync_us.restype = ctypes.c_float
        libs[name] = (lib, cs.ptxas_summary(err).get("pcg_grid_kernel"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k37_phase_stamps: no CUDA device", file=sys.stderr)
        return 1
    libs = build(args.variants.split(","))
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    lib0 = next(iter(libs.values()))[0]
    for grid, threads in ((528, 256), (396, 256), (264, 512), (132, 1024)):
        print(json.dumps({"grid_sync_us": lib0.k37_sync_us(grid, threads, 200), "grid": grid,
                          "threads": threads}), flush=True)
    g = cs.make_graph(100_000, dev)
    Ji, Jj, W, ef, et, damp, free, pack, b, steps, tol = cs.kernel_inputs(
        g, solver.SolverConfig(**cs.HEADLINE))["pcg"]
    Hp = kops.hvp(Ji, Jj, W, ef, et, b, damp, free)
    for name, (lib, ptxas) in libs.items():
        fused = kops.pcg_grid_start(pack, b).fused
        for _ in range(3):
            lib.uz_pcg_grid_step(Hp.data_ptr(), tol, *fused.args)
        runs = []
        for _ in range(5):
            lib.k37_reset()
            err = lib.uz_pcg_grid_step(Hp.data_ptr(), tol, *fused.args)
            torch.cuda.synchronize()
            if err != 0:
                raise RuntimeError(f"{name}: cudaError_t {err}")
            buf, n = (ctypes.c_ulonglong * 256)(), ctypes.c_int()
            lib.k37_read(buf, ctypes.byref(n))
            t = list(buf)[: n.value]
            runs.append([(t[i + 1] - t[i]) / 1e3 for i in range(len(t) - 1)])
        phases = [statistics.median(r[i] for r in runs) for i in range(len(runs[0]))]
        print(json.dumps({"variant": name, "ptxas": ptxas, "ctas": lib.uz_pcg_grid_ctas(),
                          "phases_us": phases, "total_us": sum(phases)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
