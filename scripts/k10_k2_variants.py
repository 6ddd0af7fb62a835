#!/usr/bin/env python3
"""Time layouts of K38 (``csrc/pcg_fleet.cu``), and K37 with K2's
Hessian-vector product inside its step (``scripts/k37_hv.cu``) beside K2 +
K37, on one card, in turns.

    python3 scripts/k10_k2_variants.py [--variants k38:stage=1,k38:rootsmem=0,minctas=3]
        [--trials 11]

A variant is "<k38|k37>:<knob>=<value>[,<knob>=<value>...]", a copy of
``csrc/pcg_fleet.cu`` (k38) or ``scripts/k37_hv.cu`` (k37) with the knobs'
constants substituted: K38's ``stage=1``
(``kStageOp``: each instance's operator copied into shared memory beside its
factor, layout (b): 1 CTA an SM at 128 edge slots) and ``persist=1``
(``kPersistent``: the CTAs the card holds at once, each walking the
instances and copying the next instance's factor into a second buffer while
the current one solves, layout (c)); the shipped layout (a) keeps the
factor and the vectors in shared memory and reads the operator through
L1 / L2 (2 CTAs an SM at 64 nodes).  Also K38's ``rootsmem=0`` (``kRootSmem``:
the root read through L2 at each apply instead of staged, 56 KB of shared
memory a CTA), ``rootilp=U`` (``kRootIlp``:
root rows a warp sums at once, each by the xor shuffle tree), ``threads=T`` and ``minctas=C`` (the CTA's
threads and the CTAs an SM its registers are budgeted for), and
``stamps=1``, not a substitution but the source built with
``-DUZ_FLEET_STAMPS=1``: each CTA's thread 0 sums %globaltimer ns by phase
(staging, the start, the Hv, the α update, the apply, the p update, the
write-back; the start's and the apply's forward levels, root and back
levels apart, the rest of them under start_sum and apply_sum) over its
instances, printed per instance after one launch.
K37's knob: ``thread=0`` (its Hv's edge pass 6 lanes an edge, the edges
staged in tiles) or ``thread=1`` (``kHvThreadEdges``: a thread an edge,
K2's edge kernel writing each edge's two terms).  Each is written into
``build/k10_k2_variants/``, compiled by ``nvcc`` with the package's flags
(one ``nvcc`` a variant, all started together) into a library of its own
and bound with ctypes like the package's; ``kops.pcg_fleet_solve`` runs a
K38 variant with ``_build.load`` pointed at it, and a K37 variant runs
``kops.pcg_grid_start`` the same way, then its ``uz_pcg_grid_solve_step``
a step (``hv_solve``, this script's wrapper of it).

Inputs: the 4096 x 64 fleet's first iteration (``chip_smoke.fleet_kernel_inputs``
at ``chip_smoke.FLEET_CONFIG``: 8 PCG steps, cutoff 16), and the first PCG
solve of the 20k and 100k single solves (``chip_smoke.kernel_inputs`` at
``chip_smoke.HEADLINE``: 12 steps).  Each variant's x must lie within 1e-4
of max|x| of the plain version's (K38's: ``pcg_fleet_solve_plain``; K37's:
K35's, ``pcg_chain_solve_plain``), and whether it is bit-equal to the
shipped K38's is printed (a K38 knob that moves the dots' thread
assignment, ``threads``, changes their summation order); one that is not
within the tolerance is reported and not timed.  Beside the variants, each input
times what the route replaced: the fleet's K2 + K10 + K3 loop (8 steps), and
the single solve's K2 + K37 (K37's start, then K2 and K37's step a step).
Timed in turns: CUDA events around 5 calls (median of ``--trials``, two
rounds in reversed order) and device ms a call over 5 profiled calls.
Prints one JSON line a variant and input, and the card's name and power
limit.
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

SOURCES = {"k38": ("uzliti_slam_tpu_torch", "csrc", "pcg_fleet.cu"),
           "k37": ("scripts", "k37_hv.cu")}
KNOBS = {
    ("k38", "stage"): (r"constexpr bool kStageOp = \w+;", "constexpr bool kStageOp = {};"),
    ("k38", "persist"): (r"constexpr bool kPersistent = \w+;", "constexpr bool kPersistent = {};"),
    ("k38", "rootilp"): (r"constexpr int kRootIlp = \d+;", "constexpr int kRootIlp = {};"),
    ("k38", "threads"): (r"constexpr int kThreads = \d+;", "constexpr int kThreads = {};"),
    ("k38", "minctas"): (r"constexpr int kMinCtas = \d+;", "constexpr int kMinCtas = {};"),
    ("k38", "rootsmem"): (r"constexpr bool kRootSmem = \w+;", "constexpr bool kRootSmem = {};"),
    ("k37", "thread"): (r"constexpr bool kHvThreadEdges = \w+;",
                        "constexpr bool kHvThreadEdges = {};"),
}
BOOL = {"0": "false", "1": "true"}
ENTRIES = {"k38": ("uz_pcg_fleet_solve",),
           "k37": ("uz_pcg_grid_start", "uz_pcg_grid_step", "uz_pcg_grid_ctas")}
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# scripts/k37_hv.cu's step with the Hv: (tol, table, levels, root blocks,
# rows, cmask, Ji, Jj, W, e_from, e_to, damp, free, row_ptr, entries, edges,
# x, r, p, z, Hp, the edges' terms, scal, scratch, its floats, partials,
# their slots, stream)
HV_STEP = [_F, _P, _I, _I, _I, _P] + [_P] * 9 + [_I] + [_P] * 8 + [_L, _P, _I, _P]
FUNCTIONS = {"k38": "pcg_fleet_kernel", "k37": "pcg_grid_kernel", "k2_k10_k3": "",
             "k2_k37": ""}


def variant_source(spec: str) -> str:
    kernel, _, knobs = spec.partition(":")
    src = ROOT.joinpath(*SOURCES[kernel]).read_text()
    for knob, value in (kv.split("=") for kv in knobs.split(",") if kv):
        if knob == "stamps":
            continue
        pattern, new = KNOBS[(kernel, knob)]
        value = BOOL.get(value, value) if "bool" in new else value
        src, n = re.subn(pattern, new.replace("{}", value), src)
        if n != 1:
            raise ValueError(f"k10_k2_variants: {pattern!r} matched {n} times")
    return src


def _specs(text: str) -> list:
    out = []
    for part in text.split(","):
        if "=" in part and ":" not in part:
            out[-1] += "," + part
        else:
            out.append(part)
    return out


def start_build(nvcc: str, out_dir: Path, spec: str):
    """Write the variant's source and start its nvcc: (process, library)."""
    from uzliti_slam_tpu_torch.kernels import _build

    name = spec.replace(":", "_").replace(",", "_").replace("=", "")
    cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(variant_source(spec))
    stamps = ["-DUZ_FLEET_STAMPS=1"] if "stamps=1" in spec else []
    cmd = [nvcc, *_build.NVCC_FLAGS, *stamps, "-shared", "-o", str(lib), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), lib


def finish_build(spec: str, proc, lib: Path) -> ctypes.CDLL | None:
    """Wait for the variant's nvcc and bind its library (None if it failed:
    a knob can exceed what the card allows)."""
    from uzliti_slam_tpu_torch.kernels import _build

    _, stderr = proc.communicate()
    if proc.returncode != 0:
        err = [ln for ln in stderr.splitlines() if "error" in ln]
        print(json.dumps({"variant": spec, "build_failed": err}), flush=True)
        return None
    ptxas = [ln for ln in stderr.splitlines() if "registers" in ln or "spill" in ln]
    print(json.dumps({"variant": spec, "ptxas": ptxas}), flush=True)
    handle = ctypes.CDLL(str(lib))
    for entry in ENTRIES[spec.partition(":")[0]]:
        getattr(handle, entry).argtypes = _build.SIGNATURES[entry]
        getattr(handle, entry).restype = ctypes.c_int
    if "stamps=1" in spec:
        handle.fleet_stamps_read.argtypes = [ctypes.c_void_p]
        handle.fleet_stamps_read.restype = ctypes.c_int
    if spec.startswith("k37"):
        handle.uz_pcg_grid_solve_step.argtypes = HV_STEP
        handle.uz_pcg_grid_solve_step.restype = ctypes.c_int
    return handle


def hv_solve(lib, pack, op, b, steps: int, tol: float):
    """scripts/k37_hv.cu's whole PCG solve: K37's start, then ``steps``
    launches of its step with the Hv inside (the state's vectors, scratch
    and partials those of the start); returns the final state."""
    from uzliti_slam_tpu_torch.kernels import _build
    from uzliti_slam_tpu_torch.kernels import ops as kops

    saved = _build.load
    _build.load = lambda: lib
    try:
        state = kops.pcg_grid_start(pack, b)
    finally:
        _build.load = saved
    n, E = b.shape[0], op.e_from.shape[0]
    ptrs = kops._operator_ptrs("pcg_grid_solve", op, n, b.device)
    hp = torch.empty(n, 6, dtype=torch.float32, device=b.device)
    ye = torch.empty(E, 12, dtype=torch.float32, device=b.device)
    a = state.fused.args
    args = (float(tol),) + a[:5] + tuple(ptrs) + (E,) + a[5:9] + (hp.data_ptr(), ye.data_ptr(),
                                                                 a[9]) + a[10:]
    for _ in range(steps):
        kops._raise_on(lib.uz_pcg_grid_solve_step(*args), "pcg_grid_solve")
    return state


STAMP_CTAS, STAMP_SLOTS = 512, 12
STAMP_NAMES = ("stage", "start_sum", "hv", "alpha_update", "apply_sum", "p_update", "write_back",
               "forward_levels", "root", "back_levels")


def read_stamps(lib) -> dict:
    """The stamps' mean ns an instance by phase over the CTAs that ran one
    (each CTA of the first 512 runs one instance), then zeroed."""
    buf = (ctypes.c_ulonglong * (STAMP_CTAS * STAMP_SLOTS))()
    err = lib.fleet_stamps_read(ctypes.addressof(buf))
    if err:
        raise RuntimeError(f"fleet_stamps_read: cudaError_t {err}")
    rows = [buf[c * STAMP_SLOTS: (c + 1) * STAMP_SLOTS] for c in range(STAMP_CTAS)]
    rows = [r for r in rows if any(r)]
    return {name: statistics.mean(r[k] for r in rows) for k, name in enumerate(STAMP_NAMES)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="k38:stage=1,k38:persist=1,k38:rootilp=4,"
                                          "k38:rootsmem=0,minctas=3,k38:threads=384,"
                                          "k38:stamps=1,k37:thread=0,k37:thread=1")
    ap.add_argument("--trials", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k10_k2_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.io import synthetic
    from uzliti_slam_tpu_torch.kernels import _build
    from uzliti_slam_tpu_torch.kernels import ops as kops
    from uzliti_slam_tpu_torch.parallel import sharded

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    shipped = _build.load()
    out_dir = _build.BUILD_DIR.parent / "k10_k2_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    started = {spec: start_build(nvcc, out_dir, spec) for spec in _specs(args.variants)}
    libs = {spec: finish_build(spec, *job) for spec, job in started.items()}
    libs = {spec: lib for spec, lib in libs.items() if lib is not None}

    B, n = cs.FLEET["batch"], cs.FLEET["n_nodes"]
    fleet = synthetic.make_pose_graph_batch(
        B, n, loop_closure_every=cs.FLEET["loop_closure_every"],
        generator=torch.Generator().manual_seed(cs.SEED), capacity_rounding="pow2", device=dev)[0]
    fcfg = sharded.fleet_config(solver.SolverConfig(**cs.FLEET_CONFIG))
    fin = cs.fleet_kernel_inputs(fleet, fcfg)
    del fleet
    Ji, Jj, W, ef, et, damp, free = fin["hvp"]
    D, U, cutoff, _ = fin["chain_factor"]
    inputs = {"fleet": ("k38", kops.chain_factor(D, U, cutoff, B),
                        kops.HvpOperator(Ji, Jj, W, ef, et, damp, free, fin["table"]), fin["b"],
                        fcfg.pcg_iterations, fcfg.pcg_tol)}
    del fin
    hcfg = solver.SolverConfig(**cs.HEADLINE)
    for nn in (20_000, 100_000):
        inputs[f"{nn // 1000}k"] = ("k37",) + tuple(cs.kernel_inputs(cs.make_graph(nn, dev),
                                                                     hcfg)["pcg_chain_solve"])

    def with_lib(lib, fn):
        def run():
            saved = _build.load
            _build.load = lambda: lib
            try:
                return fn()
            finally:
                _build.load = saved
        return run

    def events(fn, calls=5):
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

    for name, (kernel, pack, op, b, steps, tol) in inputs.items():
        if kernel == "k38":
            def solve(pack=pack, op=op, b=b, steps=steps, tol=tol):
                return kops.pcg_fleet_solve(pack, op, b, steps, tol)

            def replaced(pack=pack, op=op, b=b, steps=steps, tol=tol):
                s = kops.pcg_chain_start(pack, b, B)
                for _ in range(steps):
                    kops.pcg_chain_step(pack, kops.hvp(*op[:5], s.p, op.damp, op.free), s, tol)
                return s
            old = "k2_k10_k3"
        else:
            def replaced(pack=pack, op=op, b=b, steps=steps, tol=tol):
                s = kops.pcg_chain_start(pack, b)
                for _ in range(steps):
                    kops.pcg_chain_step(pack, kops.hvp(*op[:5], s.p, op.damp, op.free), s, tol)
                return s
            old = "k2_k37"
        runs = {old: with_lib(shipped, replaced)}
        if kernel == "k38":
            runs["shipped"] = with_lib(shipped, solve)
            runs.update({v: with_lib(lib, solve) for v, lib in libs.items()
                         if v.startswith(kernel)})
        else:
            runs.update({v: (lambda lib=lib, pack=pack, op=op, b=b, steps=steps, tol=tol:
                             hv_solve(lib, pack, op, b, steps, tol))
                         for v, lib in libs.items() if v.startswith(kernel)})
        ref = runs["shipped"]() if "shipped" in runs else None
        plain = (kops.pcg_fleet_solve_plain if kernel == "k38" else kops.pcg_chain_solve_plain)(
            pack, op, b, steps, tol)
        scale = float(plain.x.abs().max())
        for v, fn in list(runs.items()):
            if v == old:
                continue
            got = fn()
            torch.cuda.synchronize()
            rel = float((got.x - plain.x).abs().max()) / scale
            same = None if ref is None else all(torch.equal(a, c) for a, c in zip(got[:4], ref[:4]))
            print(json.dumps({"kernel": kernel, "variant": v, "input": name,
                              "x_rel_err_vs_plain": rel, "bit_equal_to_shipped": same}),
                  flush=True)
            if rel > 1e-4:
                del runs[v]
        times = {k: [] for k in runs}
        for t in range(2):
            for k in (list(runs) if t == 0 else list(runs)[::-1]):
                times[k] += events(runs[k])
        for v, fn in runs.items():
            function = FUNCTIONS[old if v == old else kernel]
            dms = cs.device_ms_of(lambda: [fn() for _ in range(5)], 5, function)
            out = {"kernel": kernel, "variant": v, "input": name,
                   "ms": statistics.median(times[v]), "device_ms": dms}
            if "stamps=1" in v:
                read_stamps(libs[v])
                fn()
                torch.cuda.synchronize()
                out["stamps_ns_an_instance"] = read_stamps(libs[v])
            print(json.dumps(out), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
