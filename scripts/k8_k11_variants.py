#!/usr/bin/env python3
"""Time variants of K8 (``csrc/components.cu``) and K11
(``csrc/occupancy.cu``) beside the shipped kernels on one card.

    python3 scripts/k8_k11_variants.py [--variants k11:few=4,k11:many=8,k11:unroll=2,k8:ctas=1,k8:cluster=8]
        [--trials 11]

A variant is "<k8|k11>:<knob>=<value>[,<knob>=<value>...]", a copy of the
package's source with the knobs' constants substituted: K11's
``few=G`` and ``many=G`` (node groups a CTA on a grid of fewer than 4
tiles an SM, and on one of more: ``kGroupsFew``, ``kGroupsMany``; the
source's layout takes any G whose arrays fit in 48 KB of static shared
memory), ``gthreads=T`` (a group's
threads, 64 or 32: ``kGroupThreads``; a thread holds 256 / T of the tile's
cells) and ``unroll=U`` (nodes a group takes at once: ``kNodeUnroll``); K8's
``ctas=C`` (the cooperative grid's CTAs an SM: ``kGridCtasPerSm``) and
``cluster=C``, which is not a substitution but ``scripts/k8_cluster.cu``
(the labels and gauge on a thread-block cluster of C CTAs, the node arrays
in their distributed shared memory) with ``kCluster = C``.  Each is written
into ``build/k8_k11_variants/``, compiled by ``nvcc`` with the package's
flags into a library of its own and bound with ctypes like the package's;
the wrappers (``kops.components_gauge``, ``kops.project_rays``) run it with
``_build.load`` pointed at it (the cluster form with the one-CTA route's
arguments, no scratch).  Inputs: K8 on the 1k, 10k and 100k solves'
graphs (``chip_smoke.make_graph``) and the 4096 x 64 fleet flattened; K11
on the 500-node map after its epoch (full rebuild, 8 new nodes), the
10k-node rebuild on the 12.8 m grid and the 10k-node radius-40 m graph on a
1024² grid of 0.1 m.  Every variant is first held against the plain
version (K8 exactly, K11 within ``chip_smoke.PROJECT_ATOL`` / the large
rows' bound); a variant that disagrees is reported with its count of
entries apart and not timed on that input.  Each is timed in turns: CUDA events around 10 calls (median
of ``--trials``, two rounds in reversed order), device ms a call queued
behind a sleep kernel, and device ms a call over 20 profiled calls.
Prints one JSON line a variant and input, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCES = {"k8": ("components.cu", "uz_components_gauge"), "k11": ("occupancy.cu", "uz_project_rays")}
KNOBS = {
    ("k11", "few"): (r"constexpr int kGroupsFew = \d+;", "constexpr int kGroupsFew = {};"),
    ("k11", "many"): (r"constexpr int kGroupsMany = \d+;", "constexpr int kGroupsMany = {};"),
    ("k11", "unroll"): (r"constexpr int kNodeUnroll = \d+;", "constexpr int kNodeUnroll = {};"),
    ("k11", "gthreads"): (r"constexpr int kGroupThreads = \d+;",
                          "constexpr int kGroupThreads = {};"),
    ("k8", "ctas"): (r"constexpr int kGridCtasPerSm = \d+;", "constexpr int kGridCtasPerSm = {};"),
    ("k8", "cluster"): (r"constexpr int kCluster = \d+;", "constexpr int kCluster = {};"),
}
FUNCTIONS = {"k8": ("components_",), "k11": ("project_tiles",)}


def variant_source(spec: str) -> str:
    from uzliti_slam_tpu_torch.kernels import _build

    kernel, _, knobs = spec.partition(":")
    cluster = "cluster=" in knobs
    src = (ROOT / "scripts" / "k8_cluster.cu" if cluster
           else _build.CSRC / SOURCES[kernel][0]).read_text()
    for knob, value in (kv.split("=") for kv in knobs.split(",") if kv):
        pattern, new = KNOBS[(kernel, knob)]
        src, n = re.subn(pattern, new.replace("{}", value), src)
        if n != 1:
            raise ValueError(f"k8_k11_variants: {pattern!r} matched {n} times")
    return src


def _specs(text: str) -> list:
    out = []
    for part in text.split(","):
        if "=" in part and ":" not in part:
            out[-1] += "," + part
        else:
            out.append(part)
    return out


def build(nvcc: str, out_dir: Path, spec: str) -> ctypes.CDLL | None:
    from uzliti_slam_tpu_torch.kernels import _build

    entry = SOURCES[spec.partition(":")[0]][1]
    name = spec.replace(":", "_").replace(",", "_").replace("=", "")
    cu, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    cu.write_text(variant_source(spec))
    cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        # reported and left out: a knob can exceed what the card allows
        err = [ln for ln in proc.stderr.splitlines() if "error" in ln]
        print(json.dumps({"variant": spec, "build_failed": err}), flush=True)
        return None
    ptxas = [ln for ln in proc.stderr.splitlines() if "registers" in ln or "spill" in ln]
    print(json.dumps({"variant": spec, "ptxas": ptxas}), flush=True)
    handle = ctypes.CDLL(str(lib))
    getattr(handle, entry).argtypes = _build.SIGNATURES[entry]
    getattr(handle, entry).restype = ctypes.c_int
    return handle


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="k11:few=4,k11:many=8,k11:unroll=2,"
                                          "k8:ctas=0,k8:ctas=1,k8:cluster=8,k8:cluster=16")
    ap.add_argument("--trials", type=int, default=11)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k8_k11_variants: no CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from uzliti_slam_tpu_torch import pipeline
    from uzliti_slam_tpu_torch.config import SlamConfig
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.io import synthetic
    from uzliti_slam_tpu_torch.kernels import _build
    from uzliti_slam_tpu_torch.kernels import ops as kops

    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi_line(), flush=True)
    shipped = _build.load()
    out_dir = _build.BUILD_DIR.parent / "k8_k11_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    libs = {spec: build(nvcc, out_dir, spec) for spec in _specs(args.variants)}
    libs = {spec: lib for spec, lib in libs.items() if lib is not None}

    k8_inputs = {f"{n // 1000}k": cs.components_inputs(cs.make_graph(n, dev))
                 for n in (1000, 10_000, 100_000)}
    fleet = synthetic.make_pose_graph_batch(
        cs.FLEET["batch"], cs.FLEET["n_nodes"], loop_closure_every=cs.FLEET["loop_closure_every"],
        generator=torch.Generator().manual_seed(cs.SEED), capacity_rounding="pow2", device=dev)[0]
    g = solver._flatten_fleet(fleet)
    n_fleet = g.node_valid.shape[0]
    k8_inputs["fleet"] = (g.e_from, g.e_to, g.e_valid, g.node_valid, g.node_fixed, g.stamp,
                          n_fleet, solver.component_iterations(fleet.pose.shape[1]))
    k11_inputs = {}
    ecfg, state, _, _ = cs.make_epoch_state(**cs.EPOCH_500, device=dev)
    s500 = cs.with_scans(state, cs.SEED + 5)
    k11_inputs["500_full"] = cs.map_args(s500, ecfg, None)[1]
    k11_inputs["500_inc8"] = cs.map_args(cs.add_scanned_nodes(s500, 8), ecfg,
                                         pipeline.project_map(s500, ecfg))[1]
    for name, radius, grid in (("10k_full", 2.0, None), ("10k_cover", 40.0, (1024, 0.1))):
        cfg = SlamConfig(node_capacity=10240, edge_capacity=16384)
        if grid:
            cfg = SlamConfig(node_capacity=10240, edge_capacity=16384,
                             grid=dataclasses.replace(cfg.grid, size=grid[0],
                                                      resolution=grid[1]))
        st = cs.with_scans(pipeline.init_state(cfg, seed=cs.SEED, device=dev).replace(
            graph=synthetic.make_pose_graph(
                10_000, node_capacity=10240, edge_capacity=16384, radius=radius,
                generator=torch.Generator().manual_seed(cs.SEED), device=dev)[0]),
            cs.SEED + (7 if grid is None else 9))
        k11_inputs[name] = cs.map_args(st, cfg, None)[1]

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

    for kernel, inputs in (("k8", k8_inputs), ("k11", k11_inputs)):
        for name, a in inputs.items():
            if kernel == "k8":
                ref = kops.components_gauge_plain(*a)
                runs = {"shipped": with_lib(shipped, lambda a=a: kops.components_gauge(*a))}
                for v, lib in libs.items():
                    if not v.startswith("k8"):
                        continue
                    cluster = "cluster=" in v
                    chunk_bytes = 12 * -(-a[6] // int(v.rpartition("=")[2])) if cluster else 0
                    if cluster and chunk_bytes > kops._SMEM_BYTES:
                        continue
                    runs[v] = with_lib(lib, lambda a=a, c=cluster: kops.components_gauge(
                        *a, route="cta" if c else None))
            else:
                ref = kops.project_rays_plain(*a)
                runs = {"shipped": with_lib(shipped, lambda a=a: kops.project_rays(*a))}
                runs.update({v: with_lib(lib, lambda a=a: kops.project_rays(*a))
                             for v, lib in libs.items() if v.startswith("k11")})
            for v, fn in list(runs.items()):
                got = fn()
                torch.cuda.synchronize()
                if kernel == "k8":
                    bad = sum(int((x != y).sum()) for x, y in zip(got, ref))
                else:
                    err = (got - ref[0]).abs()
                    bound = (cs.PROJECT_SUM_RTOL * ref[1].float() + cs.PROJECT_ATOL_LARGE
                             if name.startswith("10k") else cs.PROJECT_ATOL)
                    bad = int((err > bound).sum())
                if bad and v == "shipped":
                    raise AssertionError(f"{v} {name}: {bad} entries apart from the plain version")
                if bad:
                    # a variant that disagrees is reported and not timed
                    print(json.dumps({"kernel": kernel, "variant": v, "input": name,
                                      "mismatches": bad}), flush=True)
                    del runs[v]
            times = {k: [] for k in runs}
            for t in range(2):
                for k in (list(runs) if t == 0 else list(runs)[::-1]):
                    times[k] += events(runs[k])
            for v, fn in runs.items():
                dms = [cs.device_ms_of(lambda: [fn() for _ in range(20)], 20, f)
                       for f in FUNCTIONS[kernel]]
                dms = [d for d in dms if d is not None]
                print(json.dumps({"kernel": kernel, "variant": v, "input": name,
                                  "ms": statistics.median(times[v]),
                                  "device_ms_queued": cs.queued_device_ms(fn),
                                  "device_ms": sum(dms) if dms else None}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
