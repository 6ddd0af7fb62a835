#!/usr/bin/env python3
"""Time K5 (``csrc/relax_min.cu``) and K6 (``csrc/cluster_labels.cu``) on one
card on the epochs' inputs, by sweep and by phase.

    python3 scripts/k5_k6_variants.py [--variants k6:threads=256,k6:stamps=1]
        [--threads 64,128,256,512] [--sizes epoch500,epoch10k]

For each size (``chip_smoke.EPOCH_500`` / ``EPOCH_10K``, the inputs
``chip_smoke.epoch_kernel_inputs`` gives the entries) it prints:

- "cost": the shipped entries' device ms a call (20 profiled calls) at
  n_iters 0, 1, 2, 4, 8, 16, 32 and 64 (K6: 0-16): the slope is a sweep's or
  a round's cost, the intercept the launch's fixed part; beside them the
  sweeps the epoch's rows need (a frontier not yet empty) and the rounds
  K6's labels take to their fixed point, from the plain versions;
- "threads": K5's pairs, uncertainty and rows entries at each count of
  ``--threads`` a CTA (``kops.RELAX_THREADS`` and ``RELAX_ROOT_THREADS``),
  each held bit for bit against its plain version, device ms queued behind
  a sleep kernel (``chip_smoke.queued_device_ms``, the table's launch
  included);
- one line a K6 variant: a copy of the package's source with knobs
  substituted, written into ``build/k5_k6_variants/``, compiled by ``nvcc``
  with the package's flags into a library of its own and bound with ctypes
  like the package's (``kops.cluster_roots`` and ``kops.cluster_labels`` run
  it with ``_build.load`` pointed at it): ``threads=N`` (a CTA's threads,
  ``kThreads``), held against the plain version and timed queued;
  ``stamps=1`` (``%globaltimer`` stamps after the loads, the adjacency with
  round 1, the later rounds, the statistics, the compaction and the
  writes, written over the first six labels: the phases' ns, median over
  20 calls, in place of the check);
- ``k6:square``: the labels as the lowest set bit of each row of
  (A ∪ I)^n_iters by squaring (``scripts/k6_square.cu``, its own
  ``uz_cluster_labels``), held exactly against the plain version on the
  epoch's candidates and a 256-candidate chain beyond 16 hops at n_iters 0,
  1, 5 and 16, its device ms (20 profiled calls) and queued ms beside the
  shipped labels entry's;
- ``k5:warps=W``: K5's pairs entry with one warp a row and W rows a CTA,
  ``__syncwarp`` ending each sweep (``scripts/k5_warp_rows.cu``), on the
  package's table; held bit for bit against the plain version, its device
  ms (the relaxation kernel alone) and queued ms (table included) beside
  the shipped pairs entry's, and where its rows and table live.

Prints one JSON line a measurement, and the card's name and power limit.
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

KNOBS = {"threads": (r"constexpr int kThreads = \d+;", "constexpr int kThreads = {};")}
# stamps=1: a stamp after each phase; (anchor, text put before it)
STAMPS = [
    ("  // The adjacency, once:", "  STAMP(1);\n"),
    ("  // The later rounds take only", "  STAMP(2);\n"),
    ("  for (int i = tid; i < b; i += kThreads) a.labels[i] = cur[i];\n  if (!kRoots) return;",
     "  STAMP(3);\n"),
    ("  // roots: label == own slot", "  STAMP(4);\n"),
    ("  for (int k = tid; k < a.n_roots; k += kThreads) {\n    a.root_live[k]", "  STAMP(5);\n"),
]
STAMP_DEF = """
#define STAMP(i)                                                            \\
  do {                                                                      \\
    __syncthreads();                                                        \\
    if (threadIdx.x == 0) {                                                 \\
      long long t_;                                                         \\
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                \\
      s_t[i] = t_;                                                          \\
    }                                                                       \\
  } while (0)
"""


K6_ENTRIES = ("uz_cluster_labels", "uz_cluster_roots")
# the variants in sources of their own: (file, entries)
OWN_SOURCES = {"k6:square": ("k6_square.cu", ("uz_cluster_labels",)),
               "k5:warps": ("k5_warp_rows.cu", ("uz_relax_pairs_warps",))}
OWN_SIGNATURES = {"uz_relax_pairs_warps": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                  + [ctypes.c_void_p] * 4}


def variant_source(spec: str) -> str:
    from uzliti_slam_tpu_torch.kernels import _build

    text = (_build.CSRC / "cluster_labels.cu").read_text()
    for knob in spec.split(":", 1)[1].split(","):
        name, value = knob.split("=")
        if name == "stamps":
            text = text.replace("namespace {\n", "namespace {\n" + STAMP_DEF, 1)
            text = text.replace("  extern __shared__ __align__(16) int sm[];\n",
                                "  extern __shared__ __align__(16) int sm[];\n"
                                "  __shared__ long long s_t[7];\n  STAMP(0);\n", 1)
            for anchor, put in STAMPS:
                assert text.count(anchor) == 1, anchor
                text = text.replace(anchor, put + anchor)
            end = ("      row[j] = static_cast<unsigned char>(s >= 0 && ok[j] && cur[j] == s);\n"
                   "  }\n")
            assert text.count(end) == 1
            text = text.replace(end, end + "  STAMP(6);\n  if (tid < 6) a.labels[tid] = "
                                "static_cast<int>(s_t[tid + 1] - s_t[tid]);\n")
        else:
            pattern, repl = KNOBS[name]
            text, n = re.subn(pattern, repl.format(value), text)
            assert n == 1, knob
    return text


def build(nvcc: str, out_dir: Path, spec: str) -> ctypes.CDLL:
    """A variant's library: a substituted copy of K6's source, or one of
    ``OWN_SOURCES``."""
    from uzliti_slam_tpu_torch.kernels import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    own = OWN_SOURCES.get(spec.split("=")[0])
    tag = re.sub(r"\W", "_", spec if own is None else own[0][:-3])
    cu, lib = out_dir / f"{tag}.cu", out_dir / f"lib{tag}.so"
    cu.write_text(variant_source(spec) if own is None else (ROOT / "scripts" / own[0]).read_text())
    cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-shared", "-o", str(lib), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{proc.stderr}")
    handle = ctypes.CDLL(str(lib))
    for name in (K6_ENTRIES if own is None else own[1]):
        fn = getattr(handle, name)
        fn.argtypes = OWN_SIGNATURES.get(name) or _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return handle


def device_ms(fn, name: str, calls: int = 20):
    import chip_smoke as cs

    fn()
    torch.cuda.synchronize()
    _, names = cs.device_profile(lambda: [fn() for _ in range(calls)])
    v = cs.kernel_device_ms(names, (name,))[name]
    return None if v is None else v / calls


def variant_device_ms(fn, function: str, calls: int = 20):
    """Device ms a call of the profiled kernels whose names hold ``function``."""
    import chip_smoke as cs

    fn()
    torch.cuda.synchronize()
    _, names = cs.device_profile(lambda: [fn() for _ in range(calls)])
    hits = [ms for key, ms in names.items() if function in key]
    return sum(hits) / calls if hits else None


def square_line(size: str, lib, labels_args) -> dict:
    """``k6:square`` against the shipped labels entry."""
    import chip_smoke as cs
    from uzliti_slam_tpu_torch.kernels import _build
    from uzliti_slam_tpu_torch.kernels import ops as kops

    sf, st, valid, max_dt = labels_args
    chain = 10.0 + 4.9 * torch.arange(256, dtype=torch.float32, device=sf.device)
    cases = [(sf, st, valid, max_dt), (chain, chain + 500.0, torch.ones_like(valid), 5.0)]
    shipped = _build.load
    row = {"size": size, "variant": "k6:square",
           "shipped_device_ms": device_ms(lambda: kops.cluster_labels(*labels_args, 16),
                                          "cluster_labels"),
           "shipped_queued_ms": cs.queued_device_ms(lambda: kops.cluster_labels(*labels_args, 16))}
    _build.load = lambda: lib
    try:
        row["exact"] = all(torch.equal(kops.cluster_labels(*c, it),
                                       kops.cluster_labels_plain(*c, it))
                           for c in cases for it in (0, 1, 5, 16))
        row["device_ms"] = variant_device_ms(lambda: kops.cluster_labels(*labels_args, 16),
                                             "cluster_square")
        row["queued_ms"] = cs.queued_device_ms(lambda: kops.cluster_labels(*labels_args, 16))
    finally:
        _build.load = shipped
    return row


def warp_rows_lines(size: str, lib, pairs_args, warps) -> list:
    """``k5:warps=W`` against the shipped pairs entry, on the package's table."""
    import chip_smoke as cs
    from uzliti_slam_tpu_torch.kernels import ops as kops

    src, tgt, ef, et, w, n, n_iters = pairs_args
    dev, rows = src.device, src.shape[0]
    ref = kops.relax_pairs_plain(*pairs_args)
    lines = [{"size": size, "variant": "k5:shipped",
              "device_ms": device_ms(lambda: kops.relax_pairs(*pairs_args), "relax_pairs"),
              "queued_ms": cs.queued_device_ms(lambda: kops.relax_pairs(*pairs_args))}]
    scratch = torch.empty(rows * 2 * n, dtype=torch.float32, device=dev)
    out = torch.empty(rows, dtype=torch.float32, device=dev)
    layout = (ctypes.c_int * 2)()
    for W in warps:
        def call(W=W):
            t = kops.relax_table(ef, et, w, n)
            err = lib.uz_relax_pairs_warps(
                src.data_ptr(), tgt.data_ptr(), t.row_ptr.data_ptr(), t.adj.data_ptr(), rows, n,
                n_iters, W, min(n, kops.RELAX_LIST_CAP), ef.shape[0], out.data_ptr(),
                scratch.data_ptr(), ctypes.addressof(layout), kops._stream(dev))
            if err:
                raise RuntimeError(f"uz_relax_pairs_warps: CUDA error {err}")

        call()
        torch.cuda.synchronize()
        lines.append({"size": size, "variant": f"k5:warps={W}", "exact": torch.equal(out, ref),
                      "rows_in_smem": layout[0], "table_in_smem": layout[1],
                      "device_ms": variant_device_ms(call, "pairs_warp_rows"),
                      "queued_ms": cs.queued_device_ms(call)})
    return lines


def frontier_sweeps(dist0, ef, et, w, n_iters: int) -> int:
    from uzliti_slam_tpu_torch.kernels import ops as kops

    d, changed = dist0, dist0 < kops.INF
    for k in range(n_iters):
        if not bool(changed.any()):
            return k
        nd = kops.relax_min_plain(d, ef, et, w, 1)
        changed, d = nd != d, nd
    return n_iters


def label_rounds(sf, st, valid, max_dt, n_iters: int) -> int:
    from uzliti_slam_tpu_torch.kernels import ops as kops

    lab = kops.cluster_labels_plain(sf, st, valid, max_dt, 0)
    for k in range(n_iters):
        nxt = kops.cluster_labels_plain(sf, st, valid, max_dt, k + 1)
        if torch.equal(nxt, lab):
            return k + 1
        lab = nxt
    return n_iters


def main() -> int:
    import chip_smoke as cs
    from uzliti_slam_tpu_torch.kernels import _build
    from uzliti_slam_tpu_torch.kernels import ops as kops

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="k6:threads=256,k6:threads=512,k6:stamps=1,"
                    "k6:square,k5:warps=1,k5:warps=2,k5:warps=4,k5:warps=8")
    ap.add_argument("--threads", default="32,64,128,256,512")
    ap.add_argument("--sizes", default="epoch500,epoch10k")
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    _build.load()
    cs.lift_sync_check_for_restart_read()
    nvcc = _build.find_nvcc()
    out_dir = _build.BUILD_DIR.parent / "k5_k6_variants"
    specs = [v for v in args.variants.split(",") if v]
    warps = [int(s.split("=")[1]) for s in specs if s.startswith("k5:warps=")]
    square = build(nvcc, out_dir, "k6:square") if "k6:square" in specs else None
    warp_lib = build(nvcc, out_dir, "k5:warps") if warps else None
    libs = {spec: build(nvcc, out_dir, spec) for spec in specs
            if spec.startswith("k6:") and spec != "k6:square"}
    shipped = _build.load
    for size in args.sizes.split(","):
        spec = cs.EPOCH_500 if size == "epoch500" else cs.EPOCH_10K
        cfg, state, _, _ = cs.make_epoch_state(**spec, device=dev)
        inp = cs.epoch_kernel_inputs(state, cfg)
        src, tgt, ef, et, w, n, _ = inp["relax_pairs"]
        d0 = torch.full((src.shape[0], n), kops.INF, device=dev).scatter(
            1, src.long()[:, None], 0.0)
        st, nv, unc, *_ = inp["relax_uncertainty"]
        sf, stt, valid, max_dt, _ = inp["cluster_labels"]
        roots = inp["cluster_roots"]
        cost = {"pairs": {}, "uncertainty": {}, "labels": {}, "roots": {}}
        for it in (0, 1, 2, 4, 8, 16, 32, 64):
            cost["pairs"][it] = device_ms(
                lambda: kops.relax_pairs(src, tgt, ef, et, w, n, it), "relax_pairs")
            cost["uncertainty"][it] = device_ms(
                lambda: kops.relax_uncertainty(st, nv, unc, ef, et, w, it), "relax_uncertainty")
        for it in (0, 1, 2, 4, 8, 16):
            cost["labels"][it] = device_ms(
                lambda: kops.cluster_labels(sf, stt, valid, max_dt, it), "cluster_labels")
            cost["roots"][it] = device_ms(
                lambda: kops.cluster_roots(*roots[:9], it, roots[10]), "cluster_roots")
        print(json.dumps({"size": size, "cost": cost,
                          "pairs_sweeps_needed": frontier_sweeps(d0, ef, et, w, 64),
                          "k6_rounds_to_fixed_point": label_rounds(sf, stt, valid, max_dt, 16),
                          "k6_valid": int(valid.sum())}), flush=True)
        default = (kops.RELAX_THREADS, kops.RELAX_ROOT_THREADS)
        for T in (int(t) for t in args.threads.split(",")):
            kops.RELAX_THREADS = kops.RELAX_ROOT_THREADS = T
            row = {}
            for name in ("relax_pairs", "relax_uncertainty", "relax_min"):
                fn = getattr(kops, name)
                check = torch.equal(fn(*inp[name]), getattr(kops, name + "_plain")(*inp[name]))
                row[name] = {"bit_equal": check,
                             "queued_ms": cs.queued_device_ms(lambda: fn(*inp[name]))}
            print(json.dumps({"size": size, "threads": T, **row}), flush=True)
        kops.RELAX_THREADS, kops.RELAX_ROOT_THREADS = default
        if square is not None:
            print(json.dumps(square_line(size, square, (sf, stt, valid, max_dt))), flush=True)
        if warp_lib is not None:
            for line in warp_rows_lines(size, warp_lib, inp["relax_pairs"], warps):
                print(json.dumps(line), flush=True)
        for spec_v, lib in [("shipped", None)] + list(libs.items()):
            _build.load = shipped if lib is None else (lambda lib=lib: lib)
            try:
                if "stamps=1" in spec_v:
                    phases = []
                    for _ in range(20):
                        lab = kops.cluster_roots(*roots).labels
                        phases.append(lab[:6].tolist())
                    names = ("loads", "adjacency_and_round_1", "later_rounds", "statistics",
                             "compaction", "writes")
                    row = {k: statistics.median(p[i] for p in phases) for i, k in
                           enumerate(names)}
                    print(json.dumps({"size": size, "variant": spec_v, "phase_ns": row}),
                          flush=True)
                    continue
                got, ref = kops.cluster_roots(*roots), kops.cluster_roots_plain(*roots)
                same = all(torch.equal(a, b) for a, b in zip(got, ref))
                print(json.dumps({"size": size, "variant": spec_v, "exact": same,
                                  "roots_queued_ms": cs.queued_device_ms(
                                      lambda: kops.cluster_roots(*roots)),
                                  "labels_queued_ms": cs.queued_device_ms(
                                      lambda: kops.cluster_labels(sf, stt, valid, max_dt, 16))}),
                      flush=True)
            finally:
                _build.load = shipped
        del state
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
