#!/usr/bin/env python3
"""Time K21 (``csrc/feature_votes.cu``) and K22 (``csrc/repository.cu``)
against a parent checkout's kernels on one card, and the Hamming-distance
engines' instructions alone.

    python3 scripts/k21_k22_variants.py [--variants b1,b1:stamps=1] [--parent build/parent]
        [--sizes step,10k,50k] [--trials 11] [--rounds 2] [--check-only] [--rates]

The variant ``b1`` is the package's two sources (the b1 mma with AND +
popcount, ``csrc/hamming_mma.cuh``); ``b1:stamps=1`` the same with
``-DUZ_RECOG_STAMPS``, a timing build: CTA 0's µs by phase of K21 and of
``repo_votes`` (``STAMP_PHASES``) and K21's CTAs' spread.  Each is compiled
by ``nvcc`` with the package's flags into a library of its own under
``build/k21_k22_variants/`` (all builds started together), and called
through the package's wrappers (``kops.feature_votes``, ``repo_nearest``,
``repo_votes``, with ``_build.load`` pointed at the variant's library).
``--parent`` builds another checkout's ``feature_votes.cu`` and
``repository.cu`` the same way (variant "parent") and calls their C entries
as that checkout's wrappers did: a sims buffer, the keys filled with ones
and the votes with zeros, a call.  Sizes: "step" the VGA step's shapes (K21
256 queries x 512 nodes x 256; K22 256 queries, D = 16,384 with 8 links, 512
nodes), "1k", "10k", "50k" phase 14b's synthetic banks (128 descriptors a
node; D = 32·N).  Each call is held against the plain version exactly
(every output) and run twice for the same bits, then timed: CUDA events
around the calls (median of ``--trials`` windows), device ms a call queued
back to back behind a sleep kernel (``chip_smoke.queued_device_ms``), and
the device launches and device ms of one whole profiled call (fills
included); with ``--rounds`` the variants take turns, their order reversed
every other round.  ``--check-only`` also holds
``chip_smoke.recognition_edge_cases`` and skips the timing.  ``--rates``
first times each engine's instruction alone (``scripts/hamming_mma_rates.cu``:
the b1 mma with AND or XOR + popcount, the u8 m16n8k32 mma, ``popc``;
independent chains a warp, 8 CTAs of 256 an SM).  Prints one JSON line a
variant, entry and size, the ptxas lines and the card's name and power
limit.
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

ENTRIES = ("feature_votes", "repo_nearest", "repo_votes")
SOURCES = ("feature_votes.cu", "repository.cu")


def build_all(nvcc: str, specs: list, parent: Path | None) -> dict:
    """Start every variant's nvcc at once; {spec: (library path, ptxas
    lines)} for those that built, {spec: error text} for the rest."""
    from uzliti_slam_tpu_torch.kernels import _build

    procs = {}
    for spec in specs + (["parent"] if parent else []):
        csrc = (parent / "uzliti_slam_tpu_torch" / "csrc") if spec == "parent" else _build.CSRC
        out = ROOT / "build" / "k21_k22_variants" / spec.replace(":", "_").replace("=", "-")
        out.mkdir(parents=True, exist_ok=True)
        flags = list(_build.NVCC_FLAGS) + ["-I", str(csrc)]
        if spec != "parent":
            name, *opts = spec.split(":")
            if name != "b1":
                raise SystemExit(f"unknown variant {spec!r}")
            for o in opts:
                key, val = o.split("=", 1)
                if key == "stamps" and int(val):
                    flags.append("-DUZ_RECOG_STAMPS=1")
                else:
                    raise SystemExit(f"unknown option in {spec!r}")
        lib = out / "lib.so"
        cmd = [nvcc, *flags, "-shared", "-o", str(lib), *(str(csrc / f) for f in SOURCES)]
        procs[spec] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                             text=True))
    built = {}
    for spec, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            built[spec] = err[-3000:]
            continue
        regs = [ln.strip() for ln in err.splitlines() if "registers" in ln or "spill" in ln]
        built[spec] = (lib, regs)
    return built


def load(lib: Path):
    from uzliti_slam_tpu_torch.kernels import _build

    cdll = ctypes.CDLL(str(lib))
    for name in ("uz_feature_votes", "uz_repo_nearest", "uz_repo_votes"):
        fn = getattr(cdll, name)
        fn.argtypes = _build.SIGNATURES[name]
        fn.restype = ctypes.c_int
    return cdll


def parent_wrappers(lib) -> dict:
    """The parent checkout's wrappers over its C entries: each call makes
    its sims, fills its keys with ones or its votes with zeros, as they
    did."""
    from uzliti_slam_tpu_torch.kernels import ops as kops

    def stream(dev):
        return torch.cuda.current_stream(dev).cuda_stream

    def feature_votes(query, qvalid, bank, bank_valid, stamp, valid, q_stamp, k, thresh,
                      min_sim, min_dt):
        dev, (N, Fb, _) = query.device, bank.shape
        sims = torch.empty(N, dtype=torch.float32, device=dev)
        slots = torch.empty(k, dtype=torch.int32, device=dev)
        top = torch.empty(k, dtype=torch.float32, device=dev)
        ok = torch.empty(k, dtype=torch.bool, device=dev)
        err = lib.uz_feature_votes(*(t.data_ptr() for t in (query, qvalid, bank, bank_valid,
                                                            stamp, valid, q_stamp)),
                                   query.shape[0], Fb, N, k, float(thresh), float(min_sim),
                                   float(min_dt), sims.data_ptr(), slots.data_ptr(),
                                   top.data_ptr(), ok.data_ptr(), stream(dev))
        kops._raise_on(err, "feature_votes")
        return slots, top, ok

    def repo_nearest(query, qvalid, bank, bank_valid, thresh):
        dev, F, D = query.device, query.shape[0], bank.shape[0]
        keys = torch.full((F,), -1, dtype=torch.int64, device=dev)
        nn_dist = torch.empty(F, dtype=torch.float32, device=dev)
        nn_idx = torch.empty(F, dtype=torch.int32, device=dev)
        dup = torch.empty(F, dtype=torch.bool, device=dev)
        err = lib.uz_repo_nearest(*(t.data_ptr() for t in (query, qvalid, bank, bank_valid)), F,
                                  D, float(thresh), keys.data_ptr(), nn_dist.data_ptr(),
                                  nn_idx.data_ptr(), dup.data_ptr(), stream(dev))
        kops._raise_on(err, "repository")
        return nn_dist, nn_idx, dup

    def repo_votes(query, qvalid, bank, bank_valid, links, link_valid, node_stamp, node_valid,
                   q_stamp, k, thresh, min_votes, min_dt):
        dev, (D, L), N = query.device, links.shape, node_stamp.shape[0]
        votes = torch.zeros(N, dtype=torch.int32, device=dev)
        slots = torch.empty(k, dtype=torch.int32, device=dev)
        top = torch.empty(k, dtype=torch.int32, device=dev)
        ok = torch.empty(k, dtype=torch.bool, device=dev)
        err = lib.uz_repo_votes(*(t.data_ptr() for t in (query, qvalid, bank, bank_valid, links,
                                                         link_valid, node_stamp, node_valid,
                                                         q_stamp)),
                                query.shape[0], D, L, N, k, float(thresh), float(min_votes),
                                float(min_dt), votes.data_ptr(), slots.data_ptr(), top.data_ptr(),
                                ok.data_ptr(), stream(dev))
        kops._raise_on(err, "repository")
        return slots, top, ok

    return {"feature_votes": feature_votes, "repo_nearest": repo_nearest,
            "repo_votes": repo_votes}


def size_calls(size: str, dev) -> dict:
    """{entry: arguments} at a size."""
    import chip_smoke as cs

    if size == "step":
        nearest, votes = cs.repository_inputs(512, dev, cs.SEED + 1, F=256)
        return {"feature_votes": cs.feature_bank_inputs(512, dev, cs.SEED, F=256),
                "repo_nearest": nearest, "repo_votes": votes}
    n = {"1k": 1000, "10k": 10_000, "50k": 50_000}[size]
    nearest, votes = cs.repository_inputs(n, dev, cs.SEED + n + 1)
    return {"feature_votes": cs.feature_bank_inputs(n, dev, cs.SEED + n),
            "repo_nearest": nearest, "repo_votes": votes}


# the entries' device functions in either checkout
FUNCTIONS = {"feature_votes": ("feature_votes_kernel", "node_sims", "topk_sims"),
             "repo_nearest": ("repo_nearest_kernel", "nearest_chunk", "nearest_finish"),
             "repo_votes": ("repo_votes_kernel", "desc_hits", "topk_votes")}


# bit products a warp instruction computes, by form of hamming_mma_rates.cu
RATE_BITS = {0: 16 * 8 * 256, 1: 16 * 8 * 256, 2: 16 * 8 * 32, 3: 32 * 32}


def mma_rates(nvcc: str, dev) -> list:
    """``scripts/hamming_mma_rates.cu`` built and timed: each form's warp
    instructions a second, a second and SM, and bit products a second (an
    u8 mma's byte holds one bit), 8 CTAs of 256 an SM, CUDA events around
    one launch after a warm-up one."""
    from uzliti_slam_tpu_torch.kernels import _build

    out = ROOT / "build" / "k21_k22_variants" / "rates"
    out.mkdir(parents=True, exist_ok=True)
    lib = out / "rates.so"
    proc = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
                           str(ROOT / "scripts" / "hamming_mma_rates.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        return [{"rates": "build failed", "stderr": proc.stderr[-3000:]}]
    cdll = ctypes.CDLL(str(lib))
    cdll.uz_mma_rate.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    chains = cdll.uz_mma_rate_chains()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks, threads = 8 * sms, 256
    words = torch.randint(0, 2**31, (256,), dtype=torch.int64, device=dev).to(torch.int32)
    sink = torch.empty(blocks * threads, dtype=torch.int32, device=dev)
    rows = []
    for form in (0, 1, 2, 3):
        iters = 2000 if form < 3 else 20000
        args = (form, words.data_ptr(), blocks, threads, iters, sink.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        if cdll.uz_mma_rate(*args) != 0:
            rows.append({"form": form, "rates": "launch failed"})
            continue
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        cdll.uz_mma_rate(*args)
        end.record()
        end.synchronize()
        s = start.elapsed_time(end) / 1e3
        instr = blocks * (threads // 32) * iters * chains
        rows.append({"form": form, "ms": 1e3 * s, "warp_instructions_per_s": instr / s,
                     "per_sm_per_us": instr / s / sms / 1e6,
                     "bit_products_per_s": instr * RATE_BITS[form] / s})
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default="b1")
    ap.add_argument("--parent", type=Path, default=None, help="another checkout (its kernels)")
    ap.add_argument("--sizes", default="step,10k,50k")
    ap.add_argument("--trials", type=int, default=11)
    ap.add_argument("--rounds", type=int, default=1,
                    help="timing rounds, the variants' order reversed every other round")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--rates", action="store_true",
                    help="first time each form's instruction alone (hamming_mma_rates.cu)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from uzliti_slam_tpu_torch.kernels import _build
    from uzliti_slam_tpu_torch.kernels import ops as kops

    dev = torch.device("cuda", 0)
    if args.rates:
        for row in mma_rates(_build.find_nvcc(), dev):
            print(json.dumps(row), flush=True)
    specs = [v for v in args.variants.split(",") if v]
    built = build_all(_build.find_nvcc(), specs, args.parent)
    runs = {}
    for spec, res in built.items():
        if isinstance(res, str):
            print(json.dumps({"variant": spec, "build": "failed", "stderr": res}), flush=True)
            continue
        lib, regs = res
        print(json.dumps({"variant": spec, "ptxas": regs}), flush=True)
        cdll = load(lib)
        if spec == "parent":
            runs[spec] = parent_wrappers(cdll)
        else:
            runs[spec] = {e: (lambda *a, e=e, cdll=cdll: _with_lib(cdll, getattr(kops, e), a))
                          for e in ENTRIES}
            if "stamps=1" in spec:
                runs[spec]["_stamps"] = cdll
    if args.check_only:
        for spec, fns in runs.items():
            if spec == "parent":
                continue
            kops._recognition_scratch.clear()
            bad = {}
            for label, w, a in cs.recognition_edge_cases(dev):
                got, again = fns[w](*a), fns[w](*a)
                ref = getattr(kops, f"{w}_plain")(*a)
                torch.cuda.synchronize()
                mism = sum(int((x != y).sum()) for x, y in zip(got, ref))
                if mism or not cs.same_bits(got, again):
                    bad[f"{w} {label}"] = {"mismatches": mism,
                                           "same_bits_twice": cs.same_bits(got, again)}
            print(json.dumps({"variant": spec, "edge_cases_failed": bad}), flush=True)
    for size in args.sizes.split(","):
        calls = size_calls(size, dev)
        refs = {e: getattr(kops, f"{e}_plain")(*calls[e]) for e in ENTRIES}
        order = list(runs.items())
        for rnd in range(args.rounds):
            for spec, fns in (order if rnd % 2 == 0 else order[::-1]):
                kops._recognition_scratch.clear()     # each variant from a fresh scratch
                for e in ENTRIES:
                    row = {"variant": spec, "entry": e, "size": size, "round": rnd}
                    row.update(measure(fns[e], calls[e], refs[e], e, not args.check_only,
                                       args.trials))
                    if "_stamps" in fns and e != "repo_nearest":
                        row["phases_us"] = stamped_phases(fns["_stamps"], fns[e], calls[e], e)
                    print(json.dumps(row), flush=True)
        del calls, refs
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}), flush=True)
    return 0


def measure(fn, a, ref, entry: str, timed: bool, trials: int) -> dict:
    """One entry's call against the plain version's outputs ``ref``, twice
    for the same bits; timed: CUDA events, queued device ms, one profile."""
    import chip_smoke as cs

    def call():
        return fn(*a)

    got, again = call(), call()
    torch.cuda.synchronize()
    row = {"mismatches": sum(int((x != y).sum()) for x, y in zip(got, ref)),
           "same_bits_twice": cs.same_bits(got, again), "bound_ms": cs.bound(entry, a)["bound_ms"]}
    if timed:
        row["event_ms"] = cs.time_call(call, trials=trials, calls=5)
        row["queued_device_ms"] = cs.queued_device_ms(call, 10)
        prof, names = cs.device_profile(call)
        row["profile_device_launches"] = prof.get("device_launches")
        row["profile_device_ms"] = prof.get("device_kernel_ms")
        row["kernel_device_ms"] = sum(v for k, v in names.items()
                                      if any(f in k for f in FUNCTIONS[entry]))
    return row


# the stamp slots of a stamps build (csrc/feature_votes.cu:k21_ns,
# csrc/repository.cu:votes_ns)
STAMP_PHASES = {
    "feature_votes": ("start", "next_node_and_issue", "wait", "popcounts", "strips",
                      "stage_barrier", "node_sim", "ticket", "last_cta_topk", "stages",
                      "first_start", "last_start", "last_ticket"),
    "repo_votes": ("setup_and_tail", "strip_rows", "strip_columns", "strip_votes", "ticket",
                   "last_cta_topk", "last_cta_topk_and_zeroing", "strips")}


def stamped_phases(cdll, fn, a, entry: str) -> dict:
    """One call of a stamps build: CTA 0's µs by phase (its warp 0's for
    repo_votes), the last CTA's tail, and the count of stages or strips."""
    name = {"feature_votes": "stamps_feature_votes", "repo_votes": "stamps_repo_votes"}[entry]
    read = getattr(cdll, name)
    read.argtypes = [ctypes.c_void_p]
    n = len(STAMP_PHASES[entry])
    buf = (ctypes.c_ulonglong * n)()
    torch.cuda.synchronize()
    read(buf)                                      # zeroes the stamps
    fn(*a)
    torch.cuda.synchronize()
    read(buf)
    out = {p: (buf[i] if p in ("stages", "strips") else buf[i] / 1e3)
           for i, p in enumerate(STAMP_PHASES[entry]) if p not in SPREAD}
    if entry == "feature_votes":                   # the CTAs' spread, µs from the first start
        first = ~buf[10] & (2**64 - 1)
        out["last_start_us"] = (buf[11] - first) / 1e3
        out["last_ticket_us"] = (buf[12] - first) / 1e3
    return out


SPREAD = ("first_start", "last_start", "last_ticket")


def _with_lib(cdll, wrapper, a):
    """``wrapper(*a)`` with the package's ``_build.load`` pointed at
    ``cdll``."""
    from uzliti_slam_tpu_torch.kernels import _build

    load_ = _build.load
    _build.load = lambda: cdll
    try:
        return wrapper(*a)
    finally:
        _build.load = load_


if __name__ == "__main__":
    sys.exit(main())
