#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's pose-graph solve on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA card (Hopper,
``sm_90a``) and ``nvcc``.  It builds the port's kernels from ``csrc/`` into
``build/uzliti_slam_tpu_torch/`` and runs, in order, each phase printing one
line of its own:

1. the environment: torch and CUDA versions, nvcc, the card's name and
   power limit (nvidia-smi);
2. the kernels' build, timed;
3. each kernel (K1 linearize, K2 hvp, K3 chain_apply, K4 residual_chi2)
   against its plain PyTorch version on the card, on the inputs the solve
   gives it on a generated 1k-node and 100k-node graph: max error against
   a stated tolerance, and the median time of both;
4. the 1k-node headline solve (20 LM x 12 PCG, chain factor refreshed every
   5, fixed iteration count) through ``optimize``: launch counts of one
   solve, no host synchronisation inside the timed solves (CUDA sync debug
   mode "error"), final χ² against the same solve on CPU tensors and
   against the sparse oracle, median solve time;
5. the library default ``SolverConfig()`` (early exit) at 1k nodes against
   the oracle;
6. the headline configuration at 10k nodes against the oracle (LM);
7. the headline configuration at 100k nodes: time, finite χ² below χ²₀.

Then one JSON line with the kernels' results, the nvidia-smi line, and as
the last line ``{"ok": true, "device": {...}}``.  Any failed check raises,
and the exit code is not 0.  Without a CUDA device it exits with code 1
before doing anything.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time

import torch

SEED = 0
HEADLINE = dict(iterations=20, pcg_iterations=12, preconditioner="chain",
                precond_refresh=5, early_exit=False)
# Solve-level χ² tolerance: summation order alone moves a converged χ² by
# 5.9e-5 relative JAX against JAX, 12-step PCG is not converged, and an LM
# accept test can turn on a near-tie, so 1e-3 relative plus 1e-6·χ²₀.
CHI2_RTOL = 1e-3
# Oracle bar of tests/test_solver.py: within 10% of "what g2o returns".
ORACLE_FACTOR, ORACLE_ATOL = 1.10, 1e-3
# Kernel against plain version, as max|kernel - plain| / max|plain|:
#  K1 1e-3 — the Jacobian's Q block takes (θ²/2 + cos θ - 1)/θ⁴ just above
#     its 1e-2 Taylor switch, where float32 keeps few bits, and scales it
#     by |ρ|; a different rounding order there moves Jⱼ by ~1e-4 of its
#     scale, then H = JᵀWJ and float atomics add their own;
#  K2, K3, K4 1e-4 — the same arithmetic summed in another order.
KERNEL_TOL = {"linearize": 1e-3, "hvp": 1e-4, "chain_apply": 1e-4, "residual_chi2": 1e-4}
REPLACES = {
    "linearize": "uzliti_slam_tpu/graph/solver.py:355 (_make_fused_linearize)",
    "hvp": "uzliti_slam_tpu/graph/solver.py:306 (_make_hvp)",
    "chain_apply": "uzliti_slam_tpu/graph/tridiag.py:198 (block_tridiag_apply)",
    "residual_chi2": "uzliti_slam_tpu/graph/solver.py:1034 (_robust_chi2_from_r)"
                     " + graph/factors.py:72 (batched_residuals)",
}
SOURCE = {k: f"uzliti_slam_tpu_torch/csrc/{k}.cu" for k in REPLACES}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def time_pair(kernel_fn, plain_fn, trials: int = 21, calls: int = 10):
    """Median ms per call of two functions on the card, in alternating
    trials (plain, kernel, kernel, plain, ...) timed with CUDA events."""
    def one(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    for fn in (kernel_fn, plain_fn):
        fn()
    torch.cuda.synchronize()
    tk, tp = [], []
    for i in range(trials):
        order = [(plain_fn, tp), (kernel_fn, tk)]
        for fn, acc in (order if i % 2 == 0 else order[::-1]):
            acc.append(one(fn))
    return statistics.median(tk), statistics.median(tp)


def timed_solves(optimize, g, cfg, reps: int):
    """Median seconds per solve; each solve runs under CUDA sync debug mode
    "error", so a host synchronisation inside ``optimize`` raises."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = optimize(g, cfg)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), out


DEVICE_FUNCTIONS = ("linearize_edges", "linearize_mask", "hvp_seed", "hvp_edges",
                    "chain_forward", "chain_backward", "residual_edges", "sum_partials")


def ptxas_summary(text: str) -> dict:
    """Registers and spilled bytes per device function, from ``ptxas -v``."""
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = next((f for f in DEVICE_FUNCTIONS if f in m.group(1)), m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            out.setdefault(name, {})["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return out


def device_profile(fn) -> dict:
    """One profiled call: wall ms, summed device-kernel ms, the busy share
    they give, and the five kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in kernels)
    if dev_us == 0:
        return {"profile": "not measured (no device time in the trace)"}
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    return {"profiled_wall_ms": 1e3 * wall, "device_kernel_ms": dev_us / 1e3,
            "device_busy_share": dev_us / 1e6 / wall,
            "device_launches": sum(e.count for e in kernels),
            "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in top}}


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def make_graph(n_nodes: int, device, seed: int = SEED):
    from uzliti_slam_tpu_torch.io import synthetic

    g, _ = synthetic.make_pose_graph(
        n_nodes, loop_closure_every=10, generator=torch.Generator().manual_seed(seed),
        device=device)
    return g


def kernel_inputs(g, cfg):
    """The inputs each kernel gets in the first LM iteration of a solve."""
    from uzliti_slam_tpu_torch.graph import solver

    free = (g.node_valid & ~solver.gauge_fix_mask(g, solver.connected_components(g))).float()
    p = solver._Problem(g, free, cfg)
    gen = torch.Generator().manual_seed(SEED + 1)
    r0, _ = p.residuals(g.pose)
    Ji, Jj, W, grad, Hb, U = p.linearize(r0)
    lam = torch.full((), cfg.lambda_init, device=g.device)
    damp = p.damp(lam, Hb)
    pack = p.build_pack(Hb, U, damp)
    v = torch.randn(g.node_capacity, 6, generator=gen).to(g.device)
    return {
        "residual_chi2": (g.pose, g.e_from, g.e_to, g.e_transform, g.e_info, p.valid,
                          cfg.huber_delta),
        "linearize": (r0, p.adj_meas_inv, g.e_info, p.valid, g.e_from, g.e_to, free,
                      p.both_free, p.is_chain, cfg.huber_delta),
        "hvp": (Ji, Jj, W, g.e_from, g.e_to, v, damp, free),
        "chain_apply": (pack, -grad),
    }


def compare_kernels(g, label: str, timing: bool = True):
    """Each kernel against its plain version on the same card inputs."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops

    inputs = kernel_inputs(g, solver.SolverConfig(**HEADLINE))
    results = {}
    for name, args in inputs.items():
        kernel_fn = getattr(kops, name)
        plain_fn = getattr(kops, f"{name}_plain")
        got, ref = kernel_fn(*args), plain_fn(*args)
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        torch.cuda.synchronize()
        err, rel = 0.0, 0.0
        for a, b in zip(got, ref):
            check(bool(torch.isfinite(a).all()), f"{name}: non-finite output")
            e = float((a - b).abs().max())
            err = max(err, e)
            rel = max(rel, e / max(float(b.abs().max()), 1e-30))
        row = {"max_abs_err": err, "max_rel_err": rel, "tol_rel": KERNEL_TOL[name]}
        if timing:
            row["ms"], row["plain_ms"] = time_pair(lambda: kernel_fn(*args),
                                                   lambda: plain_fn(*args))
        log(f"3 kernel {name} {label}", **row)
        check(rel <= KERNEL_TOL[name],
              f"{name} {label}: rel err {rel:.3g} > {KERNEL_TOL[name]}")
        results[name] = row
    return results


def headline_solve(g, chi2_oracle: float, reps: int):
    """Phase 4: counts, sync-free timed solves, χ² against CPU and oracle."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.kernels import ops as kops

    cfg = solver.SolverConfig(**HEADLINE)
    for _ in range(2):                       # warm-up: cuBLAS/cuSOLVER handles
        solver.optimize(g, cfg)
    torch.cuda.synchronize()
    kops.reset_launches()
    _, (g2, st) = timed_solves(solver.optimize, g, cfg, reps=1)
    counts = dict(kops.launches)
    expected = {"linearize": 24, "hvp": 240, "chain_apply": 260, "residual_chi2": 22}
    check(counts == expected, f"launch counts {counts} != {expected}")
    finals = []
    for _ in range(reps):
        t1, (g2, st) = timed_solves(solver.optimize, g, cfg, reps=1)
        finals.append((t1, float(st.chi2_history[-1])))
    t = statistics.median(f[0] for f in finals)
    hist = st.chi2_history.cpu()
    chi2_0, chi2 = float(hist[0]), float(hist[-1])
    spread = max(f[1] for f in finals) - min(f[1] for f in finals)
    _, st_cpu = solver.optimize(g.to("cpu"), cfg)
    chi2_cpu = float(st_cpu.chi2_history[-1])
    log("4 headline 1k", solve_ms=1e3 * t, solves_per_s=1.0 / t, chi2_0=chi2_0,
        chi2=chi2, chi2_run_to_run_spread=spread, chi2_cpu_plain=chi2_cpu,
        chi2_oracle=chi2_oracle, ratio_vs_oracle=chi2 / chi2_oracle, launches=counts,
        accepted=int(st.accepted.sum()), sync_free=True,
        **device_profile(lambda: solver.optimize(g, cfg)))
    check(abs(chi2 - chi2_cpu) <= CHI2_RTOL * chi2_cpu + 1e-6 * chi2_0,
          f"1k χ² {chi2} vs CPU plain path {chi2_cpu}")
    check(chi2 <= ORACLE_FACTOR * chi2_oracle + ORACLE_ATOL,
          f"1k χ² {chi2} vs oracle {chi2_oracle}")
    return counts


def oracle_chi2(g, **kw) -> float:
    from uzliti_slam_tpu_torch.graph import oracle, solver

    g_cpu = g.to("cpu")
    return float(solver.total_chi2(g_cpu, oracle.sparse_gn_oracle(g_cpu, **kw), 1.0))


def solve_against_oracle(g, phase: str, cfg_kw: dict, chi2_oracle, reps: int):
    """Phases 5-7: timed, sync-free solves; χ² against the oracle (if any)."""
    from uzliti_slam_tpu_torch.graph import solver

    cfg = solver.SolverConfig(**cfg_kw)
    solver.optimize(g, cfg)                  # warm-up at this size
    t, (g2, st) = timed_solves(solver.optimize, g, cfg, reps=reps)
    hist = st.chi2_history.cpu()
    chi2_0, chi2 = float(hist[0]), float(hist[-1])
    chi2_poses = float(solver.total_chi2(g, g2.pose, cfg.huber_delta))
    fields = dict(n_nodes=int(g.num_nodes), solve_ms=1e3 * t, solves_per_s=1.0 / t,
                  chi2_0=chi2_0, chi2=chi2, chi2_of_poses=chi2_poses,
                  accepted=int(st.accepted.sum()))
    if chi2_oracle is not None:
        fields.update(chi2_oracle=chi2_oracle, ratio_vs_oracle=chi2 / chi2_oracle)
    log(phase, **fields)
    check(torch.isfinite(g2.pose).all().item() and chi2 == chi2, f"{phase}: non-finite")
    check(chi2 < chi2_0, f"{phase}: χ² {chi2} not below χ²₀ {chi2_0}")
    if chi2_oracle is not None:
        check(chi2 <= ORACLE_FACTOR * chi2_oracle + ORACLE_ATOL,
              f"{phase}: χ² {chi2} vs oracle {chi2_oracle}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check needs a CUDA card",
              file=sys.stderr)
        return 1
    from uzliti_slam_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = nvidia_smi_line()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log("1 env", torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
        python=sys.version.split()[0], card=smi)

    t0 = time.perf_counter()
    _build.load()
    ptxas = _build.BUILD_DIR / f"ptxas_{_build.source_hash()}.log"
    log("2 build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.last_build_seconds,
        library=str(_build.library_path().relative_to(_build.BUILD_DIR.parents[1])),
        ptxas=ptxas_summary(ptxas.read_text()) if ptxas.exists() else "no log (prebuilt)")

    g1k = make_graph(1000, dev)
    g100k = make_graph(100_000, dev)
    rows = compare_kernels(g1k, "1k")
    rows_100k = compare_kernels(g100k, "100k")

    chi2_oracle_1k = oracle_chi2(g1k, iters=12)
    launches = headline_solve(g1k, chi2_oracle_1k, reps=10)
    solve_against_oracle(g1k, "5 default early-exit 1k", {}, chi2_oracle_1k, reps=5)
    g10k = make_graph(10_000, dev)
    solve_against_oracle(g10k, "6 headline 10k", HEADLINE,
                         oracle_chi2(g10k, iters=20, lm=True), reps=3)
    solve_against_oracle(g100k, "7 headline 100k", HEADLINE, None, reps=3)

    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE[name], "replaces": REPLACES[name],
         "launches": launches[name], "max_abs_err": rows[name]["max_abs_err"],
         "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
         "max_abs_err_100k": rows_100k[name]["max_abs_err"],
         "ms_100k": rows_100k[name]["ms"], "plain_ms_100k": rows_100k[name]["plain_ms"]}
        for name in REPLACES
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
