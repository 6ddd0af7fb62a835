"""Robust SE(3) Levenberg-Marquardt pose-graph solver (chain-PCG).

PyTorch counterpart of ``uzliti_slam_tpu/graph/solver.py`` for the path its
``optimize`` takes with the chain preconditioner (``_lm_loop_fast``): both
the fixed-iteration chunked form (``early_exit=False``, the headline) and
the early-exit form (the library default).  Per LM iteration: one fused
linearization (kernel K1), a fixed count of PCG steps whose Hessian-vector
products are kernel K2 and whose preconditioner applies are kernel K3, and
one retraction whose residuals and robust χ² are kernel K4.  Connected
components and gauge fixing are kernel K8.  The chain factor itself and the
PCG vector updates are plain PyTorch.

The loop never reads a device value on the host: accept/reject, the λ
schedule, the PCG stall mask and the early-exit flag are all tensors
combined with ``torch.where``, so a solve on a CUDA device queues its work
without a host synchronisation.  The early exit therefore runs the full
iteration count, each step after convergence a no-op.  The one host read
is ``odometry_restart``'s decision whether to run the second solve
(``_host_decision``), which JAX takes on the device with ``lax.cond``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from uzliti_slam_tpu_torch.graph import factors, tridiag
from uzliti_slam_tpu_torch.graph.state import GraphState
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Same fields and defaults as ``uzliti_slam_tpu.graph.solver.SolverConfig``.

    The port runs ``mode="auto"`` with ``preconditioner="chain"``; options
    of other paths raise ``NotImplementedError`` (``check_supported``).
    ``split_hv_threshold``, ``unroll_lm`` and ``unroll_pcg`` are accepted
    and have no effect: the split Hv is a TPU layout of the same operator
    that kernel K2 computes at every size, and eager PyTorch has no loop to
    unroll.  ``direct_*``, ``closure_fraction`` and ``woodbury_ns_iters``
    only tune the paths that raise.
    """

    iterations: int = 20
    pcg_iterations: int = 12
    lambda_init: float = 1e-4
    lambda_factor: float = 3.0
    lambda_min: float = 1e-9
    lambda_max: float = 1e2
    huber_delta: float = 1.0
    pcg_tol: float = 1e-8
    optimize_xy_only: bool = False
    preconditioner: str = "chain"
    precond_refresh: int = 5
    chain_dense_cutoff: int = 64
    chain_root_ns: bool = False
    use_odometry_calibration: bool = False
    restart_chi2_margin: float = 0.2
    odometry_restart: bool = False
    split_hv_threshold: int = 4096
    early_exit: bool = True
    early_exit_tol: float = 1e-6
    unroll_lm: int = 1
    unroll_pcg: int = 1
    dense_gathers: bool = False
    woodbury_ns_iters: int = 20
    mode: str = "auto"
    direct_node_threshold: int = 4096
    direct_closure_cap: int = 512
    direct_inner_cg: int = 0
    closure_fraction: float = 0.25


def check_supported(config: SolverConfig) -> None:
    """Raise NotImplementedError, naming the option, for paths not ported."""
    if config.mode != "auto":
        raise NotImplementedError(f"mode={config.mode!r}")
    if config.preconditioner != "chain":
        raise NotImplementedError(f"preconditioner={config.preconditioner!r}")
    for name in ("dense_gathers", "chain_root_ns", "use_odometry_calibration",
                 "optimize_xy_only"):
        if getattr(config, name):
            raise NotImplementedError(f"{name}=True")


class SolveStats(NamedTuple):
    chi2_history: torch.Tensor    # (iterations + 1,)
    accepted: torch.Tensor        # (iterations,) bool
    final_lambda: torch.Tensor    # ()
    num_gauge_fixed: torch.Tensor  # () int32


# ---------------------------------------------------------------------------
# Connected components + gauge fixing
# ---------------------------------------------------------------------------

def connected_components(g: GraphState, num_iters: int | None = None) -> torch.Tensor:
    """Min-label propagation over valid edges with pointer jumping (kernel
    K8 on a CUDA device).

    Returns (N,) int32 component labels (the min node slot in each
    component). Invalid nodes keep their own index.
    """
    n = g.node_capacity
    iters = num_iters if num_iters is not None else max(2 * math.ceil(math.log2(max(n, 2))), 8)
    return kops.components(g.e_from, g.e_to, g.e_valid, n, iters)


def gauge_fix_mask(g: GraphState, labels: torch.Tensor) -> torch.Tensor:
    """Nodes to hold fixed: pre-fixed nodes, plus the oldest valid node of
    every component without one (``g2o_optimizer.cpp:301-349``); kernel K8
    on a CUDA device."""
    return kops.gauge_fix(labels.to(torch.int32), g.node_valid, g.node_fixed, g.stamp)


# ---------------------------------------------------------------------------
# Normal equations
# ---------------------------------------------------------------------------

def _weighted_info(g: GraphState, r: torch.Tensor, huber_delta: float) -> torch.Tensor:
    """Per-edge robustly-weighted information, zeroed for invalid edges."""
    return factors.weighted_info(r, g.e_info, g.e_valid, huber_delta)


def _pcg(hvp, apply_minv, b, iterations: int, tol: float):
    """Preconditioned CG for H dx = b. Fixed iteration count, masked stall."""

    def vdot(a, c):
        return torch.sum(a * c)

    x = torch.zeros_like(b)
    r = b
    z = apply_minv(r)
    p = z
    rz = vdot(r, z)
    b2 = vdot(b, b)
    for _ in range(iterations):
        Hp = hvp(p)
        pHp = vdot(p, Hp)
        ok = (pHp > 1e-20) & (rz > tol * (b2 + 1e-30))
        alpha = torch.where(ok, rz / torch.where(pHp == 0, 1.0, pHp), 0.0)
        x = x + alpha * p
        r = r - alpha * Hp
        z = apply_minv(r)
        rz_new = vdot(r, z)
        beta = torch.where(ok, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
        p = torch.where(ok, z + beta * p, p)
        rz = torch.where(ok, rz_new, rz)
    return x


class _Problem:
    """Per-solve constants of the LM loop: masks, edge tables, Ad(meas⁻¹)."""

    def __init__(self, g: GraphState, free: torch.Tensor, config: SolverConfig):
        self.g, self.free, self.config = g, free, config
        self.valid = g.e_valid.to(free.dtype)
        self.is_chain = ((g.e_to == g.e_from + 1) & g.e_valid).to(free.dtype)
        self.both_free = ((free > 0) & (torch.roll(free, -1) > 0)).to(free.dtype)
        self.eye6 = torch.eye(6, dtype=free.dtype, device=free.device)
        # Measurements are constant across the solve: Ad(meas⁻¹) is hoisted
        # out of the loop, and with the residual carried forward from the
        # accepted candidate's χ² pass each linearization needs no pose.
        self.adj_meas_inv = lie.se3_adjoint(lie.pose_inverse(g.e_transform))

    def residuals(self, poses):
        return _residuals(self.g, poses, self.config.huber_delta)

    def linearize(self, r):
        g = self.g
        return kops.linearize(r, self.adj_meas_inv, g.e_info, self.valid, g.e_from,
                              g.e_to, self.free, self.both_free, self.is_chain,
                              self.config.huber_delta)

    def damp(self, lam, Hb):
        return lam * torch.clamp(torch.diagonal(Hb, dim1=-2, dim2=-1), min=1e-6)

    def build_pack(self, Hb, U, damp):
        """Chain factor of the damped block-tridiagonal part of H."""
        Dm = torch.where(self.free[:, None, None] > 0, Hb + torch.diag_embed(damp),
                         self.eye6)
        return tridiag.block_tridiag_factor(Dm, U, self.config.chain_dense_cutoff)

    def step(self, poses, pack, Ji, Jj, W, grad, damp):
        """One PCG solve + retraction: (cand, r_cand, chi2_new)."""
        g, cfg, free = self.g, self.config, self.free
        dx = _pcg(
            lambda v: kops.hvp(Ji, Jj, W, g.e_from, g.e_to, v, damp, free),
            lambda rr: tridiag.block_tridiag_apply(pack, rr),
            -grad, cfg.pcg_iterations, cfg.pcg_tol,
        )
        cand = lie.pose_retract(poses, dx * free[:, None])
        r_cand, chi2_new = self.residuals(cand)
        return cand, r_cand, chi2_new


def _lm_fixed(p: _Problem, r0, chi2_0):
    """Fixed iteration count in refresh chunks: the factor is built once per
    chunk from the chunk's first iterate (``solver.py:950-1013``)."""
    cfg = p.config
    refresh = max(1, min(int(cfg.precond_refresh), cfg.iterations))
    poses, r, chi2_cur = p.g.pose, r0, chi2_0
    lam = torch.full((), cfg.lambda_init, dtype=r0.dtype, device=r0.device)
    hist, acc = [], []
    for step_idx in range(cfg.iterations):
        if step_idx % refresh == 0:
            _, _, _, _, Hb, U = p.linearize(r)
            pack = p.build_pack(Hb, U, p.damp(lam, Hb))
        Ji, Jj, W, grad, Hb, U = p.linearize(r)
        cand, r_cand, chi2_new = p.step(poses, pack, Ji, Jj, W, grad, p.damp(lam, Hb))
        accept = chi2_new < chi2_cur
        poses = torch.where(accept, cand, poses)
        r = torch.where(accept, r_cand, r)
        chi2_cur = torch.where(accept, chi2_new, chi2_cur)
        lam = torch.clamp(
            torch.where(accept, lam / cfg.lambda_factor, lam * cfg.lambda_factor),
            cfg.lambda_min, cfg.lambda_max,
        )
        hist.append(chi2_cur)
        acc.append(accept)
    return poses, lam, hist, acc


def _lm_early_exit(p: _Problem, r0, chi2_0):
    """g2o-parity termination (``solver.py:886-948``) as a fixed count of
    steps that turn into no-ops once ``done`` is set.

    The factor is refreshed every ``precond_refresh`` accepted steps and
    right after a rejected one.  That choice depends on device values, so
    from the second iteration on the candidate factor is built every step
    and kept with ``torch.where``: factor work is traded for a loop with no
    host synchronisation.
    """
    cfg = p.config
    dev, dt = r0.device, r0.dtype
    refresh = max(1, min(int(cfg.precond_refresh), cfg.iterations))
    poses, r, chi2_cur = p.g.pose, r0, chi2_0
    lam = torch.full((), cfg.lambda_init, dtype=dt, device=dev)
    stale = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    pack = None
    hist, acc = [], []
    for it in range(cfg.iterations):
        Ji, Jj, W, grad, Hb, U = p.linearize(r)
        damp = p.damp(lam, Hb)
        # refresh on schedule OR right after a rejected step
        fresh = p.build_pack(Hb, U, damp)
        if pack is None:
            pack = fresh
        else:
            need = stale >= refresh
            pack = _select_pack(need, fresh, pack)
            stale = torch.where(need, 0, stale)
        cand, r_cand, chi2_new = p.step(poses, pack, Ji, Jj, W, grad, damp)
        active = ~done
        accept = (chi2_new < chi2_cur) & active
        gain = (chi2_cur - chi2_new) / torch.clamp(chi2_cur, min=1e-12)
        poses = torch.where(accept, cand, poses)
        r = torch.where(accept, r_cand, r)
        lam_next = torch.clamp(
            torch.where(accept, lam / cfg.lambda_factor, lam * cfg.lambda_factor),
            cfg.lambda_min, cfg.lambda_max,
        )
        # converged (tiny accepted gain with λ already relaxed) or stuck
        # (rejected with λ at its ceiling)
        finished = (
            (accept & (gain < cfg.early_exit_tol) & (lam <= cfg.lambda_init))
            | (~accept & (lam >= cfg.lambda_max))
        )
        chi2_cur = torch.where(accept, chi2_new, chi2_cur)
        lam = torch.where(active, lam_next, lam)
        stale = torch.where(accept, stale + 1, refresh)
        done = done | (active & finished)
        hist.append(chi2_cur)
        acc.append(accept)
    return poses, lam, hist, acc


def _select_pack(need: torch.Tensor, fresh, old):
    levels_f, root_f, n = fresh
    levels_o, root_o, _ = old
    levels = tuple(
        tuple(torch.where(need, a, b) for a, b in zip(lf, lo))
        for lf, lo in zip(levels_f, levels_o)
    )
    return levels, torch.where(need, root_f, root_o), n


def _residuals(g: GraphState, poses: torch.Tensor, huber_delta: float):
    """Edge residuals of ``poses`` and their robust χ² (kernel K4 on CUDA)."""
    return kops.residual_chi2(poses, g.e_from, g.e_to, g.e_transform, g.e_info,
                              g.e_valid.to(poses.dtype), huber_delta)


def total_chi2(g: GraphState, poses: torch.Tensor, huber_delta: float) -> torch.Tensor:
    """Robust χ² of ``poses`` on ``g``'s edges."""
    return _residuals(g, poses, huber_delta)[1]


def lm_loop(g: GraphState, free: torch.Tensor, config: SolverConfig):
    """The LM iteration core. Returns (poses, final_lambda, chi2_history,
    accepted)."""
    p = _Problem(g, free, config)
    r0, chi2_0 = p.residuals(g.pose)
    run = _lm_early_exit if config.early_exit else _lm_fixed
    poses, lam, hist, acc = run(p, r0, chi2_0)
    return poses, lam, torch.stack([chi2_0, *hist]), torch.stack(acc)


def _host_decision(flag: torch.Tensor) -> bool:
    """Read a device flag on the host.  The solve's only host
    synchronisation: whether ``odometry_restart`` runs its second LM solve
    (JAX skips it at run time with ``lax.cond``; running both solves and
    selecting would double every epoch's cost)."""
    return bool(flag)


def _restart_solve(g: GraphState, free: torch.Tensor, config: SolverConfig):
    """``odometry_restart`` (``solver.py:1254-1294``): solve from the current
    poses; when that ends above ``restart_chi2_margin`` × the χ² of the
    odometry prior re-anchored into the map frame (diff ∘ odom, pre-fixed
    nodes keeping their poses), solve again from that prior and keep the
    lower final χ²."""
    odo_start = lie.pose_compose(g.diff_transform[None], g.odom_pose)
    movable = g.node_valid & ~g.node_fixed
    odo_start = torch.where(movable[:, None], odo_start, g.pose)
    poses_a, lam_a, hist_a, acc_a = lm_loop(g, free, config)
    chi2_prior = total_chi2(g, odo_start, config.huber_delta)
    need = hist_a[-1] > config.restart_chi2_margin * chi2_prior
    if not _host_decision(need):
        return poses_a, lam_a, hist_a, acc_a
    poses_b, lam_b, hist_b, acc_b = lm_loop(g.replace(pose=odo_start), free, config)
    b_wins = hist_b[-1] < hist_a[-1]
    return (torch.where(b_wins, poses_b, poses_a), torch.where(b_wins, lam_b, lam_a),
            torch.where(b_wins, hist_b, hist_a), torch.where(b_wins, acc_b, acc_a))


def optimize(g: GraphState, config: SolverConfig = SolverConfig()):
    """Run LM on the pose graph; returns (updated graph, SolveStats).

    Write-back follows the reference ``storeImpl``
    (``g2o_optimizer.cpp:106-135``): poses updated, per-edge χ² errors
    recomputed, edge ages incremented.
    """
    check_supported(config)
    labels = connected_components(g)
    gauge = gauge_fix_mask(g, labels)
    free = (g.node_valid & ~gauge).to(g.pose.dtype)
    solve = _restart_solve if config.odometry_restart else lm_loop
    poses, lam, chi2_hist, accepted = solve(g, free, config)

    valid = g.e_valid.to(poses.dtype)
    r, _ = _residuals(g, poses, config.huber_delta)
    g = g.replace(
        pose=poses,
        e_error=factors.edge_chi2(r, g.e_info) * valid,
        e_age=g.e_age + valid,
    )
    stats = SolveStats(
        chi2_history=chi2_hist,
        accepted=accepted,
        final_lambda=lam,
        num_gauge_fixed=gauge.sum().to(torch.int32),
    )
    return g, stats
