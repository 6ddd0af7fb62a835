"""Robust SE(3) Levenberg-Marquardt pose-graph solver (chain-PCG).

PyTorch counterpart of ``uzliti_slam_tpu/graph/solver.py`` for the paths
its ``optimize`` takes with the chain preconditioner: the fast loop
(``_lm_loop_fast``) in both its fixed-iteration chunked form
(``early_exit=False``, the headline) and its early-exit form (the library
default), and the generic loop (``lm_loop``'s scan: ``mode="pcg"``, and
every edge-sharded solve, whose ``reduce`` hook sums the shards' partial
node rows and χ² across ranks; ``parallel/sharded.optimize_sharded``).
The generic loop is the fixed chunked loop with that hook; it ignores
``early_exit``, as the reference does.  ``optimize_xy_only`` (the planar
solve) takes each loop's own form of the reference's projection: the fast
loop masks K1's Jacobian columns and lifts the factor's masked diagonal,
the generic loop wraps the operator and gradient and hands the
preconditioner the column mask (K34 masks r before the apply and z after
it).  Per LM iteration: one fused linearization (kernel K1), a PCG solve
of a fixed count of steps, then kernel K36 in two launches: the candidate
(retraction, its residuals and robust χ²) and the accept rule with the λ
schedule (and the early exit's termination), whose state lives in
per-iteration tensors (``kops.LmState``).  The PCG takes one of five
routes (``_pcg``): a single solve within K34's cap with no reduce hook is
kernel K35, the whole solve
with its Hessian-vector products in one launch; the edge-sharded solve
(whose all-reduce sits between Hv and the dot) runs K2 for each Hv and
K34 for each step's updates around the preconditioner apply; a single
solve above K34's cap, with or without a reduce hook, K2 for each Hv and
K37 for each step (one cooperative launch over the card); a fleet whose
instance fits one CTA's shared memory is kernel K38, every instance's
whole solve in one launch; a larger fleet K2, K10 and K3.
K1, K35 and K38 sum node rows over
the solve's incidence table (``kops.incidence_table``, built once per
solve) in a fixed order, so those routes give the same bits every run.
The chain factor is kernel K9, one launch that builds the damped diagonal
from Hb as it reads it; connected components and gauge fixing are kernel
K8.  K4 computes the start's and the final poses' residuals.

``optimize_batched`` solves a fleet of B independent graphs of equal
capacities, as the reference's ``vmap`` of ``optimize``: the fleet is
flattened into one block-diagonal table (instance b's nodes at b·N, its
edges' endpoints offset by b·N), which K1, K2 and K8 take as they are,
while λ, accept, χ², the refresh state and the early-exit flag are (B,)
tensors and K36, K38 (K10 and K3 above its cap), K9 keep each instance's
sums and factor its own, the instance on their grid (K38: an instance a
CTA, its rows of the table at b·N).  A single graph runs the same loop as the
batch of one.  The launches per solve do not grow with B.

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
from uzliti_slam_tpu_torch.graph.calibration import odometry_drift_correct
from uzliti_slam_tpu_torch.graph.state import EDGE_TYPE_2D_WHEEL_ODOMETRY, GraphState
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Same fields and defaults as ``uzliti_slam_tpu.graph.solver.SolverConfig``.

    The port runs ``mode="auto"`` (the fast loop) and ``mode="pcg"`` (the
    generic loop) with ``preconditioner="chain"``; options of other paths
    raise ``NotImplementedError`` (``check_supported``).
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
    """Raise NotImplementedError, naming the option, for paths not ported
    (``mode="direct"``: ROADMAP.md A6; the TPU layouts ``dense_gathers`` and
    ``chain_root_ns``; the other preconditioners)."""
    if config.mode not in ("auto", "pcg"):
        raise NotImplementedError(f"mode={config.mode!r}")
    if config.preconditioner != "chain":
        raise NotImplementedError(f"preconditioner={config.preconditioner!r}")
    for name in ("dense_gathers", "chain_root_ns"):
        if getattr(config, name):
            raise NotImplementedError(f"{name}=True")


# The planar solve's projection onto x, y and yaw of the twist (ρ, φ)
# (``solver.py:369``, ``:1156``; the reference's ``g2o_optimizer.cpp:164-170``).
XY_COLUMNS = (1.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def _xy_mask(dtype, device) -> torch.Tensor:
    """``XY_COLUMNS`` as a tensor, built on the device without a host copy
    (``torch.tensor`` of a list would synchronise the card)."""
    one = torch.ones(2, dtype=dtype, device=device)
    return torch.cat([one, torch.zeros(3, dtype=dtype, device=device), one[:1]])


def flatten_planar(poses: torch.Tensor, node_valid: torch.Tensor) -> torch.Tensor:
    """Valid nodes' poses with z, roll and pitch set to 0, as the reference
    adds its vertices under ``optimize_xy_only`` (``solver.py:1245-1249``)."""
    flat = lie.pose2_to_pose(lie.pose_to_pose2(poses))
    return torch.where(node_valid[:, None], flat, poses)


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
    iters = num_iters if num_iters is not None else component_iterations(n)
    return kops.components(g.e_from, g.e_to, g.e_valid, n, iters)


def gauge_fix_mask(g: GraphState, labels: torch.Tensor) -> torch.Tensor:
    """Nodes to hold fixed: pre-fixed nodes, plus the oldest valid node of
    every component without one (``g2o_optimizer.cpp:301-349``); kernel K8
    on a CUDA device."""
    return kops.gauge_fix(labels.to(torch.int32), g.node_valid, g.node_fixed, g.stamp)


def components_and_gauge(g: GraphState, num_iters: int | None = None):
    """``connected_components`` and ``gauge_fix_mask`` of them, as a solve
    needs them: (labels (N,) int32, gauge (N,) bool), kernel K8 in one
    launch on a CUDA device."""
    n = g.node_capacity
    iters = num_iters if num_iters is not None else component_iterations(n)
    return kops.components_gauge(g.e_from, g.e_to, g.e_valid, g.node_valid, g.node_fixed,
                                 g.stamp, n, iters)


# ---------------------------------------------------------------------------
# Normal equations
# ---------------------------------------------------------------------------

def _weighted_info(g: GraphState, r: torch.Tensor, huber_delta: float) -> torch.Tensor:
    """Per-edge robustly-weighted information, zeroed for invalid edges."""
    return factors.weighted_info(r, g.e_info, g.e_valid, huber_delta)


def _pcg(hvp, factor, b, iterations: int, tol: float, batch: int = 1, cmask=None, op=None):
    """Preconditioned CG for H dx = b with the chain factor ``factor`` as
    the preconditioner M. Fixed iteration count, masked stall.

    With ``op`` (H's tensors and the incidence table, a
    ``kops.HvpOperator``; the caller hands it only when H is local, with no
    reduce hook) a single chain within K34's cap is K35 on a CUDA device:
    the whole solve, each step's Hp = H·p and the reference's body
    (``solver.py:512-540``) around z = M⁻¹r, in one launch, ``hvp`` unused;
    a fleet of ``batch`` instances each of which fits one CTA's shared
    memory (``kops.pcg_fleet_route``) is K38, every instance's whole solve
    in one launch.  Otherwise each step is ``hvp`` (K2, and the caller's
    reduce) → K34: the dots, axpys and stall logic, one launch, with its
    scalars on the device; a single chain above K34's cap takes K37 for the
    same step (one cooperative launch over the card); a larger fleet K10 →
    K3 → K10 with one row of scalars per instance.  ``cmask`` (6,), the generic
    loop's planar projection, makes the preconditioner M⁻¹(r·m)·m (and the
    fused routes' operator H(p·m)·m, as the caller's ``hvp`` wraps it).
    """
    if op is not None:
        if kops.pcg_chain_route(factor, batch):
            return kops.pcg_chain_solve(factor, op, b, iterations, tol, cmask).x
        if kops.pcg_fleet_route(factor, batch, op.e_from.shape[0]):
            return kops.pcg_fleet_solve(factor, op, b, iterations, tol, cmask).x
    state = kops.pcg_chain_start(factor, b, batch, cmask)
    for _ in range(iterations):
        kops.pcg_chain_step(factor, hvp(state.p), state, tol, cmask)
    return state.x


class _Problem:
    """Per-solve constants of the LM loop: masks, edge tables, Ad(meas⁻¹).

    ``g`` holds ``batch`` instances of equal capacities flattened into one
    table (``_flatten_fleet``; a single graph is the batch of one), and the
    loop's scalars are (B,).

    ``reduce``, for an edge-sharded solve (``g``'s edge table one rank's
    shard, its poses and ``free`` replicated), sums a tensor in place
    across the ranks; it is applied to K1's packed node rows, to each Hv
    product (K2) and to each χ² (K4), so that every rank takes the same
    accept and λ decisions from the same sums.  ``damp_here`` is False on
    every rank but one, whose Hv partial alone carries the damping.
    Without ``reduce`` each PCG solve hands ``_pcg`` the operator itself
    (K35's route).  ``table`` is the incidence table of ``g``'s valid
    edges, over which K1 and K35 sum node rows.
    JAX's ``lm_loop`` takes its fast loop only with no reduce and
    ``mode="auto"``; otherwise the generic loop (``generic``)."""

    def __init__(self, g: GraphState, free: torch.Tensor, config: SolverConfig,
                 batch: int = 1, reduce=None, damp_here: bool = True):
        self.g, self.free, self.config, self.batch = g, free, config, batch
        self.reduce, self.damp_here = reduce, damp_here
        self.generic = reduce is not None or config.mode == "pcg"
        # optimize_xy_only: the fast loop masks K1's Jacobian columns and
        # lifts the factor's masked diagonal (solver.py:377-381, :867-868);
        # the generic loop wraps hvp, minv and the gradient (:1152-1160);
        # minv's wrap is the mask _pcg hands the preconditioner
        xy = config.optimize_xy_only
        self.col_mask = XY_COLUMNS if xy and not self.generic else None
        self.cmask = _xy_mask(free.dtype, free.device) if xy else None
        # the factor's lift: 1 on the masked coordinates' diagonal
        self.lift = 1.0 - self.cmask if self.col_mask is not None else None
        self.valid = g.e_valid.to(free.dtype)
        self.is_chain = ((g.e_to == g.e_from + 1) & g.e_valid).to(free.dtype)
        self.both_free = ((free > 0) & (torch.roll(free, -1) > 0)).to(free.dtype)
        self.eye6 = torch.eye(6, dtype=free.dtype, device=free.device)
        # roll couples each instance's last node b·N + N-1 to the next
        # instance's node 0 (and the last to node 0); no edge crosses
        # instances, so is_chain zeroes the coupling block there, as a
        # single graph's wrap-around is zeroed.
        # Measurements are constant across the solve: Ad(meas⁻¹) is hoisted
        # out of the loop, and with the residual carried forward from the
        # accepted candidate's χ² pass each linearization needs no pose.
        self.adj_meas_inv = lie.se3_adjoint(lie.pose_inverse(g.e_transform))
        # so are the edges: K1 and K35 sum node rows over their table
        self.table = kops.incidence_table(g.e_from, g.e_to, g.e_valid, free.shape[0])

    def residuals(self, poses):
        r, chi2 = _residuals(self.g, poses, self.config.huber_delta, self.batch)
        if self.reduce is not None:
            self.reduce(chi2)
        return r, chi2

    def rules(self, early_exit: bool) -> kops.LmRules:
        cfg = self.config
        return kops.LmRules(cfg.lambda_factor, cfg.lambda_min, cfg.lambda_max, cfg.lambda_init,
                            cfg.early_exit_tol, _refresh(cfg), early_exit)

    def linearize(self, r):
        g = self.g
        return kops.linearize(r, self.adj_meas_inv, g.e_info, self.valid, g.e_from,
                              g.e_to, self.free, self.both_free, self.is_chain,
                              self.config.huber_delta, self.col_mask, self.reduce, self.table)

    def damp(self, lam, Hb):
        d = torch.clamp(torch.diagonal(Hb, dim1=-2, dim2=-1), min=1e-6)
        return (lam[:, None, None] * d.view(self.batch, -1, 6)).view(d.shape)

    def build_pack(self, Hb, U, damp, held=None, need=None):
        """Chain factor of the damped block-tridiagonal part of H (K9, which
        builds free ? Hb + diag(damp) : I, plus the lift, as it reads Hb),
        one chain per instance; with ``held``, ``held`` rebuilt in place
        (where ``need``, if given)."""
        return tridiag.block_tridiag_factor(Hb, U, self.config.chain_dense_cutoff, self.batch,
                                            held=held, need=need, damp=damp, free=self.free,
                                            lift=self.lift)

    def step(self, poses, pack, Ji, Jj, W, grad, damp):
        """One PCG solve, then K36's candidate: (cand, r_cand, chi2_new), χ²
        summed across ranks by ``reduce``.

        The fast loop's planar solve needs no wraps: with K1's columns
        masked, H, U and the lifted factor leave the masked coordinates
        decoupled, so from a masked gradient every PCG vector keeps exact
        zeros there (``tests/test_torch_planar.py`` holds the two forms
        equal)."""
        g, cfg, free = self.g, self.config, self.free
        damp_k = damp if self.damp_here else torch.zeros_like(damp)

        def hvp(v):
            y = kops.hvp(Ji, Jj, W, g.e_from, g.e_to, v, damp_k, free)
            if self.reduce is not None:
                self.reduce(y)
            return y

        b, cm = -grad, None
        if self.generic and self.cmask is not None:
            cm = self.cmask
            hvp_base = hvp

            def hvp(v):
                return hvp_base(v * cm) * cm

            b = -(grad * cm)
        # without a reduce hook H is local: K35 takes the solve where it can
        op = (kops.HvpOperator(Ji, Jj, W, g.e_from, g.e_to, damp_k, free, self.table)
              if self.reduce is None else None)
        dx = _pcg(hvp, pack, b, cfg.pcg_iterations, cfg.pcg_tol, self.batch, cm, op)
        cand, r_cand, chi2_new = kops.lm_candidate(poses, dx, free, g.e_from, g.e_to,
                                                   g.e_transform, g.e_info, self.valid,
                                                   cfg.huber_delta, self.batch)
        if self.reduce is not None:
            self.reduce(chi2_new)
        return cand, r_cand, chi2_new


def _refresh(cfg: SolverConfig) -> int:
    return max(1, min(int(cfg.precond_refresh), cfg.iterations))


def _lm_fixed(p: _Problem, s: kops.LmState) -> None:
    """Fixed iteration count in refresh chunks: the factor is built once per
    chunk from the chunk's first iterate (``solver.py:950-1013``)."""
    cfg = p.config
    refresh, rules = _refresh(cfg), p.rules(early_exit=False)
    pack = None
    for it in range(cfg.iterations):
        lam = s.lam[:, it]
        if it % refresh == 0:   # one factor, rebuilt in place each chunk
            _, _, _, _, Hb, U = p.linearize(s.r)
            pack = p.build_pack(Hb, U, p.damp(lam, Hb), held=pack)
        Ji, Jj, W, grad, Hb, U = p.linearize(s.r)
        cand, r_cand, chi2_new = p.step(s.poses, pack, Ji, Jj, W, grad, p.damp(lam, Hb))
        kops.lm_accept(s, cand, r_cand, chi2_new, it, rules)


def _lm_early_exit(p: _Problem, s: kops.LmState) -> None:
    """g2o-parity termination (``solver.py:886-948``) as a fixed count of
    steps that turn into no-ops once ``done`` is set.

    The factor is refreshed every ``precond_refresh`` accepted steps and
    right after a rejected one, and not once ``done`` is set (the reference
    leaves its loop then).  That choice depends on device values, so the
    solve holds one private factor and K9 rebuilds it in place only where
    the device flag ``need`` (written by K36's accept) is set (on CPU
    tensors the fresh factor is selected into it with ``torch.where``): a
    factor is built exactly when the reference builds one, with no host
    synchronisation.  In a fleet each instance holds its own factor and
    flag.
    """
    cfg = p.config
    rules = p.rules(early_exit=True)
    pack = None
    for it in range(cfg.iterations):
        Ji, Jj, W, grad, Hb, U = p.linearize(s.r)
        damp = p.damp(s.lam[:, it], Hb)
        # refresh on schedule OR right after a rejected step
        pack = (p.build_pack(Hb, U, damp) if pack is None
                else p.build_pack(Hb, U, damp, held=pack, need=s.need[it]))
        cand, r_cand, chi2_new = p.step(s.poses, pack, Ji, Jj, W, grad, damp)
        kops.lm_accept(s, cand, r_cand, chi2_new, it, rules)


def _residuals(g: GraphState, poses: torch.Tensor, huber_delta: float, batch: int = 1):
    """Edge residuals of ``poses`` and each instance's robust χ² (B,)
    (kernel K4 on CUDA)."""
    return kops.residual_chi2(poses, g.e_from, g.e_to, g.e_transform, g.e_info,
                              g.e_valid.to(poses.dtype), huber_delta, batch)


def total_chi2(g: GraphState, poses: torch.Tensor, huber_delta: float) -> torch.Tensor:
    """Robust χ² () of ``poses`` on ``g``'s edges."""
    return _residuals(g, poses, huber_delta)[1][0]


def _lm(g: GraphState, free: torch.Tensor, config: SolverConfig, batch: int, reduce=None,
        damp_here: bool = True):
    """The LM loop of ``batch`` flattened instances: (poses, final λ (B,),
    χ² histories (B, iterations + 1), accept flags (B, iterations))."""
    p = _Problem(g, free, config, batch, reduce, damp_here)
    r0, chi2_0 = p.residuals(g.pose)
    s = kops.lm_state(g.pose, r0, chi2_0, config.iterations, config.lambda_init, batch)
    run = _lm_early_exit if config.early_exit and not p.generic else _lm_fixed
    run(p, s)
    return s.poses, s.lam[:, -1], s.hist, s.acc


def lm_loop(g: GraphState, free: torch.Tensor, config: SolverConfig, reduce=None,
            damp_here: bool = True):
    """The LM iteration core of one graph (the batch of one), shared by the
    single solve and the edge-sharded one (``g``'s edge table a rank's
    shard, ``reduce`` the in-place all-reduce, ``damp_here`` on one rank;
    see ``_Problem``).  Returns (poses, final_lambda, chi2_history,
    accepted)."""
    poses, lam, hist, acc = _lm(g, free, config, 1, reduce, damp_here)
    return poses, lam[0], hist[0], acc[0]


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
    if config.optimize_xy_only:
        odo_start = lie.pose2_to_pose(lie.pose_to_pose2(odo_start))
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
    recomputed, edge ages incremented.  With ``use_odometry_calibration``
    the odometry measurements are warped by the graph's ``odom_params``
    for the solve and the errors (``g2o_optimizer.cpp:209-227``); the raw
    measurements are kept.
    """
    check_supported(config)
    e_meas_raw = g.e_transform
    if config.use_odometry_calibration:
        is_odom = g.e_type == EDGE_TYPE_2D_WHEEL_ODOMETRY
        g = g.replace(e_transform=torch.where(
            is_odom[:, None], odometry_drift_correct(g.e_transform, g.odom_params),
            g.e_transform))
    if config.optimize_xy_only:
        g = g.replace(pose=flatten_planar(g.pose, g.node_valid))
    _, gauge = components_and_gauge(g)
    free = (g.node_valid & ~gauge).to(g.pose.dtype)
    solve = _restart_solve if config.odometry_restart else lm_loop
    poses, lam, chi2_hist, accepted = solve(g, free, config)

    valid = g.e_valid.to(poses.dtype)
    r, _ = _residuals(g, poses, config.huber_delta)
    g = g.replace(
        pose=poses,
        e_error=factors.edge_chi2(r, g.e_info) * valid,
        e_age=g.e_age + valid,
        e_transform=e_meas_raw,
    )
    stats = SolveStats(
        chi2_history=chi2_hist,
        accepted=accepted,
        final_lambda=lam,
        num_gauge_fixed=gauge.sum().to(torch.int32),
    )
    return g, stats


# ---------------------------------------------------------------------------
# The fleet: B independent solves at once
# ---------------------------------------------------------------------------

_NODE_FIELDS = ("pose", "odom_pose", "stamp", "uncertainty", "node_valid", "node_fixed",
                "merged_into", "node_uid")
_EDGE_FIELDS = ("e_from", "e_to", "e_transform", "e_info", "e_type", "e_valid", "e_error",
                "e_age", "e_score")


def _flatten_fleet(fleet: GraphState) -> GraphState:
    """One block-diagonal graph of a fleet's B·N nodes and B·E edges:
    instance b's nodes at b·N, its edges at b·E with endpoints offset by
    b·N, so no edge crosses instances.  The scalar fields stay (B,)."""
    B, N = fleet.pose.shape[:2]
    off = torch.arange(B, dtype=torch.int32, device=fleet.device)[:, None] * N
    flat = {k: getattr(fleet, k).flatten(0, 1) for k in _NODE_FIELDS + _EDGE_FIELDS}
    flat["e_from"] = (fleet.e_from + off).reshape(-1)
    flat["e_to"] = (fleet.e_to + off).reshape(-1)
    return fleet.replace(**flat)


def component_iterations(n_nodes: int) -> int:
    """Label-propagation rounds for graphs of ``n_nodes`` slots (the
    reference's ``connected_components`` default)."""
    return max(2 * math.ceil(math.log2(max(n_nodes, 2))), 8)


def optimize_batched(fleet: GraphState, config: SolverConfig = SolverConfig()):
    """Run LM on each graph of a fleet (every field with a leading (B,)
    dimension, equal capacities), as the reference's ``vmap`` of
    ``optimize``; returns (the updated fleet, SolveStats with a leading (B,)
    dimension: χ² histories (B, iterations + 1), accept flags (B,
    iterations), final λ (B,), gauge-fixed counts (B,)).

    Connected components and gauge fixing (K8) run once on the flattened
    fleet with the rounds of one instance (components never cross
    instances); every instance keeps its own λ, accept, χ², factor refresh
    and early exit.  ``odometry_restart`` and ``use_odometry_calibration``
    in a fleet raise ``NotImplementedError`` (ROADMAP.md A29).
    """
    check_supported(config)
    for name in ("odometry_restart", "use_odometry_calibration"):
        if getattr(config, name):
            raise NotImplementedError(f"{name}=True in a fleet")
    if fleet.pose.dim() != 3:
        raise ValueError(f"optimize_batched: poses {tuple(fleet.pose.shape)}, expected "
                         "(B, N, 7)")
    B, N = fleet.pose.shape[:2]
    E = fleet.e_from.shape[1]
    g = _flatten_fleet(fleet)
    if config.optimize_xy_only:
        g = g.replace(pose=flatten_planar(g.pose, g.node_valid))
    _, gauge = components_and_gauge(g, component_iterations(N))
    free = (g.node_valid & ~gauge).to(g.pose.dtype)
    poses, lam, chi2_hist, accepted = _lm(g, free, config, B)

    valid = g.e_valid.to(poses.dtype)
    r, _ = _residuals(g, poses, config.huber_delta, B)
    out = fleet.replace(
        pose=poses.view(B, N, 7),
        e_error=(factors.edge_chi2(r, g.e_info) * valid).view(B, E),
        e_age=fleet.e_age + valid.view(B, E),
    )
    stats = SolveStats(
        chi2_history=chi2_hist,
        accepted=accepted,
        final_lambda=lam,
        num_gauge_fixed=gauge.view(B, N).sum(1).to(torch.int32),
    )
    return out, stats
