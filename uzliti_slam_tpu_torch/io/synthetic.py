"""Synthetic trajectory / pose-graph generation for tests and benchmarks.

PyTorch counterpart of ``uzliti_slam_tpu/io/synthetic.py``: a noisy circle
sequence with odometry edges and optional loop closures, built on the CUDA
card unless the caller names another device.  The noise is drawn from a ``torch.Generator`` (which cannot
reproduce ``jax.random`` streams), or injected as standard-normal arrays so
that a test can hand both packages the same draws.
"""

from __future__ import annotations

import math

import torch

from uzliti_slam_tpu_torch import _device
from uzliti_slam_tpu_torch.graph import state as gstate
from uzliti_slam_tpu_torch.graph.state import GraphState
from uzliti_slam_tpu_torch.ops import lie


def circle_trajectory(n: int, radius: float = 10.0, loops: float = 2.0,
                      device=None) -> torch.Tensor:
    """Ground-truth poses along a circle, heading tangent. (n, 7), on
    ``device`` (default: the CUDA card)."""
    device = _device.resolve(device)
    stop = loops * 2 * math.pi
    # jnp.linspace's float32 form: start·(1-s) + stop·s, s = i/(n-1), exact stop
    s = torch.arange(n - 1, dtype=torch.float32, device=device) / float(n - 1)
    stop_t = torch.full((1,), stop, dtype=torch.float32, device=device)
    th = torch.cat([stop_t * s, stop_t])
    x = radius * torch.cos(th)
    y = radius * torch.sin(th)
    yaw = th + math.pi / 2
    return lie.pose2_to_pose(torch.stack([x, y, yaw], dim=-1))


def _round_capacity(n: int, rounding: str) -> int:
    if rounding != "pow2":
        return n
    return max(32, 1 << (n - 1).bit_length())


def _prefix_compose(m: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products m[..., 0, :] ∘ … ∘ m[..., k, :] along
    dimension -2 in log2(n) batched steps (Hillis-Steele), instead of an
    n-step sequential scan."""
    out = m
    d = 1
    while d < out.shape[-2]:
        out = torch.cat([out[..., :d, :], lie.pose_compose(out[..., :-d, :], out[..., d:, :])],
                        dim=-2)
        d *= 2
    return out


def make_pose_graph(
    n_nodes: int,
    odom_noise: float = 0.02,
    rot_noise: float = 0.005,
    loop_closure_every: int = 0,
    loop_noise: float = 0.01,
    node_capacity: int | None = None,
    edge_capacity: int | None = None,
    radius: float = 10.0,
    loops: float = 2.0,
    generator: torch.Generator | None = None,
    odom_draws: torch.Tensor | None = None,
    loop_draws: torch.Tensor | None = None,
    capacity_rounding: str = "exact",
    device=None,
) -> tuple[GraphState, torch.Tensor]:
    """Build a padded GraphState from a noisy circle sequence.

    Returns (graph, ground_truth_poses).  ``odom_draws`` ((n-1, 6): 3
    translation then 3 rotation standard normals) and ``loop_draws``
    ((L, 6)) replace the generator's draws when given.  Capacities are the
    request's (``"exact"``) or the next power of two, at least 32
    (``"pow2"``), as the JAX generator's ``capacity_rounding``.
    """
    fleet, gt = make_pose_graph_batch(
        1, n_nodes, odom_noise, rot_noise, loop_closure_every, loop_noise, node_capacity,
        edge_capacity, radius, loops, generator,
        None if odom_draws is None else odom_draws[None],
        None if loop_draws is None else loop_draws[None], capacity_rounding, device)
    return gstate.graph_of(fleet, 0), gt


def make_pose_graph_batch(
    batch: int,
    n_nodes: int,
    odom_noise: float = 0.02,
    rot_noise: float = 0.005,
    loop_closure_every: int = 0,
    loop_noise: float = 0.01,
    node_capacity: int | None = None,
    edge_capacity: int | None = None,
    radius: float = 10.0,
    loops: float = 2.0,
    generator: torch.Generator | None = None,
    odom_draws: torch.Tensor | None = None,
    loop_draws: torch.Tensor | None = None,
    capacity_rounding: str = "exact",
    device=None,
) -> tuple[GraphState, torch.Tensor]:
    """A fleet of ``batch`` distinct graphs (``make_pose_graph``'s circle,
    each with its own noise), built as batched tensors in one pass: a fleet
    of (B,)-leading fields (``state.stack_graphs``'s form) and the shared
    ground truth (n, 7).  Instance b's graph is ``make_pose_graph`` with
    ``odom_draws[b]`` and ``loop_draws[b]``; without draws they come from
    ``generator``, all odometry draws (B, n-1, 6) first, then the loop
    draws (B, L, 6)."""
    device = _device.resolve(device)
    gt = circle_trajectory(n_nodes, radius=radius, loops=loops, device=device)
    rel_gt = lie.pose_relative(gt[:-1], gt[1:])
    period = int(n_nodes / max(loops, 1.0))
    lc_pairs = (
        [(i, i + period) for i in range(0, n_nodes - period, loop_closure_every)]
        if loop_closure_every else []
    )

    def draws(given, rows):
        if given is None:
            given = torch.randn(batch, rows, 6, generator=generator)
        if tuple(given.shape) != (batch, rows, 6):
            raise ValueError(f"noise draws: shape {tuple(given.shape)}, expected "
                             f"({batch}, {rows}, 6)")
        return given.to(device=device, dtype=torch.float32)

    scale = torch.tensor([odom_noise] * 3 + [rot_noise] * 3, device=device)
    odom_meas = lie.pose_compose(rel_gt, lie.se3_exp(scale * draws(odom_draws, n_nodes - 1)))
    init_poses = torch.cat([gt[0:1].expand(batch, 1, 7),
                            lie.pose_compose(gt[0:1], _prefix_compose(odom_meas))], dim=1)

    ncap = node_capacity or _round_capacity(n_nodes, capacity_rounding)
    ecap = edge_capacity or _round_capacity(n_nodes - 1 + len(lc_pairs), capacity_rounding)
    one = gstate.empty_graph(ncap, ecap, device)
    g = gstate.GraphState(**{f: getattr(one, f).expand(batch, *getattr(one, f).shape).clone()
                             for f in gstate._FIELDS})
    n_odom = n_nodes - 1
    g.pose[:, :n_nodes] = init_poses
    g.odom_pose[:, :n_nodes] = init_poses
    g.stamp[:, :n_nodes] = 0.1 * torch.arange(n_nodes, dtype=torch.float32, device=device)
    g.node_valid[:, :n_nodes] = True
    g.node_uid[:, :n_nodes] = torch.arange(n_nodes, dtype=torch.int32, device=device)
    g.num_nodes.fill_(n_nodes)

    e_from = list(range(n_odom)) + [p[0] for p in lc_pairs]
    e_to = list(range(1, n_nodes)) + [p[1] for p in lc_pairs]
    e_T = [odom_meas]
    e_info = [gstate.odometry_information(odom_meas)]
    e_type = [gstate.EDGE_TYPE_2D_WHEEL_ODOMETRY] * n_odom
    if lc_pairs:
        lf = torch.tensor([p[0] for p in lc_pairs], device=device)
        lt = torch.tensor([p[1] for p in lc_pairs], device=device)
        lnoise = loop_noise * draws(loop_draws, len(lc_pairs))
        e_T.append(lie.pose_compose(lie.pose_relative(gt[lf], gt[lt]), lie.se3_exp(lnoise)))
        e_info.append((100.0 * torch.eye(6, device=device)).expand(batch, len(lc_pairs), 6, 6))
        e_type += [gstate.EDGE_TYPE_3D_FULL] * len(lc_pairs)

    n_e = len(e_from)
    i32 = dict(dtype=torch.int32, device=device)
    g.e_from[:, :n_e] = torch.tensor(e_from, **i32)
    g.e_to[:, :n_e] = torch.tensor(e_to, **i32)
    g.e_transform[:, :n_e] = torch.cat(e_T, dim=1)
    g.e_info[:, :n_e] = torch.cat(e_info, dim=1)
    g.e_type[:, :n_e] = torch.tensor(e_type, **i32)
    g.e_valid[:, :n_e] = True
    g.num_edges.fill_(n_e)
    return g, gt


def biased_odometry_graph(p_true, n: int = 50, closure_every: int = 5,
                          node_capacity: int | None = None, edge_capacity: int | None = None,
                          device=None) -> tuple[GraphState, torch.Tensor]:
    """A graph whose wheel-odometry edges carry a known drift bias (the
    calibration tests' ``build_biased_odometry_slam``,
    ``tests/test_calibration.py:162-214``).

    The true trajectory alternates 5 straight 0.4 m steps and 3 turns of
    0.35 rad in place (so the two drift terms are separately observable);
    each odometry measurement is the drift model's inverse of the true
    motion under ``p_true`` (3,) (8 fixed-point steps), with information
    10·I; exact 3-D loop closures every ``closure_every`` nodes, 1000·I.
    Nodes start at the integrated raw odometry.  Returns (graph, ground
    truth (n, 7)), on ``device`` (default: the CUDA card)."""
    from uzliti_slam_tpu_torch.graph.calibration import odometry_drift_correct

    device = _device.resolve(device)
    segs, x, y, th = [], 0.0, 0.0, 0.0
    while len(segs) < n:
        for _ in range(5):
            x += 0.4 * math.cos(th)
            y += 0.4 * math.sin(th)
            segs.append((x, y, th))
        for _ in range(3):
            th += 0.35
            segs.append((x, y, th))
    gt = lie.pose2_to_pose(torch.tensor(segs[:n], dtype=torch.float32, device=device))
    p = torch.as_tensor(p_true, dtype=torch.float32).to(device)
    rel = lie.pose_relative(gt[:-1], gt[1:])
    meas = rel
    for _ in range(8):   # meas such that drift_correct(meas, p) == rel
        corr = odometry_drift_correct(meas, p)
        meas = lie.pose_compose(meas, lie.pose_compose(lie.pose_inverse(corr), rel))
    odo = torch.cat([gt[0:1], lie.pose_compose(gt[0:1], _prefix_compose(meas))])

    g = gstate.empty_graph(node_capacity or n, edge_capacity or 4 * n, device)
    g.pose[:n] = odo
    g.odom_pose[:n] = odo
    g.stamp[:n] = 0.1 * torch.arange(n, dtype=torch.float32, device=device)
    g.node_valid[:n] = True
    g.node_uid[:n] = torch.arange(n, dtype=torch.int32, device=device)
    g.num_nodes.fill_(n)
    lc = torch.arange(0, n - closure_every, closure_every, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    n_lc = lc.shape[0]
    eye = torch.eye(6, device=device)
    g, _ = gstate.add_edges(
        g, torch.cat([torch.arange(n - 1, **i32), lc.to(torch.int32)]),
        torch.cat([torch.arange(1, n, **i32), (lc + closure_every).to(torch.int32)]),
        torch.cat([meas, lie.pose_relative(gt[lc], gt[lc + closure_every])]),
        torch.cat([(10.0 * eye).expand(n - 1, 6, 6), (1000.0 * eye).expand(n_lc, 6, 6)]),
        torch.cat([torch.full((n - 1,), gstate.EDGE_TYPE_2D_WHEEL_ODOMETRY, **i32),
                   torch.full((n_lc,), gstate.EDGE_TYPE_3D_FULL, **i32)]),
        torch.zeros(n - 1 + n_lc, device=device),
        torch.ones(n - 1 + n_lc, dtype=torch.bool, device=device))
    return g, gt


def ate_rmse(est: torch.Tensor, gt: torch.Tensor, align: bool = True) -> torch.Tensor:
    """Absolute trajectory error (RMSE over translations), optional SE(3)
    Umeyama alignment."""
    pe = lie.pose_t(est)
    pg = lie.pose_t(gt)
    if align:
        mu_e = pe.mean(dim=0)
        mu_g = pg.mean(dim=0)
        ce = pe - mu_e
        cg = pg - mu_g
        cov = cg.T @ ce / pe.shape[0]
        u, _, vt = torch.linalg.svd(cov)
        d = torch.sign(torch.linalg.det(u @ vt))
        D = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
        R = u @ D @ vt
        pe = (R @ ce.T).T + mu_g
        pg = cg + mu_g
    return torch.sqrt(torch.mean(torch.sum((pe - pg) ** 2, dim=-1)))
