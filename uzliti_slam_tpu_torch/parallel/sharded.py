"""The fleet solve and the edge-sharded solve.

PyTorch counterpart of ``uzliti_slam_tpu/parallel/sharded.py``:

- **Instance batching** (``optimize_batch``): many independent SLAM
  instances (the reference's "N robots = N process trees") in one batched
  solve on one card (``graph.solver.optimize_batched``); across cards,
  ``multihost.solve_fleet`` gives each rank a slice of the fleet.
- **Edge sharding** (``optimize_sharded``): the factor table is split into
  contiguous blocks over the ranks of a ``torch.distributed`` group, the
  poses stay replicated, and each rank runs the generic LM loop on its
  block with an in-place ``all_reduce`` summing the partial node rows and
  χ² (``solver.lm_loop``'s ``reduce`` hook).  The reference's psums over
  ICI become NCCL collectives between cards (gloo for CPU tensors); the
  arithmetic on each shard stays in the kernels K1, K2 and K4, and K3,
  K8, K9 and K10 run replicated on every rank.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from uzliti_slam_tpu_torch.graph import factors, solver
from uzliti_slam_tpu_torch.graph.solver import _EDGE_FIELDS, SolverConfig
from uzliti_slam_tpu_torch.graph.state import GraphState

FLEET_CHAIN_CUTOFF = 16   # the reference's fleet default (sharded.py:139-143)

# all_reduce calls made by edge-sharded solves (``collectives_per_solve``
# gives one solve's); ``reset_collectives`` sets it to 0
collectives = {"all_reduce": 0}


def reset_collectives() -> None:
    collectives["all_reduce"] = 0


def fleet_config(config: SolverConfig = SolverConfig()) -> SolverConfig:
    """The configuration a fleet is solved with: the reference's override
    where the caller left the chain cutoff at its default — 2
    cyclic-reduction levels and a 16-block root at 64 nodes.  Of that
    override, the Newton-Schulz root (``chain_root_ns``) and the one-hot
    gathers (``dense_gathers``) are TPU layouts the port does not take: its
    root is the exact float64 inverse of kernel K9, and its gathers are the
    kernels' own."""
    if config.chain_dense_cutoff == SolverConfig().chain_dense_cutoff:
        config = dataclasses.replace(config, chain_dense_cutoff=FLEET_CHAIN_CUTOFF)
    return config


def optimize_batch(graphs: GraphState, config: SolverConfig = SolverConfig()) -> GraphState:
    """Optimize a fleet of independent graphs (a leading (B,) dimension on
    every field, equal capacities; ``state.stack_graphs``), each as
    ``solver.optimize`` would, with ``fleet_config(config)``.  Returns the
    updated fleet, as the reference's ``optimize_batch``; the tensors'
    device is the fleet's (the card, unless the caller built it on the
    CPU)."""
    return solver.optimize_batched(graphs, fleet_config(config))[0]


def pad_edges_to_multiple(g: GraphState, multiple: int) -> GraphState:
    """Pad the edge table with invalid zero slots so that it splits evenly
    over ``multiple`` ranks (``sharded.py:51-65``)."""
    e = g.edge_capacity
    pad = -(-e // multiple) * multiple - e
    if pad == 0:
        return g

    def padded(a):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

    return g.replace(**{f: padded(getattr(g, f)) for f in _EDGE_FIELDS})


def shard_edges(g: GraphState, rank: int, world: int) -> GraphState:
    """Rank ``rank``'s contiguous block of E/world edge slots, every edge
    field cut alike and the node fields whole: the reference's
    ``graph_partition_specs`` (``P(axis)`` on the edge fields), so the
    partial sums group as its psums do."""
    e = g.edge_capacity
    if e % world:
        raise ValueError(f"edge capacity {e} not divisible by {world} ranks; "
                         "call pad_edges_to_multiple first")
    size = e // world
    return g.replace(**{f: getattr(g, f)[rank * size:(rank + 1) * size] for f in _EDGE_FIELDS})


def collectives_per_solve(config: SolverConfig) -> int:
    """The all-reduces of one edge-sharded solve: χ²₀, the factor's
    linearization once per refresh chunk, and per LM iteration its
    linearization, one Hv product per PCG step and the candidate's χ²."""
    refresh = max(1, min(int(config.precond_refresh), config.iterations))
    chunks = -(-config.iterations // refresh)
    return 1 + chunks + config.iterations * (1 + config.pcg_iterations + 1)


class _AllReduce:
    """The ``reduce`` hook: an in-place sum over the group, counted."""

    def __init__(self, group):
        self.group = group

    def __call__(self, t: torch.Tensor) -> None:
        dist.all_reduce(t, group=self.group)
        collectives["all_reduce"] += 1


def optimize_sharded(g: GraphState, group=None,
                     config: SolverConfig = SolverConfig()) -> tuple[GraphState, torch.Tensor]:
    """LM solve with the edge table split over the ranks of ``group`` (the
    default group if None; a ``DeviceMesh``'s ``get_group("edge")`` for a
    pod mesh).  Every rank of the group calls it with the same whole graph
    and gets the same result: (updated graph, χ² history).

    As the reference's: connected components and gauge fixing (K8) run on
    the whole graph on every rank, the generic LM loop on the rank's shard
    (a fixed iteration count whatever ``early_exit`` says), the write-back
    of ``e_error`` and ``e_age`` on the whole table; no planar flattening,
    no odometry calibration and no restart.  The edge capacity must divide
    the group's size (``pad_edges_to_multiple``).  A world of one is the
    caller's to make (``multihost.initialize``, or
    ``init_process_group`` with a ``HashStore``)."""
    if not dist.is_initialized():
        raise RuntimeError("optimize_sharded: no torch.distributed process group; "
                           "initialise one first (multihost.initialize)")
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if g.edge_capacity % world:
        raise ValueError(f"edge capacity {g.edge_capacity} not divisible by {world} ranks; "
                         "call pad_edges_to_multiple first")
    solver.check_supported(config)
    _, gauge = solver.components_and_gauge(g)
    free = (g.node_valid & ~gauge).to(g.pose.dtype)
    poses, _, chi2_hist, _ = solver.lm_loop(shard_edges(g, rank, world), free, config,
                                            reduce=_AllReduce(group), damp_here=rank == 0)
    valid = g.e_valid.to(poses.dtype)
    r, _ = solver._residuals(g, poses, config.huber_delta)
    g = g.replace(pose=poses, e_error=factors.edge_chi2(r, g.e_info) * valid,
                  e_age=g.e_age + valid)
    return g, chi2_hist
