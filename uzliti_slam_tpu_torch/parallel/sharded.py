"""The fleet solve: many independent SLAM instances in one batched solve.

PyTorch counterpart of ``uzliti_slam_tpu/parallel/sharded.py:optimize_batch``
(the reference's "N robots = N process trees" as one ``vmap`` of
``solver.optimize`` sharded over a batch mesh axis).  The port runs on one
card, so there is no mesh: the fleet is one batched solve
(``graph.solver.optimize_batched``).  The edge-sharded solve
(``optimize_sharded``) is not ported (ROADMAP.md A30).
"""

from __future__ import annotations

import dataclasses

from uzliti_slam_tpu_torch.graph import solver
from uzliti_slam_tpu_torch.graph.solver import SolverConfig
from uzliti_slam_tpu_torch.graph.state import GraphState

FLEET_CHAIN_CUTOFF = 16   # the reference's fleet default (sharded.py:139-143)


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
