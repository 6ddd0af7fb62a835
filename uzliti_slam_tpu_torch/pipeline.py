"""The optimization epoch: loop-closure filter, solve, uncertainty.

PyTorch counterpart of ``uzliti_slam_tpu/pipeline.py:optimize_epoch``, the
call a live robot makes at every optimization timer tick.  ``SlamState``
holds the fields the epoch reads: the graph and, where the JAX package
keeps a ``prng`` key, a ``torch.Generator`` on the graph's device (the
RANSAC draws).  The rest of the JAX ``SlamState`` (descriptors, scans,
recognition banks, keyframe bookkeeping) belongs to slices not ported yet.

On a CUDA device the epoch runs kernels K5 (graph distances), K6
(clusters), K7 (RANSAC), K8 (components and gauge) and the solve's K1-K4,
and reads one device value on the host: ``solver._host_decision``, whether
the odometry restart runs its second solve.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from uzliti_slam_tpu_torch import _device
from uzliti_slam_tpu_torch.config import SlamConfig
from uzliti_slam_tpu_torch.graph import filter as gfilter
from uzliti_slam_tpu_torch.graph import shortest_path, solver
from uzliti_slam_tpu_torch.graph import state as gstate
from uzliti_slam_tpu_torch.ops import lie

MAX_CANDIDATES = 256


@dataclasses.dataclass
class SlamState:
    graph: gstate.GraphState
    generator: torch.Generator   # RANSAC draws, on the graph's device

    def replace(self, **changes) -> "SlamState":
        return dataclasses.replace(self, **changes)


def init_state(config: SlamConfig = SlamConfig(), seed: int = 0, device=None) -> SlamState:
    """An empty graph of the configured capacities and a generator seeded
    with ``seed``, on ``device`` (default: the CUDA card)."""
    device = _device.resolve(device)
    return SlamState(
        graph=gstate.empty_graph(config.node_capacity, config.edge_capacity, device),
        generator=torch.Generator(device=device).manual_seed(seed),
    )


def state_from_numpy(arrays: dict, seed: int = 0, device=None) -> SlamState:
    """A SlamState from numpy arrays: ``arrays["graph"]`` holds the graph's
    fields as ``graph.state.from_numpy`` takes them (e.g. from a JAX
    ``SlamState``); other entries belong to slices not ported yet and are
    ignored.  A JAX ``prng`` key cannot cross: the generator is seeded with
    ``seed``."""
    device = _device.resolve(device)
    graph = {k: np.asarray(v) for k, v in arrays["graph"].items()}
    return SlamState(graph=gstate.from_numpy(graph, device),
                     generator=torch.Generator(device=device).manual_seed(seed))


def epoch_candidates(g: gstate.GraphState, config: SlamConfig = SlamConfig()):
    """The epoch's loop-closure candidates and their heuristic gate.

    Candidates are the most recent ``min(256, edge_capacity)`` edges that
    are neither wheel odometry nor GPS priors, lie below ``num_edges`` and
    have live endpoints, regardless of their current validity.  Returns
    (idx (B,) int32, -1 padded; cand_mask (B,) bool: present and plausible).
    """
    E = g.edge_capacity
    ef, et = g.e_from.long(), g.e_to.long()
    slot_idx = torch.arange(E, device=g.device)
    is_lc = (
        (g.e_type != gstate.EDGE_TYPE_2D_WHEEL_ODOMETRY)
        & (g.e_type != gstate.EDGE_TYPE_3D_GPS)
        & (slot_idx < g.num_edges)
        & g.node_valid[ef] & g.node_valid[et]
    )
    idx = gfilter.recent_candidates(is_lc, min(MAX_CANDIDATES, E))
    cand_valid = idx >= 0
    safe = torch.where(cand_valid, idx, 0).long()
    heur = gfilter.edge_heuristic(g, g.e_from[safe], g.e_to[safe],
                                  config.scope.scope_size_factor) & cand_valid
    return idx, heur


def epoch_ransac_members(state: SlamState, config: SlamConfig = SlamConfig()) -> torch.Tensor:
    """(n_roots, B) member masks of the cluster roots the epoch's filter runs
    RANSAC on, so that a caller can draw or inject each root's triplets."""
    idx, heur = epoch_candidates(state.graph, config)
    return gfilter.cluster_roots(state.graph, idx, config.filter, cand_mask=heur).member


def optimize_epoch(state: SlamState, config: SlamConfig = SlamConfig(),
                   tri: torch.Tensor | None = None) -> tuple[SlamState, solver.SolveStats]:
    """Filter loop closures, solve, update uncertainty and the map→odom
    correction.  ``tri`` (n_roots, ransac_hypotheses, 3) injects the RANSAC
    triplets; without it they are drawn from ``state.generator``.
    Functional: ``state.graph`` is not modified (the generator advances)."""
    g = state.graph
    idx, heur = epoch_candidates(g, config)
    keep = gfilter.filter_loop_closures(g, idx, state.generator, config.filter,
                                        cand_mask=heur, tri=tri)
    g = g.replace(e_valid=gfilter.write_validity(g.e_valid, idx, keep))

    g, stats = solver.optimize(g, config.solver)
    g = shortest_path.reevaluate_uncertainty(g)

    # map->odom diff from the newest valid node (graph_slam_node.cpp:188-202)
    newest = torch.argmax(torch.where(g.node_valid, g.stamp, -math.inf)).view(1)
    diff = lie.pose_compose(g.pose.index_select(0, newest)[0],
                            lie.pose_inverse(g.odom_pose.index_select(0, newest)[0]))
    return state.replace(graph=g.replace(diff_transform=diff)), stats
