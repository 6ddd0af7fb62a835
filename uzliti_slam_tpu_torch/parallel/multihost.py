"""Multi-process (multi-card, multi-host) execution helpers.

PyTorch counterpart of ``uzliti_slam_tpu/parallel/multihost.py``.  The
reference forms one global device mesh with ``jax.distributed``; here one
process drives one card, and the processes join a ``torch.distributed``
world: NCCL between cards (NVLink within a host, the network across
hosts), gloo for CPU tensors.  Mesh recipe, as the reference's: axes
``("batch", "edge")``, independent SLAM instances over ``batch`` (no
cross-instance traffic: put it across hosts) and each solve's edge table
over ``edge`` (an all-reduce per PCG step: keep it inside a host).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from uzliti_slam_tpu_torch.graph.solver import SolverConfig
from uzliti_slam_tpu_torch.graph.state import _FIELDS, GraphState
from uzliti_slam_tpu_torch.parallel import sharded


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None) -> None:
    """Join the multi-process world.

    With no arguments this is a no-op (single-process runs, tests).
    Otherwise it calls ``init_process_group`` with
    ``init_method=f"tcp://{coordinator}"`` (``host:port`` of rank 0), the
    world size and this process's rank, on NCCL unless ``backend`` names
    another (``"gloo"`` for CPU tensors)."""
    given = (coordinator, num_processes, process_id)
    if all(a is None for a in given):
        return
    if any(a is None for a in given):
        raise ValueError("initialize: give coordinator, num_processes and process_id together")
    dist.init_process_group(backend=backend or "nccl", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def pod_mesh(batch_axis: int | None = None, edge_axis: int | None = None) -> DeviceMesh:
    """Global ("batch", "edge") mesh over the world's ranks, host-major.

    Ranks are host-major when each host runs ``LOCAL_WORLD_SIZE``
    consecutive ranks, as ``torchrun`` numbers them.  Default split:
    ``batch`` = number of hosts (world / ``LOCAL_WORLD_SIZE``; one host
    when it is unset), ``edge`` = ranks per host, so the edge-sharded
    solve's collectives stay inside a host.  Overriding one axis derives
    the other from the world size.  Every rank must call it (it makes the
    mesh's sub-groups)."""
    if not dist.is_initialized():
        raise RuntimeError("pod_mesh: no torch.distributed process group (initialize first)")
    world = dist.get_world_size()
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    hosts = max(world // max(per_host, 1), 1)
    if batch_axis is not None and edge_axis is None:
        b, e = batch_axis, world // batch_axis
    elif edge_axis is not None and batch_axis is None:
        b, e = world // edge_axis, edge_axis
    else:
        b = batch_axis if batch_axis is not None else hosts
        e = edge_axis if edge_axis is not None else world // hosts
    if b * e != world:
        raise ValueError(f"mesh {b}x{e} != {world} devices")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(world).reshape(b, e),
                      mesh_dim_names=("batch", "edge"))


def solve_fleet(graphs: GraphState, mesh: DeviceMesh | None = None,
                config: SolverConfig = SolverConfig()) -> GraphState:
    """Optimize a fleet of independent SLAM instances (a leading (B,)
    dimension) across the world: each rank solves its contiguous B/world
    slice with ``sharded.optimize_batch``, in the order of its place in
    ``mesh`` flattened (both axes; ``pod_mesh()`` if None), and every rank
    gets the whole solved fleet back through an all-gather, the stand-in
    for the reference's global array.  Every rank passes the same fleet."""
    mesh = mesh if mesh is not None else pod_mesh()
    order = mesh.mesh.flatten().tolist()
    world = dist.get_world_size()
    if sorted(order) != list(range(world)):
        raise ValueError(f"solve_fleet: the mesh holds ranks {order}, not the world's {world}")
    B = graphs.pose.shape[0]
    if B % world:
        raise ValueError(f"solve_fleet: {B} instances not divisible by {world} ranks")
    size = B // world
    start = order.index(dist.get_rank()) * size
    part = graphs.replace(**{k: getattr(graphs, k)[start:start + size] for k in _FIELDS})
    out = sharded.optimize_batch(part, config)
    solved = {}
    for name in ("pose", "e_error", "e_age"):
        local = getattr(out, name).contiguous()
        parts = [torch.empty_like(local) for _ in range(world)]
        dist.all_gather(parts, local)
        solved[name] = torch.cat([parts[r] for r in order])
    return graphs.replace(**solved)
