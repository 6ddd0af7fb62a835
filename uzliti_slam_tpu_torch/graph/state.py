"""Struct-of-arrays pose-graph state as a dataclass of tensors.

PyTorch counterpart of ``uzliti_slam_tpu/graph/state.py``: the same field
names, shapes, dtypes and layouts (fixed-capacity padded tables plus
validity masks, int32 node slots), so a graph crosses between the two
packages field by field through numpy (``from_numpy`` / ``to_numpy``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from uzliti_slam_tpu_torch import _device
from uzliti_slam_tpu_torch.ops import lie

# Edge types — the reference wire schema (``graph_slam_msgs/msg/Edge.msg``).
EDGE_TYPE_3D_FULL = 1
EDGE_TYPE_3D_ROTATION = 2
EDGE_TYPE_3D_TRANSLATION = 3
EDGE_TYPE_3D_GPS = 4
EDGE_TYPE_2D_FULL = 5
EDGE_TYPE_2D_ROTATION = 6
EDGE_TYPE_2D_TRANSLATION = 7
EDGE_TYPE_2D_WHEEL_ODOMETRY = 104
EDGE_TYPE_2D_LASER = 105


@dataclasses.dataclass
class GraphState:
    """Fixed-capacity pose graph. All tensors padded to (N,) / (E,) capacity.

    Invalid slots carry identity poses / zero info so every kernel can run
    unmasked over full tensors and mask only at reductions.
    """

    # --- nodes (capacity N) ---
    pose: torch.Tensor          # (N, 7) float32 map-frame pose [t, q]
    odom_pose: torch.Tensor     # (N, 7) float32 odometry-frame pose
    stamp: torch.Tensor         # (N,) float32 seconds
    uncertainty: torch.Tensor   # (N,) float32 accumulated path uncertainty
    node_valid: torch.Tensor    # (N,) bool
    node_fixed: torch.Tensor    # (N,) bool — gauge/boundary anchors
    merged_into: torch.Tensor   # (N,) int32 slot remap after merges
    node_uid: torch.Tensor      # (N,) int32 globally-unique node id
    # --- edges (capacity E) ---
    e_from: torch.Tensor        # (E,) int32 node slot
    e_to: torch.Tensor          # (E,) int32 node slot
    e_transform: torch.Tensor   # (E, 7) float32 measured relative pose
    e_info: torch.Tensor        # (E, 6, 6) float32 information matrix
    e_type: torch.Tensor        # (E,) int32
    e_valid: torch.Tensor       # (E,) bool
    e_error: torch.Tensor       # (E,) float32 chi2 error after last solve
    e_age: torch.Tensor         # (E,) float32 optimization epochs
    e_score: torch.Tensor       # (E,) float32 matching score
    # --- scalars ---
    num_nodes: torch.Tensor     # () int32 high-water mark of used node slots
    num_edges: torch.Tensor     # () int32
    diff_transform: torch.Tensor  # (7,) float32 map->odom correction
    odom_params: torch.Tensor   # (3,) float32 odometry calibration

    @property
    def node_capacity(self) -> int:
        return self.pose.shape[0]

    @property
    def edge_capacity(self) -> int:
        return self.e_from.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pose.device

    def replace(self, **changes) -> "GraphState":
        return dataclasses.replace(self, **changes)

    def to(self, device) -> "GraphState":
        return GraphState(**{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


_FIELDS = tuple(f.name for f in dataclasses.fields(GraphState))


def empty_graph(node_capacity: int, edge_capacity: int, device=None) -> GraphState:
    """An empty graph on ``device`` (default: the CUDA card, see ``_device``)."""
    n, e = node_capacity, edge_capacity
    device = _device.resolve(device)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    b = dict(dtype=torch.bool, device=device)
    return GraphState(
        pose=lie.pose_identity((n,), device),
        odom_pose=lie.pose_identity((n,), device),
        stamp=torch.zeros(n, **f32),
        uncertainty=torch.zeros(n, **f32),
        node_valid=torch.zeros(n, **b),
        node_fixed=torch.zeros(n, **b),
        merged_into=torch.arange(n, **i32),
        node_uid=torch.full((n,), -1, **i32),
        e_from=torch.zeros(e, **i32),
        e_to=torch.zeros(e, **i32),
        e_transform=lie.pose_identity((e,), device),
        e_info=torch.zeros(e, 6, 6, **f32),
        e_type=torch.zeros(e, **i32),
        e_valid=torch.zeros(e, **b),
        e_error=torch.zeros(e, **f32),
        e_age=torch.zeros(e, **f32),
        e_score=torch.zeros(e, **f32),
        num_nodes=torch.zeros((), **i32),
        num_edges=torch.zeros((), **i32),
        diff_transform=lie.pose_identity((), device),
        odom_params=torch.tensor([1.0, 0.0, 0.0], **f32),
    )


def from_numpy(arrays: dict, device=None) -> GraphState:
    """Build a GraphState from a dict of numpy arrays keyed by field name
    (e.g. ``{k: np.asarray(v) for k, v in g_jax._asdict().items()}``), on
    ``device`` (default: the CUDA card)."""
    device = _device.resolve(device)
    missing = set(_FIELDS) - set(arrays)
    if missing:
        raise KeyError(f"missing GraphState fields: {sorted(missing)}")
    return GraphState(**{
        k: torch.from_numpy(np.array(arrays[k], copy=True)).to(device)
        for k in _FIELDS
    })


def to_numpy(g: GraphState) -> dict:
    """Dict of numpy arrays keyed by field name (the inverse of from_numpy)."""
    return {k: getattr(g, k).detach().cpu().numpy() for k in _FIELDS}


def set_row(arr: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor, val) -> torch.Tensor:
    """A copy of ``arr`` whose row ``idx`` holds ``val`` where ``ok`` and
    keeps its old value otherwise (the masked write of the JAX package)."""
    old = arr.index_select(0, idx.view(1))[0]
    val = (val.to(device=arr.device, dtype=arr.dtype) if torch.is_tensor(val)
           else torch.full_like(old, val))
    return arr.index_copy(0, idx.view(1), torch.where(ok, val, old)[None])


def add_node(g: GraphState, pose, odom_pose, stamp, fixed=False, uncertainty=0.0,
             uid=None) -> tuple[GraphState, torch.Tensor]:
    """Append a node at the next free slot. Returns (graph, slot).

    If capacity is exhausted the write is dropped (slot == -1), as in
    ``uzliti_slam_tpu/graph/state.py:add_node``.  Functional: ``g`` is not
    modified.
    """
    slot = g.num_nodes
    ok = slot < g.node_capacity
    idx = torch.where(ok, slot, 0).long()
    wr = lambda arr, val: set_row(arr, idx, ok, val)  # noqa: E731
    g = g.replace(
        pose=wr(g.pose, pose),
        odom_pose=wr(g.odom_pose, odom_pose),
        stamp=wr(g.stamp, stamp),
        uncertainty=wr(g.uncertainty, uncertainty),
        node_valid=wr(g.node_valid, ok),
        node_fixed=wr(g.node_fixed, fixed),
        node_uid=wr(g.node_uid, slot if uid is None else uid),
        num_nodes=g.num_nodes + ok.to(torch.int32),
    )
    return g, torch.where(ok, slot, -1)


def add_edge(g: GraphState, from_slot, to_slot, transform, info,
             etype: int = EDGE_TYPE_3D_FULL, score=0.0,
             valid=True) -> tuple[GraphState, torch.Tensor]:
    """Append an edge: ``add_edges`` on a batch of one. Returns (graph,
    slot); dropped (slot == -1) if the table is full or an endpoint is -1,
    as ``uzliti_slam_tpu/graph/state.py:add_edge``."""
    dev = g.device

    def one(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev).reshape(1)

    g, slot = add_edges(g, one(from_slot, torch.int32), one(to_slot, torch.int32),
                        transform.to(dev)[None], info.to(dev)[None], one(etype, torch.int32),
                        one(score, torch.float32), one(valid, torch.bool))
    return g, slot[0]


def add_edges(g: GraphState, from_slots: torch.Tensor, to_slots: torch.Tensor,
              transforms: torch.Tensor, infos: torch.Tensor, etypes: torch.Tensor,
              scores: torch.Tensor, valid: torch.Tensor) -> tuple[GraphState, torch.Tensor]:
    """Append B edges (B,) in order, as B appends one at a time: an edge
    with an endpoint -1, or past the table's capacity, is dropped (slot -1)
    and takes no slot.  The information matrix is masked by edge type
    (``info_for_edge_type``).  One masked write per field.  Functional:
    ``g`` is not modified."""
    E = g.edge_capacity
    want = (from_slots >= 0) & (to_slots >= 0)
    wi = want.to(torch.int32)
    pos = g.num_edges + torch.cumsum(wi, 0) - wi
    ok = want & (pos < E)
    # dropped writes land in a scratch row E, cut off afterwards
    idx = torch.where(ok, pos, E).long()

    def wr(arr, vals):
        ext = torch.cat([arr, arr[:1]])
        return ext.index_copy(0, idx, vals.to(arr.dtype))[:E]

    zeros = torch.zeros_like(scores)
    g = g.replace(
        e_from=wr(g.e_from, from_slots),
        e_to=wr(g.e_to, to_slots),
        e_transform=wr(g.e_transform, transforms),
        e_info=wr(g.e_info, info_for_edge_type(etypes, infos)),
        e_type=wr(g.e_type, etypes),
        e_valid=wr(g.e_valid, valid & ok),
        e_error=wr(g.e_error, zeros),
        e_age=wr(g.e_age, zeros),
        e_score=wr(g.e_score, scores),
        num_edges=g.num_edges + ok.sum(dtype=torch.int32),
    )
    return g, torch.where(ok, pos, -1)


def odometry_information(rel_pose: torch.Tensor) -> torch.Tensor:
    """Motion-dependent odometry information model: confidence shrinks with
    distance travelled and angle turned; rotation stiffer than translation
    (reference ``graph_slam_node.cpp:316-336``)."""
    dist = torch.linalg.vector_norm(lie.pose_t(rel_pose), dim=-1)
    ang = lie.rotation_angle(lie.pose_q(rel_pose))
    trans_sigma = 0.02 + 0.1 * dist + 0.05 * ang
    rot_sigma = 0.01 + 0.05 * dist + 0.1 * ang
    batch = rel_pose.shape[:-1]
    w = torch.cat(
        [
            (1.0 / trans_sigma**2)[..., None].expand(batch + (3,)),
            (1.0 / rot_sigma**2)[..., None].expand(batch + (3,)),
        ],
        dim=-1,
    )
    return w[..., :, None] * torch.eye(6, dtype=w.dtype, device=w.device)


@functools.lru_cache(maxsize=None)
def _type_masks(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The per-type information masks, made once per device: a host table
    copied to the card synchronises, which the keyframe step must not."""
    return torch.tensor(
        [
            [1, 1, 1, 1, 1, 1],   # default (3D_FULL, wheel odometry, ...)
            [1, 1, 1, 0, 0, 0],   # 3D translation / GPS
            [0, 0, 0, 1, 1, 1],   # 3D rotation
            [1, 1, 0, 0, 0, 1],   # 2D full / laser: x, y, yaw
            [0, 0, 0, 0, 0, 1],   # 2D rotation
            [1, 1, 0, 0, 0, 0],   # 2D translation
        ],
        dtype=dtype, device=device,
    )


def info_for_edge_type(etype: torch.Tensor, base_info: torch.Tensor) -> torch.Tensor:
    """Mask an information matrix by edge type (partial-constraint types
    keep only their blocks; ``g2o_optimizer.cpp:164-188``).

    TYPE_2D_WHEEL_ODOMETRY keeps the FULL 6x6, as in the reference.
    """
    dev, dt = base_info.device, base_info.dtype
    masks = _type_masks(dev, dt)
    et = torch.as_tensor(etype, device=dev)
    sel = torch.zeros_like(et, dtype=torch.long)
    # first matching case wins, as jnp.select: apply in reverse order
    cases = [
        (et == EDGE_TYPE_3D_TRANSLATION) | (et == EDGE_TYPE_3D_GPS),
        et == EDGE_TYPE_3D_ROTATION,
        (et == EDGE_TYPE_2D_FULL) | (et == EDGE_TYPE_2D_LASER),
        et == EDGE_TYPE_2D_ROTATION,
        et == EDGE_TYPE_2D_TRANSLATION,
    ]
    for i in reversed(range(len(cases))):
        sel = torch.where(cases[i], i + 1, sel)
    mask = masks[sel]
    return base_info * mask[..., :, None] * mask[..., None, :]
