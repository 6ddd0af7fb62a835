"""Struct-of-arrays pose-graph state as a dataclass of tensors.

PyTorch counterpart of ``uzliti_slam_tpu/graph/state.py``: the same field
names, shapes, dtypes and layouts (fixed-capacity padded tables plus
validity masks, int32 node slots), so a graph crosses between the two
packages field by field through numpy (``from_numpy`` / ``to_numpy``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

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
    n, e = node_capacity, edge_capacity
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
    (e.g. ``{k: np.asarray(v) for k, v in g_jax._asdict().items()}``)."""
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


def info_for_edge_type(etype: torch.Tensor, base_info: torch.Tensor) -> torch.Tensor:
    """Mask an information matrix by edge type (partial-constraint types
    keep only their blocks; ``g2o_optimizer.cpp:164-188``).

    TYPE_2D_WHEEL_ODOMETRY keeps the FULL 6x6, as in the reference.
    """
    dev, dt = base_info.device, base_info.dtype
    masks = torch.tensor(
        [
            [1, 1, 1, 1, 1, 1],   # default (3D_FULL, wheel odometry, ...)
            [1, 1, 1, 0, 0, 0],   # 3D translation / GPS
            [0, 0, 0, 1, 1, 1],   # 3D rotation
            [1, 1, 0, 0, 0, 1],   # 2D full / laser: x, y, yaw
            [0, 0, 0, 0, 0, 1],   # 2D rotation
            [1, 1, 0, 0, 0, 0],   # 2D translation
        ],
        dtype=dt, device=dev,
    )
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
