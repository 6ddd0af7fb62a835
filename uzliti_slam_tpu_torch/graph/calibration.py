"""Sensor-extrinsic and odometry-drift calibration on a frozen graph.

The port's counterpart of ``uzliti_slam_tpu/graph/calibration.py`` (the
reference's offline ``SensorTransformOptimizer``,
``sensor_transform_optimizer.cpp:37-192``, run live): the node poses are
held fixed; the variables are the S sensor extrinsics (a retraction δL of
their initial values, with a prior to them) and the odometry drift
parameters p = [translation scale, yaw drift per rad, yaw drift per m].

- Sensor edges: r = log(T_e⁻¹ · (X_i L_sf)⁻¹ (X_j L_st)).
- Odometry edges: the measurement warped by p,
  drift = p₁·|yaw| + p₂·‖t‖, t' = p₀·Rz(drift)·t, yaw' = yaw + drift;
  r = log((X_i⁻¹ X_j)⁻¹ · warp(T_e, p)).

``calibrate`` runs dense Gauss-Newton over the 6S + 3 parameters: kernel
K20 on a CUDA device (every step, no host read), the forward-mode
``torch.func.jacfwd`` form of the reference on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from uzliti_slam_tpu_torch.graph import state as gstate
from uzliti_slam_tpu_torch.graph.state import GraphState
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie


class CalibrationResult(NamedTuple):
    sensor_transforms: torch.Tensor  # (S, 7) calibrated extrinsics
    odom_params: torch.Tensor        # (3,) [trans_scale, yaw_per_rad, yaw_per_m]
    final_cost: torch.Tensor         # ()
    cost_history: torch.Tensor       # (iterations + 1,)


def odometry_drift_correct(meas: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """Apply the drift model ``params`` (3,) to odometry measurement poses
    (..., 7)."""
    t = lie.pose_t(meas)
    yaw = lie.yaw_of(lie.pose_q(meas))
    drift = params[1] * torch.abs(yaw) + params[2] * torch.linalg.vector_norm(t, dim=-1)
    c, s = torch.cos(drift), torch.sin(drift)
    t_new = params[0] * torch.stack(
        [c * t[..., 0] - s * t[..., 1], s * t[..., 0] + c * t[..., 1], t[..., 2]], dim=-1)
    zero = torch.zeros_like(drift)
    dq = torch.stack([torch.cos(drift / 2), zero, zero, torch.sin(drift / 2)], dim=-1)
    q_new = lie.quat_normalize(lie.quat_mul(dq, lie.pose_q(meas)))
    return torch.cat([t_new, q_new], dim=-1)


def calibrate(g: GraphState, initial_sensor_transforms: torch.Tensor,
              e_sensor_from: torch.Tensor, e_sensor_to: torch.Tensor, iterations: int = 20,
              prior_weight: float = 1e2, damping: float = 1e-6) -> CalibrationResult:
    """Solve for the sensor extrinsics and the odometry drift parameters on
    a frozen graph.  ``initial_sensor_transforms`` (S, 7); ``e_sensor_from``
    and ``e_sensor_to`` (E,) int32 sensor indices per edge, -1 = the base
    frame (a 3-D edge is a sensor factor where ``e_sensor_from`` >= 0)."""
    dev = g.device
    is_odom = (g.e_type == gstate.EDGE_TYPE_2D_WHEEL_ODOMETRY) & g.e_valid
    is_sensor = (g.e_type == gstate.EDGE_TYPE_3D_FULL) & g.e_valid & (e_sensor_from >= 0)
    L0 = initial_sensor_transforms.to(device=dev, dtype=torch.float32).contiguous()
    S = L0.shape[0]
    theta, hist = kops.calib_gn(
        g.pose[g.e_from.long()].contiguous(), g.pose[g.e_to.long()].contiguous(),
        g.e_transform.contiguous(), is_sensor.contiguous(), is_odom.contiguous(),
        torch.clamp(e_sensor_from, min=0).to(torch.int32).contiguous(),
        torch.clamp(e_sensor_to, min=0).to(torch.int32).contiguous(), L0, iterations,
        prior_weight, damping)
    L = lie.pose_retract(L0, theta[:6 * S].reshape(S, 6))
    return CalibrationResult(sensor_transforms=L, odom_params=theta[6 * S:],
                             final_cost=hist[-1], cost_history=hist)
