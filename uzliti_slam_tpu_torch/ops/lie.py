"""SE(3)/SO(3) Lie-group operations on batched tensors.

PyTorch counterpart of ``uzliti_slam_tpu/ops/lie.py``, restricted to what
the pose-graph solve, the epoch, the occupancy projection, the keyframe
front-end, node merging and the calibration need.  Layouts are the same:
a pose is ``(..., 7)``
``[tx, ty, tz, qw, qx, qy, qz]`` (translation, then a unit quaternion,
scalar first) and a twist is ``(..., 6)`` ``[vx, vy, vz, wx, wy, wz]``.
Every function broadcasts over leading batch dimensions and keeps the
reference's small-angle branches and cutoffs, so the float32 results
agree with it branch for branch.  Constants are built from the inputs'
own tensors (no host-to-device copies), so the functions stay free of
host synchronisation on a CUDA device.
"""

from __future__ import annotations

import torch

# Small-angle cutoff for Taylor fallbacks. f32-safe.
_EPS = 1e-6


def _safe_norm(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Norm floored at sqrt(1e-30), as the reference's NaN-free norm."""
    return torch.sqrt(torch.clamp(torch.sum(v * v, dim=dim), min=1e-30))


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


# Small products written as broadcast sums: on a CUDA device ``@`` on
# batches of 3x3 blocks goes to cuBLAS, and the retraction runs in every LM
# iteration of the solve, which calls no library kernel.
def _mm3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _mv3(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m * v[..., None, :]).sum(-1)


# ---------------------------------------------------------------------------
# Quaternions (scalar-first [w, x, y, z])
# ---------------------------------------------------------------------------

def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    q = q / _safe_norm(q)[..., None]
    # Canonicalize sign (w >= 0) so pose comparisons are stable.
    return torch.where(q[..., 0:1] < 0, -q, q)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack(
        [a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1
    )


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qv = q[..., 1:4]
    qw = q[..., 0:1]
    # v' = v + 2*qw*(qv x v) + 2*qv x (qv x v)
    uv = _cross(qv, v)
    uuv = _cross(qv, uv)
    return v + 2.0 * (qw * uv + uuv)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4), scalar first.

    Branch-free Shepperd method: all four candidate quaternions, the one
    with the largest pivot kept (the first on a tie, as ``jnp.argmax``).
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    # Four candidates, each scaled by 4*q_pivot^2 (guaranteed >= 0 pre-max).
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)
    pivots = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    idx = torch.argmax(pivots, dim=-1)
    cand = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4 candidates, 4)
    idx = idx[..., None, None].expand(idx.shape + (1, 4))
    return quat_normalize(torch.gather(cand, -2, idx)[..., 0, :])


def quat_from_axis_angle(phi: torch.Tensor) -> torch.Tensor:
    """so(3) vector (..., 3) -> quaternion via exp."""
    theta = _safe_norm(phi)
    half = 0.5 * theta
    small = theta < _EPS
    # sin(t/2)/t with Taylor fallback 0.5 - t^2/48
    k = torch.where(
        small,
        0.5 - theta * theta / 48.0,
        torch.sin(half) / torch.where(small, torch.ones_like(theta), theta),
    )
    w = torch.cos(half)
    return quat_normalize(torch.cat([w[..., None], k[..., None] * phi], dim=-1))


def quat_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> so(3) vector (log map)."""
    q = quat_normalize(q)
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:4]
    vn = _safe_norm(v)
    theta = 2.0 * torch.atan2(vn, w)
    small = vn < _EPS
    one = torch.ones_like(w)
    scale = torch.where(
        small,
        2.0 / torch.where(torch.abs(w) < 1e-12, one, w),
        theta / torch.where(small, one, vn),
    )
    return scale[..., None] * v


def quat_slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical interpolation q0 · (q0⁻¹ q1)^t on the shorter arc (``t`` a
    number or a tensor broadcasting against the batch)."""
    q0 = quat_normalize(q0)
    q1 = quat_normalize(q1)
    dot = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(dot < 0, -q1, q1)
    phi = quat_to_axis_angle(quat_mul(quat_conj(q0), q1))
    tt = t[..., None] if torch.is_tensor(t) and t.dim() else t
    return quat_mul(q0, quat_from_axis_angle(tt * phi))


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def so3_hat(phi: torch.Tensor) -> torch.Tensor:
    x, y, z = phi.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def so3_left_jacobian(phi: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J_l of SO(3) — the V matrix of SE(3) exp."""
    theta = _safe_norm(phi)
    small = theta < _EPS
    t2 = theta * theta
    one = torch.ones_like(theta)
    b = torch.where(small, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, one, t2))
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (theta - torch.sin(theta)) / torch.where(small, one, t2 * theta))
    K = so3_hat(phi)
    return _eye3(phi) + b[..., None, None] * K + c[..., None, None] * _mm3(K, K)


def so3_left_jacobian_inv(phi: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(phi)
    small = theta < _EPS
    t2 = theta * theta
    half = 0.5 * theta
    one = torch.ones_like(theta)
    # 1/t^2 - (1+cos t)/(2 t sin t)  ==  (1 - t/2 * cot(t/2)) / t^2
    cot_term = torch.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.where(small, one, torch.sin(half)))
        / torch.where(small, one, t2),
    )
    K = so3_hat(phi)
    return _eye3(phi) - 0.5 * K + cot_term[..., None, None] * (K @ K)


# ---------------------------------------------------------------------------
# SE(3) poses as (..., 7) = [t(3), q(4 wxyz)]
# ---------------------------------------------------------------------------

def pose_identity(shape=(), device=None) -> torch.Tensor:
    p = torch.zeros(tuple(shape) + (7,), dtype=torch.float32, device=device)
    p[..., 3] = 1.0
    return p


def pose_t(p: torch.Tensor) -> torch.Tensor:
    return p[..., 0:3]


def pose_q(p: torch.Tensor) -> torch.Tensor:
    return p[..., 3:7]


def make_pose(t: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.cat([t, quat_normalize(q)], dim=-1)


def pose_apply(p: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Transform points (..., 3) by poses (..., 7)."""
    return quat_rotate(pose_q(p), pts) + pose_t(p)


def pose_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a ∘ b (apply b first in b's frame): T = Ta * Tb."""
    t = pose_t(a) + quat_rotate(pose_q(a), pose_t(b))
    q = quat_normalize(quat_mul(pose_q(a), pose_q(b)))
    return torch.cat([t, q], dim=-1)


def pose_inverse(p: torch.Tensor) -> torch.Tensor:
    qi = quat_conj(pose_q(p))
    ti = -quat_rotate(qi, pose_t(p))
    return torch.cat([ti, qi], dim=-1)


def pose_relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 ∘ b."""
    return pose_compose(pose_inverse(a), b)


# ---------------------------------------------------------------------------
# SE(3) exp / log  (twist = [v(3), w(3)])
# ---------------------------------------------------------------------------

def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) -> pose (..., 7)."""
    v, phi = xi[..., 0:3], xi[..., 3:6]
    q = quat_from_axis_angle(phi)
    t = _mv3(so3_left_jacobian(phi), v)
    return torch.cat([t, q], dim=-1)


def se3_log(p: torch.Tensor) -> torch.Tensor:
    """Pose (..., 7) -> twist (..., 6)."""
    phi = quat_to_axis_angle(pose_q(p))
    v = (so3_left_jacobian_inv(phi) @ pose_t(p)[..., None])[..., 0]
    return torch.cat([v, phi], dim=-1)


def pose_retract(p: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """Right-perturbation retraction: p ∘ exp(dx). The solver's update rule."""
    return pose_compose(p, se3_exp(dx))


# ---------------------------------------------------------------------------
# Angles, adjoint, SE(3) Jacobians
# ---------------------------------------------------------------------------

def rotation_angle(q: torch.Tensor) -> torch.Tensor:
    """Absolute rotation angle of a quaternion in radians."""
    return _safe_norm(quat_to_axis_angle(q))


def pose_distance(a: torch.Tensor, b: torch.Tensor):
    """(translation distance, rotation angle) between two poses."""
    d = pose_relative(a, b)
    return _safe_norm(pose_t(d)), rotation_angle(pose_q(d))


def pose_interpolate(a: torch.Tensor, b: torch.Tensor, t) -> torch.Tensor:
    """Geodesic interpolation a ⊕ t·log(a⁻¹b), t in [0, 1] (node merging's
    average at t = 0.5)."""
    return pose_compose(a, se3_exp(t * se3_log(pose_relative(a, b))))


def yaw_of(q: torch.Tensor) -> torch.Tensor:
    """Yaw (heading) angle extracted from a quaternion."""
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def roll_of(q: torch.Tensor) -> torch.Tensor:
    """Roll (Euler x) angle extracted from a quaternion (the GIST's roll
    compensation)."""
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))


def se3_adjoint(p: torch.Tensor) -> torch.Tensor:
    """Adjoint matrix (..., 6, 6) mapping twists between frames: Ad_T."""
    R = quat_to_matrix(pose_q(p))
    tK = so3_hat(pose_t(p))
    top = torch.cat([R, _mm3(tK, R)], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _se3_Q(rho: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Barfoot's Q(ρ,φ) block of the SE(3) left Jacobian (twist = [v, w]).

    State Estimation for Robotics eq. 7.86; the off-diagonal coupling
    between translation and rotation perturbations.
    """
    t = _safe_norm(phi)
    # Degree-2 Taylor below θ = 1e-2, as the reference: (t - sin t) etc.
    # lose ~all f32 mantissa bits there.
    small = t < 1e-2
    t2 = t * t
    t4 = t2 * t2
    one = torch.ones_like(t)
    st, ct = torch.sin(t), torch.cos(t)
    # (θ - sinθ)/θ³ ; (θ²/2 + cosθ - 1)/θ⁴ ; (θ - sinθ - θ³/6)/θ⁵
    c1 = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                     (t - st) / torch.where(small, one, t2 * t))
    c2 = torch.where(small, 1.0 / 24.0 - t2 / 720.0,
                     (t2 / 2.0 + ct - 1.0) / torch.where(small, one, t4))
    c3 = torch.where(small, -1.0 / 120.0 + t2 / 5040.0,
                     (t - st - t2 * t / 6.0) / torch.where(small, one, t4 * t))
    rx = so3_hat(rho)
    px = so3_hat(phi)
    pxrx = px @ rx
    rxpx = rx @ px
    pxrxpx = pxrx @ px
    return (
        0.5 * rx
        + c1[..., None, None] * (pxrx + rxpx + pxrxpx)
        + c2[..., None, None] * (px @ pxrx + rxpx @ px - 3.0 * pxrxpx)
        + 0.5 * (c2 + 3.0 * c3)[..., None, None] * (pxrxpx @ px + px @ pxrxpx)
    )


def se3_left_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian of SE(3) at twist xi = [v, w]: (..., 6, 6).

    Block form [[J⁻¹, -J⁻¹ Q J⁻¹], [0, J⁻¹]] with J = so3 left Jacobian.
    """
    rho, phi = xi[..., 0:3], xi[..., 3:6]
    Jinv = so3_left_jacobian_inv(phi)
    Q = _se3_Q(rho, phi)
    top = torch.cat([Jinv, -Jinv @ Q @ Jinv], dim=-1)
    bot = torch.cat([torch.zeros_like(Jinv), Jinv], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_right_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian of SE(3): Jr⁻¹(ξ) = Jl⁻¹(-ξ)."""
    return se3_left_jacobian_inv(-xi)


def pose2_to_pose(xyt: torch.Tensor) -> torch.Tensor:
    """Planar (x, y, theta) -> SE(3) pose."""
    x, y, th = xyt.unbind(-1)
    zeros = torch.zeros_like(x)
    t = torch.stack([x, y, zeros], dim=-1)
    q = torch.stack([torch.cos(th / 2), zeros, zeros, torch.sin(th / 2)], dim=-1)
    return torch.cat([t, q], dim=-1)


def pose_to_pose2(p: torch.Tensor) -> torch.Tensor:
    """SE(3) pose -> planar (x, y, theta)."""
    return torch.stack([p[..., 0], p[..., 1], yaw_of(pose_q(p))], dim=-1)
