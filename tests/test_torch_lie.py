"""Port parity: uzliti_slam_tpu_torch.ops.lie against uzliti_slam_tpu.ops.lie.

Random float32 batches from a seeded numpy generator go through both
packages on the CPU.  Each batch mixes rotation angles below the 1e-6
Taylor cutoff, between 1e-6 and the 1e-2 switch of ``_se3_Q``, ordinary
angles and angles near π, so every small-angle branch is taken.
Tolerance: ``atol=1e-5`` — float32 rounding of unit-scale quantities,
with the two frameworks' sin/cos/atan2 differing in the last bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu_torch.ops import lie as tlie

ATOL = 1e-5
THETAS = np.array([0.0, 3e-7, 8e-7, 2e-6, 5e-4, 3e-3, 9e-3, 1.1e-2, 0.3, 1.2,
                   2.5, np.pi - 1e-3, np.pi - 1e-5], dtype=np.float32)


def _twists(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(THETAS.size, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    phi = axes * THETAS[:, None]
    v = rng.normal(size=(THETAS.size, 3))
    return np.concatenate([v, phi], axis=1).astype(np.float32)


def _poses(seed: int) -> np.ndarray:
    return np.array(jlie.se3_exp(jnp.asarray(_twists(seed))))


def _both(fn_name, *arrays):
    j = np.asarray(getattr(jlie, fn_name)(*map(jnp.asarray, arrays)))
    t = getattr(tlie, fn_name)(*map(torch.from_numpy, arrays)).numpy()
    return j, t


@pytest.mark.parametrize("fn_name", ["se3_exp", "se3_right_jacobian_inv",
                                     "se3_left_jacobian_inv"])
def test_twist_functions_match(fn_name):
    xi = _twists(0)
    j, t = _both(fn_name, xi)
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("fn_name", ["se3_log", "se3_adjoint", "pose_inverse"])
def test_pose_functions_match(fn_name):
    # se3_log near θ = π: both packages take the same w ≥ 0 branch, so the
    # rotation vector keeps its sign
    j, t = _both(fn_name, _poses(1))
    np.testing.assert_allclose(t, j, atol=ATOL)


@pytest.mark.parametrize("fn_name", ["pose_compose", "pose_relative", "pose_retract"])
def test_binary_functions_match(fn_name):
    a = _poses(2)
    b = _twists(3) if fn_name == "pose_retract" else _poses(3)
    j, t = _both(fn_name, a, b)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_so3_jacobians_and_axis_angle_match():
    phi = _twists(4)[:, 3:]
    for name in ("so3_left_jacobian", "so3_left_jacobian_inv", "quat_from_axis_angle",
                 "so3_hat"):
        j, t = _both(name, phi)
        np.testing.assert_allclose(t, j, atol=ATOL, err_msg=name)
    q = np.array(jlie.quat_from_axis_angle(jnp.asarray(phi)))
    for name in ("quat_to_axis_angle", "rotation_angle", "quat_to_matrix"):
        j, t = _both(name, q)
        np.testing.assert_allclose(t, j, atol=ATOL, err_msg=name)


def test_se3_Q_small_angle_branches_match():
    xi = _twists(5)
    j, t = _both("_se3_Q", xi[:, :3], xi[:, 3:])
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_pose2_to_pose_matches():
    rng = np.random.default_rng(6)
    xyt = rng.uniform(-4.0, 4.0, size=(16, 3)).astype(np.float32)
    j, t = _both("pose2_to_pose", xyt)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_exp_log_round_trip():
    xi = _twists(7)[:-2]   # away from θ = π, where log's branch cut sits
    back = tlie.se3_log(tlie.se3_exp(torch.from_numpy(xi))).numpy()
    np.testing.assert_allclose(back, xi, atol=1e-4)
