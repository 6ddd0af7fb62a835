"""Port parity: uzliti_slam_tpu_torch.graph.factors against the JAX factors.

Edge batches come from a seeded numpy generator: poses and measurements
whose residual rotations span the small-angle branches.  Tolerances:
residuals and the residual-form Jacobians ``atol=1e-5`` (float32 rounding
of unit-scale quantities); against the jacfwd Jacobians ``atol=1e-4``
(the analytic and forward-mode forms round differently).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import factors as jfactors
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu_torch.graph import factors as tfactors
from uzliti_slam_tpu_torch.ops import lie as tlie

ATOL = 1e-5


def _edges(seed: int, n: int = 48):
    """(pose_i, pose_j, meas) with meas ≈ pose_i⁻¹·pose_j, residual angles
    from 0 to ~0.5 rad."""
    rng = np.random.default_rng(seed)
    xi_i = rng.normal(size=(n, 6)).astype(np.float32)
    xi_j = rng.normal(size=(n, 6)).astype(np.float32)
    pi = jlie.se3_exp(jnp.asarray(xi_i))
    pj = jlie.se3_exp(jnp.asarray(xi_j))
    scale = np.logspace(-8, -0.3, n, dtype=np.float32)[:, None]
    noise = (rng.normal(size=(n, 6)) * scale).astype(np.float32)
    meas = jlie.pose_compose(jlie.pose_relative(pi, pj), jlie.se3_exp(jnp.asarray(noise)))
    return tuple(np.array(a) for a in (pi, pj, meas))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def test_edge_residual_matches():
    pi, pj, m = _edges(0)
    j = np.asarray(jfactors.batched_residuals(*map(jnp.asarray, (pi, pj, m))))
    t = tfactors.batched_residuals(*_t(pi, pj, m)).numpy()
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_pose_form_jacobians_match():
    pi, pj, m = _edges(1)
    j = jfactors.batched_residual_jacobians(*map(jnp.asarray, (pi, pj, m)))
    t = tfactors.edge_residual_jacobians(*_t(pi, pj, m))
    for a, b in zip(j, t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=ATOL)


@pytest.mark.parametrize("reference", ["jax_residual_form", "jax_jacfwd"])
def test_jacobians_from_residual(reference):
    pi, pj, m = _edges(2)
    adj = np.array(jlie.se3_adjoint(jlie.pose_inverse(jnp.asarray(m))))
    r = np.array(jfactors.batched_residuals(*map(jnp.asarray, (pi, pj, m))))
    Ji, Jj = tfactors.jacobians_from_residual(*_t(r, adj))
    if reference == "jax_residual_form":
        ref = jfactors.jacobians_from_residual(jnp.asarray(r), jnp.asarray(adj))
        atol = ATOL
    else:
        ref = jfactors.batched_residual_jacobians_ad(*map(jnp.asarray, (pi, pj, m)))[1:]
        atol = 1e-4
    np.testing.assert_allclose(Ji.numpy(), np.asarray(ref[0]), atol=atol)
    np.testing.assert_allclose(Jj.numpy(), np.asarray(ref[1]), atol=atol)


def test_huber_weight_and_edge_chi2_match():
    rng = np.random.default_rng(3)
    r = rng.normal(size=(64, 6)).astype(np.float32) * np.logspace(-4, 1, 64, dtype=np.float32)[:, None]
    A = rng.normal(size=(64, 6, 6)).astype(np.float32)
    info = (A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)).astype(np.float32)
    chi2_j = np.array(jfactors.edge_chi2(jnp.asarray(r), jnp.asarray(info)))
    chi2_t = tfactors.edge_chi2(*_t(r, info)).numpy()
    np.testing.assert_allclose(chi2_t, chi2_j, rtol=1e-5)
    for delta in (0.5, 1.0, 3.0):
        wj = np.asarray(jfactors.huber_weight(jnp.asarray(chi2_j), delta))
        wt = tfactors.huber_weight(torch.from_numpy(chi2_j), delta).numpy()
        np.testing.assert_allclose(wt, wj, rtol=1e-6)
