"""Port parity: the chain preconditioner's cyclic reduction.

A random SPD block-tridiagonal system (seeded numpy) is factored and
applied by the port with ``dense_cutoff=16`` at n = 48 and at n = 200
(not a power of two, so the pad and the roll-and-zero shifts are taken),
and solved by ``uzliti_slam_tpu.graph.tridiag.block_tridiag_solve`` and by
a dense float64 solve.  Tolerance: relative error 1e-4 of the solution's
scale — float32 elimination on a system of condition ~1e2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import tridiag as jtridiag
from uzliti_slam_tpu_torch.graph import tridiag as ttridiag
from uzliti_slam_tpu_torch.kernels import ops as kops


def _system(n: int, seed: int):
    rng = np.random.default_rng(seed)
    U = 0.3 * rng.normal(size=(n, 6, 6)).astype(np.float32)
    U[-1] = 0.0
    A = rng.normal(size=(n, 6, 6)).astype(np.float32)
    D = (A @ A.transpose(0, 2, 1) + 8.0 * np.eye(6, dtype=np.float32)).astype(np.float32)
    b = rng.normal(size=(n, 6)).astype(np.float32)
    return D, U, b


def _dense(D, U):
    n = D.shape[0]
    M = np.zeros((n * 6, n * 6))
    for i in range(n):
        M[6 * i:6 * i + 6, 6 * i:6 * i + 6] = D[i]
        if i + 1 < n:
            M[6 * i:6 * i + 6, 6 * i + 6:6 * i + 12] = U[i]
            M[6 * i + 6:6 * i + 12, 6 * i:6 * i + 6] = U[i].T
    return M


@pytest.mark.parametrize("n", [48, 200])
def test_factor_and_apply_match_jax_and_dense(n):
    D, U, b = _system(n, seed=n)
    x_dense = np.linalg.solve(_dense(D, U), b.reshape(-1).astype(np.float64)).reshape(n, 6)
    x_jax = np.asarray(jtridiag.block_tridiag_solve(*map(jnp.asarray, (D, U, b))))
    factor = ttridiag.block_tridiag_factor(torch.from_numpy(D), torch.from_numpy(U),
                                           dense_cutoff=16)
    assert len(factor[0]) == (2 if n == 48 else 4)   # 64 -> 16 and 256 -> 16 blocks
    x = kops.chain_apply_plain(factor, torch.from_numpy(b)).numpy()
    scale = np.abs(x_dense).max()
    np.testing.assert_allclose(x, x_dense, atol=1e-4 * scale)
    np.testing.assert_allclose(x, x_jax, atol=1e-4 * scale)


def test_inv6_and_root_inverse_match_jax():
    D, U, _ = _system(16, seed=1)
    np.testing.assert_allclose(
        ttridiag._inv6(torch.from_numpy(D)).numpy(),
        np.asarray(jtridiag._inv6(jnp.asarray(D))), rtol=1e-4, atol=1e-6)
    root_t = ttridiag._dense_root_inverse(torch.from_numpy(D), torch.from_numpy(U)).numpy()
    root_j = np.asarray(jtridiag._dense_root_inverse(jnp.asarray(D), jnp.asarray(U)))
    np.testing.assert_allclose(root_t, root_j, atol=1e-5 * np.abs(root_j).max())


def test_solve_without_reduction_levels():
    # n ≤ dense_cutoff: the dense root covers the padded system alone
    D, U, b = _system(12, seed=2)
    x = ttridiag.block_tridiag_solve(*map(torch.from_numpy, (D, U, b))).numpy()
    x_dense = np.linalg.solve(_dense(D, U), b.reshape(-1).astype(np.float64)).reshape(12, 6)
    np.testing.assert_allclose(x, x_dense, atol=1e-4 * np.abs(x_dense).max())
