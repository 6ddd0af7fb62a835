"""Port parity: the chain preconditioner's cyclic reduction (K9's plain
version on CPU tensors, through its wrapper).

A random SPD block-tridiagonal system (seeded numpy) is factored and
applied by the port with ``dense_cutoff=16`` at n = 48 and at n = 200
(not a power of two, so the pad and the roll-and-zero shifts are taken),
and by ``uzliti_slam_tpu.graph.tridiag`` and a dense float64 solve.
Tolerances: each level tensor within 1e-5 of its largest entry of JAX's
(the same float32 operations, multiplied in another order); the solution
within 1e-4 of its scale — float32 elimination on a system of condition
~1e2.

The port computes the factor in float64 and stores it in float32, where
the reference computes in float32.  A deep chain (n = 4096, eight
levels) of a damped odometry-chain Laplacian shows what that buys: the
apply on the port's factor is at least as close to an exact float64
banded solve as JAX's float32 factor, and the port's plain version run
in float32 is as far off as JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
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
    levels_j, root_j, _ = jtridiag.block_tridiag_factor(jnp.asarray(D), jnp.asarray(U),
                                                        dense_cutoff=16)
    factor = kops.chain_factor(torch.from_numpy(D), torch.from_numpy(U), dense_cutoff=16)
    assert len(factor[0]) == (2 if n == 48 else 4)   # 64 -> 16 and 256 -> 16 blocks
    assert kops._factor_shapes(n, 16) == ([a[0].shape[1] for a in factor[0]], 16)
    for lv_t, lv_j in zip(factor[0], levels_j):
        for a, ref in zip(lv_t, lv_j):
            ref = np.asarray(ref)
            np.testing.assert_allclose(a[0].numpy(), ref, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(factor[1][0].numpy(), np.asarray(root_j),
                               atol=1e-5 * np.abs(np.asarray(root_j)).max())
    x = kops.chain_apply_plain(factor, torch.from_numpy(b)).numpy()
    scale = np.abs(x_dense).max()
    np.testing.assert_allclose(x, x_dense, atol=1e-4 * scale)
    np.testing.assert_allclose(x, x_jax, atol=1e-4 * scale)


def _chain_laplacian(n: int, lam: float, seed: int):
    """An odometry chain's H: node 0 fixed (identity, decoupled), edge i
    between nodes i and i+1 of SPD information K[i], damped by
    lam·diag(D) as the LM solve damps it."""
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(n, 6, 6))
    K = B @ B.transpose(0, 2, 1) / 6 + 0.05 * np.eye(6)
    D = np.zeros((n, 6, 6))
    D[:-1] += K[:-1]
    D[1:] += K[:-1]
    D += lam * np.einsum("nii->ni", D)[:, :, None] * np.eye(6)
    U = -K
    U[-1] = 0.0
    D[0], U[0] = np.eye(6), 0.0
    b = rng.normal(size=(n, 6))
    return D.astype(np.float32), U.astype(np.float32), b.astype(np.float32)


def _banded_solve(D, U, b):
    """The exact solve in float64: the block-tridiagonal system as an SPD
    band of half-width 11 (scipy's solveh_banded, upper form)."""
    n = D.shape[0]
    ab = np.zeros((12, 6 * n))
    blocks = 6 * np.arange(n)
    for a in range(6):
        for c in range(6):
            if a <= c:          # diagonal blocks, upper triangle
                ab[11 + a - c, blocks + c] = D[:, a, c]
            ab[5 + a - c, blocks[:-1] + 6 + c] = U[:-1, a, c]
    x = scipy.linalg.solveh_banded(ab, b.reshape(-1).astype(np.float64))
    return x.reshape(n, 6)


@pytest.mark.parametrize("lam", [1e-2, 1e-4])
def test_deep_chain_float64_factor_is_at_least_as_close_as_jax(lam):
    D, U, b = _chain_laplacian(4096, lam, seed=0)
    x_exact = _banded_solve(D, U, b)
    x_jax = np.asarray(jtridiag.block_tridiag_apply(
        jtridiag.block_tridiag_factor(jnp.asarray(D), jnp.asarray(U), dense_cutoff=16),
        jnp.asarray(b)))
    Dt, Ut, bt = map(torch.from_numpy, (D, U, b))
    factor = kops.chain_factor(Dt, Ut, dense_cutoff=16)
    assert len(factor[0]) == 8                  # 4096 -> 16 blocks
    x_port = kops.chain_apply(factor, bt).numpy()
    x_f32 = kops.chain_apply(kops.chain_factor_plain(Dt, Ut, 16, work_dtype=torch.float32),
                             bt).numpy()
    scale = np.abs(x_exact).max()
    err_port, err_jax, err_f32 = (np.abs(x - x_exact).max() / scale
                                  for x in (x_port, x_jax, x_f32))
    assert err_port <= err_jax
    assert err_port <= err_f32
    # the two float32 factors differ by float32 rounding alone
    assert err_f32 <= 2.0 * err_jax and err_jax <= 2.0 * err_f32
    np.testing.assert_allclose(x_port, x_jax, atol=2.0 * err_jax * scale)


def test_inv6_and_root_inverse_match_jax():
    D, U, _ = _system(16, seed=1)
    np.testing.assert_allclose(
        kops._inv6(torch.from_numpy(D)).numpy(),
        np.asarray(jtridiag._inv6(jnp.asarray(D))), rtol=1e-4, atol=1e-6)
    root_t = kops._dense_root_inverse(torch.from_numpy(D), torch.from_numpy(U)).numpy()
    root_j = np.asarray(jtridiag._dense_root_inverse(jnp.asarray(D), jnp.asarray(U)))
    np.testing.assert_allclose(root_t, root_j, atol=1e-5 * np.abs(root_j).max())


def test_solve_without_reduction_levels():
    # n ≤ dense_cutoff: the dense root covers the padded system alone
    D, U, b = _system(12, seed=2)
    x = ttridiag.block_tridiag_solve(*map(torch.from_numpy, (D, U, b))).numpy()
    x_dense = np.linalg.solve(_dense(D, U), b.reshape(-1).astype(np.float64)).reshape(12, 6)
    np.testing.assert_allclose(x, x_dense, atol=1e-4 * np.abs(x_dense).max())


def test_held_factor_is_rebuilt_only_where_the_flag_is_set():
    # the early-exit solve's form: a held factor, a (B,) bool refresh flag
    D, U, _ = _system(48, seed=3)
    D2, U2, _ = _system(48, seed=4)
    Dt, Ut, D2t, U2t = map(torch.from_numpy, (D, U, D2, U2))
    builds = kops.factor_builds("cpu")
    before = int(builds)
    held = kops.chain_factor(Dt, Ut, dense_cutoff=16)
    snapshot = [t.clone() for lv in held[0] for t in lv] + [held[1].clone()]
    out = kops.chain_factor(D2t, U2t, 16, held=held, need=torch.tensor([False]))
    assert out is held
    for a, b in zip([t for lv in held[0] for t in lv] + [held[1]], snapshot):
        assert torch.equal(a, b)
    kops.chain_factor(D2t, U2t, 16, held=held, need=torch.tensor([True]))
    fresh = kops.chain_factor_plain(D2t, U2t, 16)
    for a, b in zip([t for lv in held[0] for t in lv] + [held[1]],
                    [t for lv in fresh[0] for t in lv] + [fresh[1]]):
        assert torch.equal(a, b)
    assert int(builds) - before == 2    # the unconditional build and the flagged one


def test_root_matrix_is_the_dense_block_tridiagonal_system():
    D, U, _ = _system(5, seed=5)
    A = kops.root_matrix_plain(torch.from_numpy(D), torch.from_numpy(U)).numpy()
    U_used = U.copy()
    U_used[-1] = 0.0
    np.testing.assert_allclose(A, _dense(D, U_used) + 1e-8 * np.eye(30), rtol=0, atol=1e-6)
