"""K9's damped entry (``kernels/ops.chain_factor`` with ``damp``/``free``/
``lift``) against the JAX package on the CPU.

The plain version builds free ? Hb + diag(damp) : I (+ the planar lift) and
factors it; JAX's twin is the solver's ``build_pack`` (``solver.py:861-873``)
around ``tridiag.block_tridiag_factor``.  Both in float64 (JAX under
``jax.enable_x64``), on the Hessian blocks of a perturbed 500- and
1024-node graph, a fleet of three and the planar lift: every level tensor
and the root within 1e-9 of its largest entry.  The kernel's root — the
cyclic reduction continued inside the root and expanded back
(``csrc/chain_factor.cu``) — is replayed here in float64 and held against
``torch.linalg.inv`` of ``root_matrix_plain``; the refresh flags rebuild
exactly the flagged chains and count them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import tridiag as jtridiag
from uzliti_slam_tpu_torch.graph import solver as tsolver
from uzliti_slam_tpu_torch.io import synthetic as tsynthetic
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie as tlie

RTOL = 1e-9


def _system(n, batch=1, planar=False, cutoff=64, seed=2):
    """(Hb, U, damp, free, lift) of the first linearization of a perturbed
    graph (a flattened fleet when batch > 1), λ = 1e-3."""
    gen = torch.Generator().manual_seed(seed)
    if batch == 1:
        g, _ = tsynthetic.make_pose_graph(n, loop_closure_every=10, generator=gen, device="cpu")
    else:
        fleet, _ = tsynthetic.make_pose_graph_batch(batch, n, loop_closure_every=8,
                                                   generator=gen, device="cpu")
        g = tsolver._flatten_fleet(fleet)
    rng = np.random.default_rng(seed)
    dx = torch.from_numpy(0.05 * rng.normal(size=(g.node_capacity, 6)).astype(np.float32))
    g = g.replace(pose=tlie.pose_retract(g.pose, dx))
    labels = tsolver.connected_components(g, tsolver.component_iterations(g.node_capacity // batch))
    free = (g.node_valid & ~tsolver.gauge_fix_mask(g, labels)).float()
    cfg = tsolver.SolverConfig(chain_dense_cutoff=cutoff, optimize_xy_only=planar)
    p = tsolver._Problem(g, free, cfg, batch=batch)
    r, _ = p.residuals(g.pose)
    *_, Hb, U = p.linearize(r)
    damp = p.damp(torch.full((batch,), 1e-3), Hb)
    return Hb, U, damp, free, p.lift


def _jax_factor(Hb, U, damp, free, lift, cutoff):
    """JAX's build_pack + block_tridiag_factor of one chain, float64."""
    Hb, U, damp, free = (jnp.asarray(t.double().numpy()) for t in (Hb, U, damp, free))
    Dm = jnp.where(free[:, None, None] > 0, Hb + jax.vmap(jnp.diag)(damp),
                   jnp.eye(6, dtype=jnp.float64))
    if lift is not None:
        Dm = Dm + jnp.diag(jnp.asarray(lift.double().numpy()))
    levels, root, _ = jtridiag.block_tridiag_factor(Dm, U, dense_cutoff=cutoff)
    return [np.asarray(t) for lv in levels for t in lv], np.asarray(root)


def _close(a, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(a), ref, rtol=0, atol=RTOL * np.abs(ref).max())


@pytest.mark.parametrize("n, planar", [(500, False), (1024, False), (500, True)],
                         ids=["500", "1024", "500_planar_lift"])
def test_damped_factor_matches_jax_build_pack_in_float64(n, planar):
    Hb, U, damp, free, lift = _system(n, planar=planar)
    assert (lift is not None) == planar
    got = kops.chain_factor_plain(Hb.double(), U.double(), 64, damp=damp.double(),
                                  free=free.double(),
                                  lift=None if lift is None else lift.double())
    with jax.enable_x64(True):
        levels_j, root_j = _jax_factor(Hb, U, damp, free, lift, 64)
    flat = [t[0] for lv in got[0] for t in lv]
    assert len(flat) == len(levels_j) and len(got[0]) == (4 if n == 1024 else 3)
    for a, b in zip(flat, levels_j):
        _close(a.numpy(), b)
    _close(got[1][0].numpy(), root_j)
    # the float32 wrapper on CPU tensors: the same factor, stored in float32
    wrapped = kops.chain_factor(Hb, U, 64, damp=damp, free=free, lift=lift)
    ref32 = kops.chain_factor_plain(kops.damped_blocks_plain(Hb, damp, free, lift), U, 64)
    for a, b in zip([t for lv in wrapped[0] for t in lv] + [wrapped[1]],
                    [t for lv in ref32[0] for t in lv] + [ref32[1]]):
        assert torch.equal(a, b)


def test_damped_factor_of_a_fleet_is_each_chain_alone():
    B, n, cutoff = 3, 64, 16
    Hb, U, damp, free, _ = _system(n, batch=B, cutoff=cutoff)
    got = kops.chain_factor_plain(Hb.double(), U.double(), cutoff, B, damp=damp.double(),
                                  free=free.double())
    for b in range(B):
        rows = slice(b * n, (b + 1) * n)
        with jax.enable_x64(True):
            levels_j, root_j = _jax_factor(Hb[rows], U[rows], damp[rows], free[rows], None,
                                           cutoff)
        for a, ref in zip([t[b] for lv in got[0] for t in lv], levels_j):
            _close(a.numpy(), ref)
        _close(got[1][b].numpy(), root_j)


def _root_by_reduction(Dk, Uk):
    """The kernel's root in float64: 1e-8·I added once, exact cyclic
    reduction to one block (no floor) with the lower blocks L = Uᵀ carried
    apart from the upper ones, its 6x6 inverse, then each level's inverse
    rebuilt from the next one's (csrc/chain_factor.cu)."""
    eye = torch.eye(6, dtype=Dk.dtype)

    def inv6(M):   # _inv6 adds its own 1e-8·I floor: take it back out
        return kops._inv6(M - 1e-8 * eye)

    def prev(X):   # X[j-1], zero at j = 0
        return torch.cat([torch.zeros_like(X[:1]), X[:-1]])

    def nxt(X, dim=0):   # X[j+1] along dim, zero at the end
        pad = torch.zeros_like(X.narrow(dim, 0, 1))
        return torch.cat([X.narrow(dim, 1, X.shape[dim] - 1), pad], dim=dim)

    D, U = Dk + 1e-8 * eye, Uk.clone()
    U[-1] = 0.0
    L = U.transpose(-1, -2)
    saved = []
    while D.shape[0] > 1:
        Di = inv6(D[1::2])
        Ueo, Uoe, Leo, Loe = U[0::2], U[1::2], L[0::2], L[1::2]
        A1, A2, B1, B2 = Di @ Leo, Di @ Uoe, Ueo @ Di, Loe @ Di
        newD = D[0::2] - B1 @ Leo - prev(Loe) @ prev(Di) @ prev(Uoe)
        newU, newL = -(B1 @ Uoe), -(Loe @ A1)
        newU[-1], newL[-1] = 0.0, 0.0
        saved.append((Di, A1, A2, B1, B2))
        D, U, L = newD, newU, newL
    Y = inv6(D).view(1, 1, 6, 6)                  # one block
    for Di, A1, A2, B1, B2 in reversed(saved):
        k = Di.shape[0]
        XOE = -(A1[:, None] @ Y + A2[:, None] @ nxt(Y))              # (k, k, 6, 6)
        XEO = -(Y @ B1[None] + nxt(Y, 1) @ B2[None])
        XOO = (torch.eye(k, dtype=Y.dtype)[..., None, None] * Di[:, None]
               - XOE @ B1[None] - nxt(XOE, 1) @ B2[None])
        X = torch.zeros(2 * k, 2 * k, 6, 6, dtype=Y.dtype)
        X[0::2, 0::2], X[1::2, 0::2], X[0::2, 1::2], X[1::2, 1::2] = Y, XOE, XEO, XOO
        Y = X
    m = Y.shape[0]
    return Y.permute(0, 2, 1, 3).reshape(6 * m, 6 * m)


@pytest.mark.parametrize("n, cutoff", [(1024, 64), (64, 16), (40, 64), (1, 64)],
                         ids=["root64", "root16", "padded_root64", "one_block"])
def test_the_kernels_root_by_reduction_is_the_float64_inverse(n, cutoff):
    """The replayed root inverts A = tridiag(Uᵀ, D, U) + 1e-8·I as well as
    LU does: ‖A·X - I‖ within 10x LU's (+1e-12), and X within cond(A)·1e-14
    of LU's inverse (the two methods round differently; the damped root's
    condition number reaches ~1e6)."""
    Hb, U, damp, free, _ = _system(max(n, 64), cutoff=cutoff)
    Dm = kops.damped_blocks_plain(Hb, damp, free).double()[:n]
    _, Dk, Uk = kops.chain_reduce_plain(Dm, U.double()[:n], cutoff)
    A = (kops.root_matrix_plain(Dk, Uk) if Dk.shape[0] > 1
         else Dk[0] + 1e-8 * torch.eye(6, dtype=Dk.dtype))
    ref = torch.linalg.inv(A)
    got = _root_by_reduction(Dk, Uk)
    assert got.shape == ref.shape
    eye = torch.eye(A.shape[0], dtype=A.dtype)
    res_got = float((A @ got - eye).abs().max())
    res_ref = float((A @ ref - eye).abs().max())
    assert res_got <= 10 * res_ref + 1e-12, (res_got, res_ref)
    cond = float(torch.linalg.cond(A))
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-14 * cond * float(ref.abs().max()))


def test_refresh_flags_rebuild_the_flagged_chains_and_count_them():
    B, n, cutoff = 3, 64, 16
    Hb, U, damp, free, _ = _system(n, batch=B, cutoff=cutoff)
    fresh = kops.chain_factor(Hb, U, cutoff, B, damp=damp, free=free)
    held = kops.chain_factor(Hb, U, cutoff, B, damp=2.0 * damp, free=free)
    stale = [t.clone() for lv in held[0] for t in lv] + [held[1].clone()]
    builds = kops.factor_builds("cpu")
    before = int(builds)
    need = torch.tensor([True, False, True])
    out = kops.chain_factor(Hb, U, cutoff, B, held=held, need=need, damp=damp, free=free)
    assert out is held and int(builds) - before == 2
    for a, old, new in zip([t for lv in held[0] for t in lv] + [held[1]], stale,
                           [t for lv in fresh[0] for t in lv] + [fresh[1]]):
        assert torch.equal(a[0], new[0]) and torch.equal(a[2], new[2])
        assert torch.equal(a[1], old[1]) and not torch.equal(a[1], new[1])
    with pytest.raises(ValueError, match="damp and free go together"):
        kops.chain_factor(Hb, U, cutoff, B, damp=damp)
