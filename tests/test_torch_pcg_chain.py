"""K34 and K37 (``kernels.ops.pcg_chain_start`` / ``pcg_chain_step``): a
single solve's PCG step with the chain preconditioner inside it, within
K34's cap (K34) and above it (K37, ``pcg_grid_start``).

The CUDA kernel runs only on the card (``chip_smoke.py`` phase 3 holds it
against its plain version there).  Here, on the CPU:
- the port's ``solver._pcg`` with the factor against JAX's ``solver._pcg``
  with ``tridiag.block_tridiag_apply`` on the same linearized system of a
  200-node graph (cutoff 16: four levels and a 16-block root), plain and in
  the generic loop's planar form: x within 1e-4 of max|x| (the two sum their
  dots in another order, and the port's factor is computed in float64 where
  JAX's is float32);
- the fused plain step against the old plain composition (K10's init,
  alpha and beta around K3's plain apply), bit for bit;
- the same plain start and step above K34's cap (K37's plain version:
  5,000 nodes at cutoff 1, 13 levels and a one-block root), plain and with
  the planar mask, against JAX's ``_pcg`` with ``block_tridiag_apply`` on
  its own factor, 1e-4 of max|x|;
- the route, with a recording library on meta tensors: within K34's cap one
  start and one launch a step, and none of K3's or K10's entries; above the
  cap (9, 11 and 13 levels, with the planar mask, and with K2 and a reduce
  hook before each step) K37's start and one K37 launch a step; in a
  fleet, K3's and K10's;
- the argument checks and a failed launch of K34 and of K37.

K37's CUDA kernel runs only on the card too, where ``chip_smoke.py`` phase
3 holds it against this plain version at 20k and 100k nodes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import solver as jsolver
from uzliti_slam_tpu.graph import state as jstate
from uzliti_slam_tpu.graph import tridiag as jtridiag
from uzliti_slam_tpu_torch.graph import solver as tsolver
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import synthetic as tsyn
from uzliti_slam_tpu_torch.kernels import _build
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie as tlie

CFG = dict(iterations=20, pcg_iterations=12, chain_dense_cutoff=16, early_exit=False)
XY = (1.0, 1.0, 0.0, 0.0, 0.0, 1.0)


@pytest.fixture(scope="module")
def system():
    """The first LM iteration's system at perturbed poses (so that Huber
    weights below 1 appear), on the port's side: (graph, free, Ji, Jj, W,
    damp, b, Dm, U, factor)."""
    g, _ = tsyn.make_pose_graph(200, loop_closure_every=10,
                                generator=torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(12)
    dx = torch.from_numpy(0.05 * rng.normal(size=(g.node_capacity, 6)).astype(np.float32))
    g = g.replace(pose=tlie.pose_retract(g.pose, dx))
    free = (g.node_valid & ~tsolver.gauge_fix_mask(g, tsolver.connected_components(g))).float()
    p = tsolver._Problem(g, free, tsolver.SolverConfig(**CFG))
    r0, _ = p.residuals(g.pose)
    Ji, Jj, W, grad, Hb, U = p.linearize(r0)
    damp = p.damp(torch.full((1,), 1e-4), Hb)
    factor = p.build_pack(Hb, U, damp)
    Dm = torch.where(free[:, None, None] > 0, Hb + torch.diag_embed(damp), p.eye6)
    assert len(factor[0]) == 4 and factor[1].shape[-1] == 96
    assert (W < g.e_info - 1e-3).any(), "no Huber-weighted edge"
    return g, free, Ji, Jj, W, damp, -grad, Dm, U, factor


def _port_hvp(system, mask):
    g, free, Ji, Jj, W, damp = system[:6]

    def hvp(v):
        if mask is None:
            return kops.hvp(Ji, Jj, W, g.e_from, g.e_to, v, damp, free)
        return kops.hvp(Ji, Jj, W, g.e_from, g.e_to, v * mask, damp, free) * mask
    return hvp


@pytest.mark.parametrize("planar", [False, True], ids=["plain", "planar_mask"])
def test_pcg_with_the_factor_matches_jax(system, planar):
    g, free, Ji, Jj, W, damp, b, Dm, U, factor = system
    mask = torch.tensor(XY) if planar else None
    b_t = b if mask is None else b * mask
    x_t = tsolver._pcg(_port_hvp(system, mask), factor, b_t, 12, 1e-8, cmask=mask).numpy()

    jg = jstate.GraphState(**{k: jnp.asarray(v) for k, v in tstate.to_numpy(g).items()})
    j = [jnp.asarray(t.numpy()) for t in (Ji, Jj, W, damp, free, Dm, U, b_t)]
    hvp_j = jsolver._make_hvp(jg, *j[:5])
    fac_j = jtridiag.block_tridiag_factor(j[5], j[6], CFG["chain_dense_cutoff"])

    def apply_j(r):
        return jtridiag.block_tridiag_apply(fac_j, r)

    if planar:
        cm = jnp.asarray(XY)
        hvp_base, apply_base = hvp_j, apply_j
        hvp_j = lambda v: hvp_base(v * cm) * cm          # noqa: E731 (solver.py:1156-1159)
        apply_j = lambda r: apply_base(r * cm) * cm      # noqa: E731
    x_j = np.asarray(jax.jit(lambda bb: jsolver._pcg(hvp_j, apply_j, bb, 12, 1e-8))(j[7]))
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-4 * np.abs(x_j).max())
    if planar:
        assert not x_t[:, 2:5].any()


@pytest.fixture(scope="module")
def large_system():
    """A single solve above K34's cap, K37's route: 5,000 nodes at cutoff 1
    (13 levels and a one-block root), the first LM iteration's system at
    perturbed poses, with JAX's factor of the same damped blocks: (graph,
    free, Ji, Jj, W, damp, b, factor, JAX's factor)."""
    cfg = dict(CFG, chain_dense_cutoff=1)
    g, _ = tsyn.make_pose_graph(5000, loop_closure_every=10,
                                generator=torch.Generator().manual_seed(3), device="cpu")
    rng = np.random.default_rng(12)
    dx = torch.from_numpy(0.05 * rng.normal(size=(g.node_capacity, 6)).astype(np.float32))
    g = g.replace(pose=tlie.pose_retract(g.pose, dx))
    free = (g.node_valid & ~tsolver.gauge_fix_mask(g, tsolver.connected_components(g))).float()
    p = tsolver._Problem(g, free, tsolver.SolverConfig(**cfg))
    r0, _ = p.residuals(g.pose)
    Ji, Jj, W, grad, Hb, U = p.linearize(r0)
    damp = p.damp(torch.full((1,), 1e-4), Hb)
    factor = p.build_pack(Hb, U, damp)
    Dm = torch.where(free[:, None, None] > 0, Hb + torch.diag_embed(damp), p.eye6)
    assert len(factor[0]) == 13 and factor[1].shape[-1] == 6
    assert not kops.pcg_chain_route(factor)
    fac_j = jtridiag.block_tridiag_factor(jnp.asarray(Dm.numpy()), jnp.asarray(U.numpy()), 1)
    return g, free, Ji, Jj, W, damp, -grad, factor, fac_j


@pytest.mark.parametrize("planar", [False, True], ids=["plain", "planar_mask"])
def test_above_the_cap_the_plain_start_and_step_match_jax(large_system, planar):
    # K37's plain version is K34's: its start and 12 steps (what
    # pcg_chain_start / pcg_chain_step run on CPU tensors) against JAX's
    # _pcg with block_tridiag_apply, 1e-4 of max|x| as above
    g, free, Ji, Jj, W, damp, b, factor, fac_j = large_system
    mask = torch.tensor(XY) if planar else None
    b_t = b if mask is None else b * mask
    hvp = _port_hvp(large_system, mask)
    st = kops.pcg_chain_start(factor, b_t, 1, mask)
    for _ in range(12):
        kops.pcg_chain_step(factor, hvp(st.p), st, 1e-8, mask)
    assert st.fused is None
    x_t = st.x.numpy()

    jg = jstate.GraphState(**{k: jnp.asarray(v) for k, v in tstate.to_numpy(g).items()})
    hvp_j = jsolver._make_hvp(jg, *(jnp.asarray(t.numpy()) for t in (Ji, Jj, W, damp, free)))

    def apply_j(r):
        return jtridiag.block_tridiag_apply(fac_j, r)

    if planar:
        cm = jnp.asarray(XY)
        hvp_base, apply_base = hvp_j, apply_j
        hvp_j = lambda v: hvp_base(v * cm) * cm          # noqa: E731 (solver.py:1156-1159)
        apply_j = lambda r: apply_base(r * cm) * cm      # noqa: E731
    x_j = np.asarray(jax.jit(lambda bb: jsolver._pcg(hvp_j, apply_j, bb, 12, 1e-8))(
        jnp.asarray(b_t.numpy())))
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-4 * np.abs(x_j).max())
    if planar:
        assert not x_t[:, 2:5].any()


@pytest.mark.parametrize("planar", [False, True], ids=["plain", "planar_mask"])
def test_fused_plain_step_is_the_old_composition_bit_for_bit(system, planar):
    factor, b = system[9], system[6]
    mask = torch.tensor(XY) if planar else None
    hvp = _port_hvp(system, mask)
    b = b if mask is None else b * mask

    def minv(r):
        if mask is None:
            return kops.chain_apply_plain(factor, r)
        return kops.chain_apply_plain(factor, r * mask) * mask

    kops.reset_launches()
    st = kops.pcg_chain_start(factor, b, 1, mask)        # CPU tensors: the plain version
    x, r, p, scal = kops.pcg_init_plain(b, minv(b))
    oks = []
    for _ in range(12):
        kops.pcg_chain_step(factor, hvp(st.p), st, 1e-8, mask)
        kops.pcg_alpha_plain(p, hvp(p), x, r, scal, 1e-8)
        kops.pcg_beta_plain(r, minv(r), p, scal)
        oks.append(bool(st.scal[0, 2]))
    for got, ref in zip(st[:4], (x, r, p, scal)):
        assert torch.equal(got, ref)
    assert oks[0] and st.fused is None
    assert torch.equal(tsolver._pcg(hvp, factor, b, 12, 1e-8, cmask=mask), x)
    assert kops.launches == {k: 0 for k in kops.launches}


class _FakeLib:
    """Records the C calls a wrapper makes; every call returns ``err``."""

    def __init__(self):
        self.calls, self.err = [], 0

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.err
        return call


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(kops, "_stream", lambda dev: 0)
    kops.reset_launches()
    return lib


def _meta_factor(lib, n, cutoff=64, batch=1):
    factor = kops.chain_factor(_meta(batch * n, 6, 6), _meta(batch * n, 6, 6), cutoff, batch)
    lib.calls.clear()
    kops.reset_launches()
    return factor


@pytest.mark.parametrize("planar", [False, True], ids=["plain", "planar_mask"])
def test_within_the_cap_a_solve_launches_one_start_and_one_step_each(fake_lib, planar):
    factor = _meta_factor(fake_lib, 1000)
    mask = _meta(6) if planar else None
    tsolver._pcg(torch.empty_like, factor, _meta(1000, 6), 12, 1e-8, cmask=mask)
    names = [c[0] for c in fake_lib.calls]
    assert names == ["uz_pcg_chain_start"] + ["uz_pcg_chain_step"] * 12
    # (levels, root blocks, rows) after the table; the step's after Hp and tol
    assert fake_lib.calls[0][1][1:4] == (4, 64, 1000)
    assert all(c[1][1] == pytest.approx(1e-8) and c[1][3:6] == (4, 64, 1000)
               for c in fake_lib.calls[1:])
    assert kops.launches["pcg_chain"] == 13
    assert kops.launches["chain_apply"] == kops.launches["pcg"] == 0


def test_in_a_fleet_a_solve_takes_k3_and_k10(fake_lib):
    n, cutoff, batch, levels = 64, 16, 4, 2
    factor = _meta_factor(fake_lib, n, cutoff, batch)
    assert not kops.pcg_chain_route(factor, batch)
    tsolver._pcg(torch.empty_like, factor, _meta(batch * n, 6), 12, 1e-8, batch)
    names = [c[0] for c in fake_lib.calls]
    apply = ["uz_chain_forward"] * levels + ["uz_chain_root"] + ["uz_chain_backward"] * levels
    step = ["uz_pcg_alpha"] + apply + ["uz_pcg_beta"]
    assert names == apply + ["uz_pcg_init"] + step * 12
    assert kops.launches["chain_apply"] == 13 and kops.launches["pcg"] == 1 + 2 * 12
    assert kops.launches["pcg_chain"] == kops.launches["pcg_grid"] == 0


@pytest.mark.parametrize("n, cutoff, levels, m_root, planar",
                         [(20_000, 64, 9, 64, False), (5000, 1, 13, 1, False),
                          (100_000, 64, 11, 64, False), (20_000, 64, 9, 64, True)],
                         ids=["above_the_cap", "one_block_root", "100k", "planar_mask"])
def test_above_the_cap_a_solve_takes_k37(fake_lib, n, cutoff, levels, m_root, planar):
    factor = _meta_factor(fake_lib, n, cutoff)
    assert not kops.pcg_chain_route(factor)
    mask = _meta(6) if planar else None
    tsolver._pcg(torch.empty_like, factor, _meta(n, 6), 12, 1e-8, cmask=mask)
    names = [c[0] for c in fake_lib.calls]
    assert names == ["uz_pcg_grid_start"] + ["uz_pcg_grid_step"] * 12
    # (levels, root blocks, rows, cmask) after the table; the step's after
    # Hp and tol; the scratch's floats and the partials' slots
    start, steps = fake_lib.calls[0][1], [c[1] for c in fake_lib.calls[1:]]
    assert start[1:4] == (levels, m_root, n) and (start[4] is not None) == planar
    assert start[11] == kops.pcg_grid_scratch(levels, m_root) and start[13] == 4096
    assert all(a[1] == pytest.approx(1e-8) and a[3:7] == start[1:5] for a in steps)
    assert all(len(a) == len(_build.SIGNATURES["uz_pcg_grid_step"]) for a in steps)
    assert len(start) == len(_build.SIGNATURES["uz_pcg_grid_start"])
    assert kops.launches["pcg_grid"] == 13
    assert kops.launches["chain_apply"] == kops.launches["pcg"] == 0
    assert kops.launches["pcg_chain"] == kops.launches["pcg_chain_solve"] == 0


def test_above_the_cap_the_reduce_hook_runs_before_each_k37_step(fake_lib):
    n, E = 20_000, 22_000
    factor = _meta_factor(fake_lib, n)
    J, i32 = _meta(E, 6, 6), torch.int32

    def hvp(v):       # K2, then the caller's all-reduce between Hv and the dot
        y = kops.hvp(J, J, J, _meta(E, dtype=i32), _meta(E, dtype=i32), v, _meta(n, 6),
                     _meta(n))
        fake_lib.calls.append(("all_reduce", ()))
        return y

    # an operator is handed over, but the chain is above K34's cap: no K35
    op = kops.HvpOperator(J, J, J, _meta(E, dtype=i32), _meta(E, dtype=i32), _meta(n, 6),
                          _meta(n), kops.IncidenceTable(_meta(n + 1, dtype=i32),
                                                        _meta(2 * E, dtype=i32)))
    tsolver._pcg(hvp, factor, _meta(n, 6), 12, 1e-8, op=op)
    names = [c[0] for c in fake_lib.calls]
    assert names == ["uz_pcg_grid_start"] + ["uz_hvp", "all_reduce", "uz_pcg_grid_step"] * 12
    assert kops.launches["hvp"] == 12 and kops.launches["pcg_grid"] == 13
    assert kops.launches["pcg_chain_solve"] == 0


def test_the_cap_follows_from_shared_memory():
    # 18·n₂ / 8 floats a CTA at a 64-block root: 16,384 rows fit, 32,768 not
    assert kops.pcg_chain_smem(8, 64) == 148_896 <= kops._SMEM_BYTES < kops.pcg_chain_smem(9, 64)
    for n, fused in ((16_384, True), (16_385, False), (1, True), (5000, True)):
        halves, m_root = kops._factor_shapes(n, 64)
        assert (kops.pcg_chain_smem(len(halves), m_root) <= kops._SMEM_BYTES) == fused, n
    # a small root spreads its rows over fewer CTAs: at cutoff 1 one CTA holds
    # the chain, so 4,096 rows do not fit
    assert kops.pcg_chain_smem(12, 1) > kops._SMEM_BYTES >= kops.pcg_chain_smem(11, 1)


def test_argument_checks_raise(fake_lib):
    other = _meta_factor(fake_lib, 1000)
    factor = _meta_factor(fake_lib, 1000)
    with pytest.raises(ValueError, match="b: shape"):
        kops.pcg_chain_start(factor, _meta(999, 6))
    with pytest.raises(TypeError, match="b: dtype"):
        kops.pcg_chain_start(factor, _meta(1000, 6, dtype=torch.float64))
    with pytest.raises(ValueError, match="cmask: shape"):
        kops.pcg_chain_start(factor, _meta(1000, 6), 1, _meta(5))
    levels, root_inv, n = factor
    with pytest.raises(ValueError, match="P2: shape"):
        bad = ((levels[0][:2] + (_meta(1, 256, 6, 6),) + levels[0][3:]),) + levels[1:]
        kops.pcg_chain_start((bad, root_inv, n), _meta(1000, 6))
    with pytest.raises(ValueError, match="outside K34's cap"):
        kops._chain_table(_meta_factor(fake_lib, 20_000), torch.device("meta"))
    assert fake_lib.calls == []
    st = kops.pcg_chain_start(factor, _meta(1000, 6))
    with pytest.raises(ValueError, match="Hp: shape"):
        kops.pcg_chain_step(factor, _meta(1000, 3), st, 1e-8)
    with pytest.raises(ValueError, match="another factor or mask"):
        kops.pcg_chain_step(other, _meta(1000, 6), st, 1e-8)
    with pytest.raises(ValueError, match="another factor or mask"):
        kops.pcg_chain_step(factor, _meta(1000, 6), st, 1e-8, _meta(6))
    assert kops.launches["pcg_chain"] == 1       # the start


def test_a_failed_launch_or_a_cluster_that_does_not_fit_raises(fake_lib):
    factor = _meta_factor(fake_lib, 1000)
    fake_lib.err = 701          # what the kernel's cluster check returns
    with pytest.raises(RuntimeError, match="cluster .* does not fit on the device"):
        kops.pcg_chain_start(factor, _meta(1000, 6))
    fake_lib.err = 0
    st = kops.pcg_chain_start(factor, _meta(1000, 6))
    fake_lib.err = 9
    with pytest.raises(RuntimeError, match="pcg_chain: CUDA launch failed with cudaError_t 9"):
        kops.pcg_chain_step(factor, _meta(1000, 6), st, 1e-8)
    with pytest.raises(RuntimeError, match="pcg_chain: CUDA launch failed"):
        kops.pcg_chain_start(factor, _meta(1000, 6))
    assert kops.launches["pcg_chain"] == 1


def test_k37_argument_checks_raise(fake_lib):
    n = 20_000
    other, tiny = (_meta_factor(fake_lib, k) for k in (n, 40))
    factor = _meta_factor(fake_lib, n)
    with pytest.raises(ValueError, match="b: shape"):
        kops.pcg_grid_start(factor, _meta(n - 1, 6))
    with pytest.raises(TypeError, match="b: dtype"):
        kops.pcg_grid_start(factor, _meta(n, 6, dtype=torch.float64))
    with pytest.raises(ValueError, match="cmask: shape"):
        kops.pcg_grid_start(factor, _meta(n, 6), _meta(5))
    levels, root_inv, _ = factor
    with pytest.raises(ValueError, match="G1: shape"):
        bad = ((levels[0][:3] + (_meta(1, 9, 6, 6),) + levels[0][4:]),) + levels[1:]
        kops.pcg_grid_start((bad, root_inv, n), _meta(n, 6))
    # the products are read as float4: a view one float off is refused
    half = levels[0][2].shape[1]
    off = _meta(1 + half * 36).narrow(0, 1, half * 36).view(1, half, 6, 6)
    with pytest.raises(ValueError, match="P2 of level 0 is not 16-byte aligned"):
        bad = ((levels[0][:2] + (off,) + levels[0][3:]),) + levels[1:]
        kops.pcg_grid_start((bad, root_inv, n), _meta(n, 6))
    with pytest.raises(ValueError, match="at least one level"):
        kops.pcg_grid_start(tiny, _meta(40, 6))
    assert fake_lib.calls == []
    st = kops.pcg_grid_start(factor, _meta(n, 6))
    with pytest.raises(ValueError, match="Hp: shape"):
        kops.pcg_chain_step(factor, _meta(n, 3), st, 1e-8)
    with pytest.raises(ValueError, match="another factor or mask"):
        kops.pcg_chain_step(other, _meta(n, 6), st, 1e-8)
    with pytest.raises(ValueError, match="another factor or mask"):
        kops.pcg_chain_step(factor, _meta(n, 6), st, 1e-8, _meta(6))
    assert kops.launches["pcg_grid"] == 1


def test_k37_a_failed_launch_or_a_grid_that_does_not_fit_raises(fake_lib):
    factor = _meta_factor(fake_lib, 20_000)
    fake_lib.err = 720          # what the kernel returns when no CTA fits an SM
    with pytest.raises(RuntimeError, match="pcg_grid: .*cooperative grid does not fit"):
        kops.pcg_chain_start(factor, _meta(20_000, 6))
    fake_lib.err = 0
    st = kops.pcg_chain_start(factor, _meta(20_000, 6))
    fake_lib.err = 9
    with pytest.raises(RuntimeError, match="pcg_grid: CUDA launch failed with cudaError_t 9"):
        kops.pcg_chain_step(factor, _meta(20_000, 6), st, 1e-8)
    with pytest.raises(RuntimeError, match="pcg_grid: CUDA launch failed"):
        kops.pcg_grid_start(factor, _meta(20_000, 6))
    # nothing falls back to K10 and K3
    assert [c[0] for c in fake_lib.calls] == ["uz_pcg_grid_start"] * 2 + ["uz_pcg_grid_step",
                                                                          "uz_pcg_grid_start"]
    assert kops.launches["pcg_grid"] == 1
    assert kops.launches["chain_apply"] == kops.launches["pcg"] == 0
