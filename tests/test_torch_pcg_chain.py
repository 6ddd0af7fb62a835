"""K34 (``kernels.ops.pcg_chain_start`` / ``pcg_chain_step``): a single
solve's PCG step with the chain preconditioner inside it.

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
- the route, with a recording library on meta tensors: within K34's cap one
  start and one launch a step, and none of K3's or K10's entries; above the
  cap and in a fleet, K3's and K10's;
- the argument checks and a failed launch.
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


@pytest.mark.parametrize("n, cutoff, batch, levels", [(20_000, 64, 1, 9), (5000, 1, 1, 13),
                                                      (64, 16, 4, 2)],
                         ids=["above_the_cap", "one_block_root", "fleet"])
def test_above_the_cap_and_in_a_fleet_a_solve_takes_k3_and_k10(fake_lib, n, cutoff, batch,
                                                               levels):
    factor = _meta_factor(fake_lib, n, cutoff, batch)
    assert not kops.pcg_chain_route(factor, batch)
    tsolver._pcg(torch.empty_like, factor, _meta(batch * n, 6), 12, 1e-8, batch)
    names = [c[0] for c in fake_lib.calls]
    apply = ["uz_chain_forward"] * levels + ["uz_chain_root"] + ["uz_chain_backward"] * levels
    step = ["uz_pcg_alpha"] + apply + ["uz_pcg_beta"]
    assert names == apply + ["uz_pcg_init"] + step * 12
    assert kops.launches["chain_apply"] == 13 and kops.launches["pcg"] == 1 + 2 * 12
    assert kops.launches["pcg_chain"] == 0


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
