"""K38 (``kernels.ops.pcg_fleet_solve``): a fleet's whole PCG solve in one
launch, a CTA an instance; and the PCG routes around it.

The CUDA kernel runs only on the card (``chip_smoke.py`` phase 17 holds it
against its plain version there).  Here, on the CPU, on a
fleet of 8 instances of 32 nodes (64 edge slots, a closure every 8 nodes)
at perturbed poses, cutoff 8 (2 levels and an 8-block root), 8 PCG steps:
- (a) ``pcg_fleet_solve_plain`` against the composition it stands for
  (K34's plain start at batch B, then per step K2's plain version and K34's
  plain step), and ``solver._pcg`` with the operator (the fleet's route on
  CPU tensors) against ``_pcg`` without it (the K2 + K10 + K3 loop the fleet
  ran before), bit for bit, plain and with the planar mask;
- (b) the port's fleet solve against JAX's ``_pcg`` with ``_make_hvp`` and
  ``block_tridiag_apply`` under ``jax.vmap``, plain and with the planar
  mask: in float64 (JAX under x64) within 1e-9 of max|x|; in float32 within
  1e-4 of max|x| beyond JAX's own float32 error against its float64 solve
  (the two sum in another order, and 8 float32 steps on these instances
  amplify it: JAX's own float32 solve lies 1.8e-3 of max|x| from its
  float64 one);
- the table K38 reads: instance b's entries are row_ptr[b·n] ..
  row_ptr[(b+1)·n], its side-0 entries its valid edges once each, and the
  node sums in table order (the kernel's) match the index_add version;
- (c) the routes, with a recording library on meta tensors: the 4096 x
  64-node fleet at cutoff 16 (the rung's and ``fleet_config``'s default)
  takes one ``uz_pcg_fleet_solve`` a PCG solve, also through the LM step;
  an instance above K38's cap keeps K2 + K10 + K3; a single solve within
  K34's cap keeps K35; above it K2 + K37, with a reduce hook and without
  one (K2's Hv inside K37's step measured slower than K2 + K37 on the card
  and is not on the route: ``scripts/k37_hv.cu``, PERF.md §6); argument
  checks and a failed launch;
- (d) above K34's cap (3,000 nodes at cutoff 1: 12 levels) ``_pcg`` with
  the operator against the K2 + K37 loop and ``pcg_chain_solve_plain``,
  bit for bit.
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
from uzliti_slam_tpu_torch.parallel import sharded as tsharded

B, N, CUTOFF, STEPS, TOL = 8, 32, 8, 8, 1e-8
XY = (1.0, 1.0, 0.0, 0.0, 0.0, 1.0)


@pytest.fixture(scope="module")
def fleet():
    """The fleet's first LM iteration's system at perturbed poses: (the
    fleet, its flattened graph, free, Ji, Jj, W, damp, b, Dm, U, the factor,
    the operator)."""
    port, _ = tsyn.make_pose_graph_batch(B, N, loop_closure_every=8,
                                         generator=torch.Generator().manual_seed(5),
                                         capacity_rounding="pow2", device="cpu")
    rng = np.random.default_rng(7)
    dx = torch.from_numpy(0.05 * rng.normal(size=(B * N, 6)).astype(np.float32))
    port = port.replace(pose=tlie.pose_retract(port.pose.reshape(-1, 7), dx).view(B, N, 7))
    g = tsolver._flatten_fleet(port)
    labels = tsolver.connected_components(g, tsolver.component_iterations(N))
    free = (g.node_valid & ~tsolver.gauge_fix_mask(g, labels)).float()
    cfg = tsolver.SolverConfig(pcg_iterations=STEPS, chain_dense_cutoff=CUTOFF,
                               early_exit=False)
    p = tsolver._Problem(g, free, cfg, batch=B)
    r0, _ = p.residuals(g.pose)
    Ji, Jj, W, grad, Hb, U = p.linearize(r0)
    damp = p.damp(torch.full((B,), 1e-4), Hb)
    factor = p.build_pack(Hb, U, damp)
    Dm = torch.where(free[:, None, None] > 0, Hb + torch.diag_embed(damp), p.eye6)
    op = kops.HvpOperator(Ji, Jj, W, g.e_from, g.e_to, damp, free, p.table)
    assert len(factor[0]) == 2 and factor[1].shape == (B, 48, 48)
    assert port.edge_capacity == 64 and not bool(g.e_valid.all())
    assert kops.pcg_fleet_route(factor, B, g.e_from.shape[0])
    return port, g, free, Ji, Jj, W, damp, -grad, Dm, U, factor, op


def _mask(planar):
    return torch.tensor(XY) if planar else None


def _k2(fleet, mask):
    _, g, free, Ji, Jj, W, damp = fleet[:7]

    def hvp(v):
        if mask is None:
            return kops.hvp(Ji, Jj, W, g.e_from, g.e_to, v, damp, free)
        return kops.hvp(Ji, Jj, W, g.e_from, g.e_to, v * mask, damp, free) * mask
    return hvp


@pytest.mark.parametrize("planar", [False, True], ids=["plain", "planar_mask"])
def test_plain_k38_is_the_plain_start_k2_and_step_bit_for_bit(fleet, planar):
    _, g, free, Ji, Jj, W, damp, b, _, _, factor, op = fleet
    mask = _mask(planar)
    b = b if mask is None else b * mask
    got = kops.pcg_fleet_solve_plain(factor, op, b, STEPS, TOL, mask)
    ref = kops.pcg_chain_start_plain(factor, b, B, mask)
    for _ in range(STEPS):
        v = ref.p if mask is None else ref.p * mask
        hp = kops.hvp_plain(Ji, Jj, W, g.e_from, g.e_to, v, damp, free)
        kops.pcg_chain_step_plain(factor, hp if mask is None else hp * mask, ref, TOL, mask)
    for a, c in zip(got[:4], ref[:4]):
        assert torch.equal(a, c)
    assert got.scal.shape == (B, 3)
    # the solver's fleet route on CPU tensors (K38's wrapper, its plain
    # version) gives the bits the K2 + K10 + K3 loop gave
    x_route = tsolver._pcg(_k2(fleet, mask), factor, b, STEPS, TOL, B, mask, op)
    x_loop = tsolver._pcg(_k2(fleet, mask), factor, b, STEPS, TOL, B, mask)
    assert torch.equal(x_route, got.x) and torch.equal(x_loop, got.x)
    assert kops.pcg_fleet_solve(factor, op, b, 0, TOL, mask).scal[:, 2].eq(1).all()


def _jax_fleet_pcg(port, arrays, planar, dtype):
    """JAX's ``_pcg`` with ``_make_hvp`` and ``block_tridiag_apply`` on
    each instance, under ``jax.vmap`` (``arrays``: Ji, Jj, W, damp, free,
    Dm, U, b with a leading (B,) axis), in ``dtype``."""
    jg = jstate.GraphState(**{k: jnp.asarray(v) for k, v in tstate.to_numpy(port).items()})

    def one(gi, Ji_, Jj_, W_, damp_, free_, Dm_, U_, b_):
        hvp = jsolver._make_hvp(gi, Ji_, Jj_, W_, damp_, free_)
        fac = jtridiag.block_tridiag_factor(Dm_, U_, CUTOFF)

        def apply(r):
            return jtridiag.block_tridiag_apply(fac, r)

        if planar:
            cm = jnp.asarray(XY, dtype=dtype)
            hvp_base, apply_base = hvp, apply
            hvp = lambda v: hvp_base(v * cm) * cm          # noqa: E731 (solver.py:1156-1159)
            apply = lambda r: apply_base(r * cm) * cm      # noqa: E731
        return jsolver._pcg(hvp, apply, b_, STEPS, TOL)

    return np.asarray(jax.jit(jax.vmap(one))(
        jg, *(jnp.asarray(a.numpy().astype(dtype)) for a in arrays)))


@pytest.mark.parametrize("planar", [False, True], ids=["plain", "planar_mask"])
def test_the_fleet_solve_matches_jax_vmapped_pcg(fleet, planar):
    # In float64 (JAX under x64, the port's plain versions on float64
    # tensors) the two agree to 1e-9 of max|x|.  In float32 they sum in
    # another order, and 8 float32 PCG steps on these 32-node instances
    # amplify that: JAX's own float32 solve lies 1.8e-3 of max|x| from its
    # float64 one.  So the port's float32 solve is held to JAX's float64
    # solve within JAX's own float32 error plus 1e-4 of max|x|.
    port, g, free, Ji, Jj, W, damp, b, Dm, U, factor, op = fleet
    E = port.edge_capacity
    mask = _mask(planar)
    b_t = b if mask is None else b * mask
    arrays = (Ji.view(B, E, 6, 6), Jj.view(B, E, 6, 6), W.view(B, E, 6, 6), damp.view(B, N, 6),
              free.view(B, N), Dm.view(B, N, 6, 6), U.view(B, N, 6, 6), b_t.view(B, N, 6))
    x_t = tsolver._pcg(_no_hvp, factor, b_t, STEPS, TOL, B, mask, op).view(B, N, 6).numpy()
    x_j = _jax_fleet_pcg(port, arrays, planar, np.float32)
    with jax.enable_x64():
        x_j64 = _jax_fleet_pcg(port, arrays, planar, np.float64)

    d = torch.Tensor.double
    op64 = op._replace(Ji=d(Ji), Jj=d(Jj), W=d(W), damp=d(damp), free=d(free))
    factor64 = kops.chain_factor_plain(d(Dm), d(U), CUTOFF, B)
    mask64 = None if mask is None else d(mask)
    x_t64 = tsolver._pcg(_no_hvp, factor64, d(b_t), STEPS, TOL, B, mask64, op64)
    scale = np.abs(x_j64).max()
    np.testing.assert_allclose(x_t64.view(B, N, 6).numpy(), x_j64, rtol=0, atol=1e-9 * scale)
    jax_own = np.abs(x_j - x_j64).max()
    np.testing.assert_allclose(x_t, x_j64, rtol=0, atol=jax_own + 1e-4 * scale)
    if planar:
        assert not x_t[..., 2:5].any()


def test_an_instance_reads_its_own_slice_of_the_fleet_table(fleet):
    _, g, free, Ji, Jj, W, damp, b, _, _, _, op = fleet
    row_ptr, entries = op.table.row_ptr.long(), op.table.entries.long()
    E = g.e_from.shape[0] // B
    v = torch.randn(B * N, 6, generator=torch.Generator().manual_seed(2))
    vm = v * free[:, None]
    for k in range(B):
        ent = entries[row_ptr[k * N]: row_ptr[(k + 1) * N]]
        edges, side = ent // 2, ent % 2
        assert bool(((edges >= k * E) & (edges < (k + 1) * E)).all())
        first = edges[side == 0]
        valid = torch.nonzero(g.e_valid[k * E: (k + 1) * E]).flatten() + k * E
        assert torch.equal(torch.sort(first).values, valid)
        assert torch.equal(edges[side == 1].sort().values, valid)
        # K38's Hv: each valid edge's two terms once, then each node's
        # entries summed in table order
        u = Ji[first] @ vm[g.e_from[first]][..., None] + Jj[first] @ vm[g.e_to[first]][..., None]
        Wu = W[first] @ u
        yi, yj = (Ji[first].transpose(-1, -2) @ Wu)[..., 0], (Jj[first].transpose(-1, -2) @ Wu)[..., 0]
        at = {int(e): c for c, e in enumerate(first)}
        y = torch.zeros(N, 6)
        for row in range(N):
            for q in range(int(row_ptr[k * N + row]), int(row_ptr[k * N + row + 1])):
                c = at[int(entries[q]) // 2]
                y[row] += yj[c] if int(entries[q]) % 2 else yi[c]
        rows = slice(k * N, (k + 1) * N)
        got = (y + damp[rows] * vm[rows]) * free[rows, None]
        ref = kops.hvp_plain(Ji, Jj, W, g.e_from, g.e_to, v, damp, free)[rows]
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-5 * float(ref.abs().max()))


# ---------------------------------------------------------------------------
# The routes, on meta tensors with a recording library
# ---------------------------------------------------------------------------

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


def _meta_factor(lib, n, cutoff, batch=1):
    factor = kops.chain_factor(_meta(batch * n, 6, 6), _meta(batch * n, 6, 6), cutoff, batch)
    lib.calls.clear()
    kops.reset_launches()
    return factor


def _meta_op(n, E):
    i32 = torch.int32
    return kops.HvpOperator(_meta(E, 6, 6), _meta(E, 6, 6), _meta(E, 6, 6), _meta(E, dtype=i32),
                            _meta(E, dtype=i32), _meta(n, 6), _meta(n),
                            kops.IncidenceTable(_meta(n + 1, dtype=i32), _meta(2 * E, dtype=i32)))


def _no_hvp(v):
    raise AssertionError("a fused route called the hvp closure")


def _others_zero(*names):
    return all(v == 0 for k, v in kops.launches.items() if k not in names)


@pytest.mark.parametrize("config, planar", [("rung", False), ("rung", True), ("default", False)],
                         ids=["rung", "rung_planar_mask", "default"])
def test_the_4096x64_fleet_takes_k38_in_one_launch(fake_lib, config, planar):
    cfg = (tsolver.SolverConfig(chain_dense_cutoff=16, pcg_iterations=8) if config == "rung"
           else tsharded.fleet_config(tsolver.SolverConfig()))
    batch, n, E = 4096, 64, 128
    factor = _meta_factor(fake_lib, n, cfg.chain_dense_cutoff, batch)
    assert kops.pcg_fleet_route(factor, batch, batch * E)
    mask = _meta(6) if planar else None
    tsolver._pcg(_no_hvp, factor, _meta(batch * n, 6), cfg.pcg_iterations, 1e-8, batch, mask,
                 _meta_op(batch * n, batch * E))
    assert [c[0] for c in fake_lib.calls] == ["uz_pcg_fleet_solve"]
    args = fake_lib.calls[0][1]
    # (table, levels, root blocks, rows, instances, edge slots, cmask, 9
    # operator pointers, b, steps, tol, x, r, p, scal, stream)
    assert args[1:6] == (2, 16, n, batch, E) and (args[6] is not None) == planar
    assert args[17] == cfg.pcg_iterations and args[18] == pytest.approx(1e-8)
    assert len(args) == len(_build.SIGNATURES["uz_pcg_fleet_solve"])
    assert kops.launches["pcg_fleet_solve"] == 1 and _others_zero("pcg_fleet_solve")
    assert kops.pcg_fleet_smem(2, 16, n, E) == 92_772


def test_the_lm_step_of_a_fleet_takes_k38(fake_lib):
    batch, n, E = 64, 64, 128
    g = tstate.empty_graph(batch * n, batch * E, "meta")
    cfg = tsolver.SolverConfig(chain_dense_cutoff=16, pcg_iterations=8)
    p = tsolver._Problem(g, _meta(batch * n), cfg, batch=batch)
    factor = _meta_factor(fake_lib, n, 16, batch)
    J = _meta(batch * E, 6, 6)
    p.step(g.pose, factor, J, J, J, _meta(batch * n, 6), _meta(batch * n, 6))
    names = [c[0] for c in fake_lib.calls if c[0] not in ("uz_residual_chi2", "uz_lm_candidate")]
    assert names == ["uz_pcg_fleet_solve"]
    assert kops.launches["hvp"] == kops.launches["pcg"] == kops.launches["chain_apply"] == 0


@pytest.mark.parametrize("n, cutoff, levels", [(512, 16, 5), (2048, 64, 5)],
                         ids=["512_cutoff_16", "2048_cutoff_64"])
def test_above_k38s_cap_a_fleet_keeps_k2_k10_k3(fake_lib, n, cutoff, levels):
    batch, E = 4, 2 * n
    factor = _meta_factor(fake_lib, n, cutoff, batch)
    assert not kops.pcg_fleet_route(factor, batch, batch * E)
    op = _meta_op(batch * n, batch * E)

    def hvp(v):
        return kops.hvp(*op[:5], v, op.damp, op.free)

    tsolver._pcg(hvp, factor, _meta(batch * n, 6), 8, 1e-8, batch, op=op)
    names = [c[0] for c in fake_lib.calls]
    apply = ["uz_chain_forward"] * levels + ["uz_chain_root"] + ["uz_chain_backward"] * levels
    assert names == apply + ["uz_pcg_init"] + (["uz_hvp", "uz_pcg_alpha"] + apply
                                               + ["uz_pcg_beta"]) * 8
    assert kops.launches["pcg_fleet_solve"] == kops.launches["pcg_grid"] == 0


def test_a_single_solve_within_k34s_cap_keeps_k35(fake_lib):
    n, E = 1000, 1100
    factor = _meta_factor(fake_lib, n, 64)
    assert not kops.pcg_fleet_route(factor, 1, E)
    tsolver._pcg(_no_hvp, factor, _meta(n, 6), 12, 1e-8, op=_meta_op(n, E))
    assert [c[0] for c in fake_lib.calls] == ["uz_pcg_chain_solve"]
    assert kops.launches["pcg_chain_solve"] == 1 and _others_zero("pcg_chain_solve")


@pytest.mark.parametrize("reduce", [False, True], ids=["no_reduce", "reduce"])
def test_above_k34s_cap_a_single_solve_keeps_k2_k37(fake_lib, reduce):
    n, E = 100_000, 110_000
    factor = _meta_factor(fake_lib, n, 64)
    assert not kops.pcg_chain_route(factor)
    assert not kops.pcg_fleet_route(factor, 1, E)
    op = _meta_op(n, E)

    def hvp(v):      # K2, then (with the hook) the caller's all-reduce
        y = kops.hvp(*op[:5], v, op.damp, op.free)
        if reduce:
            fake_lib.calls.append(("all_reduce", ()))
        return y

    tsolver._pcg(hvp, factor, _meta(n, 6), 12, 1e-8, op=None if reduce else op)
    hook = ["all_reduce"] if reduce else []
    assert [c[0] for c in fake_lib.calls] == (["uz_pcg_grid_start"]
                                              + (["uz_hvp"] + hook + ["uz_pcg_grid_step"]) * 12)
    assert kops.launches["pcg_grid"] == 13 and kops.launches["hvp"] == 12
    assert _others_zero("pcg_grid", "hvp")


def test_k38_argument_checks_raise(fake_lib):
    batch, n, E = 16, 64, 128
    factor = _meta_factor(fake_lib, n, 16, batch)
    op, b = _meta_op(batch * n, batch * E), _meta(batch * n, 6)
    i32 = torch.int32
    bad = {
        "Ji: shape": op._replace(Ji=_meta(batch * E, 6, 5)),
        "e_to: dtype": op._replace(e_to=_meta(batch * E)),
        "damp: shape": op._replace(damp=_meta(batch * n + 1, 6)),
        "row_ptr: shape": op._replace(table=kops.IncidenceTable(_meta(batch * n, dtype=i32),
                                                                op.table.entries)),
    }
    for msg, o in bad.items():
        with pytest.raises((ValueError, TypeError), match=msg):
            kops.pcg_fleet_solve(factor, o, b, 8, 1e-8)
    with pytest.raises(ValueError, match="b: shape"):
        kops.pcg_fleet_solve(factor, op, _meta(batch * n - 1, 6), 8, 1e-8)
    with pytest.raises(ValueError, match="cmask: shape"):
        kops.pcg_fleet_solve(factor, op, b, 8, 1e-8, _meta(5))
    with pytest.raises(ValueError, match="-1 steps"):
        kops.pcg_fleet_solve(factor, op, b, -1, 1e-8)
    with pytest.raises(ValueError, match="edge slots"):
        kops.pcg_fleet_solve(factor, _meta_op(batch * n, batch * E + 1), b, 8, 1e-8)
    big = _meta_factor(fake_lib, 1024, 16, 2)
    with pytest.raises(ValueError, match="outside K38's cap"):
        kops.pcg_fleet_solve(big, _meta_op(2048, 4096), _meta(2048, 6), 8, 1e-8)
    assert fake_lib.calls == [] and kops.launches["pcg_fleet_solve"] == 0


def test_a_failed_launch_raises_and_is_not_counted(fake_lib):
    batch, n, E = 16, 64, 128
    factor = _meta_factor(fake_lib, n, 16, batch)
    op, b = _meta_op(batch * n, batch * E), _meta(batch * n, 6)
    fake_lib.err = 9
    with pytest.raises(RuntimeError, match="pcg_fleet_solve: CUDA launch failed with "
                                           "cudaError_t 9"):
        kops.pcg_fleet_solve(factor, op, b, 8, 1e-8)
    assert kops.launches["pcg_fleet_solve"] == 0
    fake_lib.err = 0
    kops.pcg_fleet_solve(factor, op, b, 8, 1e-8)
    assert kops.launches["pcg_fleet_solve"] == 1


# ---------------------------------------------------------------------------
# (d) above K34's cap the operator changes nothing: K2 + K37
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def large_chain():
    """A single solve above K34's cap: 3,000 nodes at cutoff 1 (12 levels,
    a one-block root), the first LM iteration's system."""
    g, _ = tsyn.make_pose_graph(3000, loop_closure_every=10,
                                generator=torch.Generator().manual_seed(4), device="cpu")
    free = (g.node_valid & ~tsolver.gauge_fix_mask(g, tsolver.connected_components(g))).float()
    p = tsolver._Problem(g, free, tsolver.SolverConfig(chain_dense_cutoff=1))
    r0, _ = p.residuals(g.pose)
    Ji, Jj, W, grad, Hb, U = p.linearize(r0)
    damp = p.damp(torch.full((1,), 1e-4), Hb)
    factor = p.build_pack(Hb, U, damp)
    assert len(factor[0]) == 12 and not kops.pcg_chain_route(factor)
    op = kops.HvpOperator(Ji, Jj, W, g.e_from, g.e_to, damp, free, p.table)
    return g, free, Ji, Jj, W, damp, -grad, factor, op


@pytest.mark.parametrize("planar", [False, True], ids=["plain", "planar_mask"])
def test_above_k34s_cap_the_operator_route_is_the_k2_k37_loop(large_chain, planar):
    g, free, Ji, Jj, W, damp, b, factor, op = large_chain
    mask = _mask(planar)
    b = b if mask is None else b * mask
    kops.reset_launches()

    def hvp(v):
        if mask is None:
            return kops.hvp(Ji, Jj, W, g.e_from, g.e_to, v, damp, free)
        return kops.hvp(Ji, Jj, W, g.e_from, g.e_to, v * mask, damp, free) * mask

    ref = kops.pcg_chain_solve_plain(factor, op, b, 12, TOL, mask)
    assert torch.equal(tsolver._pcg(hvp, factor, b, 12, TOL, cmask=mask, op=op), ref.x)
    assert torch.equal(tsolver._pcg(hvp, factor, b, 12, TOL, cmask=mask), ref.x)
    assert kops.launches == {k: 0 for k in kops.launches}
