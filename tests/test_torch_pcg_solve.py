"""K35 (``kernels.ops.pcg_chain_solve``): a single solve's whole PCG, its
Hessian-vector products included, in one launch; and the incidence table
it sums Hv over.

The CUDA kernel runs only on the card (``chip_smoke.py`` phase 3 holds it
against its plain version there).  Here, on the CPU, on a 200-node graph in
padded capacities (256 node and 320 edge slots, two edges invalid inside
the table), its odometry and loop noise drawn with numpy, cutoff 16:
- the incidence table against a numpy build: valid edges only, in entry
  order, padded slots left out;
- Hv summed in table order (``table_sum``, the kernel's order) against
  the index_add version, ``hvp_plain``;
- the plain K35 against JAX's ``_pcg(_make_hvp(...), block_tridiag_apply,
  b, 12, tol)``, plain and with the planar mask: in float64 (JAX under
  x64) within 1e-9 of max|x|, in float32 within 1e-4 of max|x| beyond JAX's
  own float32 error (against its float64 solve); and against the K2 + K34
  loop it replaces, bit for bit;
- the routes, with a recording library on meta tensors: within K34's cap
  and without a reduce hook one ``uz_pcg_chain_solve`` per PCG solve; with
  a reduce hook K2 + K34; above the cap, with or without one, K2 + K37; in
  a fleet above K38's cap K2 + K10 + K3;
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
N_NODES, NODE_SLOTS, EDGE_SLOTS, CLOSURES = 200, 256, 320, 10
DROPPED = (7, 150)      # edges made invalid inside the table


def padded_graph(seed: int = 21, dropped=DROPPED):
    """The 200-node circle (a closure every 10 nodes) with numpy's draws, in
    256 / 320 slots, the edges ``dropped`` invalid."""
    rng = np.random.default_rng(seed)
    odom = torch.from_numpy(rng.normal(size=(N_NODES - 1, 6)).astype(np.float32))
    loop = torch.from_numpy(rng.normal(size=(CLOSURES, 6)).astype(np.float32))
    g, _ = tsyn.make_pose_graph(N_NODES, loop_closure_every=10, node_capacity=NODE_SLOTS,
                                edge_capacity=EDGE_SLOTS, odom_draws=odom, loop_draws=loop,
                                device="cpu")
    valid = g.e_valid.clone()
    valid[list(dropped)] = False
    dx = torch.from_numpy(0.05 * rng.normal(size=(NODE_SLOTS, 6)).astype(np.float32))
    return g.replace(e_valid=valid, pose=tlie.pose_retract(g.pose, dx))


def entry_terms(from_side, to_side):
    """Per-edge terms of both sides (E, ...) interleaved as the table's
    entries (2E, ...): entry 2e + side."""
    return torch.stack([from_side, to_side], dim=1).flatten(0, 1)


def table_sum(table, terms):
    """Each node's sum of ``terms`` (2E, ...) over its table entries, added
    one at a time in table order from 0: the order of K1's and K35's node
    sums on the card."""
    row_ptr, entries = table
    deg = row_ptr[1:] - row_ptr[:-1]
    out = terms.new_zeros((deg.shape[0],) + tuple(terms.shape[1:]))
    width = (1,) * (terms.dim() - 1)
    for k in range(int(deg.max()) if deg.numel() else 0):
        has = deg > k
        pos = torch.where(has, row_ptr[:-1] + k, 0).long()
        term = terms.index_select(0, entries.index_select(0, pos).long())
        out = torch.where(has.view(-1, *width), out + term, out)
    return out


def numpy_table(e_from, e_to, e_valid, n):
    """Each node's entries 2e + side of the valid edges, in increasing order."""
    rows = [[] for _ in range(n)]
    for e, (f, t, v) in enumerate(zip(e_from, e_to, e_valid)):
        if v:
            rows[f].append(2 * e)
            rows[t].append(2 * e + 1)
    row_ptr = np.concatenate([[0], np.cumsum([len(r) for r in rows])])
    return row_ptr, np.array([j for r in rows for j in r], dtype=np.int64)


@pytest.fixture(scope="module", params=["cut", "uncut"])
def system(request):
    """The first LM iteration's system on the port's side: (problem, Ji, Jj,
    W, damp, b, Dm, U, factor); "cut" with two odometry edges invalid (the
    chain preconditioner then misses two spine couplings), "uncut" with the
    padded slots alone invalid."""
    g = padded_graph(dropped=DROPPED if request.param == "cut" else ())
    free = (g.node_valid & ~tsolver.gauge_fix_mask(g, tsolver.connected_components(g))).float()
    p = tsolver._Problem(g, free, tsolver.SolverConfig(**CFG))
    r0, _ = p.residuals(g.pose)
    Ji, Jj, W, grad, Hb, U = p.linearize(r0)
    damp = p.damp(torch.full((1,), 1e-4), Hb)
    factor = p.build_pack(Hb, U, damp)
    Dm = torch.where(free[:, None, None] > 0, Hb + torch.diag_embed(damp), p.eye6)
    assert len(factor[0]) == 4 and factor[1].shape[-1] == 96
    assert (W < g.e_info - 1e-3).any(), "no Huber-weighted edge"
    return p, Ji, Jj, W, damp, -grad, Dm, U, factor


def _op(system):
    p, Ji, Jj, W, damp = system[:5]
    return kops.HvpOperator(Ji, Jj, W, p.g.e_from, p.g.e_to, damp, p.free, p.table)


def _fleet():
    fleet, _ = tsyn.make_pose_graph_batch(3, 40, loop_closure_every=5, node_capacity=48,
                                          edge_capacity=64, generator=torch.Generator()
                                          .manual_seed(2), device="cpu")
    return tsolver._flatten_fleet(fleet)


@pytest.mark.parametrize("case", ["padded", "fleet", "no_valid_edge", "self_loop"])
def test_incidence_table_matches_a_numpy_build(case):
    if case == "fleet":
        g = _fleet()
    else:
        g = padded_graph()
        if case == "no_valid_edge":
            g = g.replace(e_valid=torch.zeros_like(g.e_valid))
        elif case == "self_loop":
            e_to = g.e_to.clone()
            e_to[3] = g.e_from[3]
            g = g.replace(e_to=e_to)
    n = g.pose.shape[0]
    table = kops.incidence_table(g.e_from, g.e_to, g.e_valid, n)
    row_ptr, entries = numpy_table(g.e_from.numpy(), g.e_to.numpy(), g.e_valid.numpy(), n)
    assert table.row_ptr.dtype == table.entries.dtype == torch.int32
    assert table.entries.shape == (2 * g.e_from.shape[0],)
    np.testing.assert_array_equal(table.row_ptr.numpy(), row_ptr)
    count = int(row_ptr[-1])
    np.testing.assert_array_equal(table.entries[:count].numpy(), entries)
    # padded and invalid slots stay out, so node 0 holds only its own edges
    assert g.e_valid[table.entries[:count].long() // 2].all()
    assert sorted(table.entries.tolist()) == list(range(2 * g.e_from.shape[0]))


def test_hv_in_table_order_matches_the_index_add_version(system):
    p, Ji, Jj, W, damp = system[:5]
    g = p.g
    v = torch.from_numpy(np.random.default_rng(5).normal(size=(NODE_SLOTS, 6)).astype(np.float32))
    ref = kops.hvp_plain(Ji, Jj, W, g.e_from, g.e_to, v, damp, p.free)
    vm = v * p.free[:, None]
    Wu = W @ (Ji @ vm[g.e_from.long(), :, None] + Jj @ vm[g.e_to.long(), :, None])
    y = table_sum(p.table, entry_terms((Ji.transpose(1, 2) @ Wu)[..., 0],
                                       (Jj.transpose(1, 2) @ Wu)[..., 0]))
    got = (y + damp * vm) * p.free[:, None]
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6 * float(ref.abs().max()))
    assert not got[~p.free.bool()].any()
    # the order is the table's: one add a term, from 0
    yi = torch.randn(g.e_from.shape[0], 6, generator=torch.Generator().manual_seed(0))
    yj = torch.randn(g.e_from.shape[0], 6, generator=torch.Generator().manual_seed(1))
    sums = table_sum(p.table, entry_terms(yi, yj))
    node = 100
    acc = torch.zeros(6)
    for j in p.table.entries[p.table.row_ptr[node]:p.table.row_ptr[node + 1]].tolist():
        acc = acc + (yj if j & 1 else yi)[j >> 1]
    assert torch.equal(sums[node], acc)


def _jax_pcg(p, arrays, planar, dtype):
    """JAX's ``_pcg(_make_hvp(...), block_tridiag_apply, b, 12, 1e-8)`` on
    (Ji, Jj, W, damp, free, Dm, U, b) in ``dtype``, under ``jax.jit``, with
    the generic loop's planar wraps (solver.py:1156-1159) where asked."""
    jg = jstate.GraphState(**{k: jnp.asarray(v) for k, v in tstate.to_numpy(p.g).items()})
    j = [jnp.asarray(t.numpy().astype(dtype)) for t in arrays]
    hvp_j = jsolver._make_hvp(jg, *j[:5])
    fac_j = jtridiag.block_tridiag_factor(j[5], j[6], CFG["chain_dense_cutoff"])

    def apply_j(r):
        return jtridiag.block_tridiag_apply(fac_j, r)

    if planar:
        cm = jnp.asarray(np.asarray(XY, dtype))
        hvp_base, apply_base = hvp_j, apply_j
        hvp_j = lambda v: hvp_base(v * cm) * cm          # noqa: E731
        apply_j = lambda r: apply_base(r * cm) * cm      # noqa: E731
    x = jax.jit(lambda bb: jsolver._pcg(hvp_j, apply_j, bb, 12, 1e-8))(j[7])
    assert x.dtype == dtype
    return np.asarray(x, np.float64)


@pytest.mark.parametrize("planar", [False, True], ids=["plain", "planar_mask"])
def test_plain_k35_matches_jax_pcg(system, planar):
    """In float64 (every input cast, JAX under x64) the port's plain K35
    and JAX's ``_pcg`` agree within 1e-9 of max|x| (2.3e-12 at most on these
    four systems).  In float32, x within 1e-4 of max|x| of JAX's, beyond
    twice JAX's own float32 error (its distance from its float64 solve).
    That error is ~5e-6 on the two plain systems, and held to 1e-5; the
    planar ones of this draw are ill-conditioned in float32 (JAX 4.2e-4 and
    1.5e-3 of max|x| from its float64 solve), and there the bar follows it."""
    p, Ji, Jj, W, damp, b, Dm, U, factor = system
    mask = torch.tensor(XY) if planar else None
    b_t = b if mask is None else b * mask
    x_t = kops.pcg_chain_solve(factor, _op(system), b_t, 12, 1e-8, mask).x.numpy()
    f64 = [t.double() for t in (Ji, Jj, W, damp, p.free, Dm, U, b_t)]
    op64 = kops.HvpOperator(*f64[:3], p.g.e_from, p.g.e_to, *f64[3:5], p.table)
    factor64 = kops.chain_factor_plain(f64[5], f64[6], CFG["chain_dense_cutoff"])
    x64 = kops.pcg_chain_solve(factor64, op64, f64[7], 12, 1e-8,
                               None if mask is None else mask.double()).x.numpy()

    arrays = (Ji, Jj, W, damp, p.free, Dm, U, b_t)
    x_j = _jax_pcg(p, arrays, planar, np.float32)
    with jax.enable_x64(True):
        x_j64 = _jax_pcg(p, arrays, planar, np.float64)
    scale = np.abs(x_j64).max()
    np.testing.assert_allclose(x64, x_j64, rtol=0, atol=1e-9 * scale)
    jax_err = np.abs(x_j - x_j64).max()
    np.testing.assert_allclose(x_t, x_j, rtol=0, atol=1e-4 * np.abs(x_j).max() + 2 * jax_err)
    if planar:
        assert not x_t[:, 2:5].any() and not x64[:, 2:5].any()
    else:
        assert jax_err <= 1e-5 * scale


@pytest.mark.parametrize("planar", [False, True], ids=["plain", "planar_mask"])
def test_plain_k35_is_the_k2_k34_loop_bit_for_bit(system, planar):
    p, Ji, Jj, W, damp, b, _, _, factor = system
    g = p.g
    mask = torch.tensor(XY) if planar else None
    b = b if mask is None else b * mask

    def hvp(v):
        if mask is None:
            return kops.hvp(Ji, Jj, W, g.e_from, g.e_to, v, damp, p.free)
        return kops.hvp(Ji, Jj, W, g.e_from, g.e_to, v * mask, damp, p.free) * mask

    kops.reset_launches()
    st = kops.pcg_chain_solve(factor, _op(system), b, 12, 1e-8, mask)
    loop = kops.pcg_chain_start(factor, b, 1, mask)
    for _ in range(12):
        kops.pcg_chain_step(factor, hvp(loop.p), loop, 1e-8, mask)
    for got, ref in zip(st[:4], loop[:4]):
        assert torch.equal(got, ref)
    assert bool(st.scal[0, 2]) and st.fused is None
    # solver._pcg with the operator: the same x, hvp not called
    assert torch.equal(tsolver._pcg(None, factor, b, 12, 1e-8, cmask=mask, op=_op(system)),
                       loop.x)
    assert kops.launches == {k: 0 for k in kops.launches}


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


def _meta_factor(lib, n, cutoff=64, batch=1):
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
    raise AssertionError("K35's route called the hvp closure")


@pytest.mark.parametrize("planar", [False, True], ids=["plain", "planar_mask"])
def test_within_the_cap_without_reduce_a_pcg_solve_is_one_k35_launch(fake_lib, planar):
    factor = _meta_factor(fake_lib, 1000)
    mask = _meta(6) if planar else None
    tsolver._pcg(_no_hvp, factor, _meta(1000, 6), 12, 1e-8, cmask=mask, op=_meta_op(1000, 1100))
    assert [c[0] for c in fake_lib.calls] == ["uz_pcg_chain_solve"]
    args = fake_lib.calls[0][1]
    # (table, levels, root blocks, rows, cmask, 9 operator pointers, edges, b, steps, tol, ...)
    assert args[1:4] == (4, 64, 1000) and args[14] == 1100 and args[16] == 12
    assert args[17] == pytest.approx(1e-8)
    assert len(args) == len(_build.SIGNATURES["uz_pcg_chain_solve"])
    assert kops.launches["pcg_chain_solve"] == 1
    assert kops.launches["hvp"] == kops.launches["pcg_chain"] == 0
    assert kops.launches["chain_apply"] == kops.launches["pcg"] == 0


def _meta_problem(n, E, reduce):
    g = tstate.empty_graph(n, E, "meta")
    free = _meta(n)
    p = tsolver._Problem(g, free, tsolver.SolverConfig(**CFG), reduce=reduce)
    return p, g


@pytest.mark.parametrize("reduce", [False, True], ids=["no_reduce", "reduce"])
def test_the_lm_step_takes_k35_without_reduce_and_k2_k34_with_it(fake_lib, reduce):
    n, E = 1000, 1100
    p, g = _meta_problem(n, E, (lambda t: None) if reduce else None)
    factor = _meta_factor(fake_lib, n, CFG["chain_dense_cutoff"])
    J = _meta(E, 6, 6)
    p.step(g.pose, factor, J, J, J, _meta(n, 6), _meta(n, 6))
    names = [c[0] for c in fake_lib.calls if c[0] not in ("uz_residual_chi2", "uz_lm_candidate")]
    if reduce:
        assert names == ["uz_pcg_chain_start"] + ["uz_hvp", "uz_pcg_chain_step"] * 12
        assert kops.launches["pcg_chain_solve"] == 0
    else:
        assert names == ["uz_pcg_chain_solve"]
        assert kops.launches["hvp"] == kops.launches["pcg_chain"] == 0


def test_in_a_fleet_the_operator_takes_k2_k10_k3(fake_lib):
    # instances of 1,024 nodes do not fit one CTA's shared memory: above
    # K38's cap a fleet keeps K2, K10 and K3
    n, cutoff, batch, levels = 1024, 16, 4, 6
    factor = _meta_factor(fake_lib, n, cutoff, batch)
    E = 2 * batch * n
    assert not kops.pcg_fleet_route(factor, batch, E)

    def hvp(v):
        return kops.hvp(*_meta_op(batch * n, E)[:5], v, _meta(batch * n, 6), _meta(batch * n))

    tsolver._pcg(hvp, factor, _meta(batch * n, 6), 12, 1e-8, batch, op=_meta_op(batch * n, E))
    names = [c[0] for c in fake_lib.calls]
    apply = ["uz_chain_forward"] * levels + ["uz_chain_root"] + ["uz_chain_backward"] * levels
    step = ["uz_hvp", "uz_pcg_alpha"] + apply + ["uz_pcg_beta"]
    assert names == apply + ["uz_pcg_init"] + step * 12
    assert kops.launches["pcg_chain_solve"] == kops.launches["pcg_chain"] == 0
    assert kops.launches["pcg_grid"] == kops.launches["pcg_fleet_solve"] == 0


@pytest.mark.parametrize("reduce", [False, True], ids=["no_reduce", "reduce"])
def test_above_the_cap_the_operator_takes_k2_k37(fake_lib, reduce):
    # the LM step hands _pcg its operator only without a reduce hook; above
    # K34's cap neither form takes K35: K2 (and the hook) then K37's step
    n, E = 20_000, 22_000
    p, g = _meta_problem(n, E, (lambda t: fake_lib.calls.append(("all_reduce", ())))
                         if reduce else None)
    factor = _meta_factor(fake_lib, n, CFG["chain_dense_cutoff"])
    J = _meta(E, 6, 6)
    p.step(g.pose, factor, J, J, J, _meta(n, 6), _meta(n, 6))
    names = [c[0] for c in fake_lib.calls if c[0] not in ("uz_residual_chi2", "uz_lm_candidate")]
    hook = ["all_reduce"] if reduce else []
    # (the hook's last call sums the candidate's χ²)
    assert names == (["uz_pcg_grid_start"] + (["uz_hvp"] + hook + ["uz_pcg_grid_step"]) * 12
                     + hook)
    assert kops.launches["pcg_grid"] == 13 and kops.launches["hvp"] == 12
    assert kops.launches["pcg_chain_solve"] == kops.launches["pcg_chain"] == 0
    assert kops.launches["chain_apply"] == kops.launches["pcg"] == 0


def test_argument_checks_raise(fake_lib):
    n, E = 1000, 1100
    factor = _meta_factor(fake_lib, n)
    op, b = _meta_op(n, E), _meta(n, 6)
    i32 = torch.int32
    bad = {
        "Ji: shape": op._replace(Ji=_meta(E, 6, 5)),
        "e_to: dtype": op._replace(e_to=_meta(E)),
        "damp: shape": op._replace(damp=_meta(n + 1, 6)),
        "row_ptr: shape": op._replace(table=kops.IncidenceTable(_meta(n, dtype=i32),
                                                                op.table.entries)),
        "entries: dtype": op._replace(table=kops.IncidenceTable(op.table.row_ptr,
                                                                _meta(2 * E))),
    }
    for msg, o in bad.items():
        with pytest.raises((ValueError, TypeError), match=msg):
            kops.pcg_chain_solve(factor, o, b, 12, 1e-8)
    with pytest.raises(ValueError, match="b: shape"):
        kops.pcg_chain_solve(factor, op, _meta(n - 1, 6), 12, 1e-8)
    with pytest.raises(ValueError, match="cmask: shape"):
        kops.pcg_chain_solve(factor, op, b, 12, 1e-8, _meta(5))
    with pytest.raises(ValueError, match="-1 steps"):
        kops.pcg_chain_solve(factor, op, b, -1, 1e-8)
    with pytest.raises(ValueError, match="outside K34's cap"):
        kops.pcg_chain_solve(_meta_factor(fake_lib, 20_000), _meta_op(20_000, E),
                             _meta(20_000, 6), 12, 1e-8)
    assert fake_lib.calls == [] and kops.launches["pcg_chain_solve"] == 0


def test_a_failed_launch_or_a_cluster_that_does_not_fit_raises(fake_lib):
    factor = _meta_factor(fake_lib, 1000)
    op, b = _meta_op(1000, 1100), _meta(1000, 6)
    fake_lib.err = 701
    with pytest.raises(RuntimeError, match="pcg_chain_solve: .*cluster .* does not fit"):
        kops.pcg_chain_solve(factor, op, b, 12, 1e-8)
    fake_lib.err = 9
    with pytest.raises(RuntimeError, match="pcg_chain_solve: CUDA launch failed with "
                                           "cudaError_t 9"):
        kops.pcg_chain_solve(factor, op, b, 12, 1e-8)
    fake_lib.err = 0
    kops.pcg_chain_solve(factor, op, b, 12, 1e-8)
    assert kops.launches["pcg_chain_solve"] == 1
