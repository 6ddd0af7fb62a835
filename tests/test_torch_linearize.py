"""K1 (``kernels.ops.linearize``) summing node rows over the incidence
table, without float atomics.

The CUDA kernel runs only on the card (``chip_smoke.py`` phase 3 holds it
against its plain version and the atomic kernel it replaced there).  Here,
on the CPU, on tests/test_torch_pcg_solve.py's 200-node graph in padded
capacities (two edges invalid inside the table, or the padded slots alone),
at perturbed poses:
- the node rows summed in table order (``table_rows``, the kernel's order)
  from ``linearize_plain``'s Ji, Jj and W against its index_add rows, with
  and without the planar column mask;
- the table-order rows against JAX's ``_make_fused_linearize``;
- the table each solve builds: its valid edges only, for a single graph, a
  flattened fleet and an edge-sharded rank's shard;
- the wrapper on meta tensors: it hands the kernel the table, checks it,
  and refuses a CUDA call without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import solver as jsolver
from uzliti_slam_tpu.graph import state as jstate
from uzliti_slam_tpu_torch.graph import solver as tsolver
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import synthetic as tsyn
from uzliti_slam_tpu_torch.kernels import _build
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.parallel import sharded

from test_torch_pcg_solve import CFG, DROPPED, entry_terms, numpy_table, padded_graph, table_sum


def _problem(cut: bool, xy: bool):
    g = padded_graph(dropped=DROPPED if cut else ())
    free = (g.node_valid & ~tsolver.gauge_fix_mask(g, tsolver.connected_components(g))).float()
    p = tsolver._Problem(g, free, tsolver.SolverConfig(**CFG, optimize_xy_only=xy))
    r0, _ = p.residuals(g.pose)
    return p, r0


def _args(p, r0):
    g = p.g
    return (r0, p.adj_meas_inv, g.e_info, p.valid, g.e_from, g.e_to, p.free, p.both_free,
            p.is_chain, 1.0)


def table_rows(p, r0, Ji, Jj, W):
    """K1's node rows (grad, Hb, U) from its per-edge Ji, Jj, W, each row
    summed over the incidence table in table order, as the kernel sums them,
    and masked (grad·free, U·both_free)."""
    n, E = p.free.shape[0], r0.shape[0]
    JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
    Wr = W @ r0[..., None]
    Uc = (JiT @ W @ Jj) * p.is_chain[:, None, None]
    from_side = torch.cat([(JiT @ Wr)[..., 0], (JiT @ W @ Ji).reshape(E, 36),
                           Uc.reshape(E, 36)], dim=1)
    to_side = torch.cat([(JjT @ Wr)[..., 0], (JjT @ W @ Jj).reshape(E, 36),
                         torch.zeros(E, 36)], dim=1)
    rows = table_sum(p.table, entry_terms(from_side, to_side))
    return (rows[:, :6] * p.free[:, None], rows[:, 6:42].reshape(n, 6, 6),
            rows[:, 42:].reshape(n, 6, 6) * p.both_free[:, None, None])


@pytest.mark.parametrize("xy", [False, True], ids=["full", "xy_columns"])
@pytest.mark.parametrize("cut", [True, False], ids=["cut", "uncut"])
def test_node_rows_in_table_order_match_the_index_add_version(cut, xy):
    p, r0 = _problem(cut, xy)
    ref = kops.linearize_plain(*_args(p, r0), col_mask=p.col_mask)
    got = table_rows(p, r0, *ref[:3])
    for name, a, b in zip(("grad", "Hb", "U"), got, ref[3:]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * float(b.abs().max()), msg=name)
    assert got[1].abs().max() > 0 and got[2].abs().max() > 0
    # rows of nodes without a valid edge (the padded slots) are exact zeros,
    # and a dropped edge's endpoints lose its terms
    assert not torch.cat([t.reshape(p.free.shape[0], -1) for t in got], 1)[200:].any()
    if xy:
        assert not ref[0][:, :, 2:5].any() and not got[0][:, 2:5].any()


def test_table_order_rows_match_jax_fused_linearize():
    """All six outputs within 1e-4 of each array's largest entry (W 1e-5),
    as tests/test_torch_solver.py holds the index_add form."""
    p, r0 = _problem(True, False)
    plain = kops.linearize_plain(*_args(p, r0))
    got = plain[:3] + table_rows(p, r0, *plain[:3])
    jg = jstate.GraphState(**{k: jnp.asarray(v) for k, v in tstate.to_numpy(p.g).items()})
    cfg = jsolver.SolverConfig(**CFG)
    lin = jsolver._make_fused_linearize(jg, jnp.asarray(p.free.numpy()), cfg,
                                        jnp.asarray(p.adj_meas_inv.numpy()))
    ref = jax.jit(lin)(jnp.asarray(r0.numpy()))
    for name, a, b in zip(("Ji", "Jj", "W", "grad", "Hb", "U"), got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=(1e-5 if name == "W" else 1e-4)
                                   * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("case", ["single", "fleet", "shard"])
def test_each_solve_builds_the_table_of_its_valid_edges(case):
    if case == "fleet":
        fleet, _ = tsyn.make_pose_graph_batch(3, 40, loop_closure_every=5, node_capacity=48,
                                              edge_capacity=64,
                                              generator=torch.Generator().manual_seed(2),
                                              device="cpu")
        g, batch = tsolver._flatten_fleet(fleet), 3
    else:
        g, batch = padded_graph(), 1
        if case == "shard":
            g = sharded.shard_edges(g, 1, 2)
    free = g.node_valid.float()
    p = tsolver._Problem(g, free, tsolver.SolverConfig(**CFG), batch=batch)
    row_ptr, entries = numpy_table(g.e_from.numpy(), g.e_to.numpy(), g.e_valid.numpy(),
                                   free.shape[0])
    np.testing.assert_array_equal(p.table.row_ptr.numpy(), row_ptr)
    np.testing.assert_array_equal(p.table.entries[:row_ptr[-1]].numpy(), entries)
    if case == "fleet":
        # no entry crosses instances: instance b's rows hold its own edges
        e = p.table.entries[:row_ptr[-1]].long() // 2
        node = torch.repeat_interleave(torch.arange(free.shape[0]),
                                       torch.from_numpy(np.diff(row_ptr)))
        assert torch.equal(node // 48, e // 64)
    if case == "shard":
        assert p.table.entries.shape == (g.e_from.shape[0] * 2,) == (320,)


class _FakeLib:
    """Records the C calls a wrapper makes; every call returns 0."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
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


def test_the_wrapper_hands_the_kernel_its_table_and_checks_it(fake_lib):
    n, E = 8, 16
    i32 = torch.int32
    args = (_meta(E, 6), _meta(E, 6, 6), _meta(E, 6, 6), _meta(E), _meta(E, dtype=i32),
            _meta(E, dtype=i32), _meta(n), _meta(n), _meta(E), 1.0)
    table = kops.IncidenceTable(_meta(n + 1, dtype=i32), _meta(2 * E, dtype=i32))
    kops.linearize(*args, table=table)
    assert [c[0] for c in fake_lib.calls] == ["uz_linearize"]
    # (r, adj, info, valid, free, both_free, is_chain, row_ptr, entries,
    #  huber_delta, n_edges, n_nodes, col_keep, Ji, Jj, W, grad, Hb, U, stream)
    assert all(len(c[1]) == len(_build.SIGNATURES["uz_linearize"]) for c in fake_lib.calls)
    assert all(c[1][9:13] == (1.0, E, n, 63) for c in fake_lib.calls)
    assert kops.launches["linearize"] == 1
    with pytest.raises(ValueError, match="row_ptr: shape"):
        kops.linearize(*args, table=table._replace(row_ptr=_meta(n, dtype=i32)))
    with pytest.raises(TypeError, match="entries: dtype"):
        kops.linearize(*args, table=table._replace(entries=_meta(2 * E)))
    with pytest.raises(ValueError, match="entries: shape"):
        kops.linearize(*args, table=table._replace(entries=_meta(E, dtype=i32)))
    with pytest.raises(ValueError, match="needs the incidence table"):
        kops.linearize(*args)
    assert kops.launches["linearize"] == 1


def test_the_cpu_wrapper_keeps_the_edge_order_plain_version():
    p, r0 = _problem(True, False)
    kops.reset_launches()
    for a, b in zip(kops.linearize(*_args(p, r0), table=p.table),
                    kops.linearize_plain(*_args(p, r0))):
        assert torch.equal(a, b)
    assert kops.launches == {k: 0 for k in kops.launches}
