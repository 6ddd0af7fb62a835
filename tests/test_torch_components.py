"""K8 against JAX: connected components and the gauge in one call.

``kops.components_gauge`` (the solves' one K8 launch) runs its plain
version on CPU tensors; here it is held bit for bit to JAX's
``connected_components`` + ``gauge_fix_mask`` on graphs that converge
early, on a chain that does not converge in its rounds, and on stamp ties;
the rounds it reports are the kernel's (up to the first that changes no
label, at most ``n_iters``).  The kernel's gauge rule (one 64-bit minimum
of the stamp's order key above the slot, ±0 alike) is replayed in numpy
against JAX's.  On meta tensors with a recording library: one
``uz_components_gauge`` launch a call, its arguments and its two forms.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import solver as jsolver
from uzliti_slam_tpu_torch.graph import solver as tsolver
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import synthetic as tsynthetic
from uzliti_slam_tpu_torch.kernels import _build
from uzliti_slam_tpu_torch.kernels import ops as kops


def _jax(ef, et, ev, nv, nf, stamp, iters):
    """JAX's labels and gauge (the two functions read only these fields)."""
    g = types.SimpleNamespace(node_capacity=len(nv), e_from=jnp.asarray(ef),
                              e_to=jnp.asarray(et), e_valid=jnp.asarray(ev),
                              node_valid=jnp.asarray(nv), node_fixed=jnp.asarray(nf),
                              stamp=jnp.asarray(stamp))
    lab = jsolver.connected_components(g, iters)
    return np.asarray(lab), np.asarray(jsolver.gauge_fix_mask(g, lab))


def _chain(n):
    ef = np.arange(n - 1, dtype=np.int32)
    return ef, ef + 1, np.ones(n - 1, bool), np.ones(n, bool), np.zeros(n, bool), \
        np.arange(n, dtype=np.float32)


def _random_forest(seed, n=500, e=420):
    """Random edges (some invalid, some self-loops), invalid and pre-fixed
    nodes, integer stamps with ties, ±0 and negative stamps."""
    rng = np.random.default_rng(seed)
    ef = rng.integers(0, n, e).astype(np.int32)
    et = rng.integers(0, n, e).astype(np.int32)
    et[::37] = ef[::37]
    ev = rng.random(e) < 0.9
    nv = rng.random(n) < 0.92
    nf = rng.random(n) < 0.01
    stamp = rng.integers(-5, 40, n).astype(np.float32)
    stamp[rng.random(n) < 0.05] = -0.0
    return ef, et, ev, nv, nf, stamp


def _pose_graph(n, every):
    g = tsynthetic.make_pose_graph(n, loop_closure_every=every, device="cpu",
                                   generator=torch.Generator().manual_seed(0))[0]
    return tuple(t.numpy() for t in (g.e_from, g.e_to, g.e_valid, g.node_valid, g.node_fixed,
                                     g.stamp))


def _fleet():
    """Four 24-node chains with closures, flattened: no edge crosses."""
    ef, et, ev, nv, nf, st = _pose_graph(24, 6)
    E, N = len(ef), len(nv)
    cat = np.concatenate
    return (cat([ef + b * N for b in range(4)]).astype(np.int32),
            cat([et + b * N for b in range(4)]).astype(np.int32),
            cat([ev] * 4), cat([nv] * 4), cat([nf] * 4), cat([st + b for b in range(4)]))


CASES = {
    # a 4,096-node chain in 3 rounds: far from converged, every round changes labels
    "chain_4096_3_rounds": (lambda: _chain(4096), 3),
    "chain_4096_default": (lambda: _chain(4096), None),
    "random_forest_a": (lambda: _random_forest(0), None),
    "random_forest_b": (lambda: _random_forest(1, n=300, e=150), None),
    "pose_graph_1k": (lambda: _pose_graph(1000, 10), None),
    "fleet_4x24": (_fleet, tsolver.component_iterations(24)),
    "no_valid_edge": (lambda: _random_forest(2, n=64, e=0), None),
    "zero_rounds": (lambda: _random_forest(3, n=64, e=64), 0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_components_gauge_matches_jax_bit_for_bit(case):
    make, iters = CASES[case]
    ef, et, ev, nv, nf, stamp = make()
    n = len(nv)
    iters = tsolver.component_iterations(n) if iters is None else iters
    lab_j, gauge_j = _jax(ef, et, ev, nv, nf, stamp, iters)
    t = torch.from_numpy
    rounds = torch.zeros((), dtype=torch.int32)
    kops.reset_launches()
    lab, gauge = kops.components_gauge(t(ef), t(et), t(ev), t(nv), t(nf), t(stamp), n, iters,
                                       rounds=rounds)
    assert lab.dtype == torch.int32 and gauge.dtype == torch.bool
    np.testing.assert_array_equal(lab.numpy(), lab_j)
    np.testing.assert_array_equal(gauge.numpy(), gauge_j)
    assert kops.launches["components"] == 0            # CPU tensors: the plain version
    # the rounds K8 runs: the first round that changes nothing ends them
    ran = int(rounds)
    assert 0 <= ran <= iters
    if ran < iters:
        labels = torch.arange(n, dtype=torch.int32)
        for _ in range(ran):
            labels = kops._components_round(labels, t(ef).long(), t(et).long(), t(ev))
        np.testing.assert_array_equal(labels.numpy(), lab_j)
    if case == "chain_4096_3_rounds":
        assert ran == 3 and lab_j[-1] > 0 and lab_j[5] == 0
    if case == "pose_graph_1k":
        assert ran < iters // 2                        # 20 rounds, stopped far earlier
    # the two functions alone agree with the one call
    np.testing.assert_array_equal(kops.components(t(ef), t(et), t(ev), n, iters).numpy(), lab_j)
    np.testing.assert_array_equal(kops.gauge_fix(lab, t(nv), t(nf), t(stamp)).numpy(), gauge_j)


def _order_key(stamp: np.ndarray) -> np.ndarray:
    """csrc/components.cu:stamp_key: ±0 alike, then the order-preserving
    unsigned map of the bits."""
    u = np.where(stamp == 0, np.float32(0), stamp).astype(np.float32).view(np.uint32)
    return np.where(u >> 31, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _gauge_by_keys(labels, nv, nf, stamp):
    """The kernel's gauge rule: per component the least 64-bit (stamp key,
    slot) over valid nodes and an OR of the valid pre-fixed nodes."""
    n = len(labels)
    key = (_order_key(stamp).astype(np.uint64) << np.uint64(32)) | np.arange(n, dtype=np.uint64)
    least = np.full(n, np.iinfo(np.uint64).max, np.uint64)
    np.minimum.at(least, labels[nv], key[nv])
    fixed = np.zeros(n, bool)
    fixed[labels[nv & nf]] = True
    oldest = nv & ((least[labels] & np.uint64(0xFFFFFFFF)) == np.arange(n, dtype=np.uint64))
    return (nv & nf) | (oldest & ~fixed[labels])


@pytest.mark.parametrize("stamps", ["ties", "signed_zeros", "infinities"])
def test_the_kernels_gauge_keys_pick_the_references_oldest_node(stamps):
    rng = np.random.default_rng(7)
    n = 400
    labels = np.sort(rng.integers(0, 40, n)).astype(np.int32)
    labels = np.minimum(labels, np.arange(n, dtype=np.int32))
    nv = rng.random(n) < 0.85
    nf = rng.random(n) < 0.02
    stamp = {"ties": rng.integers(0, 4, n).astype(np.float32),
             "signed_zeros": np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32),
             "infinities": rng.choice(np.array([-np.inf, np.inf, -3.0, 2.5], np.float32), n)}[
        stamps]
    g = types.SimpleNamespace(node_capacity=n, node_valid=jnp.asarray(nv),
                              node_fixed=jnp.asarray(nf), stamp=jnp.asarray(stamp))
    ref = np.asarray(jsolver.gauge_fix_mask(g, jnp.asarray(labels)))
    np.testing.assert_array_equal(_gauge_by_keys(labels, nv, nf, stamp), ref)
    got = kops.gauge_fix(torch.from_numpy(labels), torch.from_numpy(nv), torch.from_numpy(nf),
                         torch.from_numpy(stamp))
    np.testing.assert_array_equal(got.numpy(), ref)


class _FakeLib:
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


def _k8_inputs(n, e):
    i32, bl = torch.int32, torch.bool
    return (_meta(e, dtype=i32), _meta(e, dtype=i32), _meta(e, dtype=bl), _meta(n, dtype=bl),
            _meta(n, dtype=bl), _meta(n))


def test_k8_routes_by_its_shared_memory():
    cut = max(n for n in range(19_000, 19_400) if kops.components_route(n) == "cta")
    assert kops.components_smem(cut) <= kops._SMEM_BYTES < kops.components_smem(cut + 1)
    assert cut == 19_170
    assert kops.components_route(1000) == kops.components_route(10_000) == "cta"
    assert kops.components_route(100_000) == "grid"


@pytest.mark.parametrize("n", [1000, 19_170, 19_171, 100_000])
def test_components_gauge_is_one_launch(fake_lib, n):
    """The solves' K8: one uz_components_gauge launch with the labels, the
    gauge and the rounds out; a scratch of 4N + ⌈N/32⌉ + 3 ints on the grid
    form only."""
    ef, et, ev, nv, nf, stamp = _k8_inputs(n, 2 * n)
    rounds = _meta((), dtype=torch.int32)
    lab, gauge = kops.components_gauge(ef, et, ev, nv, nf, stamp, n, 20, rounds=rounds)
    assert tuple(lab.shape) == tuple(gauge.shape) == (n,)
    assert lab.dtype == torch.int32 and gauge.dtype == torch.bool
    assert [c[0] for c in fake_lib.calls] == ["uz_components_gauge"]
    args = fake_lib.calls[0][1]
    # (e_from, e_to, e_valid, E, N, n_iters, labels_in, node_valid, node_fixed,
    # stamp, labels, gauge, rounds, scratch, stream)
    assert len(args) == len(_build.SIGNATURES["uz_components_gauge"]) == 15
    assert args[3:7] == (2 * n, n, 20, None)
    assert all(a is not None for a in args[7:13])
    assert (args[13] is None) == (kops.components_route(n) == "cta")
    assert kops.launches["components"] == 1


def test_components_alone_and_gauge_alone_are_one_launch_each(fake_lib):
    n = 100_000
    ef, et, ev, nv, nf, stamp = _k8_inputs(n, 2 * n)
    lab = kops.components(ef, et, ev, n, 34)
    args = fake_lib.calls[-1][1]
    assert args[3:7] == (2 * n, n, 34, None) and args[7:10] == (None, None, None)
    assert args[10] is not None and args[11] is None and args[12] is None
    gauge = kops.gauge_fix(lab, nv, nf, stamp)
    args = fake_lib.calls[-1][1]
    # the gauge from given labels: no edges, no rounds, no labels out
    assert args[3:6] == (0, n, 0) and args[6] is not None and args[10] is None
    assert args[11] is not None and tuple(gauge.shape) == (n,)
    assert [c[0] for c in fake_lib.calls] == ["uz_components_gauge"] * 2
    assert kops.launches["components"] == 2
    # the solve's helper: one launch with the graph's fields
    g = tstate.empty_graph(64, 128, device="cpu").to("meta")
    tsolver.components_and_gauge(g)
    args = fake_lib.calls[-1][1]
    assert args[3:6] == (128, 64, tsolver.component_iterations(64))
    assert kops.launches["components"] == 3


def test_k8_argument_checks_raise(fake_lib):
    n = 64
    ef, et, ev, nv, nf, stamp = _k8_inputs(n, 80)
    with pytest.raises(TypeError, match="e_valid: dtype"):
        kops.components_gauge(ef, et, _meta(80, dtype=torch.int32), nv, nf, stamp, n, 8)
    with pytest.raises(TypeError, match="stamp: dtype"):
        kops.components_gauge(ef, et, ev, nv, nf, _meta(n, dtype=torch.float64), n, 8)
    with pytest.raises(ValueError, match="node_fixed: shape"):
        kops.components_gauge(ef, et, ev, nv, _meta(n + 1, dtype=torch.bool), stamp, n, 8)
    with pytest.raises(ValueError, match="rounds: shape"):
        kops.components_gauge(ef, et, ev, nv, nf, stamp, n, 8,
                              rounds=_meta(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="node_valid: shape"):
        kops.gauge_fix(_meta(n - 1, dtype=torch.int32), nv, nf, stamp)
    with pytest.raises(TypeError, match="labels: dtype"):
        kops.gauge_fix(_meta(n, dtype=torch.int64), nv, nf, stamp)
    assert fake_lib.calls == [] and kops.launches["components"] == 0
