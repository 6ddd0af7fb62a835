"""The port's graph lifecycle against JAX's, on the CPU.

``graph/lifecycle.py`` of both packages: the scope window, eviction, the
merge-pair search (the plain version of kernel K19), merging, compaction,
and ``lie.pose_interpolate`` / ``quat_slerp``.  The JAX side is called
under ``jax.jit``, as the pipeline calls it: compiled, XLA on the CPU
contracts each multiply into the add that consumes it, and the port's
gates follow that form.  Held, with their reasons:

- the scope masks, eviction, the merge pairs (keep, absorb, ok),
  compaction and every index and validity field: exactly (discrete; the
  pair order is the order of the float32 distances, which the port computes
  bit for bit);
- merged poses and rewired transforms within 1e-5 (the same float32
  formulas of the lie ops, contracted on one side);
- ``pose_interpolate`` and ``quat_slerp`` within 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import lifecycle as jlife
from uzliti_slam_tpu.graph import state as jstate
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu_torch.graph import lifecycle as tlife
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import synthetic as tsyn
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie as tlie

FAR = np.array([100.0, 0, 0, 1.0, 0, 0, 0], np.float32)   # a robot centre far from the graph
INDEX_FIELDS = ("e_from", "e_to", "e_valid", "node_valid", "merged_into", "node_fixed",
                "node_uid", "num_nodes", "num_edges", "e_type")


def _to_port(g):
    return tstate.from_numpy({k: np.asarray(v) for k, v in g._asdict().items()}, device="cpu")


def _graph(n, seed=0, **kw):
    """A circle graph (the synthetic generator's, seeded; 64 node and 128
    edge slots: one compiled shape on the JAX side) as a JAX GraphState."""
    g, _ = tsyn.make_pose_graph(n, node_capacity=64, edge_capacity=128, device="cpu",
                                generator=torch.Generator().manual_seed(seed), **kw)
    return jstate.GraphState(**{k: jnp.asarray(v) for k, v in tstate.to_numpy(g).items()})


def _t(x):
    return torch.from_numpy(np.array(x))


def _revisit_graph(n=40, loops=2.0):
    """tests/test_lifecycle.py's dense revisit graph: two noise-free laps."""
    return _graph(n, odom_noise=0.0, rot_noise=0.0, loops=loops, radius=3.0)


def _noisy_graph(n=60, seed=3):
    """Three noisy laps of a 1 m circle: many close pairs at distinct
    distances, some at the angle gate."""
    return _graph(n, seed, loops=3.0, radius=1.0, loop_closure_every=7)


def _duplicate_graph():
    """Nodes stacked in groups of identical poses: many pairs at dt = 0, so
    the flat index decides every round."""
    g = _graph(30, radius=3.0)
    idx = np.arange(64) // 3 * 3
    return g._replace(pose=g.pose[idx])


_GATES = ("dist_thresh", "angle_thresh_deg", "margin", "max_pairs")
_jax_pairs = jax.jit(jlife.find_merge_pairs, static_argnames=_GATES)
_jax_merge_step = jax.jit(jlife.merge_step, static_argnames=_GATES)


def _assert_graphs(gt, gj, atol=1e-5):
    for name in INDEX_FIELDS:
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)),
                                      err_msg=name)
    for name in ("pose", "e_transform"):
        np.testing.assert_allclose(getattr(gt, name).numpy(), np.asarray(getattr(gj, name)),
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("unc", [0.0, 10.0, 79.0, 80.0, 200.0, 1234.5])
def test_scope_radius_matches_jax(unc):
    got = tlife.scope_radius(torch.tensor(unc, dtype=torch.float32), 8.0, 0.1)
    ref = jlife.scope_radius(jnp.asarray(unc, jnp.float32), 8.0, 0.1)
    assert float(got) == float(ref)


@pytest.mark.parametrize("with_shipped", [False, True])
def test_out_of_scope_mask_and_eviction_match_jax(with_shipped):
    g = _graph(50, radius=10.0)
    # a GPS anchor far away: never evicted
    g = g._replace(node_uid=g.node_uid.at[7].set(jstate.GPS_ANCHOR_UID))
    center = g.pose[49]
    rng = np.random.default_rng(0)
    shipped = rng.random(g.node_capacity) < 0.7 if with_shipped else None
    f = jax.jit(lambda g, c, r, s: jlife.out_of_scope_mask(g, c, r, 4.0, shipped=s))
    ref = np.asarray(f(g, center, jnp.asarray(8.0), None if shipped is None else jnp.asarray(shipped)))
    gt = _to_port(g)
    got = tlife.out_of_scope_mask(gt, gt.pose[49], torch.tensor(8.0), 4.0,
                                  shipped=None if shipped is None else torch.from_numpy(shipped))
    np.testing.assert_array_equal(got.numpy(), ref)
    assert ref.any() and not ref[7]
    g_ref = jax.jit(jlife.evict_nodes)(g, jnp.asarray(ref))
    _assert_graphs(tlife.evict_nodes(gt, got), g_ref, atol=0)


@pytest.mark.parametrize("case", ["revisit", "noisy", "duplicates", "none eligible",
                                  "inside scope", "few pairs"])
def test_find_merge_pairs_exact(case):
    kw = dict(dist_thresh=0.3, angle_thresh_deg=20.0)
    center, radius = jnp.asarray(FAR), jnp.asarray(1.0)
    if case == "revisit":
        g = _revisit_graph()
    elif case == "noisy":
        g, kw = _noisy_graph(), dict(dist_thresh=0.25, angle_thresh_deg=15.0, margin=6.0)
    elif case == "duplicates":
        g = _duplicate_graph()
    elif case == "none eligible":
        g = _revisit_graph()
        center = jnp.asarray(np.array([0, 0, 0, 1.0, 0, 0, 0], np.float32))
        radius = jnp.asarray(50.0)
    elif case == "inside scope":   # only the far side of the laps is eligible
        g = _revisit_graph()
        center = g.pose[5]
        radius = jnp.asarray(1.0)
        kw = dict(kw, margin=1.0)
    else:   # 1.2 laps: fewer than 16 pairs, the last rounds find nothing
        g = _revisit_graph(loops=1.2)
    ki, ai, ok = _jax_pairs(g, center, radius, **kw)
    gt = _to_port(g)
    tki, tai, tok = tlife.find_merge_pairs(gt, _t(center), _t(radius), **kw)
    np.testing.assert_array_equal(tki.numpy(), np.asarray(ki))
    np.testing.assert_array_equal(tai.numpy(), np.asarray(ai))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(ok))
    n_ok = int(np.asarray(ok).sum())
    if case in ("none eligible",):
        assert n_ok == 0
        assert not tki.any() and not tai.any()
    elif case == "few pairs":
        assert 0 < n_ok < 16 and not tki[n_ok:].any() and not tai[n_ok:].any()
    else:
        assert n_ok > 0


def test_merge_pair_gates_match_compiled_jax():
    """dt bit for bit against the compiled reference; dr to the ulps of
    atan2 (XLA's own polynomial on the CPU against the library's), which
    can move the angle gate only within a few ulps of its threshold."""
    rng = np.random.default_rng(1)
    n = 64
    t = rng.normal(size=(n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q[n // 2:] = q[: n - n // 2] + 0.05 * rng.normal(size=(n - n // 2, 4)).astype(np.float32)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    pose = jnp.asarray(np.concatenate([t, q], 1))

    @jax.jit
    def ref(pose):
        dt = jnp.linalg.norm(jlie.pose_t(pose)[:, None] - jlie.pose_t(pose)[None, :], axis=-1)
        rel = jlie.quat_mul(jlie.quat_conj(jlie.pose_q(pose))[:, None], jlie.pose_q(pose)[None, :])
        return dt, jnp.degrees(jlie.rotation_angle(rel))

    dt_j, dr_j = (np.asarray(x) for x in ref(pose))
    tt, tq = torch.from_numpy(t), torch.from_numpy(q)
    dt, dr = kops.merge_pair_gates_plain(tt[:, None], tq[:, None], tt[None], tq[None])
    np.testing.assert_array_equal(dt.numpy(), dt_j)
    np.testing.assert_allclose(dr.numpy(), dr_j, rtol=4e-7, atol=1e-4)


@pytest.mark.parametrize("case", ["revisit", "noisy", "few pairs"])
def test_merge_step_matches_jax(case):
    if case == "noisy":
        g, kw = _noisy_graph(), dict(dist_thresh=0.25, angle_thresh_deg=15.0)
    else:
        g, kw = _revisit_graph(loops=1.2 if case == "few pairs" else 2.0), dict(
            dist_thresh=0.3, angle_thresh_deg=20.0)
    center, radius = jnp.asarray(FAR), jnp.asarray(1.0)
    g_ref, n_ref = _jax_merge_step(g, center, radius, **kw)
    gt, n = tlife.merge_step(_to_port(g), _t(center), _t(radius), **kw)
    assert int(n) == int(n_ref) > 0
    _assert_graphs(gt, g_ref)
    # the pieces: merge_nodes on the same pairs
    ki, ai, ok = _jax_pairs(g, center, radius, **kw)
    g2 = tlife.merge_nodes(_to_port(g), _t(ki), _t(ai), _t(ok))
    _assert_graphs(g2, jax.jit(jlife.merge_nodes)(g, ki, ai, ok))


def test_merge_nodes_last_slot_follows_the_reference_scatter():
    """Pairs that are not ok write slot N - 1 back with its old value, after
    the ok ones: a merge into or out of the last slot is undone, in the
    reference and in the port alike."""
    g = _graph(64, odom_noise=0.0, rot_noise=0.0, radius=3.0)
    n = g.node_capacity
    ki = jnp.asarray([3, 5, 0, 0], jnp.int32)
    ai = jnp.asarray([n - 1, 9, 0, 0], jnp.int32)
    ok = jnp.asarray([True, True, False, False])
    ref = jax.jit(jlife.merge_nodes)(g, ki, ai, ok)
    got = tlife.merge_nodes(_to_port(g), _t(ki), _t(ai), _t(ok))
    _assert_graphs(got, ref)
    assert bool(got.node_valid[n - 1]) and not bool(got.node_valid[9])


@pytest.mark.parametrize("case", ["evicted", "merged"])
def test_compact_graph_matches_jax(case):
    if case == "evicted":
        g = _graph(40, loop_closure_every=5)
        g = jlife.evict_nodes(g, jnp.zeros((g.node_capacity,), bool).at[5:25].set(True))
    else:
        g, _ = _jax_merge_step(_revisit_graph(), jnp.asarray(FAR), jnp.asarray(1.0),
                               dist_thresh=0.3, angle_thresh_deg=20.0)
    g_ref, perm_ref = jax.jit(jlife.compact_graph)(g)
    gt, perm = tlife.compact_graph(_to_port(g))
    for name, ref in g_ref._asdict().items():
        np.testing.assert_array_equal(getattr(gt, name).numpy(), np.asarray(ref), err_msg=name)
    assert perm.keys() == perm_ref.keys()
    for name, ref in perm_ref.items():
        assert perm[name].dtype == (torch.bool if name == "edge_kept" else torch.int32)
        np.testing.assert_array_equal(perm[name].numpy(), np.asarray(ref), err_msg=name)


def test_pose_interpolate_and_slerp_match_jax():
    rng = np.random.default_rng(2)
    a = np.concatenate([rng.normal(size=(32, 3)), rng.normal(size=(32, 4))], 1).astype(np.float32)
    b = np.concatenate([rng.normal(size=(32, 3)), rng.normal(size=(32, 4))], 1).astype(np.float32)
    a[:, 3:] /= np.linalg.norm(a[:, 3:], axis=1, keepdims=True)
    b[:, 3:] /= np.linalg.norm(b[:, 3:], axis=1, keepdims=True)
    b[:4] = a[:4]   # a zero step: the small-angle branches
    for t in (0.0, 0.25, 0.5, 1.0):
        np.testing.assert_allclose(
            tlie.pose_interpolate(_t(a), _t(b), t).numpy(),
            np.asarray(jax.jit(jlie.pose_interpolate, static_argnums=2)(a, b, t)), rtol=1e-6,
            atol=1e-6)
    ts = rng.uniform(0, 1, 32).astype(np.float32)
    np.testing.assert_allclose(tlie.quat_slerp(_t(a[:, 3:]), _t(b[:, 3:]), _t(ts)).numpy(),
                               np.asarray(jlie.quat_slerp(a[:, 3:], b[:, 3:], jnp.asarray(ts))),
                               atol=1e-6)
    np.testing.assert_allclose(tlie.quat_slerp(_t(a[:, 3:]), _t(b[:, 3:]), 0.3).numpy(),
                               np.asarray(jlie.quat_slerp(a[:, 3:], b[:, 3:], 0.3)), atol=1e-6)
