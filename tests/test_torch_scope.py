"""The port's scope protocol against JAX's, on the CPU.

``parallel/scope.py`` of both packages: ``make_delta``, ``apply_delta``
(with and without ``existing_slots``), ``apply_ack``, ``scope_reply`` and
``apply_scope``, and the plain versions of kernels K31 (``uid_slots``),
K32 (``edge_key_match``) and K33 (``delta_upsert``, ``scope_merge``), which
the port's functions run on CPU tensors.  Graphs come from the port's
seeded generator (64 node and 64 edge slots: one compiled shape on the
JAX side) and deltas from numpy draws; both cross as arrays.  The JAX
functions run under ``jax.jit``.  Held exactly, every field: the results
are integers, flags and copied floats (the information matrices' type
masks multiply by 0 and 1 in the same order on both sides).

Each case is built to hit one of the serial scans' rules: a uid repeated in
one delta, edges whose endpoints arrive in the same delta, in-delta
duplicates behind a table duplicate, an edge to an unknown uid, node and
edge capacity running out mid-delta, ``apply_ack`` over rows past
``num_edges``, a reply with known, unknown, repeated and -1 rows, and a
planted ``scope_reply`` tie.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import lifecycle as jlife
from uzliti_slam_tpu.graph import state as jstate
from uzliti_slam_tpu.parallel import scope as jscope
from uzliti_slam_tpu.runtime import native
from uzliti_slam_tpu_torch.graph import lifecycle as tlife
from uzliti_slam_tpu_torch.graph import solver as tsolver
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import synthetic as tsyn
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import lie as tlie
from uzliti_slam_tpu_torch.parallel import scope as tscope

N_CAP, E_CAP, DN, DE = 64, 64, 16, 32
j_apply_delta = jax.jit(jscope.apply_delta)
j_apply_ack = jax.jit(jscope.apply_ack)
j_apply_scope = jax.jit(jscope.apply_scope)
j_uid_to_slot = jax.jit(jscope.uid_to_slot)


def port_graph(n, seed=0, **kw):
    g, _ = tsyn.make_pose_graph(n, node_capacity=N_CAP, edge_capacity=E_CAP, device="cpu",
                                generator=torch.Generator().manual_seed(seed), **kw)
    return g


def to_jax(g):
    return jstate.GraphState(**{k: jnp.asarray(v) for k, v in tstate.to_numpy(g).items()})


def assert_same(port_nt, jax_nt):
    """Every field of a port structure equal to the JAX one's."""
    got = tscope.to_numpy(port_nt) if hasattr(port_nt, "_asdict") else tstate.to_numpy(port_nt)
    for k, ref in jax_nt._asdict().items():
        if ref is None:
            assert got[k] is None, k
        else:
            np.testing.assert_array_equal(got[k], np.asarray(ref), err_msg=k)


def random_poses(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(size=(n, 3)).astype(np.float32) * 3
    return np.concatenate([t, q], axis=1).astype(np.float32)


def delta_arrays(nodes, edges, seed=0, payload=False):
    """A GraphDelta's arrays: ``nodes`` the uids of its first node rows,
    ``edges`` (from_uid, to_uid, type) of its first edge rows; the other
    rows empty (uid / type -1), every float row drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    n_uid = np.full(DN, -1, np.int32)
    n_uid[:len(nodes)] = nodes
    ef, et, ty = (np.full(DE, -1, np.int32) for _ in range(3))
    for i, (a, b, t) in enumerate(edges):
        ef[i], et[i], ty[i] = a, b, t
    d = dict(
        n_uid=n_uid, n_pose=random_poses(rng, DN), n_odom_pose=random_poses(rng, DN),
        n_stamp=rng.uniform(0, 100, DN).astype(np.float32),
        n_uncertainty=rng.uniform(0, 5, DN).astype(np.float32),
        n_gist=rng.integers(0, 256, (DN, 32), dtype=np.uint8),
        e_from_uid=ef, e_to_uid=et, e_type=ty, e_transform=random_poses(rng, DE),
        e_info=rng.normal(size=(DE, 6, 6)).astype(np.float32),
        e_score=rng.uniform(0, 50, DE).astype(np.float32),
        e_valid=rng.uniform(size=DE) < 0.5,
        odom_params=np.array([1.01, 0.02, -0.01], np.float32))
    if payload:
        d.update(n_desc=rng.integers(0, 256, (DN, 8, 32), dtype=np.uint8),
                 n_desc_valid=rng.uniform(size=(DN, 8)) < 0.7,
                 n_points=rng.normal(size=(DN, 8, 3)).astype(np.float32),
                 n_scan=rng.uniform(0.5, 6, (DN, 90)).astype(np.float32),
                 n_scan_valid=rng.uniform(size=DN) < 0.8,
                 sensor_transforms=random_poses(rng, 2))
    return d


def both_deltas(arrays):
    full = {k: arrays.get(k) for k in jscope.GraphDelta._fields}
    jd = jscope.GraphDelta(**{k: None if v is None else jnp.asarray(v) for k, v in full.items()})
    return tscope.delta_from_numpy(full, device="cpu"), jd


def apply_both(g, arrays, existing=None):
    """Apply one delta on both sides; hold graph and ACK equal.  Returns
    (port graph, port ACK, JAX graph, JAX ACK)."""
    td, jd = both_deltas(arrays)
    jg = to_jax(g)
    if existing is None:
        tg2, tack = tscope.apply_delta(g, td)
        jg2, jack = j_apply_delta(jg, jd)
    else:
        tg2, tack = tscope.apply_delta(g, td, existing_slots=torch.from_numpy(np.array(existing)))
        jg2, jack = j_apply_delta(jg, jd, jnp.asarray(existing))
    assert_same(tg2, jg2)
    assert_same(tack, jack)
    return tg2, tack, jg2, jack


# ---------------------------------------------------------------------------
# The plain versions of K31-K33 against the reference's functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_uid_slots_plain_matches_uid_to_slot(seed):
    """K31's plain version: duplicate uids (the lowest live slot wins),
    dead slots holding a queried uid, -1 and unknown queries."""
    rng = np.random.default_rng(seed)
    g = port_graph(40, seed)
    uid = rng.integers(0, 20, N_CAP).astype(np.int32)
    valid = rng.uniform(size=N_CAP) < 0.6
    g = g.replace(node_uid=torch.from_numpy(uid), node_valid=torch.from_numpy(valid))
    q = np.concatenate([rng.integers(-2, 25, 40), [-1, 19, 0]]).astype(np.int32)
    got = kops.uid_slots_plain(g.node_uid, g.node_valid, torch.from_numpy(q))
    ref = j_uid_to_slot(to_jax(g), jnp.asarray(q))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy() == -1).any() and (got.numpy() >= 0).any()


def test_edge_key_match_plain_matches_the_reference_compares():
    """K32's plain version: apply_delta's per-query duplicate flag over the
    present rows (``scope.py:222-229``) and apply_ack's per-row flag in uid
    space over every row (``:282-288``)."""
    rng = np.random.default_rng(5)
    g = port_graph(30, 3, loop_closure_every=6)
    jg = to_jax(g)
    ne = int(g.num_edges)
    pick = rng.integers(0, ne, 12)
    qa = np.concatenate([np.asarray(jg.e_from)[pick], rng.integers(-1, 30, 8)]).astype(np.int32)
    qb = np.concatenate([np.asarray(jg.e_to)[pick], rng.integers(0, 30, 8)]).astype(np.int32)
    qt = np.concatenate([np.asarray(jg.e_type)[pick], np.zeros(8)]).astype(np.int32)
    qa[3] = -1                                       # an unresolved endpoint
    hit, _ = kops.edge_key_match_plain(*map(torch.from_numpy, (qa, qb, qt)), g.e_from, g.e_to,
                                       g.e_type, num_rows=g.num_edges)
    ref = jnp.any((jg.e_from[None] == qa[:, None]) & (jg.e_to[None] == qb[:, None])
                  & (jg.e_type[None] == qt[:, None])
                  & (jnp.arange(E_CAP)[None] < jg.num_edges), axis=-1) & (qa >= 0)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(ref))
    # uid space, every row (rows past num_edges read slot 0's uid, type 0)
    ua = np.asarray(jg.node_uid)[qa.clip(0)]
    ua[5] = -1
    ub, ut = np.asarray(jg.node_uid)[qb], qt
    ua[-1], ub[-1], ut[-1] = int(jg.node_uid[0]), int(jg.node_uid[0]), 0
    _, rows = kops.edge_key_match_plain(*map(torch.from_numpy, (ua, ub, ut)), g.e_from, g.e_to,
                                        g.e_type, node_uid=g.node_uid)
    ack = jscope.Ack(node_uids=jnp.full((4,), -1, jnp.int32), edge_from=jnp.asarray(ua),
                     edge_to=jnp.asarray(ub), edge_type=jnp.asarray(ut))
    ship = j_apply_ack(jg, jscope.ship_state_init(jg), ack)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(ship.edge_acked))
    assert rows[ne:].any(), "no row past num_edges was matched"


# ---------------------------------------------------------------------------
# apply_delta: the serial scans' rules
# ---------------------------------------------------------------------------

def _resend_case():
    """4 known uids (a resend) and 4 new; edges: 3 resends of table edges, 2
    between new nodes, 2 from a known to a new node, an in-delta duplicate
    of a new edge, an edge to an unknown uid, a laser and a GPS edge (their
    information masked by type)."""
    return delta_arrays([1, 2, 3, 4, 100, 101, 102, 103],
                        [(0, 1, 104), (1, 2, 104), (2, 3, 104), (100, 101, 1), (101, 102, 1),
                         (4, 100, 104), (3, 103, 105), (100, 101, 1), (5, 9999, 1),
                         (102, 103, 4), (1, 103, 2)], seed=1)


CASES = {
    "resend_and_new": _resend_case,
    # a new uid three times and a known uid twice: the first occurrence
    # inserts, the repeats find it
    "repeated_uid": lambda: delta_arrays([200, 3, 200, 201, 3, 200],
                                         [(200, 201, 1), (3, 200, 104)], seed=2),
    # row 0 duplicates a table edge; rows 1-2 repeat its key; row 3 repeats
    # a key whose earlier row has an unknown endpoint (not a blocker)
    "dup_behind_table_dup": lambda: delta_arrays(
        [300], [(0, 1, 104), (0, 1, 104), (0, 1, 104), (0, 1, 7777), (300, 2, 1),
                (300, 2, 1), (1, 0, 104)], seed=3),
    "unknown_endpoint": lambda: delta_arrays([], [(0, 4242, 1), (4242, 1, 1), (1, 2, -1)],
                                             seed=4),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_apply_delta_matches_jax(case):
    g = port_graph(10)
    tg2, tack, _, _ = apply_both(g, CASES[case]())
    if case == "unknown_endpoint":
        assert (tack.edge_from.numpy() == -1).all()
        assert int(tg2.num_edges) == int(g.num_edges)


def test_apply_delta_node_and_edge_capacity_run_out():
    """62 of 64 node slots and 61 of 64 edge slots used: two of four new
    nodes land (a dropped uid repeated stays dropped), three of five new
    edges, and the dropped ones are not ACKed."""
    g = port_graph(62)
    assert int(g.num_nodes) == 62 and int(g.num_edges) == 61
    arrays = delta_arrays([500, 501, 502, 503, 502],
                          [(500, 501, 1), (0, 500, 1), (1, 501, 1), (2, 500, 1), (3, 501, 1),
                           (502, 0, 1)], seed=6)
    tg2, tack, _, _ = apply_both(g, arrays)
    assert int(tg2.num_nodes) == N_CAP and int(tg2.num_edges) == E_CAP
    assert tack.node_uids.tolist()[:5] == [500, 501, -1, -1, -1]
    assert tack.edge_from.tolist()[:6] == [500, 0, 1, -1, -1, -1]


@pytest.mark.parametrize("case", ["resend_and_new", "repeated_uid"])
def test_apply_delta_with_existing_slots_matches_jax(case):
    """``existing_slots`` taken as given: the reference's uid_to_slot of the
    delta's uids, then a stale entry; with it a repeated unknown uid inserts
    once per row, as the reference's scan does."""
    g = port_graph(10)
    arrays = CASES[case]()
    slots = np.asarray(j_uid_to_slot(to_jax(g), jnp.asarray(arrays["n_uid"])))
    apply_both(g, arrays, slots)
    stale = slots.copy()
    stale[0] = 7
    apply_both(g, arrays, stale)


def test_apply_delta_redelivery_after_growth_matches_jax():
    """The same delta twice (a lost ACK), then a second delta that brings
    the endpoints of an earlier un-ACKed edge."""
    g = port_graph(10)
    first = delta_arrays([10, 11], [(10, 11, 1), (11, 12, 1)], seed=7)
    tg, _, _, _ = apply_both(g, first)
    tg, tack, _, _ = apply_both(tg, first)
    assert tack.node_uids.tolist()[:2] == [10, 11] and tack.edge_from.tolist()[:2] == [10, -1]
    tg, tack, _, _ = apply_both(tg, delta_arrays([12], [(11, 12, 1)], seed=8))
    assert tack.edge_from.tolist()[0] == 11


# ---------------------------------------------------------------------------
# make_delta, apply_ack, scope_reply, apply_scope
# ---------------------------------------------------------------------------

def _banks(seed=0):
    rng = np.random.default_rng(seed)
    return dict(gists=rng.integers(0, 256, (N_CAP, 32), dtype=np.uint8),
                desc=rng.integers(0, 256, (N_CAP, 12, 32), dtype=np.uint8),
                desc_valid=rng.uniform(size=(N_CAP, 12)) < 0.7,
                points=rng.normal(size=(N_CAP, 12, 3)).astype(np.float32),
                scans=rng.uniform(0.5, 6, (N_CAP, 90)).astype(np.float32),
                scan_valid=rng.uniform(size=N_CAP) < 0.8)


@pytest.mark.parametrize("max_nodes,max_edges,payload,budget",
                         [(16, 32, False, None), (3, 4, True, None), (16, 32, True, 5)])
def test_make_delta_matches_jax(max_nodes, max_edges, payload, budget):
    g = port_graph(20, 1, loop_closure_every=5)
    rng = np.random.default_rng(2)
    ship = tscope.ShipState(node_acked=torch.from_numpy(rng.uniform(size=N_CAP) < 0.3),
                            edge_acked=torch.from_numpy(rng.uniform(size=E_CAP) < 0.3))
    b = _banks()
    kw = dict(max_nodes=max_nodes, max_edges=max_edges)
    if payload:
        kw.update(desc=b["desc"], desc_valid=b["desc_valid"], points=b["points"],
                  scans=b["scans"], scan_valid=b["scan_valid"], feat_budget=budget,
                  sensor_transforms=random_poses(rng, 2))
    td = tscope.make_delta(g, ship, torch.from_numpy(b["gists"]),
                           **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                              for k, v in kw.items()})
    jd = jscope.make_delta(to_jax(g), jscope.ShipState(*map(jnp.asarray, ship)),
                           jnp.asarray(b["gists"]),
                           **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                              for k, v in kw.items()})
    assert_same(td, jd)


def test_apply_ack_over_rows_past_num_edges_matches_jax():
    """An ACK whose key matches the empty rows past ``num_edges`` (slot 0's
    uid at both ends, type 0) flags them, as the reference's compare has no
    presence mask; node uids repeated, unknown and -1."""
    g = port_graph(12, 4, loop_closure_every=4)
    jg = to_jax(g)
    rng = np.random.default_rng(9)
    u0 = int(jg.node_uid[0])
    ne = int(g.num_edges)
    ef = np.asarray(jg.node_uid)[np.asarray(jg.e_from)[:ne]]
    et = np.asarray(jg.node_uid)[np.asarray(jg.e_to)[:ne]]
    ty = np.asarray(jg.e_type)[:ne]
    pick = rng.permutation(ne)[:6]
    a_from = np.concatenate([ef[pick], [u0, -1, 55]]).astype(np.int32)
    a_to = np.concatenate([et[pick], [u0, et[0], 56]]).astype(np.int32)
    a_ty = np.concatenate([ty[pick], [0, ty[0], 1]]).astype(np.int32)
    a_from[2] = -1                                   # an edge that was not applied
    nodes = np.array([3, 3, 77, -1, 5, 11], np.int32)
    ack = dict(node_uids=nodes, edge_from=a_from, edge_to=a_to, edge_type=a_ty)
    ship = dict(node_acked=rng.uniform(size=N_CAP) < 0.2, edge_acked=rng.uniform(size=E_CAP) < 0.2)
    got = tscope.apply_ack(g, tscope.ship_from_numpy(ship, "cpu"),
                           tscope.ack_from_numpy(ack, "cpu"))
    ref = j_apply_ack(jg, jscope.ShipState(**{k: jnp.asarray(v) for k, v in ship.items()}),
                      jscope.Ack(**{k: jnp.asarray(v) for k, v in ack.items()}))
    assert_same(got, ref)
    assert got.edge_acked[ne:].any()


def test_scope_reply_planted_tie_matches_jax():
    """Three nodes at one pose (equal distances): the lower slots come
    first, as ``lax.top_k``'s; a reply cut in the middle of the tie."""
    g = port_graph(20, 2)
    pose = g.pose.clone()
    for s in (4, 9, 15):
        pose[s] = pose[12]
    g = g.replace(pose=pose)
    jg = to_jax(g)
    center = np.asarray(jg.pose[12]) + np.array([0.3, 0.1, 0, 0, 0, 0, 0], np.float32)
    for k, radius in ((8, 100.0), (2, 100.0), (6, 2.5)):
        got = tscope.scope_reply(g, torch.from_numpy(center), torch.tensor(radius), max_nodes=k)
        ref = jscope.scope_reply(jg, jnp.asarray(center), jnp.asarray(radius, jnp.float32),
                                 max_nodes=k)
        assert_same(got, ref)
    got = tscope.scope_reply(g, torch.from_numpy(center), torch.tensor(100.0), max_nodes=2)
    assert got.uid.tolist() == [int(jg.node_uid[4]), int(jg.node_uid[9])]


def test_apply_scope_known_unknown_repeated_and_empty_rows_match_jax():
    """Known uids (one twice: the last pose wins), unknown uids (one twice:
    inserted once, then updated), -1 rows; then a reply past the node
    capacity (a dropped uid repeated stays dropped)."""
    rng = np.random.default_rng(11)
    uid = np.array([2, 700, -1, 2, 701, 700, 5, -1, 702], np.int32)
    reply = dict(uid=uid, pose=random_poses(rng, uid.size),
                 stamp=rng.uniform(0, 9, uid.size).astype(np.float32))
    for g in (port_graph(8), port_graph(62)):
        got = tscope.apply_scope(g, tscope.reply_from_numpy(reply, "cpu"))
        ref = j_apply_scope(to_jax(g), jscope.ScopeReply(**{k: jnp.asarray(v)
                                                            for k, v in reply.items()}))
        assert_same(got, ref)


# ---------------------------------------------------------------------------
# Twins of tests/test_scope.py and tests/test_calibration.py's delta test
# ---------------------------------------------------------------------------

def _local(n):
    g = tsyn.make_pose_graph(n, node_capacity=32, edge_capacity=64, device="cpu",
                             generator=torch.Generator().manual_seed(0))[0]
    gists = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (32, 32), dtype=np.uint8))
    return g, gists


def _empty():
    return tstate.empty_graph(64, 128, device="cpu")


def test_roundtrip_ships_everything():
    g, gists = _local(10)
    ship = tscope.ship_state_init(g)
    delta = tscope.make_delta(g, ship, gists, max_nodes=16, max_edges=32)
    assert int((delta.n_uid >= 0).sum()) == 10 and int((delta.e_type >= 0).sum()) == 9
    glob, ack = tscope.apply_delta(_empty(), delta)
    assert int(glob.num_nodes) == 10 and int(glob.num_edges) == 9
    assert int((ack.node_uids >= 0).sum()) == 10 and int((ack.edge_from >= 0).sum()) == 9
    ship = tscope.apply_ack(g, ship, ack)
    assert int(ship.node_acked.sum()) == 10 and int(ship.edge_acked.sum()) == 9
    d2 = tscope.make_delta(g, ship, gists, max_nodes=16, max_edges=32)
    assert int((d2.n_uid >= 0).sum()) == 0 and int((d2.e_type >= 0).sum()) == 0


def test_idempotent_redelivery():
    g, gists = _local(8)
    delta = tscope.make_delta(g, tscope.ship_state_init(g), gists, max_nodes=16, max_edges=32)
    glob, _ = tscope.apply_delta(_empty(), delta)
    glob2, ack2 = tscope.apply_delta(glob, delta)
    assert int(glob2.num_nodes) == int(glob.num_nodes)
    assert int(glob2.num_edges) == int(glob.num_edges)
    assert int((ack2.node_uids >= 0).sum()) == 8


def test_edge_without_nodes_skipped_not_acked():
    g, gists = _local(8)
    delta = tscope.make_delta(g, tscope.ship_state_init(g), gists, max_nodes=16, max_edges=32)
    delta = delta._replace(n_uid=torch.full_like(delta.n_uid, -1))
    glob, ack = tscope.apply_delta(_empty(), delta)
    assert int(glob.num_edges) == 0
    assert int((ack.edge_from >= 0).sum()) == 0


def test_incremental_shipping():
    g, gists = _local(6)
    ship = tscope.ship_state_init(g)
    glob = _empty()
    d1 = tscope.make_delta(g, ship, gists, max_nodes=3, max_edges=4)
    glob, ack1 = tscope.apply_delta(glob, d1)
    ship = tscope.apply_ack(g, ship, ack1)
    d2 = tscope.make_delta(g, ship, gists, max_nodes=16, max_edges=32)
    glob, ack2 = tscope.apply_delta(glob, d2)
    ship = tscope.apply_ack(g, ship, ack2)
    assert int(glob.num_nodes) == 6 and int(ship.node_acked.sum()) == 6
    assert int(glob.num_edges) == 5


def test_reply_marks_fixed_in_radius():
    g, _ = _local(10)
    center = g.pose[9]
    reply = tscope.scope_reply(g, center, torch.tensor(3.0), max_nodes=8)
    got = reply.uid.numpy()
    assert (got >= 0).sum() >= 1
    for i, uid in enumerate(got):
        if uid >= 0:
            assert float(torch.linalg.vector_norm(reply.pose[i, :3] - center[:3])) <= 3.0 + 1e-5


def test_apply_scope_freezes_known_and_inserts_unknown():
    g, _ = _local(5)
    ident = torch.tensor([1.0, 0, 0, 0])
    reply = tscope.ScopeReply(
        uid=torch.tensor([2, 777, -1], dtype=torch.int32),
        pose=torch.stack([tlie.make_pose(torch.tensor([9.0, 9.0, 0.0]), ident),
                          tlie.make_pose(torch.tensor([1.0, 2.0, 0.0]), ident),
                          tlie.pose_identity((), "cpu")]),
        stamp=torch.tensor([0.2, 99.0, 0.0]))
    g2 = tscope.apply_scope(g, reply)
    assert bool(g2.node_fixed[2])
    np.testing.assert_allclose(g2.pose[2, :3].numpy(), [9.0, 9.0, 0.0])
    slot = int(tscope.uid_to_slot(g2, torch.tensor([777], dtype=torch.int32))[0])
    assert slot >= 0 and bool(g2.node_fixed[slot])
    assert int(g2.num_nodes) == 6


def test_end_to_end_local_global_convergence():
    g, gists = _local(10)
    delta = tscope.make_delta(g, tscope.ship_state_init(g), gists, max_nodes=16, max_edges=32)
    glob, _ = tscope.apply_delta(_empty(), delta)
    glob_opt, stats = tsolver.optimize(glob, tsolver.SolverConfig(iterations=10))
    assert np.isfinite(float(stats.chi2_history[-1]))
    reply = tscope.scope_reply(glob_opt, g.pose[9], torch.tensor(5.0), max_nodes=4)
    g2 = tscope.apply_scope(g, reply)
    g2_opt, _ = tsolver.optimize(g2, tsolver.SolverConfig(iterations=10))
    for i, uid in enumerate(reply.uid.tolist()):
        if uid >= 0:
            slot = int(tscope.uid_to_slot(g2, torch.tensor([uid], dtype=torch.int32))[0])
            np.testing.assert_allclose(g2_opt.pose[slot].numpy(), reply.pose[i].numpy(),
                                       atol=1e-6)


def test_scope_delta_ships_odom_params():
    """tests/test_calibration.py's delta test: the drift parameters and the
    extrinsics ride along, and the receiver adopts the parameters."""
    p = torch.tensor([1.02, 0.01, -0.02])
    g, _ = tsyn.biased_odometry_graph(p, n=12, closure_every=4, device="cpu")
    g = g.replace(odom_params=p)
    gists = torch.zeros(g.node_capacity, 32, dtype=torch.uint8)
    delta = tscope.make_delta(g, tscope.ship_state_init(g), gists, max_nodes=16, max_edges=32,
                              sensor_transforms=tlie.pose_identity((1,), "cpu"))
    np.testing.assert_allclose(delta.odom_params.numpy(), p.numpy())
    assert delta.sensor_transforms is not None
    g2, _ = tscope.apply_delta(tstate.empty_graph(32, 64, device="cpu"), delta)
    np.testing.assert_allclose(g2.odom_params.numpy(), p.numpy())


# ---------------------------------------------------------------------------
# The reference's stale uid map (ROADMAP C4) and the port's live lookup
# ---------------------------------------------------------------------------

def test_stale_uid_map_corrupts_the_reference_but_not_the_port():
    """The reference's runner keeps a host uid -> slot map, rebuilt only
    after a merge or a compaction.  Invalidate a node another way and
    redeliver it: the map's stale slot makes the reference ACK the node
    without re-inserting it; the port's lookup reads ``node_valid`` and
    re-inserts it."""
    g = port_graph(10)
    jg = to_jax(g)
    uid_map = native.UidMap()
    n = int(g.num_nodes)
    uid_map.insert_batch(np.asarray(jg.node_uid[:n], np.int32), np.arange(n, dtype=np.int32))
    dead = np.zeros(N_CAP, bool)
    dead[3] = True
    jg = jlife.evict_nodes(jg, jnp.asarray(dead))
    g = tlife.evict_nodes(g, torch.from_numpy(dead))
    arrays = delta_arrays([3], [], seed=12)
    td, jd = both_deltas(arrays)
    existing = uid_map.lookup_batch(arrays["n_uid"])
    assert existing[0] == 3                          # stale: slot 3 is dead
    jg2, jack = j_apply_delta(jg, jd, jnp.asarray(existing))
    assert int(jack.node_uids[0]) == 3 and int(jg2.num_nodes) == n
    assert int(j_uid_to_slot(jg2, jnp.asarray([3], jnp.int32))[0]) == -1
    tg2, tack = tscope.apply_delta(g, td)
    assert int(tack.node_uids[0]) == 3 and int(tg2.num_nodes) == n + 1
    assert int(tscope.uid_to_slot(tg2, torch.tensor([3], dtype=torch.int32))[0]) == n


def test_lookup_after_merge_and_compaction():
    """After a merge and a compaction, a merged-away uid resolves to -1 and
    a moved uid to its new slot, with no map to rebuild."""
    g = port_graph(20)
    keep = torch.tensor([2], dtype=torch.int32)
    absorb = torch.tensor([7], dtype=torch.int32)
    g = tlife.merge_nodes(g, keep, absorb, torch.tensor([True]))
    dead = torch.zeros(N_CAP, dtype=torch.bool)
    dead[[0, 1, 4]] = True
    g = tlife.evict_nodes(g, dead)
    uids = torch.tensor([7, 0, 19, 5, 2], dtype=torch.int32)
    before = tscope.uid_to_slot(g, uids)
    assert before.tolist() == [-1, -1, 19, 5, 2]
    g2, perm = tlife.compact_graph(g)
    after = tscope.uid_to_slot(g2, uids)
    inv = perm["node_inv"]
    assert after.tolist() == [-1, -1, int(inv[19]), int(inv[5]), int(inv[2])]
    assert after[2] < 19 and (g2.node_uid[after[2:].long()] == uids[2:]).all()
