"""Port parity: the GIST bank and ``gist_query`` (K16's plain version on the
CPU), the feature-set bank and ``feature_set_query`` (K21's), the feature
repository's ``repository_add`` and ``repository_query`` (K22's) and
``mask_existing_pairs`` against JAX's, on the cases of
tests/test_recognition.py and on planted ties.

Hamming distances are integers, and a similarity is one float32 division
of integers: slots, distances, similarities, votes, flags and every field
of a bank are held exactly, ties to the lower slot (also among the +inf or
-1 of ineligible entries, which fill the k results when fewer are
eligible), nearest descriptors to the first index.  Descriptors are made
with numpy from a seed and given to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.recognition import recognizer as jrec
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.recognition import recognizer as trec


def rand_desc(seed, n, *shape):
    return np.random.default_rng(seed).integers(0, 256, (n, *shape, 32)).astype(np.uint8)


def perturb(desc, n_bits, seed):
    rng = np.random.default_rng(seed)
    bits = np.unpackbits(desc, axis=-1)
    for row in bits.reshape(-1, 256):
        row[rng.choice(256, n_bits, replace=False)] ^= 1
    return np.packbits(bits, axis=-1)


def _banks(capacity, entries):
    """The same bank built on both sides from (slot, desc, stamp) entries."""
    bj, bt = jrec.gist_bank_init(capacity), trec.gist_bank_init(capacity, device="cpu")
    for slot, d, stamp in entries:
        bj = jrec.gist_bank_add(bj, jnp.asarray(slot), jnp.asarray(d), jnp.asarray(stamp, jnp.float32))
        bt = trec.gist_bank_add(bt, slot, torch.from_numpy(d), stamp)
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return bj, bt


def _query_both(bj, bt, q, stamp, **kw):
    ref = jrec.gist_query(bj, jnp.asarray(q), jnp.asarray(stamp, jnp.float32), **kw)
    got = trec.gist_query(bt, torch.from_numpy(q), stamp, **kw)
    for a, b, name in zip(got, ref, ("slots", "dists", "ok")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    return [x.numpy() for x in got]


def test_finds_similar_scene():
    descs = rand_desc(0, 20)
    bj, bt = _banks(64, [(i, descs[i], float(i)) for i in range(20)])
    q = perturb(descs[7:8], 8, 1)[0]
    slots, dists, ok = _query_both(bj, bt, q, 100.0, k=5, max_dist=30.0)
    assert ok[0] and slots[0] == 7 and dists[0] <= 10


def test_time_gate():
    d = rand_desc(2, 1)[0]
    bj, bt = _banks(16, [(0, d, 10.0)])
    _, _, ok = _query_both(bj, bt, d, 12.0, k=3)
    assert not ok.any()
    slots, _, ok = _query_both(bj, bt, d, 20.0, k=3)
    assert ok[0] and slots[0] == 0


def test_remove():
    d = rand_desc(3, 1)[0]
    bj, bt = _banks(16, [(0, d, 0.0)])
    bj, bt = jrec.gist_bank_remove(bj, jnp.asarray(0)), trec.gist_bank_remove(bt, 0)
    np.testing.assert_array_equal(bt.valid.numpy(), np.asarray(bj.valid))
    _, _, ok = _query_both(bj, bt, d, 100.0, k=3)
    assert not ok.any()
    # a negative slot writes nothing
    bt2 = trec.gist_bank_add(bt, -1, torch.from_numpy(d), 5.0)
    assert all(torch.equal(a, b) for a, b in zip(bt2, bt))


@pytest.mark.parametrize("k", [3, 6, 12])
def test_ties_and_ineligible_padding_match_jax(k):
    base = rand_desc(4, 1)[0]
    descs = rand_desc(5, 12)
    descs[[1, 4, 8]] = base                    # three exact ties at distance 0
    descs[6] = perturb(base[None], 2, 6)[0]
    stamps = [float(i) for i in range(12)]
    stamps[8] = 98.0                          # too close to the query in time
    bj, bt = _banks(12, [(i, descs[i], stamps[i]) for i in range(10)])   # slots 10, 11 unused
    slots, dists, ok = _query_both(bj, bt, base, 100.0, k=k, max_dist=60.0)
    assert list(slots[:3]) == [1, 4, 6] and list(dists[:2]) == [0.0, 0.0]
    if k == 12:   # two invalid slots and the time-gated one fill the tail, lowest slot first
        assert np.isinf(dists[-3:]).all() and list(slots[-3:]) == [8, 10, 11] and not ok[-3:].any()


def test_masks_existing():
    e_from = np.array([0, 2, 5], np.int32)
    e_to = np.array([1, 3, 6], np.int32)
    e_valid = np.array([True, True, False])
    ca = np.array([1, 3, 5, 7], np.int32)
    cb = np.array([0, 2, 6, 8], np.int32)
    ref = np.asarray(jrec.mask_existing_pairs(*map(jnp.asarray, (e_from, e_to, e_valid, ca, cb))))
    got = trec.mask_existing_pairs(*map(torch.from_numpy, (e_from, e_to, e_valid, ca, cb))).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [False, False, True, True])


# ---------------------------------------------------------------------------
# Feature-set bank (K21)
# ---------------------------------------------------------------------------

def _feature_banks(capacity, F, entries, min_descriptors=10):
    """The same feature-set bank on both sides from (slot, desc, valid,
    stamp) entries."""
    bj, bt = jrec.feature_bank_init(capacity, F), trec.feature_bank_init(capacity, F, device="cpu")
    for slot, d, v, stamp in entries:
        bj = jrec.feature_bank_add(bj, jnp.asarray(slot), jnp.asarray(d), jnp.asarray(v),
                                   jnp.asarray(stamp, jnp.float32), min_descriptors=min_descriptors)
        bt = trec.feature_bank_add(bt, slot, torch.from_numpy(d), torch.from_numpy(v), stamp,
                                   min_descriptors=min_descriptors)
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return bj, bt


def _feature_query_both(bj, bt, q, qv, stamp, **kw):
    ref = jrec.feature_set_query(bj, jnp.asarray(q), jnp.asarray(qv),
                                 jnp.asarray(stamp, jnp.float32), **kw)
    got = trec.feature_set_query(bt, torch.from_numpy(q), torch.from_numpy(qv), stamp, **kw)
    for a, b, name in zip(got, ref, ("slots", "sims", "ok")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    return [x.numpy() for x in got]


def test_feature_set_revisit_detection():
    F = 32
    scenes = rand_desc(10, 5, F)
    ones = np.ones(F, bool)
    bj, bt = _feature_banks(16, F, [(i, scenes[i], ones, float(i)) for i in range(5)])
    q = perturb(scenes[3], 4, 11)
    slots, sims, ok = _feature_query_both(bj, bt, q, ones, 50.0, k=3, hamming_thresh=20.0,
                                          min_similarity=0.5)
    assert ok[0] and slots[0] == 3 and sims[0] > 0.9


def test_feature_set_min_descriptor_gate():
    F = 32
    d = rand_desc(12, F)
    dv = np.arange(F) < 5                               # only 5 valid
    bj, bt = _feature_banks(8, F, [(0, d, dv, 0.0)])
    assert not bool(bt.valid[0])
    _, _, ok = _feature_query_both(bj, bt, d, dv, 100.0, k=3, hamming_thresh=20.0,
                                   min_similarity=0.1)
    assert not ok.any()


def test_feature_set_unrelated_scene():
    F = 32
    ones = np.ones(F, bool)
    bj, bt = _feature_banks(8, F, [(0, rand_desc(13, F), ones, 0.0)])
    _, sims, ok = _feature_query_both(bj, bt, rand_desc(14, F), ones, 100.0, k=3,
                                      hamming_thresh=20.0, min_similarity=0.3)
    assert not ok.any()


@pytest.mark.parametrize("k", [4, 12])
def test_feature_set_ties_gates_and_invalid_descriptors(k):
    """Equal votes at several slots (lower slot first), a node whose only
    close descriptors are invalid, a time-gated node, a removed node, an
    invalid query descriptor and unused slots filling the tail with -1."""
    F = 16
    base = rand_desc(15, F)
    q = perturb(base, 3, 16)
    qv = np.ones(F, bool)
    qv[5] = False
    half = np.where(np.arange(F)[:, None] < 8, base, rand_desc(17, F))   # 8 of 16 close
    masked = np.ones(F, bool)
    masked[:8] = False                                                 # its close ones invalid
    ones = np.ones(F, bool)
    entries = [(0, rand_desc(18, F), ones, 0.0), (1, half, ones, 1.0), (2, half, masked, 2.0),
               (3, half, ones, 3.0), (4, base, ones, 98.0), (5, half, ones, 5.0),
               (6, base, ones, 6.0)]
    bj, bt = _feature_banks(12, F, entries, min_descriptors=4)
    bj, bt = jrec.feature_bank_remove(bj, jnp.asarray(6)), trec.feature_bank_remove(bt, 6)
    slots, sims, ok = _feature_query_both(bj, bt, q, qv, 100.0, k=k, hamming_thresh=20.0,
                                          min_similarity=0.2)
    assert list(slots[:3]) == [1, 3, 5] and sims[0] == sims[1] == sims[2]
    if k == 12:
        assert list(slots[3:5]) == [0, 2] and sims[3] == sims[4] == 0.0
        assert (sims[-7:] == -1.0).all() and list(slots[-7:]) == [4, 6, 7, 8, 9, 10, 11]


def test_feature_set_empty_bank_and_empty_query():
    F = 8
    bj, bt = _feature_banks(6, F, [])
    slots, sims, ok = _feature_query_both(bj, bt, rand_desc(19, F), np.ones(F, bool), 10.0, k=6)
    assert list(slots) == list(range(6)) and (sims == -1.0).all() and not ok.any()
    ones = np.ones(F, bool)
    bj, bt = _feature_banks(6, F, [(0, rand_desc(20, F), ones, 0.0)], min_descriptors=2)
    # no valid query descriptor: sim 0 / max(0, 1)
    _, sims, ok = _feature_query_both(bj, bt, rand_desc(20, F), np.zeros(F, bool), 10.0, k=2,
                                      min_similarity=0.0)
    assert sims[0] == 0.0 and ok[0]


# ---------------------------------------------------------------------------
# Feature repository (K22)
# ---------------------------------------------------------------------------

def _flip(desc, lo, hi):
    """``desc`` with bits lo..hi-1 flipped."""
    bits = np.unpackbits(desc, axis=-1, bitorder="little")
    bits[..., lo:hi] ^= 1
    return np.packbits(bits, axis=-1, bitorder="little")


def _repos_equal(rt, rj):
    for name, a, b in zip(rt._fields, rt, rj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def _add_both(rj, rt, slot, d, v, stamp, thresh=30.0):
    rj = jrec.repository_add(rj, jnp.asarray(slot), jnp.asarray(d), jnp.asarray(v),
                             jnp.asarray(stamp, jnp.float32), match_thresh=thresh)
    rt = trec.repository_add(rt, slot, torch.from_numpy(d), torch.from_numpy(v), stamp,
                             match_thresh=thresh)
    _repos_equal(rt, rj)
    return rj, rt


def _repo_query_both(rj, rt, q, qv, stamp, **kw):
    ref = jrec.repository_query(rj, jnp.asarray(q), jnp.asarray(qv),
                                jnp.asarray(stamp, jnp.float32), **kw)
    got = trec.repository_query(rt, torch.from_numpy(q), torch.from_numpy(qv), stamp, **kw)
    for a, b, name in zip(got, ref, ("slots", "votes", "ok")):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    return [x.numpy() for x in got]


def _repository_frames(F=12, n=9, seed=21):
    """A sequence of frames over a pool of 60 prototypes, three of them in
    every frame (their link rows fill): revisits (a prototype a few bits
    off), in-frame near-duplicates, two descriptors of one frame near the
    same stored one (same target), invalid slots, and a descriptor T
    equidistant from two stored ones, a (frame 1) and b (frame 2), 40 bits
    apart (frame 3: the first index wins)."""
    rng = np.random.default_rng(seed)
    pool = rand_desc(seed, 60)
    frames = []
    for i in range(n):
        idx = np.concatenate([[0, 1, 2], rng.choice(np.arange(3, 60), F - 3, replace=False)])
        d = np.stack([perturb(pool[j][None], int(rng.integers(0, 6)), seed + 100 * i + j)[0]
                      for j in idx])
        d[1] = perturb(d[0][None], 2, seed + i)[0]              # an in-frame duplicate
        d[3] = perturb(d[2][None], 3, seed + 50 + i)[0]         # the same target as d[2]
        v = rng.random(F) > 0.15
        v[:4] = True
        frames.append((d, v))
    t = rand_desc(seed + 1, 1)[0]
    for i, desc in ((1, _flip(t, 0, 20)), (2, _flip(t, 20, 40)), (3, t)):
        frames[i][0][4], frames[i][1][4] = desc, True
    return frames, _flip(t, 0, 20), _flip(t, 20, 40)


@pytest.mark.parametrize("dcap, lcap", [(256, 4), (40, 3), (16, 2)])
def test_repository_add_sequence_matches_jax(dcap, lcap):
    """Every field after each add, with same-target collisions, in-frame
    duplicates, the descriptor bank full (40 and 16) and full link rows;
    the query after each add."""
    frames, a, b = _repository_frames()
    rj = jrec.repository_init(dcap, lcap, 16)
    rt = trec.repository_init(dcap, lcap, 16, device="cpu")
    for i, (d, v) in enumerate(frames):
        rj, rt = _add_both(rj, rt, i, d, v, float(i))
        _repo_query_both(rj, rt, d, v, float(i) + 10.0, k=5, min_votes=2)
    if dcap < 256:
        assert int(rt.num_desc) == dcap
    assert bool(rt.link_valid.all(-1).any())                  # some link row is full
    if dcap == 256:
        # frame 3's T, 20 bits from both a and b, linked to a: the first index
        rows = rt.desc.numpy()
        ia, ib = (int(np.flatnonzero((rows == x).all(-1))[0]) for x in (a, b))
        assert ia < ib
        assert 3 in rt.links[ia].numpy()[rt.link_valid[ia].numpy()]
        assert 3 not in rt.links[ib].numpy()[rt.link_valid[ib].numpy()]


def test_repository_same_target_writes_one_link():
    F = 4
    d0 = rand_desc(30, F)
    rj, rt = jrec.repository_init(32, 4, 8), trec.repository_init(32, 4, 8, device="cpu")
    ones = np.ones(F, bool)
    rj, rt = _add_both(rj, rt, 0, d0, ones, 0.0)
    # two descriptors of frame 1 near stored descriptor 2, far from each other
    d1 = rand_desc(31, F)
    d1[0], d1[1] = _flip(d0[2], 0, 16), _flip(d0[2], 16, 32)
    rj, rt = _add_both(rj, rt, 1, d1, ones, 1.0)
    assert int(rt.link_valid[2].sum()) == 2 and list(rt.links[2, :2].numpy()) == [0, 1]


def test_repository_dedup_voting_and_no_false_positive():
    F = 16
    shared = rand_desc(32, F)
    ones = np.ones(F, bool)
    rj, rt = jrec.repository_init(256, 4, 32), trec.repository_init(256, 4, 32, device="cpu")
    rj, rt = _add_both(rj, rt, 0, shared, ones, 0.0)
    rj, rt = _add_both(rj, rt, 1, shared, ones, 1.0)
    assert int(rt.num_desc) == F
    slots, votes, ok = _repo_query_both(rj, rt, shared, ones, 100.0, k=3, min_votes=5)
    assert {0, 1} <= set(slots[ok].tolist()) and votes[0] == votes[1] == F
    _, _, ok = _repo_query_both(rj, rt, rand_desc(33, F), ones, 100.0, k=3, min_votes=2)
    assert not ok.any()
    # an empty repository: every node -1, slots in order
    rj0, rt0 = jrec.repository_init(8, 2, 4), trec.repository_init(8, 2, 4, device="cpu")
    slots, votes, _ = _repo_query_both(rj0, rt0, shared, ones, 0.0, k=4)
    assert list(slots) == [0, 1, 2, 3] and (votes == -1).all()


def test_repository_add_with_ok_false_is_a_no_op():
    rt = trec.repository_init(16, 2, 4, device="cpu")
    d = torch.from_numpy(rand_desc(34, 4))
    rt2 = trec.repository_add(rt, 1, d, torch.ones(4, dtype=torch.bool), 3.0,
                              ok=torch.tensor(False))
    assert all(torch.equal(a, b) for a, b in zip(rt2, rt))


# ---------------------------------------------------------------------------
# K21 and K22 at the edges of their tiles (16 query rows x 8 stored columns,
# a node's stage, a CTA's tile of stored descriptors), on CPU tensors
# ---------------------------------------------------------------------------

def _feature_bank_both(desc, desc_valid, stamp, valid):
    bj = jrec.FeatureSetBank(jnp.asarray(desc), jnp.asarray(desc_valid),
                             jnp.asarray(stamp, jnp.float32), jnp.asarray(valid))
    bt = trec.FeatureSetBank(torch.from_numpy(desc), torch.from_numpy(desc_valid),
                             torch.from_numpy(stamp.astype(np.float32)), torch.from_numpy(valid))
    return bj, bt


@pytest.mark.parametrize("Fq, Fb, N, k, case", [
    (1, 9, 133, 133, "mixed"), (17, 1, 1, 1, "mixed"), (255, 9, 133, 5, "mixed"),
    (17, 9, 133, 7, "ineligible"), (17, 9, 40, 40, "invalid_bank"), (16, 8, 133, 9, "ties"),
    (17, 9, 40, 40, "thresh_inf")],
    ids=["Fq1-N133-k=N", "Fb1-N1", "Fq255", "all-ineligible", "invalid-bank", "ties",
         "thresh-inf"])
def test_feature_set_query_at_tile_edges_matches_jax(Fq, Fb, N, k, case):
    """Query counts either side of a 16-row strip, stored counts either side
    of an 8-column tile, one node and 133 (past one CTA's nodes), k = N,
    every node ineligible, a wholly invalid bank, a threshold of +inf (every
    valid query votes for every node), and equal sims at slots far apart;
    half the nodes near the query, a few bits off."""
    rng = np.random.default_rng(100 + Fq + Fb + N)
    q = rand_desc(200 + Fq, Fq)
    qv = rng.random(Fq) < 0.9
    qv[0] = True
    desc = rand_desc(300 + N, N, Fb)
    near = (rng.random(N) < 0.5) & (case != "ties")
    for n in np.flatnonzero(near):
        pick = rng.integers(0, Fq, Fb)
        desc[n] = perturb(q[pick], int(rng.integers(0, 30)), int(n))
    desc_valid = rng.random((N, Fb)) < 0.8
    stamp = rng.permutation(N).astype(np.float32)
    valid = rng.random(N) < 0.9
    if case == "ties":                       # the same node at slots 3, 70 and 131
        desc[3], desc_valid[3] = perturb(q[:Fb], 3, 3), True
        for n in (70, 131):
            desc[n], desc_valid[n], valid[n] = desc[3], desc_valid[3], True
        valid[3] = True
    if case == "invalid_bank":
        desc_valid[:] = False
    bj, bt = _feature_bank_both(desc, desc_valid, stamp, valid)
    qs = 1000.0 if case != "ineligible" else 50.0
    kw = dict(k=k, hamming_thresh=float("inf") if case == "thresh_inf" else 40.0,
              min_similarity=0.1, min_dt=5.0 if case != "ineligible" else 1e4)
    if case == "thresh_inf":                 # a node with no valid descriptor still votes
        desc_valid[3] = False
        bj, bt = _feature_bank_both(desc, desc_valid, stamp, valid)
    slots, sims, ok = _feature_query_both(bj, bt, q, qv, qs, **kw)
    if case == "thresh_inf":
        assert (sims[valid[slots]] == 1.0).all()
    if case == "ineligible":
        assert (sims == -1.0).all() and list(slots) == list(range(k))
    if case == "invalid_bank":
        assert (sims[valid[slots]] == 0.0).all() and not ok.any()
    if case == "ties":
        s = list(slots)
        assert s.index(3) < s.index(70) < s.index(131)


def _repo_both(desc, desc_valid, links, link_valid, node_stamp, node_valid):
    rj = jrec.FeatureRepository(jnp.asarray(desc), jnp.asarray(desc_valid), jnp.asarray(links),
                                jnp.asarray(link_valid), jnp.asarray(int(desc_valid.sum()), jnp.int32),
                                jnp.asarray(node_stamp, jnp.float32), jnp.asarray(node_valid))
    rt = trec.FeatureRepository(torch.from_numpy(desc), torch.from_numpy(desc_valid),
                                torch.from_numpy(links), torch.from_numpy(link_valid),
                                torch.tensor(int(desc_valid.sum()), dtype=torch.int32),
                                torch.from_numpy(node_stamp.astype(np.float32)),
                                torch.from_numpy(node_valid))
    return rj, rt


@pytest.mark.parametrize("F, D, N, k, case", [
    (1, 300, 133, 133, "mixed"), (17, 9, 1, 1, "mixed"), (255, 520, 133, 5, "mixed"),
    (17, 300, 133, 7, "ineligible"), (17, 300, 40, 40, "invalid_bank"),
    (16, 300, 133, 9, "ties"), (17, 300, 40, 40, "thresh_inf")],
    ids=["F1-N133-k=N", "D9-N1", "F255", "all-ineligible", "invalid-bank", "ties",
         "thresh-inf"])
def test_repository_search_and_query_at_tile_edges_match_jax(F, D, N, k, case):
    """repository_add (K22's search: nearest, first index among ties,
    in-frame duplicates) and repository_query (K22's votes) at query counts
    either side of a 16-row strip, D either side of a 64-descriptor tile,
    one node and 133, k = N, every node ineligible, a wholly invalid bank,
    a threshold of +inf, and a query's nearest stored descriptor repeated
    at indices 10, 75 and 260 (three tiles apart)."""
    rng = np.random.default_rng(500 + F + D + N)
    L = 3
    q = rand_desc(600 + F, F)
    qv = rng.random(F) < 0.9
    qv[0] = True
    if F > 4:
        q[3] = perturb(q[1][None], 2, 7)[0]             # an in-frame duplicate of query 1
    desc = rand_desc(700 + D, D)
    for i in rng.choice(D, min(D, 2 * F), replace=False):
        desc[i] = perturb(q[rng.integers(0, F)][None], int(rng.integers(0, 40)), int(i))[0]
    desc_valid = rng.random(D) < 0.85
    if case == "ties":
        for i in (10, 75, 260):
            desc[i], desc_valid[i] = perturb(q[0][None], 5, 1)[0], True
    if case == "invalid_bank":
        desc_valid[:] = False
    links = rng.integers(0, N, (D, L)).astype(np.int32)
    link_valid = rng.random((D, L)) < 0.6
    node_stamp = rng.permutation(N).astype(np.float32)
    node_valid = rng.random(N) < 0.9
    rj, rt = _repo_both(desc, desc_valid, links, link_valid, node_stamp, node_valid)
    qs = 1000.0 if case != "ineligible" else 50.0
    thresh = float("inf") if case == "thresh_inf" else 40.0
    slots, votes, _ = _repo_query_both(rj, rt, q, qv, qs, k=k, match_thresh=thresh, min_votes=1,
                                       min_dt=5.0 if case != "ineligible" else 1e4)
    if case == "thresh_inf":                 # invalid stored descriptors vote too (inf <= inf)
        linked = np.zeros(N, np.int64)
        np.add.at(linked, links[link_valid], 1)
        eligible = node_valid & (np.abs(node_stamp - qs) >= 5.0)
        assert (votes == np.where(eligible, linked, -1)[slots]).all()
        return
    if case == "ineligible":
        assert (votes == -1).all() and list(slots) == list(range(k))
    # the search, through the whole add: the repositories after it agree
    rj2, rt2 = _add_both(rj, rt, min(2, N - 1), q, qv, 2000.0, thresh=40.0)
    nn_dist, nn_idx, dup = kops.repo_nearest_plain(
        torch.from_numpy(q), torch.from_numpy(qv), rt.desc, rt.desc_valid, 40.0)
    if case == "ties":
        assert int(nn_idx[0]) == 10 and float(nn_dist[0]) <= 5.0
    if case == "invalid_bank":
        assert torch.isinf(nn_dist).all() and (nn_idx == 0).all()
    if F > 4:
        assert bool(dup[3])
