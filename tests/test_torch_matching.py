"""Port parity: uzliti_slam_tpu_torch.ops.matching (K16's plain version on
the CPU) against JAX's, on every case of tests/test_matching_ransac.py's
bits, Hamming and match-pipeline classes, and ``match_descriptors`` on
planted ties, the 1e9 padding and the ratio test's edge.

Hamming distances are integers, so everything is held exactly: indices,
flags and distances.  Descriptors are made with numpy from a seed and
given to both (JAX takes unpacked bits, the port packed bytes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.ops import matching as jm
from uzliti_slam_tpu_torch.ops import matching as tm


def rand_desc(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, 32)).astype(np.uint8)


def flip_bits(desc, n_bits, seed):
    """A copy of each descriptor with ``n_bits`` distinct bits flipped."""
    rng = np.random.default_rng(seed)
    bits = np.unpackbits(desc, axis=-1, bitorder="little")
    for row in bits:
        row[rng.choice(256, n_bits, replace=False)] ^= 1
    return np.packbits(bits, axis=-1, bitorder="little")


def _jax_match(a, b, valid_a=None, valid_b=None, ratio=0.99, max_dist=None):
    opt = lambda v: None if v is None else jnp.asarray(v)  # noqa: E731
    out = jm.match_descriptors(jm.unpack_bits(jnp.asarray(a)), jm.unpack_bits(jnp.asarray(b)),
                               valid_a=opt(valid_a), valid_b=opt(valid_b), ratio=ratio,
                               max_dist=max_dist)
    return [np.asarray(x) for x in out]


def _port_match(a, b, valid_a=None, valid_b=None, ratio=0.99, max_dist=None):
    opt = lambda v: None if v is None else torch.from_numpy(np.asarray(v))  # noqa: E731
    out = tm.match_descriptors(torch.from_numpy(a), torch.from_numpy(b), valid_a=opt(valid_a),
                               valid_b=opt(valid_b), ratio=ratio, max_dist=max_dist)
    return [x.numpy() for x in out]


def _assert_same(got, ref):
    for g, r, name in zip(got, ref, ("match_idx", "ok", "best_dist")):
        np.testing.assert_array_equal(g, r, err_msg=name)


def test_pack_unpack_roundtrip():
    packed = rand_desc(0, 40)
    bits = tm.unpack_bits(torch.from_numpy(packed))
    assert bits.shape == (40, 256) and set(np.unique(bits.numpy())) <= {0.0, 1.0}
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jm.unpack_bits(jnp.asarray(packed))))
    np.testing.assert_array_equal(tm.pack_bits(bits).numpy(), packed)


def test_hamming_matches_numpy_popcount_and_jax():
    a, b = rand_desc(1, 30), rand_desc(2, 50)
    dm = tm.hamming_matrix_packed(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=-1).sum(-1)
    np.testing.assert_array_equal(dm, ref)
    np.testing.assert_array_equal(dm, np.asarray(jm.hamming_matrix_packed(jnp.asarray(a),
                                                                          jnp.asarray(b))))
    # a batch of stored sets
    bb = np.stack([b, b[::-1]])
    dmb = tm.hamming_matrix_packed(torch.from_numpy(a), torch.from_numpy(bb)).numpy()
    np.testing.assert_array_equal(dmb[1], ref[:, ::-1])


def test_self_distance_zero():
    a = torch.from_numpy(rand_desc(3, 16))
    assert torch.all(torch.diagonal(tm.hamming_matrix_packed(a, a)) == 0)


def test_finds_permuted_matches():
    a = rand_desc(4, 64)
    perm = np.random.default_rng(5).permutation(64)
    b = a[perm]
    got = _port_match(a, b, ratio=0.99, max_dist=10.0)
    _assert_same(got, _jax_match(a, b, ratio=0.99, max_dist=10.0))
    inv = np.empty(64, dtype=int)
    inv[perm] = np.arange(64)
    mi, ok, _ = got
    assert ok.sum() >= 60
    np.testing.assert_array_equal(mi[ok], inv[ok.nonzero()[0]])


def test_invalid_masks():
    a = rand_desc(6, 16)
    valid_b = np.arange(16) < 8
    got = _port_match(a, a, valid_b=valid_b, ratio=0.8)
    _assert_same(got, _jax_match(a, a, valid_b=valid_b, ratio=0.8))
    assert np.all(got[0][got[1]] < 8)


def _planted():
    """Stored set with exact ties, a query whose best and second tie, one
    that passes the ratio test exactly on its edge (best = fl(0.9·second)),
    one just above it."""
    rng = np.random.default_rng(7)
    stored = rand_desc(8, 24)
    stored[5] = stored[2]                       # duplicates: best and second tie
    stored[9] = stored[2]
    q = flip_bits(stored[[2, 11, 14, 17]], 3, 9)
    # query 1: best 9 bits from stored 11, second at 10: 9 <= fl(0.9 * 10) = 9
    q[1] = flip_bits(stored[11:12], 9, 10)[0]
    stored[12] = flip_bits(q[1:2], 10, 11)[0]
    # query 2: best 10, second 11: 10 > fl(0.9 * 11) = 9.9
    q[2] = flip_bits(stored[14:15], 10, 12)[0]
    stored[15] = flip_bits(q[2:3], 11, 13)[0]
    queries = np.concatenate([q, rand_desc(14, 12)])
    return queries, stored, rng


@pytest.mark.parametrize("case", ["plain", "ratio_only", "valid_b", "valid_a", "one_valid",
                                  "none_valid", "one_valid_at_0"])
def test_match_descriptors_matches_jax_on_planted_cases(case):
    q, s, rng = _planted()
    va, vb = np.ones(len(q), bool), np.ones(len(s), bool)
    kw = dict(ratio=float(np.float32(0.9)), max_dist=64.0)
    if case == "ratio_only":
        kw["max_dist"] = None
    elif case == "valid_b":
        vb = rng.random(len(s)) < 0.6
        vb[[2, 5, 9, 11, 12]] = True
    elif case == "valid_a":
        va = rng.random(len(q)) < 0.5
    elif case == "one_valid":            # second is the 1e9 padding: the ratio test passes
        vb[:] = False
        vb[7] = True
    elif case == "none_valid":           # all 1e9: indices 0 (and 1), never ok
        vb[:] = False
    elif case == "one_valid_at_0":
        vb[:] = False
        vb[0] = True
    got = _port_match(q, s, va, vb, **kw)
    ref = _jax_match(q, s, va, vb, **kw)
    _assert_same(got, ref)
    mi, ok, best = got
    if case == "plain":
        assert mi[0] == 2 and not ok[0]        # ties keep the lower index; 3 <= 0.9·3 fails
        assert ok[1] and best[1] == 9 and not ok[2] and best[2] == 10
    if case == "one_valid":
        assert np.all(mi == 7) and np.array_equal(ok, best <= 64)
    if case == "none_valid":
        assert np.all(mi == 0) and not ok.any() and np.all(best == 1e9)


def test_match_descriptors_batch_and_bank_gather_match_per_candidate():
    q = rand_desc(20, 16)
    bank = np.stack([rand_desc(21 + i, 12) for i in range(5)])
    bank[3, 4] = q[0]
    valid = np.random.default_rng(30).random((5, 12)) < 0.8
    valid[3, 4] = True
    slots = np.array([3, 0, 3, 4], np.int32)
    t = torch.from_numpy
    got = tm.match_against_bank(t(q), torch.ones(16, dtype=torch.bool), t(bank), t(valid), t(slots),
                                0.9, 64.0)
    for c, slot in enumerate(slots):
        ref = _jax_match(q, bank[slot], valid_b=valid[slot], ratio=0.9, max_dist=64.0)
        _assert_same([x[c].numpy() for x in got], ref)
    batched = _port_match(q, bank[slots], valid_b=valid[slots], ratio=0.9, max_dist=64.0)
    _assert_same(batched, [x.numpy() for x in got])
    assert got[0][0, 0] == 4 and got[2][0, 0] == 0


def test_knn_and_ratio_test_match_jax():
    rng = np.random.default_rng(40)
    d = rng.integers(0, 6, (9, 7)).astype(np.float32)
    va, vb = rng.random(9) < 0.7, rng.random(7) < 0.7
    dj, ij = jm.knn_match(jnp.asarray(d), jnp.asarray(va), jnp.asarray(vb), k=3)
    dt, it = tm.knn_match(torch.from_numpy(d), torch.from_numpy(va), torch.from_numpy(vb), k=3)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    for ratio, md in ((0.9, None), (0.5, 3.0)):
        rj = jm.ratio_test(dj, ij, ratio, md)
        rt = tm.ratio_test(dt, it, ratio, md)
        for a, b in zip(rt, rj):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
