"""Port parity: the GIST bank and ``gist_query`` (K16's plain version on the
CPU) and ``mask_existing_pairs`` against JAX's, on the GIST and pair-mask
cases of tests/test_recognition.py and on planted ties.

Hamming distances are integers: slots, distances and flags are held
exactly, ties to the lower slot (also among the +inf of ineligible
entries, which fill the k results when fewer are eligible).
Descriptors are made with numpy from a seed and given to both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.recognition import recognizer as jrec
from uzliti_slam_tpu_torch.recognition import recognizer as trec


def rand_desc(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, 32)).astype(np.uint8)


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
