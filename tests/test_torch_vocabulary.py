"""Port parity: the bag-of-words vocabulary (``build_vocabulary``, K23's
plain versions on the CPU), ``quantize`` and the BoW bank's ``bow_query``
(K24's) against the JAX package's.

Held, with their reasons:

- the vocabulary's centres exactly: Hamming distances, member counts and
  bit counts are integers, the majority is an integer comparison, and the
  reseed order a stable sort of integer distances.  JAX draws the first
  seed with ``jax.random.choice``, which a ``torch.Generator`` cannot
  repeat: the test draws it with JAX's key and hands it to the port
  (``first=``);
- idf within 1e-6 (a float32 log: XLA's on one side, torch's on the other);
- ``quantize``'s words exactly and its vectors within 1e-6 (the L1 norm
  summed in another order);
- ``bow_query``'s scores within 1e-6 (the L1 distance summed in another
  order) and its slots and flags exactly (no two scores of these data lie
  within 1e-5 of each other, except planted exact ties, which both sides
  order by slot).

Descriptors are made with numpy from a seed and given to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.ops import matching as jmatch
from uzliti_slam_tpu.recognition import vocabulary as jvoc
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.recognition import vocabulary as tvoc


def clustered(seed, n_clusters, per_cluster, flip_bits=8):
    """Random prototypes and noisy members (``flip_bits`` bits flipped)."""
    rng = np.random.default_rng(seed)
    protos = rng.integers(0, 256, (n_clusters, 32)).astype(np.uint8)
    bits = np.unpackbits(np.repeat(protos, per_cluster, axis=0), axis=-1, bitorder="little")
    for row in bits:
        row[rng.choice(256, flip_bits, replace=False)] ^= 1
    return np.packbits(bits, axis=-1, bitorder="little"), protos


def jax_first(key, valid) -> int:
    """The first seed JAX's ``build_vocabulary`` draws with ``key``."""
    p = jnp.asarray(valid, jnp.float32)
    return int(jax.random.choice(key, valid.shape[0], p=p / jnp.maximum(jnp.sum(p), 1.0)))


def build_both(desc, valid, k, iterations, seed):
    key = jax.random.PRNGKey(seed)
    ref = jvoc.build_vocabulary(key, jnp.asarray(desc), jnp.asarray(valid), k=k,
                                iterations=iterations)
    got = tvoc.build_vocabulary(torch.from_numpy(desc), torch.from_numpy(valid), k=k,
                                iterations=iterations, first=jax_first(key, valid))
    return ref, got


@pytest.mark.parametrize("n_clusters, per, k, iterations, frac_valid, flip", [
    (8, 32, 8, 10, 1.0, 8),      # tests/test_vocabulary.py's recovery case
    (4, 16, 16, 6, 1.0, 8),      # more words than clusters
    (2, 8, 12, 5, 1.0, 8),       # the empty-cluster stability case
    (16, 16, 32, 6, 0.8, 8),     # a fifth of the descriptors invalid
    (3, 8, 8, 4, 1.0, 0),        # 3 distinct descriptors, 8 words: duplicate
                                 # seeds, empty words reseeded every round
    (6, 12, 24, 5, 0.9, 1),      # repeated descriptors among noisy ones
])
def test_build_vocabulary_matches_jax(n_clusters, per, k, iterations, frac_valid, flip):
    desc, protos = clustered(n_clusters * 7 + k, n_clusters, per, flip_bits=flip)
    valid = np.random.default_rng(k).random(desc.shape[0]) < frac_valid
    ref, got = build_both(desc, valid, k, iterations, seed=k)
    np.testing.assert_array_equal(got.centers.numpy(), np.asarray(ref.centers))
    np.testing.assert_allclose(got.idf.numpy(), np.asarray(ref.idf), rtol=0, atol=1e-6)
    if frac_valid == 1.0 and k == n_clusters and flip:
        d = np.asarray(jmatch.hamming_matrix_packed(jnp.asarray(protos), jnp.asarray(
            got.centers.numpy())))
        assert (d.min(axis=1) <= 6).all()


def test_build_vocabulary_draws_its_first_seed():
    desc, _ = clustered(3, 4, 16)
    gen = torch.Generator().manual_seed(0)
    v = tvoc.build_vocabulary(torch.from_numpy(desc), k=8, iterations=3, generator=gen)
    assert v.centers.shape == (8, 32) and v.centers.dtype == torch.uint8
    assert torch.isfinite(v.idf).all()
    # the same draw gives the same vocabulary
    again = tvoc.build_vocabulary(torch.from_numpy(desc), k=8, iterations=3,
                                  generator=torch.Generator().manual_seed(0))
    assert torch.equal(v.centers, again.centers)


def test_word_majority_plain_takes_the_majority():
    desc, _ = clustered(4, 2, 9)
    valid = np.ones(18, bool)
    valid[0] = False
    word = torch.from_numpy(np.repeat(np.arange(2, dtype=np.int32), 9))
    counts = torch.tensor([8, 9], dtype=torch.int32)
    got = kops.word_majority_plain(torch.from_numpy(desc), torch.from_numpy(valid), word, counts)
    bits = np.unpackbits(desc, axis=-1, bitorder="little").astype(int)
    want = np.stack([bits[1:9].sum(0) * 2 > 8, bits[9:].sum(0) * 2 > 9])
    np.testing.assert_array_equal(np.unpackbits(got.numpy(), axis=-1, bitorder="little"), want)


@pytest.fixture(scope="module")
def vocab_pair():
    desc, _ = clustered(5, 16, 16)
    valid = np.ones(desc.shape[0], bool)
    ref, _ = build_both(desc, valid, 32, 6, seed=5)
    return desc, ref, tvoc.from_numpy(np.asarray(ref.centers), np.asarray(ref.idf), "cpu")


@pytest.mark.parametrize("sl, masked", [(slice(0, 32), False), (slice(40, 120), True),
                                        (slice(200, 256), False)])
def test_quantize_matches_jax(vocab_pair, sl, masked):
    desc, vj, vt = vocab_pair
    d = desc[sl]
    valid = (np.arange(d.shape[0]) % 3 != 0) if masked else np.ones(d.shape[0], bool)
    ref = np.asarray(jvoc.quantize(vj, jnp.asarray(d), jnp.asarray(valid)))
    got = tvoc.quantize(vt, torch.from_numpy(d), torch.from_numpy(valid)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    assert abs(float(np.abs(got).sum()) - 1.0) <= 1e-5
    word, _, hist = kops.word_assign(torch.from_numpy(d), torch.from_numpy(valid), vt.centers)
    jword = np.argmin(np.asarray(jmatch.hamming_matrix_packed(jnp.asarray(d), vj.centers)), -1)
    np.testing.assert_array_equal(word.numpy(), jword)
    np.testing.assert_array_equal(hist.numpy(), np.bincount(jword[valid], minlength=32))


def _bow_banks(capacity, k_words, entries):
    bj, bt = jvoc.bow_bank_init(capacity, k_words), tvoc.bow_bank_init(capacity, k_words, "cpu")
    for slot, vec, stamp in entries:
        bj = jvoc.bow_bank_add(bj, jnp.asarray(slot), jnp.asarray(vec),
                               jnp.asarray(stamp, jnp.float32))
        bt = tvoc.bow_bank_add(bt, slot, torch.from_numpy(np.array(vec)), stamp)
    for a, b in zip(bt, bj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    return bj, bt


def _bow_query_both(bj, bt, q, stamp, **kw):
    ref = jvoc.bow_query(bj, jnp.asarray(q), jnp.asarray(stamp, jnp.float32), **kw)
    got = tvoc.bow_query(bt, torch.from_numpy(np.array(q)), stamp, **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]), err_msg="slots")
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]), err_msg="ok")
    return [x.numpy() for x in got]


def test_bow_retrieval_ranks_same_place_first(vocab_pair):
    desc, vj, vt = vocab_pair
    places = [desc[i * 80:(i + 1) * 80] for i in range(3)]
    vec = [np.asarray(jvoc.quantize(vj, jnp.asarray(p[:40]))) for p in places]
    bj, bt = _bow_banks(8, 32, [(i, vec[i], 10.0 * i) for i in range(3)])
    q = np.asarray(jvoc.quantize(vj, jnp.asarray(places[1][40:])))
    slots, scores, ok = _bow_query_both(bj, bt, q, 100.0, k=3)
    assert slots[0] == 1 and ok[0] and scores[0] > scores[1]


@pytest.mark.parametrize("k", [4, 10])
def test_bow_query_gates_and_ties(k):
    """Random L1-normalised rows, two exact duplicates of one row (a tie:
    the lower slot first), a zero row, a time-gated row, a removed row and
    unused slots; then a zero query (every score -1)."""
    rng = np.random.default_rng(7)
    rows = rng.random((7, 64)).astype(np.float32) * (rng.random((7, 64)) < 0.3)
    rows /= np.maximum(rows.sum(-1, keepdims=True), 1e-12)
    rows[4] = rows[1]
    rows[6] = rows[1]
    rows[2] = 0.0
    q = (rows[1] * 0.8 + rows[0] * 0.2).astype(np.float32)
    stamps = [0.0, 1.0, 2.0, 99.0, 4.0, 5.0, 6.0]
    bj, bt = _bow_banks(10, 64, [(i, rows[i], stamps[i]) for i in range(7)])
    bj, bt = jvoc.bow_bank_remove(bj, jnp.asarray(5)), tvoc.bow_bank_remove(bt, 5)
    slots, scores, ok = _bow_query_both(bj, bt, q, 100.0, k=k, min_score=0.05)
    assert list(slots[:3]) == [1, 4, 6] and scores[0] == scores[1] == scores[2] and ok[0]
    if k == 10:
        assert list(slots[-6:]) == [2, 3, 5, 7, 8, 9] and (scores[-6:] == -1.0).all()
    _, scores, ok = _bow_query_both(bj, bt, np.zeros(64, np.float32), 100.0, k=k)
    assert (scores == -1.0).all() and not ok.any()


def test_bow_time_gate_and_remove(vocab_pair):
    desc, vj, vt = vocab_pair
    vec = np.asarray(jvoc.quantize(vj, jnp.asarray(desc[:16])))
    bj, bt = _bow_banks(4, 32, [(0, vec, 0.0)])
    _, _, ok = _bow_query_both(bj, bt, vec, 2.0, k=2)
    assert not ok[0]
    _, _, ok = _bow_query_both(bj, bt, vec, 20.0, k=2)
    assert ok[0]
    bj, bt = jvoc.bow_bank_remove(bj, jnp.asarray(0)), tvoc.bow_bank_remove(bt, 0)
    _, _, ok = _bow_query_both(bj, bt, vec, 20.0, k=2)
    assert not ok[0]
    # a negative slot writes nothing
    bt2 = tvoc.bow_bank_add(bt, -1, torch.from_numpy(np.array(vec)), 5.0)
    assert all(torch.equal(a, b) for a, b in zip(bt2, bt))


def test_from_numpy_and_bow_score():
    v = tvoc.from_numpy(np.zeros((4, 32), np.uint8), np.arange(4, dtype=np.float64), "cpu")
    assert v.centers.dtype == torch.uint8 and v.idf.dtype == torch.float32
    a = torch.tensor([0.5, 0.5, 0.0])
    b = torch.tensor([0.0, 0.5, 0.5])
    assert float(tvoc.bow_score(a, b)) == float(jvoc.bow_score(jnp.asarray(a.numpy()),
                                                               jnp.asarray(b.numpy())))
