"""K16 (``csrc/hamming_top2.cu``) on the CPU: numpy emulations of its two
entries' algorithms against the sequential scan they replace, the plain
versions (``kops.hamming_top2_plain``, ``kops.gist_topk_plain``) and the
JAX package's ``knn_match`` + ``ratio_test`` and ``gist_query``.

- The matching: the stored descriptors 256 at a time, each query's scan
  split over 8 lanes, each lane's (best, second) pair of 64-bit keys
  (distance << 32 | stored index) kept branch-free, the lanes' pairs
  merged by xor shuffles.
- The GIST query: the bank dealt over a cluster's threads, each thread's
  8 smallest keys by sorted insertion, a warp's by rounds of a butterfly
  minimum of the lanes' heads, then the CTA's warps' lists and the
  cluster's CTAs' lists the same way; k > 8 by passes over the keys above
  the last one taken.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.ops import matching as JM
from uzliti_slam_tpu.recognition import recognizer as JR
from uzliti_slam_tpu_torch.kernels import ops as kops

EMPTY = np.uint64((0x7FFFFFFF << 32) | 0xFFFFFFFF)   # kEmpty: after every key
MASKED = 1_000_000_000                                # knn_match's 1e9
LANES = 8                                             # kLanes
TILE = 256                                            # kTile: stored descriptors staged at a time
KEEP = 8                                              # kKeep: keys a pass
GIST_THREADS, GIST_MAX_CTAS, GIST_PER_THREAD = 512, 8, 8


def _hamming(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(..., Na, 32) x (..., Nb, 32) uint8 -> (..., Na, Nb) int64."""
    x = np.bitwise_xor(a[..., :, None, :], b[..., None, :, :])
    return np.unpackbits(x, axis=-1).sum(-1).astype(np.int64)


def lane_split_top2(query, bank, bank_valid, cslot, valid_a, ratio, max_dist, lanes=LANES):
    """The matching kernel's arithmetic, the stored descriptors taken a
    tile at a time: (idx (C, Na) int32, ok (C, Na) bool, best (C, Na)
    float32)."""
    F = bank.shape[1]
    d = _hamming(query[None], bank[cslot])                                  # (C, Na, F)
    d = np.where(valid_a[None, :, None] & bank_valid[cslot][:, None, :], d, MASKED)
    keys = (d.astype(np.uint64) << np.uint64(32)) | np.arange(F, dtype=np.uint64)
    k1 = np.full((lanes,) + d.shape[:2], EMPTY)
    k2 = k1.copy()
    for t0 in range(0, F, TILE):
        for lane in range(lanes):
            for j in range(t0 + lane, min(t0 + TILE, F), lanes):
                key = keys[..., j]
                k2[lane] = np.minimum(k2[lane], np.maximum(k1[lane], key))
                k1[lane] = np.minimum(k1[lane], key)
    off = lanes // 2
    while off:
        partner = np.arange(lanes) ^ off
        o1, o2 = k1[partner], k2[partner]
        k2 = np.minimum(np.maximum(k1, o1), np.minimum(k2, o2))
        k1 = np.minimum(k1, o1)
        off //= 2
    best = (k1[0] >> np.uint64(32)).astype(np.int64).astype(np.float32)
    second = (k2[0] >> np.uint64(32)).astype(np.int64).astype(np.float32)
    idx = (k1[0] & np.uint64(0xFFFFFFFF)).astype(np.int32)
    ok = valid_a[None] & (best <= np.float32(ratio) * second) & (best <= np.float32(max_dist))
    return idx, ok, best


def sequential_top2(query, bank, bank_valid, cslot, valid_a, ratio, max_dist):
    """The scan the kernel replaced: a running best and second per query in
    ascending stored index with strict '<'."""
    C, Na, F = len(cslot), len(query), bank.shape[1]
    d = _hamming(query[None], bank[cslot])
    idx = np.zeros((C, Na), np.int32)
    best = np.zeros((C, Na), np.float32)
    ok = np.zeros((C, Na), bool)
    for c in range(C):
        for i in range(Na):
            b1 = b2 = 2**31 - 1
            i1 = 0
            for j in range(F):
                dj = int(d[c, i, j]) if valid_a[i] and bank_valid[cslot[c], j] else MASKED
                if dj < b1:
                    b2, b1, i1 = b1, dj, j
                elif dj < b2:
                    b2 = dj
            idx[c, i], best[c, i] = i1, np.float32(b1)
            ok[c, i] = valid_a[i] and best[c, i] <= np.float32(ratio) * np.float32(b2) \
                and best[c, i] <= np.float32(max_dist)
    return idx, ok, best


def _match_case(name: str, F: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    Na, N = 24, 6
    query = rng.integers(0, 256, (Na, 32), dtype=np.uint8)
    bank = rng.integers(0, 256, (N, F, 32), dtype=np.uint8)
    bank_valid = rng.random((N, F)) < 0.8
    valid_a = rng.random(Na) < 0.85
    bank[2, F // 2] = query[0]                           # an exact match
    bank[2, F - 1] = query[0]                            # and its later twin: a tie
    if name == "all_equal":
        query[:] = query[0]
        bank[:] = query[0]
        bank_valid[:] = True
        valid_a[:] = True
    elif name == "all_masked":
        valid_a[: Na // 2] = False
        bank_valid[2] = False
    elif name == "one_valid_stored":
        bank_valid[:] = False
        bank_valid[2, F // 3] = True
        bank_valid[5, 0] = True
    cslot = np.array([2, 0, 5, 2, 3], np.int32)
    return query, bank, bank_valid, cslot, valid_a


@pytest.mark.parametrize("F", [2, 3, 13, 64, 600])
@pytest.mark.parametrize("name", ["random", "all_equal", "all_masked", "one_valid_stored"])
def test_lane_split_top2_equals_the_sequential_scan_plain_and_jax(name, F):
    case = _match_case(name, F)
    query, bank, bank_valid, cslot, valid_a = case
    for ratio, max_dist in ((0.9, 64.0), (0.99, np.inf)):
        got = lane_split_top2(*case, ratio, max_dist)
        seq = sequential_top2(*case, ratio, max_dist)
        plain = kops.hamming_top2(*(torch.from_numpy(a) for a in case), ratio, max_dist)
        for g, s, p in zip(got, seq, plain):
            np.testing.assert_array_equal(g, s)
            np.testing.assert_array_equal(g, p.numpy())
        for c, slot in enumerate(cslot):
            dm = JM.hamming_matrix_packed(jnp.asarray(query), jnp.asarray(bank[slot]))
            dj, ij = JM.knn_match(dm, jnp.asarray(valid_a), jnp.asarray(bank_valid[slot]))
            mj, okj = JM.ratio_test(dj, ij, ratio, None if np.isinf(max_dist) else max_dist)
            np.testing.assert_array_equal(got[0][c], np.asarray(mj))
            np.testing.assert_array_equal(got[1][c], np.asarray(okj) & valid_a)
            np.testing.assert_array_equal(got[2][c], np.asarray(dj)[:, 0])
    if name == "all_masked":
        # a row with no valid pair: indices 0 and 1, best 1e9, not ok
        assert (got[0][0] == 0).all() and (got[2][0] == MASKED).all() and not got[1][0].any()
    if name == "one_valid_stored":
        # second = 1e9: the one valid stored descriptor passes the ratio test
        assert got[1][0][valid_a].all() and (got[0][0][valid_a] == F // 3).all()
    if name == "all_equal":
        # best = second = 0: 0 <= ratio · 0 holds, and the lower index wins
        assert (got[0] == 0).all() and (got[2] == 0).all() and got[1].all()


def _insert(lst: list, key) -> None:
    """The kernel's sorted insertion into a list of KEEP keys."""
    if key < lst[-1]:
        lst[-1] = key
        lst.sort()


def _warp_select(lists: list) -> list:
    """KEEP rounds of a minimum over the lanes' heads, the owner popping."""
    lists = [list(x) for x in lists] + [[EMPTY] * KEEP] * (32 - len(lists))
    out = []
    for _ in range(KEEP):
        m = min(x[0] for x in lists)
        out.append(m)
        lists = [x[1:] + [EMPTY] if x[0] == m else x for x in lists]
    return out


def cluster_topk(query, bank, stamp, valid, q_stamp, k, min_dt, max_dist, threads=GIST_THREADS,
                 ctas=None):
    """The GIST kernel's algorithm: (slots (k,) int32, dist (k,) float32,
    ok (k,) bool)."""
    N = len(bank)
    if ctas is None:
        per_cta = threads * GIST_PER_THREAD
        ctas = min(GIST_MAX_CTAS, max(1, -(-N // per_cta)))
    d = _hamming(query[None], bank)[0].astype(np.float32)
    gap = np.abs((stamp - np.float32(q_stamp)).astype(np.float32))
    eligible = valid & (gap >= np.float32(min_dt))
    bits = np.where(eligible, d.view(np.uint32), np.uint32(0x7F800000)).astype(np.uint64)
    keys = (bits << np.uint64(32)) | np.arange(N, dtype=np.uint64)
    stride, warps = ctas * threads, threads // 32
    taken, last = [], None
    while len(taken) < k:
        cta_lists = []
        for rank in range(ctas):
            warp_lists = []
            for w in range(warps):
                lanes = []
                for lane in range(32):
                    lst = [EMPTY] * KEEP
                    for j in range(rank * threads + 32 * w + lane, N, stride):
                        if last is None or keys[j] > last:
                            _insert(lst, keys[j])
                    lanes.append(lst)
                warp_lists.append(_warp_select(lanes))
            cta_lists.append(_warp_select(warp_lists))
        final = _warp_select(cta_lists)
        taken += final[: min(KEEP, k - len(taken))]
        last = final[-1]
    keys = np.array(taken, np.uint64)
    dist = (keys >> np.uint64(32)).astype(np.uint32).view(np.float32)
    slots = (keys & np.uint64(0xFFFFFFFF)).astype(np.int32)
    return slots, dist, np.isfinite(dist) & (dist <= np.float32(max_dist))


def _gist_case(N: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (7, 32), dtype=np.uint8)
    bank = base[rng.integers(0, 7, N)]                   # many exact ties
    flip = rng.random((N, 32)) < 0.05
    bank = np.where(flip, bank ^ np.uint8(1), bank).astype(np.uint8)
    stamp = rng.uniform(0, 60, N).astype(np.float32)
    valid = rng.random(N) < 0.8
    query = base[3].copy()
    return query, bank, stamp, valid, np.float32(30.0)


@pytest.mark.parametrize("k", [1, 5, KEEP, KEEP + 1, 2 * KEEP + 3, "N"])
def test_gist_topk_by_passes_equals_jax_gist_query(k):
    N = 300
    query, bank, stamp, valid, q_stamp = _gist_case(N)
    k = N if k == "N" else k
    min_dt, max_dist = 5.0, 40.0
    jbank = JR.GistBank(desc=jnp.asarray(bank), stamp=jnp.asarray(stamp), valid=jnp.asarray(valid))
    sj, dj, okj = jax.jit(lambda b, q, s: JR.gist_query(b, q, s, k=k, max_dist=max_dist,
                                                         min_dt=min_dt))(
        jbank, jnp.asarray(query), jnp.asarray(q_stamp))
    plain = kops.gist_topk(torch.from_numpy(query), torch.from_numpy(bank),
                           torch.from_numpy(stamp), torch.from_numpy(valid),
                           torch.tensor(q_stamp), k, min_dt, max_dist)
    # the kernel's shape (one CTA of 512 threads at this N), and a cluster of
    # three small CTAs whose threads hold several entries each
    for threads, ctas in ((GIST_THREADS, None), (64, 3)):
        got = cluster_topk(query, bank, stamp, valid, q_stamp, k, min_dt, max_dist, threads, ctas)
        for g, ref, p in zip(got, (sj, dj, okj), plain):
            np.testing.assert_array_equal(g, np.asarray(ref))
            np.testing.assert_array_equal(g, p.numpy())
    assert np.isfinite(got[1][:k]).any()
    if k == N:
        assert np.isinf(got[1]).any()      # the ineligible entries last, by index


def test_gist_topk_cluster_size_follows_the_bank():
    """1 CTA up to 4,096 entries, then one per 4,096, at most 8 (a 100k
    bank: 8 CTAs of 512 threads, ~25 entries a thread)."""
    def ctas(n):
        return min(GIST_MAX_CTAS, max(1, -(-n // (GIST_THREADS * GIST_PER_THREAD))))
    assert [ctas(n) for n in (1, 4096, 4097, 10_000, 50_000, 100_000)] == [1, 1, 2, 3, 8, 8]
