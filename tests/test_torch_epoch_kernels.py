"""K5's and K6's entries on the CPU: their plain versions against the JAX
package, and numpy emulations of the kernels' algorithms against the plain
versions.

The CUDA kernels run only on the card (``chip_smoke.py`` holds each entry
against its plain version there).  Here:

- ``kops.cluster_roots_plain`` against the steps of JAX's
  ``filter_loop_closures`` before its RANSAC (``filter.py:105-154``): labels,
  gates, root slots and member masks exactly, at B = 256 with a stamp chain
  longer than 16 hops, clusters that fail each gate, as many qualifying
  roots as there are root rows, no valid candidate, negative and infinite
  stamps, B = 1 and B = 77;
- the roots kernel's algorithm (the bit matrix, rounds to the fixed point,
  order-preserving stamp keys, ballot compaction) replayed in numpy
  against the plain version;
- K5's frontier algorithm (the table in a shuffled fill order, Jacobi
  sweeps over the changed nodes only, double buffers, the bitmasks by
  parity, list overflow read from the bitmask, the stop at an empty
  frontier) replayed in numpy, each frontier in a shuffled order, against
  ``relax_min_plain`` bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import filter as jfilter
from uzliti_slam_tpu_torch.graph import filter as tfilter
from uzliti_slam_tpu_torch.kernels import ops as kops

INF = np.float32(kops.INF)
CFG = tfilter.FilterConfig()


# ---------------------------------------------------------------------------
# K6: cluster roots
# ---------------------------------------------------------------------------

def _jax_roots(cand_idx, e_from, e_to, e_valid, node_valid, stamp, cand_mask=None):
    """``uzliti_slam_tpu/graph/filter.py:105-154`` up to the member masks."""
    cand_idx, e_from, e_to = map(jnp.asarray, (cand_idx, e_from, e_to))
    e_valid, node_valid, stamp = map(jnp.asarray, (e_valid, node_valid, stamp))
    b = cand_idx.shape[0]
    present = cand_idx >= 0
    ci = jnp.where(present, cand_idx, 0)
    ef, et = e_from[ci], e_to[ci]
    valid = present & (e_valid[ci] if cand_mask is None else jnp.asarray(cand_mask))
    valid &= node_valid[ef] & node_valid[et]
    sf, st = stamp[ef], stamp[et]
    labels = jfilter._cluster_labels(sf, st, valid, CFG.max_dt)
    seg = lambda x, op, init: op(jnp.where(valid, x, init), labels, num_segments=b + 1)
    csize = jax.ops.segment_sum(valid.astype(jnp.int32), labels, num_segments=b + 1)
    f_min, f_max = seg(sf, jax.ops.segment_min, jnp.inf), seg(sf, jax.ops.segment_max, -jnp.inf)
    t_min, t_max = seg(st, jax.ops.segment_min, jnp.inf), seg(st, jax.ops.segment_max, -jnp.inf)
    runs = ((csize >= CFG.min_cluster_size) & ((f_max - f_min) >= CFG.min_time_span)
            & ((t_max - t_min) >= CFG.min_time_span))
    n_roots = max(1, min(b, b // max(CFG.min_cluster_size, 1)))
    is_root = (labels == jnp.arange(b)) & valid & runs[jnp.arange(b)]
    root_slot = jnp.nonzero(is_root, size=n_roots, fill_value=-1)[0]
    root_live = root_slot >= 0
    root_safe = jnp.where(root_live, root_slot, 0)
    member = (labels[None, :] == root_safe[:, None]) & valid[None, :] & root_live[:, None]
    return {"valid": valid, "labels": labels, "root_live": root_live, "root_safe": root_safe,
            "member": member, "sf": sf, "st": st}


def _candidates(sf, st, rng, n_spare_nodes=8):
    """Edge tables whose edge c joins two nodes stamped sf[c] and st[c]
    (shuffled slots), candidate c naming edge c; spare nodes and edges
    beside them."""
    b = len(sf)
    n = 2 * b + n_spare_nodes
    perm = rng.permutation(n)
    stamp = rng.uniform(-1e3, 1e3, n).astype(np.float32)
    stamp[perm[:b]], stamp[perm[b:2 * b]] = sf, st
    E = b + 16
    e_from = rng.integers(0, n, E).astype(np.int32)
    e_to = rng.integers(0, n, E).astype(np.int32)
    e_from[:b], e_to[:b] = perm[:b], perm[b:2 * b]
    return {"cand_idx": np.arange(b, dtype=np.int32), "e_from": e_from, "e_to": e_to,
            "e_valid": np.ones(E, bool), "node_valid": np.ones(n, bool), "stamp": stamp}


def _case_mixed(rng):
    """B = 256: a 40-long stamp chain (each candidate adjacent to its
    neighbours only, 39 hops), clusters failing the size, the from-span and
    the to-span gates, passing clusters (one at negative stamps), infinite
    stamps, and candidates out by padding, edge validity and node validity."""
    sf, st = [], []

    def group(f0, t0, df, dt, k):
        sf.extend(f0 + df * np.arange(k))
        st.extend(t0 + dt * np.arange(k))

    group(10.0, 500.0, 4.9, 4.9, 40)          # the chain
    group(2000.0, 3000.0, 0.75, 0.75, 4)      # 4 members: size gate
    group(4000.0, 5000.0, 0.25, 0.8, 6)       # from-span 1.25 s
    group(6000.0, 7000.0, 0.8, 0.3, 6)        # to-span 1.5 s
    for k in range(8):                         # passing clusters of 5-12
        group(8000.0 + 1000 * k, 20000.0 + 1000 * k, 0.6, 0.7, 5 + k)
    group(-120.0, -60.0, 0.5, 0.5, 9)          # negative stamps, passing
    rest = 256 - len(sf) - 4
    group(40000.0, 50000.0, 7.0, 0.1, rest)    # pairs at 7 s: singletons
    sf += [np.inf, -np.inf, np.inf, 1e4]
    st += [np.inf, -np.inf, 1.0, -np.inf]
    a = _candidates(np.array(sf, np.float32), np.array(st, np.float32), rng)
    singles = rng.permutation(np.arange(133, 252))     # the singletons' slots
    a["cand_idx"][singles[:6]] = -1
    a["e_valid"][singles[6:12]] = False
    a["node_valid"][a["e_to"][[115, 127]]] = False       # a member of two passing clusters
    a["node_valid"][a["e_from"][singles[12:14]]] = False
    return a


def _case_most_roots(rng):
    """B = 256, 51 passing clusters of exactly 5 (B // min_cluster_size: as
    many roots as there are root rows, the most the gates allow)."""
    sf = np.concatenate([1000.0 * k + 0.6 * np.arange(5) for k in range(51)] + [[9e5]])
    st = np.concatenate([2000.0 * k + 0.6 * np.arange(5) for k in range(51)] + [[9e5]])
    return _candidates(sf.astype(np.float32), st.astype(np.float32), rng)


def _case_none_valid(rng):
    a = _case_most_roots(rng)
    a["cand_idx"][:] = -1
    return a


def _case_small(b):
    def make(rng):
        sf = (rng.integers(0, 12, b) * 1.5).astype(np.float32)
        st = (sf + rng.integers(0, 3, b)).astype(np.float32)
        return _candidates(sf, st, rng)
    return make


def _case_mask(rng):
    """The heuristic's mask in place of the edges' validity."""
    a = _case_mixed(rng)
    a["cand_mask"] = rng.random(256) < 0.85
    return a


ROOT_CASES = {"mixed": _case_mixed, "most_roots": _case_most_roots,
              "none_valid": _case_none_valid, "b1": _case_small(1), "b77": _case_small(77),
              "cand_mask": _case_mask}


def _plain_roots(a):
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    return kops.cluster_roots(t["cand_idx"], t["e_from"], t["e_to"], t["e_valid"],
                              t["node_valid"], t["stamp"], CFG.max_dt, CFG.min_cluster_size,
                              CFG.min_time_span, 16, cand_mask=t.get("cand_mask"))


@pytest.mark.parametrize("case", list(ROOT_CASES))
def test_cluster_roots_match_jax_exactly(case):
    a = ROOT_CASES[case](np.random.default_rng(len(case)))
    got = _plain_roots(a)
    ref = _jax_roots(**a)
    for name in ref:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(ref[name]),
                                      err_msg=name)
    b = len(a["cand_idx"])
    assert got.labels.dtype == torch.int32 and got.root_safe.dtype == torch.int64
    assert got.member.shape == (kops.cluster_root_count(b, CFG.min_cluster_size), b)
    live = int(got.root_live.sum())
    if case == "mixed":
        labels = got.labels.numpy()
        # the chain: a label is the least slot within 16 hops, not the chain's start
        assert labels[39] == 23 and labels[16] == 0 and labels[17] == 1
        assert live == 10                      # the chain, 8 clusters, the negative one
    if case == "most_roots":
        assert live == got.root_live.shape[0] == 51
    if case == "none_valid":
        assert live == 0 and not got.member.any() and not got.valid.any()


def _order_key(x):
    u = np.asarray(x, np.float32).view(np.uint32)
    return np.where(u >> 31, ~u, u | np.uint32(0x80000000)).astype(np.uint32)


def _from_key(k):
    k = np.asarray(k, np.uint32)
    return np.where(k >> 31, k ^ np.uint32(0x80000000), ~k).astype(np.uint32).view(np.float32)


def _emulate_roots_kernel(a, n_iters=16):
    """csrc/cluster_labels.cu's roots entry, step by step in numpy."""
    cand_idx, e_from, e_to = a["cand_idx"], a["e_from"], a["e_to"]
    b = len(cand_idx)
    ci = np.where(cand_idx >= 0, cand_idx, 0)
    ef, et = e_from[ci], e_to[ci]
    mask = a["cand_mask"] if "cand_mask" in a else a["e_valid"][ci]
    ok = (cand_idx >= 0) & mask & a["node_valid"][ef] & a["node_valid"][et]
    sf, st = a["stamp"][ef], a["stamp"][et]
    words = (b + 31) // 32
    with np.errstate(invalid="ignore"):
        adjacent = (ok[:, None] & ok[None, :]
                    & (np.abs(sf[:, None] - sf[None, :]) < np.float32(CFG.max_dt))
                    & (np.abs(st[:, None] - st[None, :]) < np.float32(CFG.max_dt)))
    assert words <= 32
    bits = np.zeros((b, 32), np.uint32)            # lane l's word: bit w is column 32·w + l
    for j in range(b):
        bits[:, j % 32] |= adjacent[:, j].astype(np.uint32) << np.uint32(j // 32)
    cur = np.where(ok, np.arange(b), b).astype(np.int64)
    moved = ok.copy()                               # round 0: every valid label is new
    rounds = 0
    for _ in range(n_iters):
        nxt = cur.copy()
        for i in np.flatnonzero(bits.any(axis=1)):
            lane_min = [cur[32 * w + lane] for lane in range(32) for w in range(words)
                        if (int(bits[i, lane]) >> w) & 1 and moved[32 * w + lane]]
            if lane_min:
                nxt[i] = min(cur[i], min(lane_min))
        if rounds == 0:
            # the kernel's round 1: the least adjacent slot, each row's lowest set bit
            lowest = [min([32 * w + lane for lane in range(32) for w in range(words)
                           if (int(bits[i, lane]) >> w) & 1], default=b) for i in range(b)]
            np.testing.assert_array_equal(nxt, np.minimum(cur, lowest))
        rounds += 1
        moved = nxt != cur
        cur = nxt
        if not moved.any():
            break
    fmin = np.full(b + 1, _order_key(np.inf)); fmax = np.full(b + 1, _order_key(-np.inf))
    tmin, tmax, csize = fmin.copy(), fmax.copy(), np.zeros(b + 1, np.int64)
    for i in np.random.default_rng(5).permutation(b):       # atomics: any order
        if ok[i]:
            l = cur[i]
            csize[l] += 1
            fmin[l] = min(fmin[l], _order_key(sf[i])); fmax[l] = max(fmax[l], _order_key(sf[i]))
            tmin[l] = min(tmin[l], _order_key(st[i])); tmax[l] = max(tmax[l], _order_key(st[i]))
    with np.errstate(invalid="ignore"):
        runs = ((csize >= CFG.min_cluster_size)
                & (_from_key(fmax) - _from_key(fmin) >= np.float32(CFG.min_time_span))
                & (_from_key(tmax) - _from_key(tmin) >= np.float32(CFG.min_time_span)))
    is_root = (cur[:b] == np.arange(b)) & ok & runs[:b]
    r = kops.cluster_root_count(b, CFG.min_cluster_size)
    slot = np.full(r, -1)
    balls = [sum(int(is_root[i]) << (i - 32 * w) for i in range(32 * w, min(b, 32 * w + 32)))
             for w in range(words)]
    prefix = np.concatenate([[0], np.cumsum([bin(x).count("1") for x in balls])])
    for i in range(b):
        if is_root[i]:
            pos = prefix[i // 32] + bin(balls[i // 32] & ((1 << (i % 32)) - 1)).count("1")
            if pos < r:
                slot[pos] = i
    live = slot >= 0
    safe = np.where(live, slot, 0)
    member = live[:, None] & ok[None, :] & (cur[None, :b] == slot[:, None])
    return {"valid": ok, "labels": cur[:b].astype(np.int32), "root_live": live,
            "root_safe": safe, "member": member, "sf": sf, "st": st}, rounds


@pytest.mark.parametrize("case", ["mixed", "most_roots", "none_valid", "b77"])
def test_roots_kernel_algorithm_matches_the_plain_version(case):
    a = ROOT_CASES[case](np.random.default_rng(len(case)))
    emu, rounds = _emulate_roots_kernel(a)
    got = _plain_roots(a)
    for name, v in emu.items():
        np.testing.assert_array_equal(getattr(got, name).numpy(), v, err_msg=name)
    if case == "mixed":
        assert rounds == 16            # the 40-long chain moves labels for all 16 rounds
    if case == "none_valid":
        assert rounds == 1             # nothing moves: the first round is the fixed point


def test_order_keys_keep_float_order():
    x = np.array([-np.inf, -3.4e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 2.0, 3.4e38, np.inf],
                 np.float32)
    k = _order_key(x)
    assert (np.diff(k.astype(np.int64)) > 0).all()
    np.testing.assert_array_equal(_from_key(k).view(np.uint32), x.view(np.uint32))


def test_first_indices_keeps_the_first_size_entries():
    mask = torch.from_numpy(np.random.default_rng(3).random(256) < 0.3)
    got = kops.first_indices(mask, 20).numpy()
    ref = np.asarray(jnp.nonzero(jnp.asarray(mask.numpy()), size=20, fill_value=-1)[0])
    np.testing.assert_array_equal(got, ref)
    assert tfilter.first_indices is kops.first_indices


# ---------------------------------------------------------------------------
# K5: the frontier algorithm
# ---------------------------------------------------------------------------

def _emulate_table(e_from, e_to, w, n, rng):
    """csrc/relax_min.cu's table: counts, scan, a fill in a shuffled order."""
    keep = (w < INF) & (e_from != e_to)
    count = np.zeros(n, np.int64)
    np.add.at(count, e_from[keep], 1)
    np.add.at(count, e_to[keep], 1)
    row_ptr = np.concatenate([[0], np.cumsum(count)]).astype(np.int64)
    cursor = row_ptr[:-1].copy()
    nbr = np.full(2 * len(w), -1, np.int64)
    wt = np.zeros(2 * len(w), np.float32)
    for e in rng.permutation(np.flatnonzero(keep)):
        for a, b in ((e_from[e], e_to[e]), (e_to[e], e_from[e])):
            nbr[cursor[a]], wt[cursor[a]] = b, w[e]
            cursor[a] += 1
    return row_ptr, nbr, wt


def _emulate_sweeps(d0, table, n_iters, cap, rng):
    """One row of csrc/relax_min.cu's sweeps; returns (distances, sweeps run)."""
    row_ptr, nbr, wt = table
    n = len(d0)
    rd, wr = d0.astype(np.float32).copy(), d0.astype(np.float32).copy()
    bits = [np.zeros(n, bool), np.zeros(n, bool)]
    lists = [[], []]
    count = [0, 0, 0]

    def join(v, parity, slot):
        if not bits[parity][v]:
            bits[parity][v] = True
            if count[slot] < cap:
                lists[parity].append(v)
            count[slot] += 1

    for u in rng.permutation(n):
        if rd[u] < INF:
            join(u, 0, 0)
    k = 0
    while k < n_iters:
        cur = count[k % 3]
        if cur == 0:
            break
        count[(k + 2) % 3] = 0
        cb, nb = k & 1, (k + 1) & 1
        if cur <= cap:
            nodes = list(lists[cb])
            assert sorted(nodes) == list(np.flatnonzero(bits[cb]))
        else:                                      # the list overflowed: the bitmask
            nodes = list(np.flatnonzero(bits[cb]))
        bits[cb][nodes] = False
        assert not bits[nb].any()                  # cleared as the frontier two sweeps before
        lists[nb] = []
        for u in rng.permutation(nodes):           # the lanes' groups: any order
            du = rd[u]
            wr[u] = min(wr[u], du)
            for e in range(row_ptr[u], row_ptr[u + 1]):
                v = nbr[e]
                off = np.float32(du + wt[e])
                off = off if off < INF else INF
                if off < rd[v]:
                    wr[v] = min(wr[v], off)
                    join(v, nb, (k + 1) % 3)
        rd, wr = wr, rd
        k += 1
    return rd, k


def _chain_with_closures(n=600, every=60, span=100, seed=0):
    """A chain of n nodes with a closure from every ``every``-th node to the
    node ``span`` ahead: more than 64 hops across; lengths 0.1-1 m, a few
    edges invalid (weight INF), a self-loop and two duplicated edges."""
    rng = np.random.default_rng(seed)
    ef = list(range(n - 1)) + list(range(0, n - span, every))
    et = list(range(1, n)) + [i + span for i in range(0, n - span, every)]
    ef += [5, 7, 7, 0]
    et += [5, 8, 8, 0]
    w = rng.uniform(0.1, 1.0, len(ef)).astype(np.float32)
    w[[100, 350]] = INF
    w[-2] = w[-3]
    w[-1] = INF                                    # a padded slot: 0 -> 0, INF
    return np.array(ef, np.int32), np.array(et, np.int32), w


def _hops(ef, et, w, n, src):
    adj = [[] for _ in range(n)]
    for a, b, x in zip(ef, et, w):
        if x < INF:
            adj[a].append(b)
            adj[b].append(a)
    dist = np.full(n, -1)
    dist[src], frontier = 0, [src]
    while frontier:
        nxt = []
        for u in frontier:
            for v in adj[u]:
                if dist[v] < 0:
                    dist[v] = dist[u] + 1
                    nxt.append(v)
        frontier = nxt
    return dist


def _random_graph(n=120, E=400, seed=1):
    rng = np.random.default_rng(seed)
    ef = rng.integers(0, n, E).astype(np.int32)
    et = rng.integers(0, n, E).astype(np.int32)
    w = rng.uniform(0.0, 2.0, E).astype(np.float32)
    w[rng.random(E) < 0.1] = INF
    et[:3] = ef[:3]                                 # self-loops
    return ef, et, w


RELAX_CASES = {
    # (graph, start rows, n_iters, list capacity)
    "chain_sources_64": ("chain", "sources", 64, 1024),
    "chain_sources_overflow": ("chain", "sources", 64, 1),
    "chain_to_fixed_point": ("chain", "sources", 2000, 1024),
    "chain_dense_rows": ("chain", "dense", 64, 32),
    "random_dense_rows": ("random", "dense", 64, 16),
    "random_sources_1": ("random", "sources", 1, 1024),
    "random_sources_0": ("random", "sources", 0, 1024),
    "random_isolated_source": ("random_isolated", "sources", 64, 1024),
}


@pytest.mark.parametrize("case", list(RELAX_CASES))
def test_frontier_sweeps_match_the_plain_version_bit_for_bit(case):
    graph, starts, n_iters, cap = RELAX_CASES[case]
    rng = np.random.default_rng(7)
    if graph == "chain":
        ef, et, w = _chain_with_closures()
        n = 600
        assert _hops(ef, et, w, n, 0).max() > 64
    else:
        ef, et, w = _random_graph()
        n = 130                                  # nodes 120-129 have no edge
    if starts == "sources":
        src = [0, n - 1, 123] if graph == "random_isolated" else [0, n // 2, n - 1, 7]
        d0 = np.full((len(src), n), INF, np.float32)
        d0[np.arange(len(src)), src] = 0.0
    else:
        d0 = rng.uniform(0, 50, (3, n)).astype(np.float32)
        d0[1, ::3] = INF
    table = _emulate_table(ef, et, w, n, rng)
    ref = kops.relax_min_plain(torch.from_numpy(d0), torch.from_numpy(ef), torch.from_numpy(et),
                               torch.from_numpy(w), n_iters).numpy()
    for r in range(d0.shape[0]):
        got, ran = _emulate_sweeps(d0[r], table, n_iters, cap, rng)
        np.testing.assert_array_equal(got.view(np.uint32), ref[r].view(np.uint32))
        if case == "chain_to_fixed_point":
            assert ran < 2000                    # stopped at an empty frontier
        if graph == "random_isolated" and r == 2:
            assert ran == 1 and (got[np.arange(n) != 123] == INF).all()


def test_table_matches_the_plain_table_up_to_order():
    ef, et, w = _chain_with_closures()
    n = 600
    row_ptr, nbr, wt = _emulate_table(ef, et, w, n, np.random.default_rng(2))
    plain = kops.relax_table_plain(torch.from_numpy(ef), torch.from_numpy(et),
                                   torch.from_numpy(w), n)
    np.testing.assert_array_equal(plain.row_ptr.numpy(), row_ptr)
    adj = plain.adj.numpy()
    for u in range(n):
        lo, hi = row_ptr[u], row_ptr[u + 1]
        a = sorted(zip(adj[lo:hi, 0], adj[lo:hi, 1].copy().view(np.float32)))
        b = sorted(zip(nbr[lo:hi], wt[lo:hi]))
        assert a == b, u
    # the INF edges, the self-loop and the padded slot stay out; duplicates stay in
    assert row_ptr[-1] == 2 * (len(w) - 2 - 2)
    assert plain.adj.shape == (2 * len(w), 2)


def test_relax_layout_routes():
    # the 500-node epoch: rows, bitmasks, lists and the table's copy (4096 edge slots)
    assert kops.relax_layout(512, 4096) == (512, True, True, 0)
    assert 8 * 512 + 4 * (2 * 16 + 2 * 512) + 4 * 514 + 16 * 4096 <= kops._SMEM_BYTES
    # the 10k epoch: the table stays in device memory
    cap, rows, table, per_row = kops.relax_layout(10240, 32768)
    assert cap == kops.RELAX_LIST_CAP and rows and not table and per_row == 0
    assert 8 * 10240 + 4 * (2 * 320 + 2 * cap) <= kops._SMEM_BYTES
    # above the cut (8·N + 8·⌈N/32⌉ + 8·cap bytes) the rows take a scratch
    assert kops.relax_layout(27_000, 64)[1] and not kops.relax_layout(28_000, 64)[1]
    assert kops.relax_layout(40000, 64) == (kops.RELAX_LIST_CAP, False, False, 80000)
    with pytest.raises(ValueError, match="bitmasks"):
        kops.relax_layout(8_000_000, 64)
