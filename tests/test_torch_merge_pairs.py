"""Kernel K19's procedure, replayed in numpy on the CPU, against JAX's
``find_merge_pairs``; and the two exact shortcuts it takes.

K19 (``csrc/merge_pairs.cu``) cannot run here, so its algorithm is replayed
step for step: each row i tests every column j's stamps (a non-eligible
column's stamp read as NaN) and a float32 bound on the squared distance,
fl(fl(d0²) + fl(d1²)) + fl(d2²) <= s_hi; only the pairs that pass take the
exact gates (``kops.merge_pair_gates_plain``: dt = fl(√s) of the fused
sum of squares, the rotation gate only within ``dist_thresh``); a close
pair is the key (float bits of dt << 32 | i·N + j), gathered 32 columns at
a time into a 128-entry buffer that is sorted and cut to K = 2·max_pairs -
1 keys when a chunk would overflow it, and sorted and cut again at the row's
end; a histogram of the keys' top 16 bits picks the largest prefix of bins
that fits the last CTA's list, that subset is gathered from the sorted rows,
and the greedy rounds run over it, then over every row's keys once it holds
no live key.  The replay is held exactly (keep, absorb, ok) to JAX's
``find_merge_pairs`` under ``jax.jit`` and to the port's plain version, on
rows with more than K close pairs (a tight cluster, whose rows also
overflow the buffer), exact dt ties across rows and within a row, NaN and
±inf poses, equal stamps, no eligible node, and max_pairs 1 and 32.

The shortcuts, each over every float32 bit pattern in a band of 2·2^18
around s* (``kops.merge_dist_bound``): the correctly rounded float32 root
(``__fsqrt_rn`` on the card, ``np.sqrt`` of a float32 here) equals the
plain version's ``sqrt_f32`` (the float64 root rounded once), and fl(√s) <
t exactly when s < s*; the float32 bound passes every pair with dt < t
(random and adversarial distance triples).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uzliti_slam_tpu.graph import lifecycle as jlife
from uzliti_slam_tpu.graph import state as jstate
from uzliti_slam_tpu_torch.graph import state as tstate
from uzliti_slam_tpu_torch.io import synthetic as tsyn
from uzliti_slam_tpu_torch.kernels import ops as kops

FAR = np.array([100.0, 0, 0, 1.0, 0, 0, 0], np.float32)   # every valid node near 0 eligible
RADIUS, MARGIN = 1.0, 6.0
# kBuf, a warp's columns, kListCap and kHistBins in csrc/merge_pairs.cu
BUF, CHUNK, LIST_CAP, HIST_BINS = 128, 32, 7120, 1 << 16
_GATES = ("dist_thresh", "angle_thresh_deg", "margin", "max_pairs")
_jax_pairs = jax.jit(jlife.find_merge_pairs, static_argnames=_GATES)


def _f32(x):
    return np.float32(x)


def _fma64(a, b, c):
    """K19's fma64: the float64 sum of an exact product, rounded once."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _bound_sum(d0, d1, d2):
    """K19's float32 bound on the squared distance (no fused operations)."""
    return (d0 * d0 + d1 * d1) + d2 * d2


def _exact_sum(d0, d1, d2):
    return _fma64(d2, d2, _fma64(d1, d1, d0 * d0))


def replay_merge_pairs(pose, stamp, eligible, dist_thresh, angle_thresh, max_pairs,
                       cap=LIST_CAP):
    """K19's procedure in numpy, its last CTA's list holding ``cap`` keys:
    (keep, absorb, ok) and the number of rows whose buffer was cut before
    their end."""
    n = pose.shape[0]
    K = 2 * max_pairs - 1
    _, s_hi = kops.merge_dist_bound(dist_thresh)
    t = pose[:, :3]
    col_stamp = np.where(eligible, stamp, np.float32(np.nan))
    with np.errstate(invalid="ignore", over="ignore"):
        d = (t[:, None, :] - t[None, :, :]).astype(np.float32)
        sa = _bound_sum(d[..., 0], d[..., 1], d[..., 2])
        cheap = (stamp[:, None] < col_stamp[None, :]) & (sa <= np.float32(s_hi))
    cheap &= eligible[:, None]
    pt = torch.from_numpy(pose)
    dt, dr = kops.merge_pair_gates_plain(pt[:, None, :3], pt[:, None, 3:], pt[None, :, :3],
                                         pt[None, :, 3:])
    dt, dr = dt.numpy(), dr.numpy()
    with np.errstate(invalid="ignore"):
        exact = cheap & (dt < np.float32(dist_thresh)) & (dr < np.float32(angle_thresh))
        # the bound never drops a pair the reference's gates keep
        ref_close = ((dt < np.float32(dist_thresh)) & (dr < np.float32(angle_thresh))
                     & eligible[:, None] & eligible[None, :] & (stamp[:, None] < stamp[None, :]))
    assert np.array_equal(exact, ref_close)
    keys = ((dt.view(np.uint32).astype(np.uint64) << np.uint64(32))
            | (np.arange(n, dtype=np.uint64)[:, None] * np.uint64(n)
               + np.arange(n, dtype=np.uint64)[None, :]))
    rows, cut_rows = [], 0
    for i in range(n):
        buf, cut = [], False
        for c0 in range(0, n, CHUNK):
            new = [keys[i, j] for j in range(c0, min(c0 + CHUNK, n)) if exact[i, j]]
            if len(buf) + len(new) > BUF:
                buf, cut = sorted(buf)[:K], True
            buf += new
        rows.append(sorted(buf)[:K])
        cut_rows += cut
    # the histogram of the keys' top 16 bits, the largest prefix of bins
    # that fits the list, the subset gathered from the sorted rows
    every = [k for row in rows for k in row]
    hist = np.bincount(np.array([int(k >> np.uint64(48)) for k in every], np.int64),
                       minlength=HIST_BINS)
    fits = np.nonzero(np.cumsum(hist) <= cap)[0]
    b = int(fits[-1]) if fits.size else -1
    subset = []
    for row in rows:
        for k in row:
            if int(k >> np.uint64(48)) > b:
                break
            subset.append(k)
    cand, whole = subset, len(subset) == len(every)
    used = np.zeros(n, bool)
    keep, absorb, ok = [], [], []

    def live_keys(keys):
        return [k for k in keys if not used[int(k & np.uint64(0xFFFFFFFF)) // n]
                and not used[int(k & np.uint64(0xFFFFFFFF)) % n]]

    for _ in range(max_pairs):
        live = live_keys(cand)
        if not live and not whole:   # the subset is spent: every row's keys
            cand, whole = every, True
            live = live_keys(cand)
        if not live:
            keep.append(0)
            absorb.append(0)
            ok.append(False)
            continue
        flat = int(min(live) & np.uint64(0xFFFFFFFF))
        i, j = flat // n, flat % n
        used[i] = used[j] = True
        keep.append(i)
        absorb.append(j)
        ok.append(True)
    return (np.array(keep, np.int32), np.array(absorb, np.int32), np.array(ok)), cut_rows


def _graph(n, capacity, seed=0, **kw):
    g, _ = tsyn.make_pose_graph(n, node_capacity=capacity, edge_capacity=2 * capacity,
                                device="cpu", generator=torch.Generator().manual_seed(seed), **kw)
    return {k: v.copy() for k, v in tstate.to_numpy(g).items()}


def _case(name):
    """(graph arrays, dist_thresh, angle_thresh, max_pairs) of a case."""
    rng = np.random.default_rng(7)
    kw = dict(dist=0.25, angle=15.0, max_pairs=16)
    if name in ("cluster", "cluster_max_pairs_1"):
        # 200 nodes within a few cm: every row has up to 199 close pairs,
        # more than K and more than the 128-entry buffer holds
        g = _graph(200, 256, radius=3.0)
        g["pose"][:200, :3] = rng.normal(scale=0.02, size=(200, 3)).astype(np.float32)
        q = np.array([1.0, 0, 0, 0], np.float32) + rng.normal(scale=0.01, size=(200, 4))
        g["pose"][:200, 3:] = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
        if name == "cluster_max_pairs_1":
            kw["max_pairs"] = 1
    elif name == "ties":
        # nodes on a 0.125 m lattice: many pairs at exactly the same dt,
        # across rows and within a row (the four neighbours of a node)
        g = _graph(49, 64, radius=3.0)
        xy = np.stack(np.meshgrid(np.arange(7), np.arange(7)), -1).reshape(-1, 2) * 0.125
        g["pose"][:49, :3] = np.concatenate([xy, np.zeros((49, 1))], 1).astype(np.float32)
        g["pose"][:49, 3:] = np.array([1.0, 0, 0, 0], np.float32)
        kw["dist"] = 0.2
    elif name == "nan_inf":
        g = _graph(60, 64, loops=3.0, radius=1.0, loop_closure_every=7)
        g["pose"][3, 0] = np.nan
        g["pose"][8, 3:] = np.nan
        g["pose"][11, 1] = np.inf
        g["pose"][17, 2] = -np.inf
        g["pose"][23, :3] = np.inf
        g["pose"][29, 4] = np.inf
    elif name == "equal_stamps":
        g = _graph(40, 64, odom_noise=0.0, rot_noise=0.0, loops=2.0, radius=3.0)
        g["stamp"][:40] = np.repeat(g["stamp"][:40:2], 2)   # pairs of equal stamps
        g["stamp"][20:40] = g["stamp"][:20]                 # and the second lap's repeat the first's
    elif name == "none_eligible":
        g = _graph(40, 64, odom_noise=0.0, rot_noise=0.0, loops=2.0, radius=3.0)
        g["node_valid"][:] = False
    else:   # "max_pairs_32": three noisy laps, many pairs
        g = _graph(60, 64, seed=3, loops=3.0, radius=1.0, loop_closure_every=7)
        kw.update(max_pairs=32, dist=0.3, angle=25.0)
    return g, kw["dist"], kw["angle"], kw["max_pairs"]


CASES = ("cluster", "cluster_max_pairs_1", "ties", "nan_inf", "equal_stamps", "none_eligible",
         "max_pairs_32")


@pytest.mark.parametrize("cap", [LIST_CAP, 6])
@pytest.mark.parametrize("case", CASES)
def test_replayed_kernel_matches_jax_find_merge_pairs(case, cap):
    """At the kernel's list size, and at 6 keys: the subset spent after a
    round or two, the rounds then search every row."""
    g, dist, angle, max_pairs = _case(case)
    gj = jstate.GraphState(**{k: jnp.asarray(v) for k, v in g.items()})
    ref = _jax_pairs(gj, jnp.asarray(FAR), jnp.asarray(RADIUS), dist_thresh=dist,
                     angle_thresh_deg=angle, margin=MARGIN, max_pairs=max_pairs)
    ref = [np.asarray(x) for x in ref]
    pose, stamp = g["pose"].astype(np.float32), g["stamp"].astype(np.float32)
    with np.errstate(invalid="ignore"):
        d_center = np.linalg.norm(pose[:, :3] - FAR[:3], axis=-1)
        eligible = g["node_valid"] & (d_center > np.float32(RADIUS + MARGIN))
    got, cut_rows = replay_merge_pairs(pose, stamp, eligible, dist, angle, max_pairs, cap)
    for a, b, name in zip(got, ref, ("keep", "absorb", "ok")):
        np.testing.assert_array_equal(a, b, err_msg=name)
    plain = kops.merge_pairs_plain(torch.from_numpy(pose), torch.from_numpy(stamp),
                                   torch.from_numpy(eligible), dist, angle, max_pairs)
    for a, b in zip(got, plain):
        np.testing.assert_array_equal(a, b.numpy())
    n_ok = int(ref[2].sum())
    if case == "none_eligible":
        assert n_ok == 0 and not ref[0].any()
    else:
        assert n_ok > 0
    if case.startswith("cluster"):
        assert cut_rows >= 50   # rows above the buffer: the cut ran mid-row
        assert n_ok == max_pairs
    if case == "max_pairs_32":
        assert n_ok > 16


BAND = 2 ** 18
THRESHOLDS = (0.25, 0.3, 1.0, 1e-3, 7.77, 0.1, 3.0e-20, 1.5e19)


@pytest.mark.parametrize("t", THRESHOLDS)
def test_shortcuts_exact_over_a_band_around_s_star(t):
    s_star, s_hi = kops.merge_dist_bound(t)
    tf = _f32(t)
    b0 = int(np.array(s_star, np.float32).view(np.uint32))
    bits = np.arange(max(0, b0 - BAND), min(0x7F800001, b0 + BAND), dtype=np.uint32)
    s = bits.view(np.float32)
    with np.errstate(over="ignore"):
        sqrt_f32 = kops.sqrt_f32(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(np.sqrt(s), sqrt_f32)   # __fsqrt_rn is sqrt64
    np.testing.assert_array_equal(s < np.float32(s_star), sqrt_f32 < tf)
    assert np.float32(s_hi) > np.float32(s_star) or np.isinf(s_star)


def test_shortcut_thresholds_at_their_limits():
    assert all(np.isnan(v) for v in kops.merge_dist_bound(float("nan")))
    for t in (0.0, -1.0):
        s_star, s_hi = kops.merge_dist_bound(t)
        assert s_star == 0.0 and s_hi > 0.0
    s_star, s_hi = kops.merge_dist_bound(1e30)   # above fl(√FLT_MAX): every finite s passes
    assert np.isinf(s_star) and np.isinf(s_hi)
    big = np.float32(np.finfo(np.float32).max)
    assert np.sqrt(big) < np.float32(1e30)


@pytest.mark.parametrize("t", (0.25, 0.3, 1.0, 1e-3, 7.77))
def test_float32_bound_passes_every_close_pair(t):
    rng = np.random.default_rng(11)
    s_star, s_hi = kops.merge_dist_bound(t)
    n = 400_000
    # distance triples around the threshold: one axis, two, three, and
    # mixed scales (a tiny term beside large ones)
    scale = np.float32(t) * rng.uniform(0.9, 1.1, n).astype(np.float32)
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[: n // 4, 1:] = 0.0
    w[n // 4: n // 2, 2] = 0.0
    w[n // 2: 3 * n // 4, 2] *= np.float32(1e-4)
    w /= np.linalg.norm(w, axis=1, keepdims=True).astype(np.float32)
    d = (w * scale[:, None]).astype(np.float32)
    d0, d1, d2 = d[:, 0], d[:, 1], d[:, 2]
    exact = _exact_sum(d0, d1, d2)
    close = kops.sqrt_f32(torch.from_numpy(exact)).numpy() < np.float32(t)
    bound = _bound_sum(d0, d1, d2)
    assert close.sum() > 1000 and (~close).sum() > 1000
    assert (bound[close] <= np.float32(s_hi)).all()
    # how far the two sums lie apart, in ulps of the exact one
    gap = np.abs(bound.view(np.int32).astype(np.int64) - exact.view(np.int32).astype(np.int64))
    assert gap.max() <= 4 < kops.MERGE_FILTER_ULPS
