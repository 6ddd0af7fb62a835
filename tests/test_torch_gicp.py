"""The port's dense colored-cloud registration (``ops/gicp.py``) against the
JAX package's, on the CPU, with the JAX tests' own inputs
(``tests/test_gicp.py``).  Held, with their reasons:

- ``rgb_to_lab`` within 1e-4 (XLA's and torch's float32 pow and cube root
  differ by ulps; L runs 0-100);
- ``voxel_downsample`` against JAX's under ``jax.jit``, as the keyframe step
  runs it (XLA turns ``p / voxel`` into ``p * fl(1/voxel)``): the kept
  voxels, their order and validity exactly, the means within 1e-6 of the
  coordinate scale (the port sums in exact fixed point, JAX in float32);
- ``estimate_normals`` by |n · n_ref| >= 1 - 1e-5 where the two smallest
  eigenvalues of JAX's covariance are at least 1e-3 of the largest apart
  (a normal's sign is arbitrary; a near-double eigenvalue leaves it free);
- K27's merge key (``kops.argmin_key_plain``: 0 for a NaN, else the
  distance in total order + 1, then the index) picks ``torch.argmin``'s and
  ``jnp.argmin``'s index exactly, on rows with ties, infinities, NaNs and
  signed zeros; so does a numpy replay of the kernel's search (each of
  4-32 lanes a strided share of the targets, strict < with a NaN kept once
  taken, then the keys' minimum), on twins and NaNs that lie in different
  lanes;
- ``gicp_6d`` and ``register_clouds`` on the four problems: the pose within
  1e-4 (20 iterations whose 6x6 solves LAPACK and the port's LU round
  differently; on the two parallel walls only x, the one component they
  constrain), the fraction within 1e-6 and ok exactly, and each problem's
  own bar on the port's result.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import test_gicp as jtests
import torch

from uzliti_slam_tpu.frontend import camera as jcam
from uzliti_slam_tpu.io import simulator as jsim
from uzliti_slam_tpu.ops import gicp as jgicp
from uzliti_slam_tpu.ops import lie as jlie
from uzliti_slam_tpu_torch.kernels import ops as kops
from uzliti_slam_tpu_torch.ops import gicp as tgicp
from uzliti_slam_tpu_torch.ops import lie as tlie

_voxel_jit = jax.jit(jgicp.voxel_downsample, static_argnums=(3, 4))


def t(x):
    return torch.from_numpy(np.array(x))


def test_rgb_to_lab_matches_jax():
    rgb = np.random.default_rng(0).uniform(-0.1, 1.1, (2000, 3)).astype(np.float32)
    rgb[:256] = (np.arange(256, dtype=np.float32) / 255.0)[:, None]       # the step's gray
    np.testing.assert_allclose(tgicp.rgb_to_lab(t(rgb)).numpy(),
                               np.asarray(jax.jit(jgicp.rgb_to_lab)(rgb)), atol=1e-4)
    lab = tgicp.rgb_to_lab(torch.tensor([[1.0, 1.0, 1.0], [0.0, 0.0, 0.0]]))
    np.testing.assert_allclose(lab.numpy(), [[100.0, 0, 0], [0, 0, 0]], atol=0.5)


def _frame_cloud():
    """A 96x128 WallWorld frame backprojected into the base frame, as the
    keyframe step's cloud, with its gray Lab."""
    world = jsim.WallWorld(img_h=96, img_w=128)
    fr = jsim.simulate_sequence(world, n_frames=2)[1]
    dep = jnp.asarray(fr["depth"]).astype(jnp.float32) * 0.001
    pts = jlie.pose_apply(jsim.cam_extrinsic()[None],
                          jcam.backproject_image(world.cam, dep).reshape(-1, 3))
    gray = np.clip(np.asarray(fr["image"], np.float32).reshape(-1) / 255.0, 0, 1)
    lab = jgicp.rgb_to_lab(np.stack([gray] * 3, -1))
    valid = (dep.reshape(-1) > 0.1) & jnp.isfinite(dep.reshape(-1))
    return np.asarray(pts), np.asarray(lab), np.asarray(valid)


def _voxel_cases(case: int):
    if case == 0:
        pts = np.array([[0.01, 0.01, 0.0], [0.02, 0.02, 0.0], [1.0, 1.0, 1.0]], np.float32)
        return pts, np.eye(3, dtype=np.float32), np.ones(3, bool), 16
    if case == 1:
        return np.zeros((4, 3), np.float32), np.zeros((4, 3), np.float32), np.zeros(4, bool), 8
    if case in (2, 3):
        pts, rgb = map(np.asarray, jtests.colored_room(jtests.KEY))
        return pts, np.asarray(jgicp.rgb_to_lab(rgb)), np.ones(len(pts), bool), (
            64 if case == 2 else 1024)
    pts, lab, valid = _frame_cloud()
    return pts, lab, valid, 256


@pytest.mark.parametrize("case", range(5), ids=["averages", "invalid", "room_64", "room_1024",
                                                 "frame_256"])
def test_voxel_downsample_matches_jitted_jax(case):
    pts, lab, valid, V = _voxel_cases(case)
    pj, cj, vj = map(np.asarray, _voxel_jit(pts, lab, valid, 0.05, V))
    pt, ct, vt = (x.numpy() for x in tgicp.voxel_downsample(t(pts), t(lab), t(valid), 0.05, V))
    np.testing.assert_array_equal(vt, vj)
    scale = max(float(np.abs(pts).max()), 1.0)
    np.testing.assert_allclose(pt[vj], pj[vj], rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(ct[vj], cj[vj], rtol=0, atol=1e-6 * max(float(np.abs(lab).max()), 1.0))
    if case == 0:
        assert int(vt.sum()) == 2 and any(np.allclose(g, [0.015, 0.015, 0.0], atol=1e-6)
                                          for g in pt[vt])
    if case == 1:
        assert int(vt.sum()) == 0
    if case == 4:   # the step's cloud: a full budget of voxels on the wall
        assert int(vt.sum()) == V


def test_estimate_normals_matches_jax():
    pts, rgb = map(np.asarray, jtests.colored_room(jtests.KEY))
    p, _, v = map(np.asarray, _voxel_jit(pts, np.asarray(jgicp.rgb_to_lab(rgb)),
                                         np.ones(len(pts), bool), 0.05, 256))
    nj = np.asarray(jax.jit(jgicp.estimate_normals)(p, v))
    nt = tgicp.estimate_normals(t(p), t(v)).numpy()
    ev = np.linalg.eigvalsh(kops.knn_covariance_plain(t(p)[None], t(v)[None])[0].double().numpy())
    apart = (ev[:, 1] - ev[:, 0]) >= 1e-3 * ev[:, 2]
    assert apart.sum() >= 200
    dots = np.abs((nj * nt).sum(-1))
    assert dots[apart].min() >= 1 - 1e-5
    np.testing.assert_allclose(np.linalg.norm(nt, axis=-1), 1.0, atol=1e-5)


def _gicp_problem(case: int):
    """(kind, JAX args, kwargs) of tests/test_gicp.py's four problems."""
    pts, rgb = jtests.colored_room(jtests.KEY)
    allv = jnp.ones(pts.shape[0], bool)
    if case == 0:
        true_pose = jlie.se3_exp(jnp.array([0.08, -0.05, 0.03, 0.02, -0.03, 0.05]))
        src = jlie.pose_apply(jlie.pose_inverse(true_pose)[None], pts)
        return "register", (src, rgb, allv, pts, rgb, allv), {}, true_pose
    if case == 1:
        far = pts + jnp.array([50.0, 0.0, 0.0])
        return "register", (pts, rgb, allv, far, rgb, allv), {}, None
    if case == 2:
        n = 300
        u = jax.random.uniform(jtests.KEY, (n,))
        v = jax.random.uniform(jax.random.PRNGKey(1), (n,))
        wall_a = jnp.stack([jnp.zeros(n), u * 2, v], axis=-1)
        wall_b = jnp.stack([jnp.full((n,), 0.3), u * 2, v], axis=-1)
        dst = jnp.concatenate([wall_a, wall_b])
        cols = jnp.concatenate([jnp.tile(jnp.array([[1.0, 0, 0]]), (n, 1)),
                                jnp.tile(jnp.array([[0, 0, 1.0]]), (n, 1))])
        src = wall_a + jnp.array([0.12, 0.0, 0.0])
        args = (src, jgicp.rgb_to_lab(cols[:n]), jnp.ones(n, bool), dst, jgicp.rgb_to_lab(cols),
                jnp.ones(2 * n, bool))
        return "gicp", args, dict(max_corr_dist=0.4, color_weight=0.01), None
    return "register", (pts, rgb, allv, pts, rgb, allv), {}, None


@pytest.mark.parametrize("case", range(4), ids=["recovers_transform", "rejects_disjoint",
                                                 "color_disambiguates", "information"])
def test_gicp_matches_jax_and_its_bars(case):
    kind, args, kw, true_pose = _gicp_problem(case)
    targs = [t(a) for a in args]
    if kind == "register":
        rj = jgicp.register_clouds(None, *args, **kw)
        rt = tgicp.register_clouds(*targs, **kw)
    else:
        rj = jgicp.gicp_6d(*args, **kw)
        rt = tgicp.gicp_6d(*targs, **kw)
    # two parallel walls constrain only x (the rest is the 6x6 system's null
    # space, where the 1e-6 damping and rounding set the drift on each side)
    held = [0] if case == 2 else list(range(7))
    np.testing.assert_allclose(rt.pose.numpy()[held], np.asarray(rj.pose)[held], atol=1e-4)
    assert abs(float(rt.fraction) - float(rj.fraction)) <= 1e-6
    assert bool(rt.ok) == bool(rj.ok)
    np.testing.assert_array_equal(rt.information.numpy(), np.asarray(rj.information))
    if case == 0:   # tests/test_gicp.py's bars
        dt, dr = tlie.pose_distance(rt.pose, t(true_pose))
        assert bool(rt.ok) and float(dt) < 0.05 and float(dr) < 0.03 and float(rt.fraction) > 0.8
    if case == 1:
        assert not bool(rt.ok)
    if case == 2:
        assert float(rt.pose[0]) < -0.05
    if case == 3:
        info = rt.information.numpy()
        assert info[0, 0] == 100.0 and info[3, 3] == 400.0


def test_gicp_batches_problems_and_fails_a_correction_too_large():
    """A batch of targets shares one source (the keyframe step's form) and
    equals the problems one at a time; a start 2 m off fails the 1 m gate."""
    pts, rgb = map(np.asarray, jtests.colored_room(jtests.KEY))
    lab = tgicp.rgb_to_lab(t(rgb))
    p, c, v = tgicp.voxel_downsample(t(pts), lab, torch.ones(len(pts), dtype=torch.bool), 0.05, 256)
    shift = tlie.se3_exp(torch.tensor([[0.03, 0.0, 0.0, 0.0, 0.0, 0.02],
                                       [0.0, -0.04, 0.01, 0.01, 0.0, 0.0]]))
    dst = tlie.pose_apply(shift[:, None], p[None])
    init = torch.stack([tlie.pose_identity(), tlie.make_pose(torch.tensor([2.0, 0.0, 0.0]),
                                                             torch.tensor([1.0, 0, 0, 0]))])
    batch = tgicp.gicp_6d(p, c, v, dst, c.expand(2, -1, -1), v.expand(2, -1), init_pose=init)
    for b in range(2):
        one = tgicp.gicp_6d(p, c, v, dst[b], c, v, init_pose=init[b])
        torch.testing.assert_close(batch.pose[b], one.pose, rtol=0, atol=0)
    assert bool(batch.ok[0]) and not bool(batch.ok[1])
    assert float(math.dist(batch.pose[0, :3].tolist(), shift[0, :3].tolist())) < 0.01


def test_argmin_key_rule_matches_torch_and_jax_argmin():
    """K27's merge of its lanes' first minima: the least (key, index) pair,
    the key 0 for a NaN, else the distance in total order + 1 (-0 as +0),
    is argmin's first NaN, else its first smallest entry."""
    nan, inf = float("nan"), float("inf")
    rows = [[3.0, 1.0, 1.0, 2.0], [inf, inf, inf, inf], [5.0, nan, 1.0, nan],
            [inf, 2.5, inf, 2.5], [0.0, -0.0, 1.0, 0.0], [-0.0, 0.0, 2.0, 1.0],
            [-1.0, -3.0, -3.0, 4.0], [1e-30, 0.0, 1e-30, inf], [nan, nan, 0.0, 0.0],
            [3.4e38, inf, 3.4e38, 1e38]]
    rng = np.random.default_rng(0)
    rand = rng.choice(np.array([0.0, -0.0, 1.0, 2.0, np.inf, np.nan, -1.0], np.float32),
                      size=(64, 9))
    d = np.concatenate([np.asarray(rows, np.float32), rand[:, :4]])
    got = kops.first_argmin_plain(t(d)).numpy()
    np.testing.assert_array_equal(got, torch.argmin(t(d), dim=-1).numpy())
    np.testing.assert_array_equal(got, np.asarray(jnp.argmin(jnp.asarray(d), axis=-1)))
    wide = kops.first_argmin_plain(t(rand)).numpy()
    np.testing.assert_array_equal(wide, np.asarray(jnp.argmin(jnp.asarray(rand), axis=-1)))
    keys = kops.argmin_key_plain(t(np.array([nan, -0.0, 0.0, -inf, inf], np.float32)))
    assert int(keys[0]) == 0 and int(keys[1]) == int(keys[2]) and 0 < int(keys[3]) < int(keys[1])
    assert int(keys[4]) > int(keys[2])


def _lane_search_replay(d, lanes):
    """csrc/gicp.cu's ``search`` on the rows of d (R, N): lane sl scans
    targets sl, sl + lanes, ... in order, keeping its first minimum (strict
    <, a NaN kept once taken); then the least (argmin_key, index) over the
    lanes."""
    R, N = d.shape
    out = np.empty(R, np.int64)
    for r in range(R):
        keys = []
        for sl in range(min(lanes, N)):
            best, bj = np.float32(np.inf), sl
            for j in range(sl, N, lanes):
                if d[r, j] < best or (np.isnan(d[r, j]) and not np.isnan(best)):
                    best, bj = d[r, j], j
            keys.append((int(kops.argmin_key_plain(torch.tensor([best]))[0]), bj))
        out[r] = min(keys)[1]
    return out


@pytest.mark.parametrize("lanes", [4, 8, 16, 32])
def test_k27_lane_search_and_key_merge_pick_argmin(lanes):
    """The kernel's split search and key merge pick jnp.argmin's index on
    rows whose ties and NaNs fall in different lanes: twins 15 apart (the
    higher index in the lower lane at 16 lanes), NaNs at 10 and 21, rows of
    +inf, and random rows over a few values."""
    rng = np.random.default_rng(lanes)
    N = 60
    u = rng.uniform(0.0, 2.0, (6, 30)).astype(np.float32)
    twins = u[:, np.r_[0:15, 0:15, 15:30, 15:30]]
    nans = twins[:2].copy()
    nans[:, [10, 21]] = np.nan
    inf = np.full((1, N), np.inf, np.float32)
    few = rng.choice(np.array([0.0, -0.0, 1.0, 2.0, np.inf, np.nan], np.float32), size=(40, N))
    short = np.concatenate([twins[:3, :7], np.array([[np.inf, 1.0, np.nan, 1.0, 0.5, 0.5, 3.0]],
                                                     np.float32)])
    for d in (np.concatenate([twins, nans, inf, few]), short):
        want = np.asarray(jnp.argmin(jnp.asarray(d), axis=-1))
        np.testing.assert_array_equal(_lane_search_replay(d, lanes), want)
        np.testing.assert_array_equal(torch.argmin(t(d), dim=-1).numpy(), want)
