"""The port's kernel layer on a machine without a GPU or nvcc.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against its plain version there).  Here: the build is lazy and
hash-keyed, a failed nvcc lookup raises, every exported C function has a
ctypes signature of its arity, wrappers on CPU tensors run the plain
version without counting a launch, and the argument checks raise.
"""

import ctypes
import math
import re

import numpy as np
import pytest
import torch

from uzliti_slam_tpu_torch.kernels import _build
from uzliti_slam_tpu_torch.kernels import ops as kops


def test_import_does_not_build():
    assert _build._lib is None


def test_load_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load()
    assert _build._lib is None and not (tmp_path / "build").exists()


def test_source_hash_follows_the_sources(tmp_path, monkeypatch):
    for p in _build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.source_hash()
    assert _build.library_path().name == f"libuzkernels_{before}.so"
    header = tmp_path / "lie.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.source_hash() != before


def test_nvcc_flags_target_hopper_without_fast_math():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    assert {p.name for p in _build.sources()} == {
        "linearize.cu", "hvp.cu", "chain_apply.cu", "residual_chi2.cu", "relax_min.cu",
        "cluster_labels.cu", "ransac_rigid.cu", "components.cu", "chain_factor.cu", "pcg.cu",
        "occupancy.cu", "fast_nms.cu", "grid_topk.cu", "orb_describe.cu", "scan_bins.cu",
        "hamming_top2.cu", "bilateral.cu", "icp.cu", "merge_pairs.cu", "calib_gn.cu",
        "feature_votes.cu", "repository.cu", "bow_words.cu", "bow_query.cu", "voxel_grid.cu",
        "gicp.cu", "pnp.cu", "sift_describe.cu", "l2_top2.cu", "scope_match.cu",
        "delta_apply.cu", "pcg_chain.cu", "lm_step.cu", "pcg_grid.cu", "pcg_fleet.cu"}


def test_every_exported_function_has_a_signature_of_its_arity():
    exported = {}
    for src in _build.sources():
        text = src.read_text()
        for m in re.finditer(r'extern "C" int (uz_\w+)\(([^)]*)\)', text):
            exported[m.group(1)] = len([a for a in m.group(2).split(",") if a.strip()])
    assert exported.keys() == _build.SIGNATURES.keys()
    for name, arity in exported.items():
        assert len(_build.SIGNATURES[name]) == arity, name


def test_cpu_wrappers_run_the_plain_version_without_counting():
    kops.reset_launches()
    rng = np.random.default_rng(0)
    n, E = 8, 7
    ef = torch.arange(E, dtype=torch.int32)
    et = ef + 1
    J = torch.from_numpy(rng.normal(size=(3, E, 6, 6)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32))
    damp = torch.ones(n, 6)
    free = torch.ones(n)
    torch.testing.assert_close(kops.hvp(J[0], J[1], J[2], ef, et, v, damp, free),
                               kops.hvp_plain(J[0], J[1], J[2], ef, et, v, damp, free))
    assert kops.launches == {k: 0 for k in kops.launches}


def test_argument_checks_raise():
    cpu = torch.device("cpu")
    x = torch.zeros(4, 6)
    assert kops._check("x", x, (4, 6), torch.float32, cpu) == x.data_ptr()
    with pytest.raises(TypeError, match="dtype"):
        kops._check("x", x.double(), (4, 6), torch.float32, cpu)
    with pytest.raises(ValueError, match="shape"):
        kops._check("x", x, (4, 7), torch.float32, cpu)
    with pytest.raises(ValueError, match="contiguous"):
        kops._check("x", torch.zeros(6, 4).T, (4, 6), torch.float32, cpu)
    with pytest.raises(ValueError, match="on cpu"):
        kops._check("x", x, (4, 6), torch.float32, torch.device("meta"))


def _epoch_kernel_cases():
    """Small CPU inputs for K5-K8: (wrapper name, args)."""
    rng = np.random.default_rng(1)
    n, E, b = 12, 16, 10
    ef = torch.from_numpy(rng.integers(0, n, E).astype(np.int32))
    et = torch.from_numpy(rng.integers(0, n, E).astype(np.int32))
    w = torch.from_numpy(rng.uniform(0.1, 1.0, E).astype(np.float32))
    dist0 = torch.full((2, n), kops.INF)
    dist0[0, 0] = dist0[1, 5] = 0.0
    stamps = torch.from_numpy(rng.uniform(0, 20, (2, b)).astype(np.float32))
    valid_b = torch.from_numpy(rng.random(b) < 0.8)
    pts = torch.from_numpy(rng.normal(size=(1, 8, 3)).astype(np.float32)).expand(2, 8, 3)
    tri = torch.from_numpy(rng.integers(0, 8, (2, 4, 3)).astype(np.int32))
    uniforms = torch.from_numpy(rng.random((2, 12)).astype(np.float32))
    quality = torch.from_numpy(-rng.integers(0, 9, (2, 8)).astype(np.float32))
    e_valid = torch.from_numpy(rng.random(E) < 0.7)
    labels = kops.components_plain(ef, et, e_valid, n, 8)
    node_valid = torch.from_numpy(rng.random(n) < 0.8)
    stamp_n = torch.from_numpy(rng.uniform(0, 20, n).astype(np.float32))
    cand = torch.from_numpy(np.where(rng.random(b) < 0.8, rng.integers(0, E, b), -1)
                            .astype(np.int32))
    return [
        ("relax_min", (dist0, ef, et, w, 4)),
        ("cluster_labels", (stamps[0], stamps[1], valid_b, 5.0, 16)),
        ("ransac_rigid", (pts, pts + 0.01, torch.ones(2, 8, dtype=torch.bool), tri, 0.3, 3,
                          0.01)),
        ("components", (ef, et, e_valid, n, 8)),
        ("gauge_fix", (labels, torch.arange(n) < 10, torch.arange(n) == 3,
                       torch.from_numpy(rng.uniform(0, 5, n).astype(np.float32)))),
        # K7 with its draw: uniforms mapped to triplets (soft PROSAC)
        ("ransac_rigid", (pts, pts + 0.01, (torch.arange(8) % 3 > 0).expand(2, 8).contiguous(),
                          None, 0.3, 3, 0.01, None, uniforms, quality)),
        # K5's other entries and K6's roots entry
        ("relax_table", (ef, et, w, n)),
        ("relax_pairs", (torch.tensor([0, 5, 11], dtype=torch.int32),
                         torch.tensor([3, 2, 0], dtype=torch.int32), ef, et, w, n, 4)),
        ("relax_uncertainty", (stamp_n, node_valid, torch.full((n,), 7.0), ef, et, w, 4)),
        ("cluster_roots", (cand, ef, et, e_valid, node_valid, stamp_n, 5.0, 2, 1.0, 16)),
    ]


@pytest.mark.parametrize("case", range(10), ids=["relax_min", "cluster_labels", "ransac_rigid",
                                                  "components", "gauge_fix", "ransac_rigid_draw",
                                                  "relax_table", "relax_pairs",
                                                  "relax_uncertainty", "cluster_roots"])
def test_epoch_kernel_wrappers_run_their_plain_version_on_cpu(case):
    name, args = _epoch_kernel_cases()[case]
    kops.reset_launches()
    got, ref = getattr(kops, name)(*args), getattr(kops, f"{name}_plain")(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kops.launches == {k: 0 for k in kops.launches}


def test_epoch_kernel_argument_checks_raise():
    pts = torch.zeros(2, 8, 3)
    with pytest.raises(ValueError, match="strides"):
        kops._root_view("src", pts.transpose(0, 1).contiguous().transpose(0, 1), 2, 8,
                        torch.device("cpu"))
    assert kops._root_view("src", pts[:1].expand(2, 8, 3), 2, 8, torch.device("cpu"))[1] == 0
    with pytest.raises(ValueError, match="float32"):
        kops._root_view("src", pts.double(), 2, 8, torch.device("cpu"))


def _spd_chain(n: int, seed: int):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, 6, 6)).astype(np.float32)
    D = torch.from_numpy((A @ A.transpose(0, 2, 1) + 8 * np.eye(6)).astype(np.float32))
    U = torch.from_numpy((0.3 * rng.normal(size=(n, 6, 6))).astype(np.float32))
    return D, U


def _occupancy_case():
    """A 32² grid, three of five nodes active, one ray without a return."""
    from uzliti_slam_tpu_torch.mapping import occupancy

    rng = np.random.default_rng(2)
    size, bins = 32, 36
    table = torch.from_numpy(kops.pack_center_tables(*occupancy.center_tables(size, 0.1, bins)))
    scans = torch.from_numpy((0.5 + rng.random((5, bins))).astype(np.float32))
    scans[1, 3] = torch.inf
    cx = torch.tensor([16, 10, 20, 40, 16], dtype=torch.int32)
    cy = torch.tensor([16, 12, 18, 5, 16], dtype=torch.int32)
    kbin = torch.tensor([0, 5, 29, 2, 1], dtype=torch.int32)    # in [0, bins)
    idx = torch.tensor([0, 1, 4, 0, 0], dtype=torch.int32)
    return (torch.zeros(size, size), cx, cy, kbin, scans, idx, torch.tensor(3, dtype=torch.int32),
            table, 0.1, 1.5, 0.85, -0.4, 10.0, True)


@pytest.mark.parametrize("name", ["chain_factor", "pcg", "project_rays"])
def test_solve_and_map_kernel_wrappers_run_their_plain_version_on_cpu(name):
    kops.reset_launches()
    if name == "chain_factor":
        D, U = _spd_chain(40, 0)
        got, ref = kops.chain_factor(D, U, 8), kops.chain_factor_plain(D, U, 8)
        pairs = list(zip([t for lv in got[0] for t in lv] + [got[1]],
                         [t for lv in ref[0] for t in lv] + [ref[1]]))
    elif name == "pcg":
        b, z = _spd_chain(1, 1)[0][0], _spd_chain(1, 2)[0][0]
        got, ref = kops.pcg_init(b, z), kops.pcg_init_plain(b, z)
        kops.pcg_alpha(got[2], 2.0 * got[2], got[0], got[1], got[3], 1e-8)
        kops.pcg_alpha_plain(ref[2], 2.0 * ref[2], ref[0], ref[1], ref[3], 1e-8)
        kops.pcg_beta(got[1], 0.5 * got[1], got[2], got[3])
        kops.pcg_beta_plain(ref[1], 0.5 * ref[1], ref[2], ref[3])
        pairs = list(zip(got, ref))
    else:
        args = _occupancy_case()
        got = kops.project_rays(*args)
        ref, mag = kops.project_rays_plain(*args)
        pairs = [(got, ref)]
        assert (ref > 0).any() and (ref < 0).any() and float(mag.max()) > 0
    for a, b in pairs:
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kops.launches == {k: 0 for k in kops.launches}


def test_project_rays_plain_marks_and_skips_inactive_nodes():
    args = list(_occupancy_case())
    out, _ = kops.project_rays_plain(*args)
    args[-1] = False
    unmarked, _ = kops.project_rays_plain(*args)
    # node 0 and node 4 share cell (16, 16): two marks of 2·miss there
    assert float(out[16, 16] - unmarked[16, 16]) == pytest.approx(4 * -0.4, abs=1e-6)
    diff = (out - unmarked).abs() > 0
    assert int(diff.sum()) == 2 and bool(diff[12, 10])   # node 1's cell; node 2 is inactive
    args[6] = torch.tensor(0, dtype=torch.int32)          # no active node: the base grid
    assert torch.equal(kops.project_rays_plain(*args)[0], args[0])


class _FakeLib:
    """Records the C calls a wrapper makes; every call returns ``err``."""

    def __init__(self, err: int = 0):
        self.calls, self.err = [], err

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return self.err
        return call


def _meta(*shape, dtype=torch.float32):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda: lib)
    monkeypatch.setattr(kops, "_stream", lambda dev: 0)
    # a meta tensor holds no values: K14's patterns reach as far as BRIEF's
    monkeypatch.setattr(kops, "describe_reach", lambda pattern: 20)
    kops.reset_launches()
    return lib


def test_chain_factor_launches_one_level_kernel_per_level_and_the_root(fake_lib):
    """K9 is one launch a call: its levels and root are phases of one
    cooperative kernel, each level's five tensors handed over in a host
    table of device pointers."""
    levels, root_inv, n = kops.chain_factor(_meta(200, 6, 6), _meta(200, 6, 6), 16)
    assert [c[0] for c in fake_lib.calls] == ["uz_chain_factor"]
    args = fake_lib.calls[0][1]
    assert len(args) == len(_build.SIGNATURES["uz_chain_factor"])
    # (damp, free, lift) absent: D is the matrix itself; (rows, chains,
    # levels, root blocks)
    assert args[2:5] == (None, None, None) and args[5:9] == (200, 1, 4, 16)
    assert [lv[0].shape[1] for lv in levels] == [128, 64, 32, 16]
    assert tuple(root_inv.shape) == (1, 96, 96)
    # the scratch's doubles; no flag: always build; every phase
    assert args[11] == kops.chain_factor_scratch([128, 64, 32, 16], 16, 1)
    assert args[12] is None and args[14] == 0
    assert kops.launches["chain_factor"] == 1 and n == 200
    held = (levels, root_inv, n)
    kops.chain_factor(_meta(200, 6, 6), _meta(200, 6, 6), 16, held=held,
                      need=_meta(1, dtype=torch.bool))
    assert kops.launches["chain_factor"] == 2 and len(fake_lib.calls) == 2
    assert fake_lib.calls[1][1][12] is not None
    kops.chain_apply(held, _meta(200, 6))
    names = [c[0] for c in fake_lib.calls[2:]]
    assert names == ["uz_chain_forward"] * 4 + ["uz_chain_root"] + ["uz_chain_backward"] * 4
    kops.chain_apply(kops.chain_factor(_meta(12, 6, 6), _meta(12, 6, 6)), _meta(12, 6))
    root_call = fake_lib.calls[-1]
    assert root_call[0] == "uz_chain_root" and root_call[1][2:8] == (12, 12, 96, 1, 0, 12)
    assert kops.launches["chain_apply"] == 2
    # the damped form: Hb, U, damp, free and the planar lift in the one launch
    kops.chain_factor(_meta(200, 6, 6), _meta(200, 6, 6), 16, damp=_meta(200, 6),
                      free=_meta(200), lift=_meta(6))
    assert fake_lib.calls[-1][0] == "uz_chain_factor"
    assert all(a is not None for a in fake_lib.calls[-1][1][2:5])
    assert kops.launches["chain_factor"] == 4


@pytest.mark.parametrize("n, grid", [(10, False), (5461, False), (5462, True), (100_000, True)])
def test_pcg_launches_through_the_library_on_its_route(fake_lib, n, grid):
    x, r, p, scal = kops.pcg_init(_meta(n, 6), _meta(n, 6))
    kops.pcg_alpha(p, _meta(n, 6), x, r, scal, 1e-8)
    kops.pcg_beta(r, _meta(n, 6), p, scal)
    assert [c[0] for c in fake_lib.calls] == ["uz_pcg_init", "uz_pcg_alpha", "uz_pcg_beta"]
    assert fake_lib.calls[0][1][2:4] == (6 * n, 1) and kops.launches["pcg"] == 3
    # the grid route's partials: two per 4096-float chunk; none on one CTA
    partials = [c[1][-2] for c in fake_lib.calls]
    assert all((ptr is not None) == grid for ptr in partials)
    assert tuple(scal.shape) == (1, 4)


def test_project_rays_launches_through_the_library(fake_lib):
    i32 = torch.int32
    out = kops.project_rays(_meta(32, 32), _meta(5, dtype=i32), _meta(5, dtype=i32),
                            _meta(5, dtype=i32), _meta(5, 36), _meta(5, dtype=i32),
                            _meta((), dtype=i32), _meta(1024, 4), 0.1, 6.0, 0.85, -0.4, 10.0,
                            True)
    assert tuple(out.shape) == (32, 32) and kops.launches["project_rays"] == 1
    assert fake_lib.calls[-1][0] == "uz_project_rays"
    # (base, table, scans, bins, cx, cy, kbin, idx, count, size, res, band, ...)
    assert fake_lib.calls[-1][1][3] == 36 and fake_lib.calls[-1][1][9] == 32
    assert fake_lib.calls[-1][1][10:18] == pytest.approx((0.1, 0.071, 6.0, 0.85, -0.4, 10.0, 1,
                                                          -0.8))


def test_a_failed_launch_raises_and_is_not_counted(fake_lib):
    fake_lib.err = 9
    with pytest.raises(RuntimeError, match="chain_factor: CUDA launch failed with cudaError_t 9"):
        kops.chain_factor(_meta(64, 6, 6), _meta(64, 6, 6))
    with pytest.raises(RuntimeError, match="pcg: CUDA launch failed"):
        kops.pcg_init(_meta(4, 6), _meta(4, 6))
    assert kops.launches["chain_factor"] == kops.launches["pcg"] == 0


def test_solve_and_map_kernel_argument_checks_raise(fake_lib):
    D = _meta(200, 6, 6)
    with pytest.raises(ValueError, match="refresh flag needs a held factor"):
        kops.chain_factor(D, D, 16, need=_meta(1, dtype=torch.bool))
    with pytest.raises(ValueError, match="at most 64"):
        kops.chain_factor(D, D, 128)
    held = kops.chain_factor(_meta(100, 6, 6), _meta(100, 6, 6), 16)
    with pytest.raises(ValueError, match="other shapes"):
        kops.chain_factor(D, D, 16, held=held, need=_meta(1, dtype=torch.bool))
    held = kops.chain_factor(D, D, 16)
    with pytest.raises(TypeError, match="need: dtype"):
        kops.chain_factor(D, D, 16, held=held, need=_meta(1))
    with pytest.raises(ValueError, match="U: shape"):
        kops.chain_factor(D, _meta(199, 6, 6), 16)
    with pytest.raises(ValueError, match="Hp: shape"):
        kops.pcg_alpha(_meta(4, 6), _meta(5, 6), _meta(4, 6), _meta(4, 6), _meta(1, 4), 1e-8)
    with pytest.raises(ValueError, match="scal: shape"):
        kops.pcg_beta(_meta(4, 6), _meta(4, 6), _meta(4, 6), _meta(1, 3))
    i32 = torch.int32
    good = [_meta(32, 32), _meta(5, dtype=i32), _meta(5, dtype=i32), _meta(5, dtype=i32),
            _meta(5, 36), _meta(5, dtype=i32), _meta((), dtype=i32), _meta(1024, 4)]
    for pos, bad, err in ((5, _meta(5, dtype=torch.int64), "idx: dtype"),
                          (6, _meta(1, dtype=i32), "count: shape"),
                          (7, _meta(1024, 4, dtype=i32), "table: dtype"),
                          (7, _meta(1024, 3), "table: shape"),
                          (4, _meta(5, 36, dtype=torch.float64), "scans: dtype")):
        args = list(good)
        args[pos] = bad
        with pytest.raises((TypeError, ValueError), match=err):
            kops.project_rays(*args, 0.1, 6.0, 0.85, -0.4, 10.0, True)
    # only the two factors built for the held-factor cases reached the library
    assert [c[0] for c in fake_lib.calls] == ["uz_chain_factor"] * 2


def _frontend_cases():
    """Small CPU inputs for K12-K15: (wrapper name, args)."""
    from uzliti_slam_tpu_torch.frontend import camera
    from uzliti_slam_tpu_torch.ops import features, scan

    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(0, 256, (2, 60, 72)).astype(np.float32))
    score = kops.fast_nms_plain(img, 20.0)
    uv = kops.grid_topk_plain(score, 16, 4)[0]
    depth = torch.from_numpy(rng.uniform(0.5, 4.0, (2, 24, 32)).astype(np.float32))
    cam = camera.PinholeCamera(40.0, 40.0, 16.0, 12.0, 32, 24)
    pose = torch.tensor([[0.0, 0.0, 0.5, 0.5, -0.5, 0.5, -0.5]] * 2)
    xf = scan.depth_camera_transform(pose)
    return [
        ("fast_nms", (img, 20.0)),
        ("fast_nms", ([img, img[:, 5:50, 3:64].contiguous()], 20.0)),
        ("grid_topk", (score, 16, 4)),
        ("grid_topk", (score, 8, 4)),
        ("orb_describe_levels", ([[kops.DescribeRow(img, uv, features.pattern("brief", "cpu")),
                                   kops.DescribeRow(img, uv[:, :5],
                                                    features.pattern("freak", "cpu"))],
                                  [features.gist_row(img[:1], 0.3)]],)),
        ("scan_bins", (depth, cam, xf, 90, -np.pi, np.pi, (-0.4, 0.6), 6.0, 0.3)),
    ]


@pytest.mark.parametrize("case", range(6), ids=["fast_nms", "fast_nms_levels", "grid_topk",
                                                 "grid_topk_global", "orb_describe", "scan_bins"])
def test_frontend_kernel_wrappers_run_their_plain_version_on_cpu(case):
    name, args = _frontend_cases()[case]
    kops.reset_launches()
    got, ref = getattr(kops, name)(*args), getattr(kops, f"{name}_plain")(*args)
    for a, b in zip(got if isinstance(got, (tuple, list)) else (got,),
                    ref if isinstance(ref, (tuple, list)) else (ref,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kops.launches == {k: 0 for k in kops.launches}


def test_frontend_kernels_launch_through_the_library(fake_lib):
    from uzliti_slam_tpu_torch.frontend import camera

    # K12: every level in one launch, the levels in a host table of (img,
    # out, H, W) rows read while the call runs; the maps are views of one
    # buffer, laid end to end
    nms_tables = []

    def fast_nms_levels(levels, n_levels, C, t, stream):
        nms_tables.append(np.array((ctypes.c_longlong * (4 * n_levels)).from_address(levels)))
        fake_lib.calls.append(("uz_fast_nms_levels", (levels, n_levels, C, t, stream)))
        return 0

    fake_lib.uz_fast_nms_levels = fast_nms_levels
    shapes = [(480, 640), (400, 533), (333, 444), (278, 370)]
    maps = kops.fast_nms([_meta(2, h, w) for h, w in shapes], 20.0)
    assert kops.launches["fast_nms"] == 1
    assert fake_lib.calls[-1][0] == "uz_fast_nms_levels"
    assert fake_lib.calls[-1][1][1:4] == (4, 2, 20.0)
    assert nms_tables[-1].reshape(4, 4)[:, 2:].tolist() == [list(hw) for hw in shapes]
    assert [tuple(m.shape) for m in maps] == [(2, h, w) for h, w in shapes]
    assert all(m._base is maps[0]._base for m in maps) and all(m.is_contiguous() for m in maps)
    assert [m.storage_offset() for m in maps] == [0, 614400, 1040800, 1336504]
    # one level's tensor: one row, its one map
    assert tuple(kops.fast_nms(_meta(2, 48, 64), 20.0).shape) == (2, 48, 64)
    assert fake_lib.calls[-1][1][1:4] == (1, 2, 20.0)
    assert nms_tables[-1].tolist()[2:] == [48, 64]
    # 16 cells x 4 = k_total: no scratch; 16 cells x 1 > 8: the global top-k's scratch;
    # (levels, C, grid, k_cell, k_total, scratch) after the host table of levels
    uv, resp, valid = kops.grid_topk(_meta(2, 48, 64), 64, 4)
    assert fake_lib.calls[-1][0] == "uz_grid_topk"
    assert fake_lib.calls[-1][1][1:7] == (1, 2, 4, 4, 64, None)
    assert tuple(uv.shape) == (2, 64, 2) and valid.dtype == torch.bool
    kops.grid_topk(_meta(2, 48, 64), 8, 4)
    assert fake_lib.calls[-1][1][1:6] == (1, 2, 4, 1, 8) and fake_lib.calls[-1][1][6] is not None
    # every pyramid level in one call: one launch, the outputs stacked by level
    uv, resp, valid = kops.grid_topk([_meta(2, 48, 64), _meta(2, 40, 53), _meta(2, 33, 44)], 64, 4)
    assert fake_lib.calls[-1][1][1:7] == (3, 2, 4, 4, 64, None)
    assert tuple(uv.shape) == (3, 2, 64, 2) and tuple(valid.shape) == (3, 2, 64)
    assert all(lv.is_contiguous() for lv in uv)
    # K14: every row (two levels of two cameras in one block, a GIST with
    # its given angle in another) in one launch, the rows in a host table of
    # (img, uv, pattern, given, angles, desc, C, H, W, K, stride), read while
    # the call runs: a block's rows written side by side, camera c's
    # keypoint k at c·stride + k
    tables = []

    def describe_rows(rows, n_rows, stream):
        tables.append(np.array((ctypes.c_longlong * (11 * n_rows)).from_address(rows)))
        fake_lib.calls.append(("uz_orb_describe_rows", (rows, n_rows, stream)))
        return 0

    fake_lib.uz_orb_describe_rows = describe_rows
    (a0, d0), (ag, dg) = kops.orb_describe_levels(
        [[kops.DescribeRow(_meta(2, 48, 64), _meta(2, 16, 2), _meta(256, 2, 2)),
          kops.DescribeRow(_meta(2, 40, 53), _meta(2, 12, 2), _meta(256, 2, 2))],
         [kops.DescribeRow(_meta(1, 63, 63), _meta(1, 1, 2), _meta(256, 2, 2), _meta(1, 1))]])
    assert fake_lib.calls[-1][0] == "uz_orb_describe_rows" and fake_lib.calls[-1][1][1] == 3
    table = tables[-1].reshape(3, 11)
    assert table[:, 6:].tolist() == [[2, 48, 64, 16, 28], [2, 40, 53, 12, 28], [1, 63, 63, 1, 1]]
    # the second row's outputs start 16 keypoints into the block's
    assert table[1, 4] - table[0, 4] == 4 * 16 and table[1, 5] - table[0, 5] == 32 * 16
    assert tuple(d0.shape) == (2, 28, 32) and d0.dtype == torch.uint8
    assert tuple(a0.shape) == (2, 28) and tuple(dg.shape) == (1, 1, 32)
    # rows with no keypoint launch nothing, and count nothing
    (a1, d1), = kops.orb_describe_levels(
        [[kops.DescribeRow(_meta(2, 48, 64), _meta(2, 0, 2), _meta(256, 2, 2))]])
    assert len(tables) == 1 and tuple(d1.shape) == (2, 0, 32)
    cam = camera.PinholeCamera(40.0, 40.0, 16.0, 12.0, 64, 48)
    near, far = kops.scan_bins(_meta(2, 48, 64), cam, _meta(2, 12), 360, -np.pi, np.pi,
                               (-0.4, 0.6), 6.0, 0.3)
    assert tuple(near.shape) == tuple(far.shape) == (2, 360)
    args = fake_lib.calls[-1][1]
    assert fake_lib.calls[-1][0] == "uz_scan_bins" and args[2:5] == (2, 48, 64)
    assert args[9] == 360 and args[12] == pytest.approx(360 / (2 * np.pi), rel=1e-6)
    assert args[17] == pytest.approx((2**21 - 1) / 6.006, rel=1e-6)
    assert kops.launches["fast_nms"] == 2 and kops.launches["grid_topk"] == 3
    assert kops.launches["orb_describe"] == 1 and kops.launches["scan_bins"] == 1


def test_frontend_kernel_argument_checks_raise(fake_lib, monkeypatch):
    from uzliti_slam_tpu_torch.frontend import camera

    with pytest.raises(ValueError, match="expected \\(C, H, W\\)"):
        kops.fast_nms(_meta(48, 64), 20.0)
    with pytest.raises(TypeError, match="img: dtype"):
        kops.fast_nms(_meta(1, 48, 64, dtype=torch.float64), 20.0)
    # the levels of one call: the same cameras, at least one, float32,
    # contiguous (more than 8 take ⌈L/8⌉ launches: the next test)
    with pytest.raises(ValueError, match="img: shape"):
        kops.fast_nms([_meta(2, 48, 64), _meta(1, 40, 53)], 20.0)
    with pytest.raises(ValueError, match="no level"):
        kops.fast_nms([], 20.0)
    with pytest.raises(TypeError, match="img: dtype"):
        kops.fast_nms([_meta(1, 48, 64), _meta(1, 40, 53, dtype=torch.float64)], 20.0)
    with pytest.raises(ValueError, match="img: not contiguous"):
        kops.fast_nms([_meta(1, 48, 64), _meta(1, 53, 40).transpose(1, 2)], 20.0)
    with pytest.raises(ValueError, match="per cell"):
        kops.grid_topk(_meta(1, 8, 8), 128, 4)
    with pytest.raises(ValueError, match="per cell"):
        kops.grid_topk([_meta(1, 48, 64), _meta(1, 8, 8)], 128, 4)
    with pytest.raises(ValueError, match="score: shape"):
        kops.grid_topk([_meta(1, 48, 64), _meta(2, 40, 53)], 64, 4)
    with pytest.raises(ValueError, match="no level"):
        kops.grid_topk([], 64, 4)
    row = kops.DescribeRow
    with pytest.raises(ValueError, match="pattern: shape"):
        kops.orb_describe_levels([[row(_meta(1, 48, 64), _meta(1, 4, 2), _meta(128, 2, 2))]])
    with pytest.raises(ValueError, match="angles: shape"):
        kops.orb_describe_levels([[row(_meta(1, 48, 64), _meta(1, 4, 2), _meta(256, 2, 2))],
                                  [row(_meta(1, 48, 64), _meta(1, 4, 2), _meta(256, 2, 2),
                                       _meta(1, 5))]])
    with pytest.raises(ValueError, match="img: shape"):
        # a block's rows lie on the same cameras
        kops.orb_describe_levels([[row(_meta(2, 48, 64), _meta(2, 4, 2), _meta(256, 2, 2)),
                                   row(_meta(1, 40, 53), _meta(1, 4, 2), _meta(256, 2, 2))]])
    with pytest.raises(ValueError, match="1..16"):
        kops.orb_describe_levels([[row(_meta(1, 48, 64), _meta(1, 4, 2), _meta(256, 2, 2))] * 17])
    with pytest.raises(ValueError, match="pattern: not 16-byte aligned"):
        kops.orb_describe_levels([[row(_meta(1, 48, 64), _meta(1, 4, 2),
                                       _meta(1025)[1:].view(256, 2, 2))]])
    # a pattern whose window exceeds the kernel's 72 rows x 76 floats: the
    # GIST's (reach 39) fits its 63x63 image, not a VGA level
    monkeypatch.setattr(kops, "describe_reach", lambda pattern: 39)
    kops.orb_describe_levels([[row(_meta(1, 63, 63), _meta(1, 1, 2), _meta(256, 2, 2))]])
    with pytest.raises(ValueError, match="79 rows of 82 floats"):
        kops.orb_describe_levels([[row(_meta(1, 480, 640), _meta(1, 4, 2), _meta(256, 2, 2))]])
    monkeypatch.setattr(kops, "describe_reach", lambda pattern: 35)
    kops.orb_describe_levels([[row(_meta(1, 480, 640), _meta(1, 4, 2), _meta(256, 2, 2))]])
    assert [c[0] for c in fake_lib.calls] == ["uz_orb_describe_rows"] * 2
    fake_lib.calls.clear()
    cam = camera.PinholeCamera(40.0, 40.0, 16.0, 12.0, 64, 48)
    with pytest.raises(ValueError, match="1..1023"):
        kops.scan_bins(_meta(1, 48, 64), cam, _meta(1, 12), 1024, -np.pi, np.pi, (-0.4, 0.6),
                       6.0, 0.3)
    with pytest.raises(ValueError, match="xf: shape"):
        kops.scan_bins(_meta(1, 48, 64), cam, _meta(1, 7), 360, -np.pi, np.pi, (-0.4, 0.6),
                       6.0, 0.3)
    assert fake_lib.calls == []


def _keyframe_cases():
    """Small CPU inputs for K16-K18: (wrapper name, args)."""
    rng = np.random.default_rng(4)
    t = torch.from_numpy
    query = t(rng.integers(0, 256, (20, 32)).astype(np.uint8))
    bank = t(rng.integers(0, 256, (6, 16, 32)).astype(np.uint8))
    bank[2, 3] = query[0]
    bank_valid = t(rng.random((6, 16)) < 0.8)
    gbank = t(rng.integers(0, 256, (12, 32)).astype(np.uint8))
    depth = t(rng.uniform(0.5, 4.0, (2, 20, 24)).astype(np.float32))
    depth[0, 3:6, 4:9] = 0.0
    guide = t(rng.integers(0, 256, (2, 20, 24)).astype(np.float32))
    th = np.linspace(-np.pi, np.pi, 60, endpoint=False)
    dst = np.stack([3 * np.cos(th), 2 * np.sin(th)], -1).astype(np.float32)
    src = (dst - np.array([0.05, -0.02], np.float32)).astype(np.float32)
    ones = torch.ones(2, 60, dtype=torch.bool)
    return [
        ("hamming_top2", (query, bank, bank_valid, t(np.array([2, 0, 5], np.int32)),
                          t(rng.random(20) < 0.9), 0.9, 64.0)),
        ("gist_topk", (query[0], gbank, t(rng.uniform(0, 20, 12).astype(np.float32)),
                       t(rng.random(12) < 0.8), torch.tensor(15.0), 5, 5.0, 110.0)),
        ("bilateral", (depth, guide)),
        ("icp", (t(np.stack([src, src])), ones, t(np.stack([dst, dst])), ones,
                 torch.zeros(2, 3), 10, 0.25, 0.25, 1.5, 0.8, 0.0004)),
    ]


@pytest.mark.parametrize("case", range(4), ids=["hamming_top2", "gist_topk", "bilateral", "icp"])
def test_keyframe_kernel_wrappers_run_their_plain_version_on_cpu(case):
    name, args = _keyframe_cases()[case]
    kops.reset_launches()
    got, ref = getattr(kops, name)(*args), getattr(kops, f"{name}_plain")(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kops.launches == {k: 0 for k in kops.launches}
    if name == "hamming_top2":
        assert int(got[0][0, 0]) == 3 and float(got[2][0, 0]) == 0.0
    if name == "icp":
        assert bool(got[4].all())


def test_lu3_solves_and_inverts_with_partial_pivoting():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(50, 3, 3)).astype(np.float32)
    A[0] = [[0.0, 1.0, 2.0], [1.0, 0.0, 3.0], [4.0, -3.0, 8.0]]      # a zero leading pivot
    b = rng.normal(size=(50, 3)).astype(np.float32)
    x = kops.lu_solve_plain(torch.from_numpy(A), torch.from_numpy(b))
    np.testing.assert_allclose(x.numpy(),
                               np.linalg.solve(A.astype(np.float64), b[..., None])[..., 0],
                               rtol=1e-3, atol=1e-3)
    # the zero leading pivot takes row 2 (the largest |a_i0|): exact in float32
    np.testing.assert_array_equal(x[0].numpy(), np.linalg.solve(A[0].astype(np.float64),
                                                                b[0]).astype(np.float32))
    inv = kops.inv3(torch.from_numpy(A))
    np.testing.assert_allclose(inv.numpy() @ A, np.broadcast_to(np.eye(3), A.shape), atol=1e-3)
    # several right-hand sides: each column as its own solve, bit for bit
    cols = torch.stack([kops.lu_solve_plain(torch.from_numpy(A), torch.eye(3)[:, c].expand(50, 3))
                        for c in range(3)], dim=-1)
    assert torch.equal(inv, cols)


def test_keyframe_kernels_launch_through_the_library(fake_lib):
    u8, i32, b = torch.uint8, torch.int32, torch.bool
    idx, ok, best = kops.hamming_top2(_meta(256, 32, dtype=u8), _meta(512, 256, 32, dtype=u8),
                                      _meta(512, 256, dtype=b), _meta(10, dtype=i32),
                                      _meta(256, dtype=b), 0.9, 64.0)
    assert fake_lib.calls[-1][0] == "uz_hamming_top2"
    assert fake_lib.calls[-1][1][5:10] == (10, 256, 256, 0.9, 64.0)
    assert tuple(idx.shape) == (10, 256) and ok.dtype == b and best.dtype == torch.float32
    slots, dist, gok = kops.gist_topk(_meta(32, dtype=u8), _meta(512, 32, dtype=u8),
                                      _meta(512), _meta(512, dtype=b), _meta(()), 5, 5.0, 60.0)
    assert fake_lib.calls[-1][0] == "uz_gist_topk" and fake_lib.calls[-1][1][5:9] == (512, 5, 5.0,
                                                                                      60.0)
    assert tuple(slots.shape) == (5,) and slots.dtype == i32
    # no shared-memory cap: 8,000 stored descriptors a node, a 100k-node GIST bank
    kops.hamming_top2(_meta(256, 32, dtype=u8), _meta(4, 8000, 32, dtype=u8),
                      _meta(4, 8000, dtype=b), _meta(2, dtype=i32), _meta(256, dtype=b), 0.9, 64.0)
    assert fake_lib.calls[-1][1][5:8] == (2, 256, 8000)
    kops.gist_topk(_meta(32, dtype=u8), _meta(100_000, 32, dtype=u8), _meta(100_000),
                   _meta(100_000, dtype=b), _meta(()), 100_000, 5.0, 60.0)
    assert fake_lib.calls[-1][1][5:7] == (100_000, 100_000)
    out = kops.bilateral(_meta(2, 480, 640), _meta(2, 480, 640))
    args = fake_lib.calls[-1][1]
    assert fake_lib.calls[-1][0] == "uz_bilateral" and args[2:5] == (2, 480, 640)
    assert args[6] == kops.NEG_INV_2SC2 and tuple(out.shape) == (2, 480, 640)
    # the 25 spatial weights: one host table a process, the same on every call
    table = kops.bilateral_spatial_host()
    assert args[5] == table.buffer_info()[0] and list(table) == list(kops.bilateral_spatial())
    assert args[8] is None      # no tile paths asked for
    pose, frac, mse, cov, iok = kops.icp(_meta(1, 360, 2), _meta(1, 360, dtype=b),
                                         _meta(1, 360, 2), _meta(1, 360, dtype=b), _meta(1, 3),
                                         20, 0.25, 0.25, 1.5, 0.8, 0.0004)
    args = fake_lib.calls[-1][1]
    assert fake_lib.calls[-1][0] == "uz_icp" and args[5:9] == (1, 360, 360, 20)
    assert args[9:14] == pytest.approx((0.25, 0.25, 1.5, 0.8, 0.0004))
    assert tuple(cov.shape) == (1, 3, 3) and iok.dtype == b
    # the re-registration's batch: one launch for the four problems
    kops.icp(_meta(4, 360, 2), _meta(4, 360, dtype=b), _meta(4, 360, 2), _meta(4, 360, dtype=b),
             _meta(4, 3), 20, 0.25, 0.25, 1.5, 0.8, 0.0004)
    assert fake_lib.calls[-1][1][5:9] == (4, 360, 360, 20) and len(fake_lib.calls[-1][1]) == 20
    # the matching and the GIST query are one kernel, one count
    assert kops.launches["hamming_top2"] == 4
    assert kops.launches["bilateral"] == 1 and kops.launches["icp"] == 2
    # with the tile paths: a (C, ceil(H / 16), ceil(W / 32)) int32 map
    out, paths = kops.bilateral(_meta(2, 470, 630), _meta(2, 470, 630), tile_paths=True)
    args = fake_lib.calls[-1][1]
    assert args[5] == kops.bilateral_spatial_host().buffer_info()[0] and args[8] is not None
    assert tuple(paths.shape) == (2, 30, 20) and paths.dtype == torch.int32
    assert kops.launches["bilateral"] == 2


def test_keyframe_kernel_argument_checks_raise(fake_lib):
    u8, i32, b = torch.uint8, torch.int32, torch.bool
    with pytest.raises(TypeError, match="cslot: dtype"):
        kops.hamming_top2(_meta(8, 32, dtype=u8), _meta(4, 16, 32, dtype=u8), _meta(4, 16, dtype=b),
                          _meta(2, dtype=torch.int64), _meta(8, dtype=b), 0.9, 64.0)
    with pytest.raises(ValueError, match="query: not 16-byte aligned"):
        kops.hamming_top2(_meta(9 * 32, dtype=u8)[4: 4 + 8 * 32].view(8, 32),
                          _meta(4, 16, 32, dtype=u8), _meta(4, 16, dtype=b), _meta(2, dtype=i32),
                          _meta(8, dtype=b), 0.9, 64.0)
    with pytest.raises(ValueError, match="bank: not 16-byte aligned"):
        kops.gist_topk(_meta(32, dtype=u8), _meta(9 * 32, dtype=u8)[8: 8 + 8 * 32].view(8, 32),
                       _meta(8), _meta(8, dtype=b), _meta(()), 5, 5.0, 60.0)
    with pytest.raises(ValueError, match="k = 9 of a 8-entry bank"):
        kops.gist_topk(_meta(32, dtype=u8), _meta(8, 32, dtype=u8), _meta(8), _meta(8, dtype=b),
                       _meta(()), 9, 5.0, 60.0)
    with pytest.raises(ValueError, match="q_stamp: shape"):
        kops.gist_topk(_meta(32, dtype=u8), _meta(8, 32, dtype=u8), _meta(8), _meta(8, dtype=b),
                       _meta(1), 5, 5.0, 60.0)
    with pytest.raises(ValueError, match="guide: shape"):
        kops.bilateral(_meta(1, 48, 64), _meta(1, 48, 63))
    with pytest.raises(ValueError, match="2..8192"):
        kops.icp(_meta(1, 360, 2), _meta(1, 360, dtype=b), _meta(1, 9000, 2),
                 _meta(1, 9000, dtype=b), _meta(1, 3), 20, 0.25, 0.25, 1.5, 0.8, 0.0004)
    with pytest.raises(ValueError, match="init: shape"):
        kops.icp(_meta(2, 360, 2), _meta(2, 360, dtype=b), _meta(2, 360, 2),
                 _meta(2, 360, dtype=b), _meta(1, 3), 20, 0.25, 0.25, 1.5, 0.8, 0.0004)
    assert fake_lib.calls == []


def _maintenance_cases():
    """Small CPU inputs for K19, K20 and K15's bin_min_max: (name, args)."""
    from uzliti_slam_tpu_torch.io import synthetic

    g, _ = synthetic.make_pose_graph(24, odom_noise=0.0, rot_noise=0.0, loops=2.0, radius=1.5,
                                     device="cpu")
    rng = np.random.default_rng(4)
    cal, _ = synthetic.biased_odometry_graph([1.04, 0.05, 0.03], 12, device="cpu")
    ef, et = cal.e_from.long(), cal.e_to.long()
    E = cal.edge_capacity
    zeros = torch.zeros(E, dtype=torch.int32)
    pts = torch.from_numpy(rng.uniform(-7.0, 7.0, (2, 300, 2)).astype(np.float32))
    ok = torch.from_numpy(rng.random((2, 300)) < 0.7)
    return [
        ("merge_pairs", (g.pose, g.stamp, g.node_valid, 0.3, 20.0, 16)),
        ("calib_gn", (cal.pose[ef], cal.pose[et], cal.e_transform, torch.zeros(E, dtype=torch.bool),
                      (cal.e_type == 104) & cal.e_valid, zeros, zeros,
                      torch.tensor([[0.0, 0, 0, 1, 0, 0, 0]]), 3, 1e2, 1e-6)),
        ("bin_min_max", (pts, ok, 30, -math.pi, math.pi, 6.0, 0.05)),
    ]


@pytest.mark.parametrize("case", range(3), ids=["merge_pairs", "calib_gn", "bin_min_max"])
def test_maintenance_kernel_wrappers_run_their_plain_version_on_cpu(case):
    name, args = _maintenance_cases()[case]
    kops.reset_launches()
    got, ref = getattr(kops, name)(*args), getattr(kops, f"{name}_plain")(*args)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kops.launches == {k: 0 for k in kops.launches}
    if name == "merge_pairs":   # two noise-free laps: some pairs, then empty rounds
        assert bool(got[2][0]) and not bool(got[2][-1])
    if name == "calib_gn":
        assert tuple(got[0].shape) == (9,) and tuple(got[1].shape) == (4,)


def test_bin_min_max_batches_scans_as_the_one_scan_form():
    """The plain bin_min_max (the points entry) on a batch gives, row for
    row, what it gives one scan, which is the reduction core
    ``scan._bin_min_max`` on the points' ranges, flags and bins with the
    far range finished to +inf; the core's empty bin is +inf / -inf."""
    from uzliti_slam_tpu_torch.ops import scan

    _, (pts, ok, n_bins, a0, a1, max_range, min_range) = _maintenance_cases()[2]
    near, far = kops.bin_min_max_plain(pts, ok, n_bins, a0, a1, max_range, min_range)
    for b in range(2):
        n1, f1 = kops.bin_min_max_plain(pts[b], ok[b], n_bins, a0, a1, max_range, min_range)
        assert torch.equal(near[b], n1) and torch.equal(far[b], f1)
        x, y = pts[b, :, 0], pts[b, :, 1]
        rng, bearing = scan._hypot(x, y), torch.atan2(y, x)
        keep = scan._planar_ok(rng, bearing, ok[b], a0, a1, max_range, min_range)
        bins = scan.bin_index(bearing, n_bins, a0, a1)
        n2, f2 = scan._bin_min_max(rng, keep, bins, n_bins, max_range)
        assert torch.equal(n1, n2) and torch.equal(f1, torch.where(f2 > 0, f2, math.inf))
    n1, f1 = kops.bin_reduce_plain(rng, keep & (bins != 3), bins, n_bins, max_range)
    assert n1[3] == math.inf and f1[3] == -math.inf


def test_maintenance_kernels_launch_through_the_library(fake_lib):
    i32, b = torch.int32, torch.bool
    keep, absorb, ok = kops.merge_pairs(_meta(500, 7), _meta(500), _meta(500, dtype=b), 0.25,
                                        15.0, 16)
    args = fake_lib.calls[-1][1]
    # (n, dist_thresh, its squared-distance bound s_hi, angle, max_pairs); then
    # the key slots, the histograms and the arrival counter after them
    s_star, s_hi = kops.merge_dist_bound(0.25)
    assert fake_lib.calls[-1][0] == "uz_merge_pairs" and args[3:8] == (500, 0.25, s_hi, 15.0,
                                                                        16)
    assert len(args) == len(_build.SIGNATURES["uz_merge_pairs"])
    assert np.float32(np.sqrt(np.float64(s_star))) >= np.float32(0.25) and s_hi > s_star
    assert args[10] - args[9] == 4 * kops.MERGE_HIST_BINS
    assert tuple(keep.shape) == (16,) and keep.dtype == i32 and ok.dtype == b
    theta, hist = kops.calib_gn(_meta(4096, 7), _meta(4096, 7), _meta(4096, 7),
                                _meta(4096, dtype=b), _meta(4096, dtype=b),
                                _meta(4096, dtype=i32), _meta(4096, dtype=i32), _meta(2, 7), 20,
                                1e2, 1e-6)
    args = fake_lib.calls[-1][1]
    # (E, S, iterations, √100 = 10, damping), then the scratch of the 16
    # CTAs' shares of 4,096 edges
    assert fake_lib.calls[-1][0] == "uz_calib_gn" and args[8:13] == (4096, 2, 20, 10.0, 1e-6)
    assert len(args) == len(_build.SIGNATURES["uz_calib_gn"])
    assert tuple(theta.shape) == (15,) and tuple(hist.shape) == (21,)
    kops.calib_gn(_meta(300, 7), _meta(300, 7), _meta(300, 7), _meta(300, dtype=b),
                  _meta(300, dtype=b), _meta(300, dtype=i32), _meta(300, dtype=i32),
                  _meta(1, 7), 5, 1e2, 1e-6)
    args = fake_lib.calls[-1][1]
    # one camera: 6 + 3 parameters; the scratch holds each CTA's share of 300 edges
    assert args[8:13] == (300, 1, 5, 10.0, 1e-6)
    assert kops.CALIB_CLUSTER_CTAS == 16 and kops.calib_scratch_ints(300) == 16 * (30 * 19 + 1)
    near, far = kops.bin_min_max(_meta(16, 720, 2), _meta(16, 720, dtype=b), 360, -math.pi,
                                 math.pi, 6.0, 0.05)
    args = fake_lib.calls[-1][1]
    # (B, P, D, n_bins) after the points and their flags; the bin factor,
    # the ranges, no band for planar points
    assert fake_lib.calls[-1][0] == "uz_bin_min_max" and args[2:6] == (16, 720, 2, 360)
    assert args[8] == pytest.approx(360 / (2 * np.pi), rel=1e-6) and args[9:11] == (0.05, 6.0)
    assert len(args) == len(_build.SIGNATURES["uz_bin_min_max"])
    assert tuple(near.shape) == tuple(far.shape) == (16, 360)
    # a cloud: (x, y, z) points with the height band, one scan
    kops.bin_min_max(_meta(1, 4000, 3), _meta(1, 4000, dtype=b), 180, -math.pi, math.pi, 6.0,
                     0.3, (0.1, 1.0))
    args = fake_lib.calls[-1][1]
    assert args[2:6] == (1, 4000, 3, 180) and args[11:13] == (0.1, 1.0)
    assert kops.launches["merge_pairs"] == 1 and kops.launches["calib_gn"] == 2
    assert kops.launches["bin_min_max"] == 2


def test_ransac_rigid_launches_once_with_its_draw(fake_lib):
    """K7 is one C call a batch of roots, the draw included: the uniforms
    and the quality go in, the triplets come out (a view of the one output
    allocation); with triplets given, the kernel reads them and writes
    none.  The argument order follows ``_build.SIGNATURES``."""
    i32, b = torch.int32, torch.bool
    src = _meta(1, 256, 3).expand(5, 256, 3)
    out = kops.ransac_rigid(src, _meta(5, 256, 3), _meta(5, 256, dtype=b), None, 0.05, 12,
                            0.01, uniforms=_meta(5, 384), quality=_meta(5, 256))
    name, args = fake_lib.calls[-1]
    assert name == "uz_ransac_rigid" and len(args) == len(_build.SIGNATURES[name])
    # (src stride 0: one broadcast table) ... (R, M, K), beta; tri_in None
    assert args[1] == 0 and args[3] == 768 and args[8] is None
    assert args[9:12] == (5, 256, 128) and args[15] == 4.0
    assert args[12] == pytest.approx(0.0025) and args[14] == pytest.approx(1e-4)
    pose, consensus, mse, information, ok, best, counts, tri = out
    assert tuple(tri.shape) == (5, 128, 3) and tri.dtype == i32 and args[23] is not None
    assert tuple(counts.shape) == (5, 128) and tuple(information.shape) == (5, 6, 6)
    assert ok.dtype == b and tuple(pose.shape) == (5, 7)
    assert len({t.untyped_storage().data_ptr() for t in out}) == 1   # one allocation
    given = _meta(5, 32, 3, dtype=i32)
    out = kops.ransac_rigid(src, _meta(5, 256, 3), _meta(5, 256, dtype=b), given, 0.05, 12, 0.01)
    args = fake_lib.calls[-1][1]
    assert args[6] is None and args[7] is None and args[11] == 32 and args[23] is None
    assert out[-1] is given and kops.launches["ransac_rigid"] == 2
    with pytest.raises(ValueError, match="not both"):
        kops.ransac_rigid(src, _meta(5, 256, 3), _meta(5, 256, dtype=b), given, 0.05, 12, 0.01,
                          uniforms=_meta(5, 96))
    with pytest.raises(ValueError, match="1..1024"):
        kops.ransac_rigid(src, _meta(5, 256, 3), _meta(5, 256, dtype=b), None, 0.05, 12, 0.01,
                          uniforms=_meta(5, 3075))
    with pytest.raises(ValueError, match="quality: shape"):
        kops.ransac_rigid(src, _meta(5, 256, 3), _meta(5, 256, dtype=b), None, 0.05, 12, 0.01,
                          uniforms=_meta(5, 384), quality=_meta(5, 255))
    assert kops.launches["ransac_rigid"] == 2


def test_maintenance_kernel_argument_checks_raise(fake_lib):
    i32, b = torch.int32, torch.bool
    with pytest.raises(ValueError, match="65535"):
        kops.merge_pairs(_meta(70000, 7), _meta(70000), _meta(70000, dtype=b), 0.25, 15.0, 16)
    with pytest.raises(ValueError, match="max_pairs"):
        kops.merge_pairs(_meta(50, 7), _meta(50), _meta(50, dtype=b), 0.25, 15.0, 33)
    with pytest.raises(ValueError, match="stamp: shape"):
        kops.merge_pairs(_meta(50, 7), _meta(49), _meta(50, dtype=b), 0.25, 15.0, 16)
    with pytest.raises(ValueError, match="3 sensors"):
        kops.calib_gn(_meta(8, 7), _meta(8, 7), _meta(8, 7), _meta(8, dtype=b), _meta(8, dtype=b),
                      _meta(8, dtype=i32), _meta(8, dtype=i32), _meta(3, 7), 20, 1e2, 1e-6)
    with pytest.raises(TypeError, match="sf: dtype"):
        kops.calib_gn(_meta(8, 7), _meta(8, 7), _meta(8, 7), _meta(8, dtype=b), _meta(8, dtype=b),
                      _meta(8, dtype=torch.int64), _meta(8, dtype=i32), _meta(1, 7), 20, 1e2, 1e-6)
    with pytest.raises(ValueError, match="L0: shape"):
        kops.calib_gn(_meta(8, 7), _meta(8, 7), _meta(8, 7), _meta(8, dtype=b), _meta(8, dtype=b),
                      _meta(8, dtype=i32), _meta(8, dtype=i32), _meta(2, 6), 20, 1e2, 1e-6)
    with pytest.raises(ValueError, match="-1 iterations"):
        kops.calib_gn(_meta(8, 7), _meta(8, 7), _meta(8, 7), _meta(8, dtype=b), _meta(8, dtype=b),
                      _meta(8, dtype=i32), _meta(8, dtype=i32), _meta(1, 7), -1, 1e2, 1e-6)
    with pytest.raises(ValueError, match="1..65535"):
        kops.merge_pairs(_meta(0, 7), _meta(0), _meta(0, dtype=b), 0.25, 15.0, 16)
    with pytest.raises(ValueError, match="max_pairs"):
        kops.merge_pairs(_meta(50, 7), _meta(50), _meta(50, dtype=b), 0.25, 15.0, 0)
    with pytest.raises(ValueError, match="1..1023"):
        kops.bin_min_max(_meta(2, 9, 2), _meta(2, 9, dtype=b), 2000, -math.pi, math.pi, 6.0,
                         0.05)
    with pytest.raises(TypeError, match="valid: dtype"):
        kops.bin_min_max(_meta(2, 9, 2), _meta(2, 9, dtype=torch.int64), 90, -math.pi, math.pi,
                         6.0, 0.05)
    with pytest.raises(ValueError, match="height_band"):
        kops.bin_min_max(_meta(2, 9, 3), _meta(2, 9, dtype=b), 90, -math.pi, math.pi, 6.0, 0.05)
    with pytest.raises(ValueError, match="height_band"):
        kops.bin_min_max(_meta(2, 9, 2), _meta(2, 9, dtype=b), 90, -math.pi, math.pi, 6.0, 0.05,
                         (0.1, 1.0))
    assert fake_lib.calls == []


def _recognition_cases():
    """Small CPU inputs for K21-K24's wrappers, with planted hits and ties:
    (name, args)."""
    rng = np.random.default_rng(6)
    t = torch.from_numpy
    bank = rng.integers(0, 256, (9, 12, 32)).astype(np.uint8)
    query = bank[4].copy()
    bank[7] = bank[4]                                   # a tie with node 4
    stamp = t(np.arange(9, dtype=np.float32))
    flat = bank.reshape(-1, 32)
    links = t(rng.integers(0, 9, (108, 3)).astype(np.int32))
    vec = rng.random((9, 20)).astype(np.float32)
    vec[5] = 0.0
    vec[7] = vec[4]
    vec /= np.maximum(vec.sum(-1, keepdims=True), 1e-12)
    valid12 = t(rng.random(12) < 0.9)
    return [
        ("feature_votes", (t(query), valid12, t(bank), t(rng.random((9, 12)) < 0.9), stamp,
                           torch.ones(9, dtype=torch.bool), torch.tensor(20.0), 4, 40.0, 0.2,
                           5.0)),
        ("repo_nearest", (t(query), valid12, t(flat), t(rng.random(108) < 0.8), 40.0)),
        ("repo_votes", (t(query), valid12, t(flat), t(rng.random(108) < 0.8), links,
                        t(rng.random((108, 3)) < 0.6), stamp, torch.ones(9, dtype=torch.bool),
                        torch.tensor(20.0), 5, 40.0, 2.0, 5.0)),
        ("word_assign", (t(flat), t(rng.random(108) < 0.9), t(flat[::9].copy()))),
        ("word_majority", (t(flat), t(rng.random(108) < 0.9),
                           t((np.arange(108) % 12).astype(np.int32)),
                           t(np.full(12, 8, np.int32)))),
        ("bow_query", (t(vec), stamp, torch.ones(9, dtype=torch.bool), t(vec[4].copy()),
                       torch.tensor(20.0), 6, 0.05, 5.0)),
    ]


@pytest.mark.parametrize("case", range(6), ids=["feature_votes", "repo_nearest", "repo_votes",
                                                 "word_assign", "word_majority", "bow_query"])
def test_recognition_kernel_wrappers_run_their_plain_version_on_cpu(case):
    name, args = _recognition_cases()[case]
    kops.reset_launches()
    got, ref = getattr(kops, name)(*args), getattr(kops, f"{name}_plain")(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kops.launches == {k: 0 for k in kops.launches}
    if name in ("feature_votes", "bow_query"):   # node 4 and its twin 7, the lower slot first
        assert got[0][:2].tolist() == [4, 7] and float(got[1][0]) == float(got[1][1])
    if name == "repo_nearest":                   # the query's own rows, the first valid one
        assert bool((got[0] == 0).any())


def test_recognition_wrappers_allocate_no_keys_or_votes_a_call(fake_lib, monkeypatch):
    """K21's and K22's scratch is made once a device and entry, zero-filled,
    and reused: a second call makes no fill, and only a larger N or F grows
    it (by reallocation)."""
    u8, i32, b = torch.uint8, torch.int32, torch.bool
    kops._recognition_scratch.clear()

    def calls(n, f):
        kops.feature_votes(_meta(f, 32, dtype=u8), _meta(f, dtype=b), _meta(n, 64, 32, dtype=u8),
                           _meta(n, 64, dtype=b), _meta(n), _meta(n, dtype=b), _meta(()), 5,
                           40.0, 0.2, 5.0)
        kops.repo_nearest(_meta(f, 32, dtype=u8), _meta(f, dtype=b), _meta(32 * n, 32, dtype=u8),
                          _meta(32 * n, dtype=b), 40.0)
        kops.repo_votes(_meta(f, 32, dtype=u8), _meta(f, dtype=b), _meta(32 * n, 32, dtype=u8),
                        _meta(32 * n, dtype=b), _meta(32 * n, 8, dtype=i32),
                        _meta(32 * n, 8, dtype=b), _meta(n), _meta(n, dtype=b), _meta(()), 5,
                        40.0, 5.0, 5.0)

    calls(512, 256)
    first = dict(kops._recognition_scratch)
    assert set(first) == {(e, torch.device("meta"))
                          for e in ("feature_votes", "repo_nearest", "repo_votes")}

    def no_fill(*a, **kw):
        raise AssertionError("a wrapper filled a buffer")

    with monkeypatch.context() as m:
        m.setattr(torch, "zeros", no_fill)
        m.setattr(torch, "full", no_fill)
        calls(512, 256)
        calls(100, 64)                                     # smaller: the same scratch
    assert all(kops._recognition_scratch[key] is t for key, t in first.items())
    calls(4096, 1024)                                      # larger: grown
    assert all(kops._recognition_scratch[key].numel() > t.numel() for key, t in first.items())
    assert kops.launches["feature_votes"] == 4 and kops.launches["repository"] == 8


def test_recognition_kernels_shared_memory_needs(fake_lib):
    """The wrappers hold no copy of the kernels' shared-memory layout: K21
    at Fq + Fb = 7,100 (past the 33·(Fq + Fb) bytes the scalar form held)
    reaches its C entry, and a size the C entry refuses (its
    ``cudaFuncSetAttribute`` error, here cudaErrorInvalidValue from the
    fake library) raises with that code, after the call."""
    u8, b = torch.uint8, torch.bool
    kops.feature_votes(_meta(4000, 32, dtype=u8), _meta(4000, dtype=b), _meta(3, 3100, 32, dtype=u8),
                       _meta(3, 3100, dtype=b), _meta(3), _meta(3, dtype=b), _meta(()), 3, 40.0,
                       0.2, 5.0)
    assert fake_lib.calls[-1][0] == "uz_feature_votes"
    fake_lib.err = 1
    with pytest.raises(RuntimeError, match="repository: CUDA launch failed with cudaError_t 1"):
        kops.repo_nearest(_meta(30000, 32, dtype=u8), _meta(30000, dtype=b),
                          _meta(8, 32, dtype=u8), _meta(8, dtype=b), 40.0)
    with pytest.raises(RuntimeError, match="repository: CUDA launch failed with cudaError_t 1"):
        kops.repo_votes(_meta(60000, 32, dtype=u8), _meta(60000, dtype=b), _meta(8, 32, dtype=u8),
                        _meta(8, dtype=b), _meta(8, 2, dtype=torch.int32), _meta(8, 2, dtype=b),
                        _meta(4), _meta(4, dtype=b), _meta(()), 2, 40.0, 1.0, 5.0)
    assert [c[0] for c in fake_lib.calls] == ["uz_feature_votes", "uz_repo_nearest",
                                              "uz_repo_votes"]
    assert kops.launches["repository"] == 0


def test_recognition_scratch_is_zero_filled_and_grows_by_reallocation():
    kops._recognition_scratch.clear()
    t = kops.recognition_scratch("cpu", "repo_votes", 100)
    assert t.dtype == torch.uint8 and t.numel() >= 100 and not t.any()
    t[:4] = 7                                  # a kernel leaves it as it found it; here it did not
    assert kops.recognition_scratch("cpu", "repo_votes", 90) is t
    grown = kops.recognition_scratch("cpu", "repo_votes", 1000)
    assert grown is not t and grown.numel() >= 1000 and not grown.any()
    assert kops.recognition_scratch("cpu", "repo_nearest", 10) is not grown
    kops._recognition_scratch.clear()


@pytest.mark.parametrize("rows", ["random", "zeros_and_ones"])
def test_hamming_by_and_is_the_xor_popcount(rows):
    """The identity K21 and K22 compute on the tensor cores, popc(a) +
    popc(b) - 2·popc(a & b), against the popcount of a XOR b."""
    rng = np.random.default_rng(8)
    a = rng.integers(0, 256, (37, 32)).astype(np.uint8)
    b = rng.integers(0, 256, (11, 32)).astype(np.uint8)
    if rows == "zeros_and_ones":
        a[:4], b[:3] = 0x00, 0xFF
        a[4], b[3] = 0xFF, 0x00
    got = kops.hamming_by_and(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.unpackbits(a[:, None, :] ^ b[None, :, :], axis=-1).sum(-1)
    np.testing.assert_array_equal(got, ref)
    if rows == "zeros_and_ones":
        assert (got[:4, :3] == 256).all() and got[4, 3] == 256 and (got[:4, 3] == 0).all()
    ref_float = kops._hamming(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got.astype(np.float32), ref_float)


def test_largest_k_keeps_the_lower_index_among_ties():
    vals, idx = kops.largest_k(torch.tensor([1.0, 3.0, 3.0, -1.0, 3.0, -1.0]), 5)
    assert idx.tolist() == [1, 2, 4, 0, 3] and vals.tolist() == [3.0, 3.0, 3.0, 1.0, -1.0]


def test_recognition_kernels_launch_through_the_library(fake_lib):
    u8, i32, b, f32 = torch.uint8, torch.int32, torch.bool, torch.float32
    slots, sims, ok = kops.feature_votes(
        _meta(256, 32, dtype=u8), _meta(256, dtype=b), _meta(512, 256, 32, dtype=u8),
        _meta(512, 256, dtype=b), _meta(512), _meta(512, dtype=b), _meta(()), 5, 40.0, 0.2, 5.0)
    assert fake_lib.calls[-1][0] == "uz_feature_votes"
    assert fake_lib.calls[-1][1][7:14] == pytest.approx((256, 256, 512, 5, 40.0, 0.2, 5.0))
    assert tuple(slots.shape) == (5,) and slots.dtype == i32 and sims.dtype == f32
    dist, idx, dup = kops.repo_nearest(_meta(256, 32, dtype=u8), _meta(256, dtype=b),
                                       _meta(16384, 32, dtype=u8), _meta(16384, dtype=b), 40.0)
    assert fake_lib.calls[-1][0] == "uz_repo_nearest" and fake_lib.calls[-1][1][4:7] == (
        256, 16384, 40.0)
    assert idx.dtype == i32 and dup.dtype == b and tuple(dist.shape) == (256,)
    slots, votes, ok = kops.repo_votes(
        _meta(256, 32, dtype=u8), _meta(256, dtype=b), _meta(16384, 32, dtype=u8),
        _meta(16384, dtype=b), _meta(16384, 8, dtype=i32), _meta(16384, 8, dtype=b), _meta(512),
        _meta(512, dtype=b), _meta(()), 5, 40.0, 5.0, 5.0)
    assert fake_lib.calls[-1][0] == "uz_repo_votes"
    assert fake_lib.calls[-1][1][9:17] == (256, 16384, 8, 512, 5, 40.0, 5.0, 5.0)
    assert votes.dtype == i32
    word, d, hist = kops.word_assign(_meta(3328, 32, dtype=u8), _meta(3328, dtype=b),
                                     _meta(256, 32, dtype=u8))
    assert fake_lib.calls[-1][0] == "uz_word_assign" and fake_lib.calls[-1][1][3:5] == (3328, 256)
    assert word.dtype == d.dtype == hist.dtype == i32 and tuple(hist.shape) == (256,)
    centers = kops.word_majority(_meta(3328, 32, dtype=u8), _meta(3328, dtype=b),
                                 _meta(3328, dtype=i32), _meta(256, dtype=i32))
    assert fake_lib.calls[-1][0] == "uz_word_majority" and tuple(centers.shape) == (256, 32)
    slots, scores, ok = kops.bow_query(_meta(512, 256), _meta(512), _meta(512, dtype=b),
                                       _meta(256), _meta(()), 5, 0.05, 5.0)
    assert fake_lib.calls[-1][0] == "uz_bow_query"
    assert fake_lib.calls[-1][1][5:10] == pytest.approx((512, 256, 5, 0.05, 5.0))
    # the repository's two entry points and the vocabulary's two are one kernel each
    assert kops.launches["feature_votes"] == 1 and kops.launches["repository"] == 2
    # K21's and K22's calls pass their entry's device scratch (the ticket,
    # then the sims / keys / votes) in the place of the old per-call buffer
    for name, nbytes in (("uz_feature_votes", 16 + 4 * 512), ("uz_repo_nearest", 16 + 8 * 256),
                         ("uz_repo_votes", 16 + 4 * 512)):
        args = next(c[1] for c in fake_lib.calls if c[0] == name)
        assert len(args) == len(_build.SIGNATURES[name])
        entry = name[3:]
        assert kops._recognition_scratch[(entry, torch.device("meta"))].numel() >= nbytes
    assert kops.launches["bow_words"] == 2 and kops.launches["bow_query"] == 1


def test_recognition_kernel_argument_checks_raise(fake_lib):
    u8, i32, b = torch.uint8, torch.int32, torch.bool
    with pytest.raises(ValueError, match="k = 9 of 8 entries"):
        kops.feature_votes(_meta(16, 32, dtype=u8), _meta(16, dtype=b), _meta(8, 16, 32, dtype=u8),
                           _meta(8, 16, dtype=b), _meta(8), _meta(8, dtype=b), _meta(()), 9,
                           40.0, 0.2, 5.0)
    with pytest.raises(ValueError, match="k = 0 of 500 entries"):
        kops.bow_query(_meta(500, 16), _meta(500), _meta(500, dtype=b), _meta(16), _meta(()),
                       0, 0.05, 5.0)
    with pytest.raises(ValueError, match="shared memory"):
        kops.word_assign(_meta(10, 32, dtype=u8), _meta(10, dtype=b), _meta(8000, 32, dtype=u8))
    with pytest.raises(TypeError, match="links: dtype"):
        kops.repo_votes(_meta(4, 32, dtype=u8), _meta(4, dtype=b), _meta(8, 32, dtype=u8),
                        _meta(8, dtype=b), _meta(8, 2, dtype=torch.int64), _meta(8, 2, dtype=b),
                        _meta(6), _meta(6, dtype=b), _meta(()), 3, 40.0, 5.0, 5.0)
    with pytest.raises(ValueError, match="counts: shape"):
        kops.word_majority(_meta(10, 32, dtype=u8), _meta(10, dtype=b), _meta(10, dtype=i32),
                           _meta(4, 2, dtype=i32))
    assert fake_lib.calls == []


def _registration_cases():
    """Small inputs of K25-K28 (the gicp and pnp estimators), from a seed."""
    from uzliti_slam_tpu_torch.ops import lie

    g = torch.Generator().manual_seed(3)
    pts = torch.rand(500, 3, generator=g) * 0.4
    lab = torch.rand(500, 3, generator=g) * 100
    valid = torch.rand(500, generator=g) > 0.2
    cloud = torch.rand(2, 40, 3, generator=g)
    cvalid = torch.rand(2, 40, generator=g) > 0.1
    T = lie.se3_exp(torch.tensor([[0.01, -0.02, 0.0, 0.01, 0.0, -0.01]] * 2))
    src = lie.pose_apply(T[:1], cloud[0])
    normals = kops.knn_normals_plain(cloud, cvalid)
    X = torch.cat([torch.rand(2, 30, 2, generator=g) * 4 - 2,
                   torch.rand(2, 30, 1, generator=g) * 5 + 3], -1)
    xn = X[..., :2] / X[..., 2:] + 0.001 * torch.randn(2, 30, 2, generator=g)
    pvalid = torch.rand(2, 30, generator=g) > 0.2
    depth = X[..., 2].contiguous()
    keys = torch.rand(2, 8, 30, generator=g)
    none_valid = cvalid.clone()
    none_valid[1] = False
    return [
        ("voxel_grid", (pts, lab, valid, 20.0, 64)),
        ("knn_normals", (cloud, cvalid)),
        ("gicp", (src, lab[:40], cvalid[0], cloud, lab[:40].expand(2, 40, 3).contiguous(), cvalid,
                  normals, lie.pose_identity((2,)), 5, 0.04, 0.002, 0.3, 1.0, math.pi / 6)),
        ("gicp", (src, lab[:40], cvalid[0], cloud, lab[:40].expand(2, 40, 3).contiguous(),
                  none_valid, normals, lie.pose_identity((2,)), 1, 0.04, 0.002, 0.3, 1.0,
                  math.pi / 6)),
        ("pnp_ransac", (X, xn, pvalid, None, keys, 3.6e-5, 0.04, 8.0, 4, 250000.0)),
        ("pnp_ransac", (X, xn, pvalid, depth, keys, 3.6e-5, 0.04, 8.0, 4, 250000.0)),
    ]


@pytest.mark.parametrize("case", range(6), ids=["voxel_grid", "knn_normals", "gicp",
                                                 "gicp_no_valid_target", "pnp_ransac_no_depth",
                                                 "pnp_ransac"])
def test_registration_kernel_wrappers_run_their_plain_version_on_cpu(case):
    name, args = _registration_cases()[case]
    kops.reset_launches()
    got, ref = getattr(kops, name)(*args), getattr(kops, f"{name}_plain")(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert kops.launches == {k: 0 for k in kops.launches}
    if name == "voxel_grid":   # 8 x 8 x 8 cells of 5 cm: fewer than 64 kept, means inside their cell
        pts, _, valid = got
        assert 0 < int(valid.sum()) <= 64 and bool((pts[valid] >= 0).all())


def test_voxel_grid_plain_keeps_the_smallest_ids_and_poisons_non_finite_points():
    pts = torch.tensor([[0.01, 0.01, 0.0], [0.02, 0.02, 0.0], [1.0, 1.0, 1.0], [0.0, 0.0, 0.0]])
    lab = torch.tensor([[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0], [5.0, 5.0, 5.0]])
    valid = torch.tensor([True, True, True, False])
    p, c, v = kops.voxel_grid_plain(pts, lab, valid, 20.0, 16)
    assert int(v.sum()) == 2
    ids = kops.voxel_ids_plain(pts, valid, 20.0)
    assert int(ids[3]) == kops.VOXEL_EMPTY and int(ids[0]) == int(ids[1])
    first = int(torch.argmin(torch.where(valid, ids, 2**40)))
    slot0 = p[0] if first == 0 else p[1]
    assert torch.allclose(slot0, torch.tensor([0.015, 0.015, 0.0]), atol=1e-6)
    p1, _, v1 = kops.voxel_grid_plain(pts, lab, valid, 20.0, 1)   # only the smallest id kept
    assert int(v1.sum()) == 1
    pts[3, 1] = math.nan                                     # an invalid NaN point: NaN in its slot
    p2, _, _ = kops.voxel_grid_plain(pts, lab, valid, 20.0, 16)
    assert int(torch.isnan(p2).sum()) == 1


def test_lu_solve_plain_and_jacobi_factorizations():
    g = torch.Generator().manual_seed(1)
    A = torch.randn(4, 6, 6, generator=g, dtype=torch.float64)
    A[0, 0, 0] = 0.0                                    # the first pivot needs a row swap
    b = torch.randn(4, 6, generator=g, dtype=torch.float64)
    torch.testing.assert_close(kops.lu_solve_plain(A, b), torch.linalg.solve(A, b))
    S = A @ A.transpose(-1, -2)
    vals, vecs = kops.jacobi_eigh3_plain(S[:, :3, :3])
    torch.testing.assert_close(vecs @ torch.diag_embed(vals) @ vecs.transpose(-1, -2), S[:, :3, :3])
    M = torch.randn(5, 12, 9, generator=g, dtype=torch.float64)
    AV, V, sig = kops.jacobi_svd_plain(M)
    torch.testing.assert_close(torch.sort(sig, descending=True).values, torch.linalg.svdvals(M))
    torch.testing.assert_close(AV, M @ V)
    R, _ = kops.proper_rotation_plain(torch.randn(3, 3, 3, generator=g, dtype=torch.float64))
    torch.testing.assert_close(R @ R.transpose(-1, -2), torch.eye(3, dtype=torch.float64).expand(3, 3, 3))
    assert bool((torch.linalg.det(R) > 0).all())


def test_registration_kernels_launch_through_the_library(fake_lib):
    b = torch.bool
    p, c, v = kops.voxel_grid(_meta(307200, 3), _meta(307200, 3), _meta(307200, dtype=b), 20.0,
                              256)
    assert fake_lib.calls[-1][0] == "uz_voxel_grid" and fake_lib.calls[-1][1][3:6] == (
        307200, 20.0, 256)
    assert tuple(p.shape) == (256, 3) and v.dtype == b
    n = kops.knn_normals(_meta(10, 256, 3), _meta(10, 256, dtype=b))
    assert fake_lib.calls[-1][0] == "uz_knn_normals" and fake_lib.calls[-1][1][2:4] == (10, 256)
    assert tuple(n.shape) == (10, 256, 3)
    pose, frac, mse, ok = kops.gicp(_meta(256, 3), _meta(256, 3), _meta(256, dtype=b),
                                    _meta(10, 256, 3), _meta(10, 256, 3), _meta(10, 256, dtype=b),
                                    _meta(10, 256, 3), _meta(10, 7), 20, 0.04, 0.002, 0.3, 1.0,
                                    0.5)
    assert fake_lib.calls[-1][0] == "uz_gicp"
    assert fake_lib.calls[-1][1][8:17] == pytest.approx((10, 256, 256, 20, 0.04, 0.002, 0.3, 1.0,
                                                         0.5))
    assert tuple(pose.shape) == (10, 7) and ok.dtype == b
    assert kops.launches["voxel_grid"] == kops.launches["knn_normals"] == 1
    assert kops.launches["gicp"] == 1 and kops.launches["pnp"] == 0


def test_pnp_ransac_is_one_launch_of_the_whole_ransac(fake_lib):
    """K28's one-launch entry: the draws' keys and the gates in, the draws,
    hypotheses and results out, one ``uz_pnp_ransac`` call; its stamps
    (int64, reset to (-1, 0, 0, 0)) passed only when asked for."""
    b, i32 = torch.bool, torch.int32
    out = kops.pnp_ransac(_meta(10, 256, 3), _meta(10, 256, 2), _meta(10, 256, dtype=b),
                          _meta(10, 256), _meta(10, 64, 256), 3.6e-5, 0.04, 10.0, 8, 275625.0)
    assert [c[0] for c in fake_lib.calls] == ["uz_pnp_ransac"]
    args = fake_lib.calls[0][1]
    assert len(args) == len(_build.SIGNATURES["uz_pnp_ransac"])
    assert args[5:13] == pytest.approx((10, 256, 64, 3.6e-5, 0.04, 10.0, 8, 275625.0))
    assert args[21] is None
    shapes = [tuple(t.shape) for t in out]
    assert shapes == [(10, 64, 6), (10, 192, 7), (10, 7), (10,), (10,), (10,), (10,), (10, 192)]
    assert out[3].dtype == i32 and out[5].dtype == b and out[7].dtype == i32
    kops.pnp_ransac(_meta(2, 30, 3), _meta(2, 30, 2), _meta(2, 30, dtype=b), None,
                    _meta(2, 8, 30), 3.6e-5, 0.04, 10.0, 8, 1.0)
    assert fake_lib.calls[-1][1][3] is None   # no depth: a null pointer, two families
    with pytest.raises(TypeError, match="stamps: dtype"):
        kops.pnp_ransac(_meta(2, 30, 3), _meta(2, 30, 2), _meta(2, 30, dtype=b), None,
                        _meta(2, 8, 30), 3.6e-5, 0.04, 10.0, 8, 1.0, stamps=_meta(2, 4))
    assert kops.launches["pnp"] == 2


def test_registration_kernel_argument_checks_raise(fake_lib):
    b = torch.bool
    with pytest.raises(ValueError, match="max_out"):
        kops.voxel_grid(_meta(10, 3), _meta(10, 3), _meta(10, dtype=b), 20.0, 4096)
    with pytest.raises(TypeError, match="valid: dtype"):
        kops.voxel_grid(_meta(10, 3), _meta(10, 3), _meta(10, dtype=torch.uint8), 20.0, 16)
    with pytest.raises(ValueError, match="k = 8 neighbours"):
        kops.knn_normals(_meta(2, 5, 3), _meta(2, 5, dtype=b))
    with pytest.raises(ValueError, match="5000 points"):
        kops.knn_normals(_meta(1, 5000, 3), _meta(1, 5000, dtype=b))
    with pytest.raises(ValueError, match="target points"):
        kops.gicp(_meta(8, 3), _meta(8, 3), _meta(8, dtype=b), _meta(1, 4096, 3),
                  _meta(1, 4096, 3), _meta(1, 4096, dtype=b), _meta(1, 4096, 3), _meta(1, 7), 20,
                  0.04, 0.002, 0.3, 1.0, 0.5)
    with pytest.raises(ValueError, match="init: shape"):
        kops.gicp(_meta(8, 3), _meta(8, 3), _meta(8, dtype=b), _meta(2, 16, 3), _meta(2, 16, 3),
                  _meta(2, 16, dtype=b), _meta(2, 16, 3), _meta(7), 20, 0.04, 0.002, 0.3, 1.0, 0.5)
    with pytest.raises(ValueError, match="keys: shape"):
        kops.pnp_ransac(_meta(2, 30, 3), _meta(2, 30, 2), _meta(2, 30, dtype=b), None,
                        _meta(2, 8, 31), 3.6e-5, 0.04, 10.0, 8, 1.0)
    with pytest.raises(ValueError, match="2049 correspondences"):
        kops.pnp_ransac(_meta(1, 2049, 3), _meta(1, 2049, 2), _meta(1, 2049, dtype=b),
                        _meta(1, 2049), _meta(1, 16384, 2049), 3.6e-5, 0.04, 10.0, 8, 1.0)
    with pytest.raises(ValueError, match="a vote holds"):
        kops.pnp_ransac(_meta(1, 30, 3), _meta(1, 30, 2), _meta(1, 30, dtype=b), _meta(1, 30),
                        _meta(1, 349526, 30), 3.6e-5, 0.04, 10.0, 8, 1.0)
    with pytest.raises(ValueError, match="a draw takes 6"):
        kops.pnp_ransac(_meta(2, 5, 3), _meta(2, 5, 2), _meta(2, 5, dtype=b), None,
                        _meta(2, 8, 5), 3.6e-5, 0.04, 10.0, 8, 1.0)
    assert fake_lib.calls == []


# ---------------------------------------------------------------------------
# Slice 9: K29 sift_describe, K30 l2_top2 and the fleet's batched entries
# ---------------------------------------------------------------------------

def _fleet_kernel_inputs(batch=3, n=20, cutoff=4):
    """A flattened fleet's first-iteration inputs (each instance a chain
    with a few closures), and each instance's own."""
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.io import synthetic

    fl, _ = synthetic.make_pose_graph_batch(batch, n, loop_closure_every=3,
                                            generator=torch.Generator().manual_seed(5),
                                            device="cpu")
    g = solver._flatten_fleet(fl)
    labels = kops.components_plain(g.e_from, g.e_to, g.e_valid, batch * n,
                                   solver.component_iterations(n))
    free = (g.node_valid & ~kops.gauge_fix_plain(labels, g.node_valid, g.node_fixed,
                                                 g.stamp)).float()
    cfg = solver.SolverConfig(chain_dense_cutoff=cutoff)
    p = solver._Problem(g, free, cfg, batch=batch)
    r, _ = p.residuals(g.pose)
    Ji, Jj, W, grad, Hb, U = p.linearize(r)
    damp = p.damp(torch.full((batch,), 1e-3), Hb)
    Dm = torch.where(free[:, None, None] > 0, Hb + torch.diag_embed(damp), p.eye6)
    return fl, g, p, Dm, U, -grad


def test_batched_plain_versions_equal_a_loop_of_the_single_ones():
    """Each plain version of K3, K4, K9 and K10 on a batch of instances
    against the same plain version on each instance alone (the batch of
    one): within 2e-6 of each array's largest entry (the same float
    operations; the root product and the dots are one batched call where
    the loop makes one per instance, summed in another order)."""
    fl, g, p, Dm, U, b = _fleet_kernel_inputs()
    B, n = fl.pose.shape[:2]
    E = fl.e_from.shape[1]
    valid = g.e_valid.float()

    def close(a, ref):
        torch.testing.assert_close(a, ref, rtol=0, atol=2e-6 * float(ref.abs().max()) + 1e-30)

    r, chi2 = kops.residual_chi2_plain(g.pose, g.e_from, g.e_to, g.e_transform, g.e_info,
                                       valid, 1.0, B)
    fac = kops.chain_factor_plain(Dm, U, 4, B)
    x = kops.chain_apply_plain(fac, b)
    x0, r0, p0, scal = kops.pcg_init_plain(b, x, B)
    Hp = b.flip(0).contiguous()
    kops.pcg_alpha_plain(p0, Hp, x0, r0, scal, 1e-8)
    kops.pcg_beta_plain(r0, x, p0, scal)
    assert chi2.shape == (B,) and scal.shape == (B, 3)
    for i in range(B):
        ns, es = slice(i * n, (i + 1) * n), slice(i * E, (i + 1) * E)
        ef, et = g.e_from[es] - i * n, g.e_to[es] - i * n
        ri, ci = kops.residual_chi2_plain(g.pose[ns], ef, et, g.e_transform[es], g.e_info[es],
                                          valid[es], 1.0)
        close(r[es], ri)
        close(chi2[i], ci[0])
        fi = kops.chain_factor_plain(Dm[ns], U[ns], 4)
        for a, ref in zip([t[i] for lv in fac[0] for t in lv] + [fac[1][i]],
                          [t[0] for lv in fi[0] for t in lv] + [fi[1][0]]):
            close(a, ref)
        xi = kops.chain_apply_plain(fi, b[ns])
        close(x[ns], xi)
        s = kops.pcg_init_plain(b[ns], xi)
        kops.pcg_alpha_plain(s[2], Hp[ns], s[0], s[1], s[3], 1e-8)
        kops.pcg_beta_plain(s[1], xi, s[2], s[3])
        for a, ref in zip((x0[ns], r0[ns], p0[ns], scal[i]), s[:3] + (s[3][0],)):
            close(a, ref)


def test_batched_and_slice9_wrappers_run_their_plain_version_on_cpu():
    fl, g, p, Dm, U, b = _fleet_kernel_inputs()
    B = fl.pose.shape[0]
    kops.reset_launches()
    valid = g.e_valid.float()
    args = (g.pose, g.e_from, g.e_to, g.e_transform, g.e_info, valid, 1.0, B)
    for a, ref in zip(kops.residual_chi2(*args), kops.residual_chi2_plain(*args)):
        assert torch.equal(a, ref)
    fac = kops.chain_factor(Dm, U, 4, B)
    for a, ref in zip(kops.chain_apply(fac, b),
                      kops.chain_apply_plain(kops.chain_factor_plain(Dm, U, 4, B), b)):
        assert torch.equal(a, ref)
    held = kops.chain_factor(Dm * 2, U, 4, B)
    need = torch.tensor([True, False, True])
    kops.chain_factor(Dm, U, 4, B, held=held, need=need)
    assert torch.equal(held[1][0], fac[1][0]) and torch.equal(held[1][2], fac[1][2])
    assert not torch.equal(held[1][1], fac[1][1])
    img = torch.from_numpy(np.random.default_rng(2).uniform(0, 255, (2, 40, 48)).astype(np.float32))
    uv = torch.tensor([[[20.0, 20.0], [5.5, 30.0]]] * 2)
    win = kops.sift_window("cpu")
    for a, ref in zip(kops.sift_describe(img, uv, win), kops.sift_describe_plain(img, uv, win)):
        assert torch.equal(a, ref)
    a = torch.rand(5, 16)
    out = kops.l2_top2(a, a.flip(0), torch.ones(5, dtype=torch.bool),
                       torch.ones(5, dtype=torch.bool), 0.64, math.inf)
    assert torch.equal(out[0], torch.arange(4, -1, -1, dtype=torch.int32)) and bool(out[1].all())
    assert kops.launches == {k: 0 for k in kops.launches}


def test_slice9_kernels_launch_through_the_library(fake_lib):
    b, i32 = torch.bool, torch.int32
    ang, desc = kops.sift_describe(_meta(2, 480, 640), _meta(2, 75, 2), _meta(16, 16))
    assert fake_lib.calls[-1][0] == "uz_sift_describe" and fake_lib.calls[-1][1][3:7] == (
        2, 480, 640, 75)
    assert tuple(ang.shape) == (2, 75) and tuple(desc.shape) == (2, 75, 128)
    idx, ok, best = kops.l2_top2(_meta(300, 128), _meta(280, 128), _meta(300, dtype=b),
                                 _meta(280, dtype=b), 0.64, math.inf)
    assert fake_lib.calls[-1][0] == "uz_l2_top2"
    assert fake_lib.calls[-1][1][4:9] == pytest.approx((300, 280, 128, 0.64, math.inf))
    assert idx.dtype == i32 and ok.dtype == b and tuple(best.shape) == (300,)
    # the fleet: 4096 instances of 64 nodes and 128 edges, cutoff 16 (2 levels)
    B, n, E = 4096, 64, 128
    r, chi2 = kops.residual_chi2(_meta(B * n, 7), _meta(B * E, dtype=i32),
                                 _meta(B * E, dtype=i32), _meta(B * E, 7),
                                 _meta(B * E, 6, 6), _meta(B * E), 1.0, B)
    assert fake_lib.calls[-1][0] == "uz_residual_chi2" and fake_lib.calls[-1][1][7:9] == (E, B)
    assert tuple(chi2.shape) == (B,) and tuple(r.shape) == (B * E, 6)
    fac = kops.chain_factor(_meta(B * n, 6, 6), _meta(B * n, 6, 6), 16, B)
    # one launch: (rows, instances, levels) and the root's blocks
    assert fake_lib.calls[-1][0] == "uz_chain_factor"
    assert fake_lib.calls[-1][1][5:9] == (n, B, 2, 16)
    assert tuple(fac[1].shape) == (B, 96, 96) and tuple(fac[0][0][0].shape) == (B, 32, 6, 6)
    kops.chain_factor(_meta(B * n, 6, 6), _meta(B * n, 6, 6), 16, B, held=fac,
                      need=_meta(B, dtype=b))
    x = kops.chain_apply(fac, _meta(B * n, 6))
    names = [c[0] for c in fake_lib.calls[-5:]]
    assert names == (["uz_chain_forward"] * 2 + ["uz_chain_root"] + ["uz_chain_backward"] * 2)
    assert tuple(x.shape) == (B * n, 6)
    x, rr, p, scal = kops.pcg_init(_meta(B * n, 6), _meta(B * n, 6), B)
    kops.pcg_alpha(p, _meta(B * n, 6), x, rr, scal, 1e-8)
    kops.pcg_beta(rr, _meta(B * n, 6), p, scal)
    assert [c[0] for c in fake_lib.calls[-3:]] == ["uz_pcg_init", "uz_pcg_alpha", "uz_pcg_beta"]
    # 384 floats an instance, one CTA each: no grid scratch
    assert fake_lib.calls[-3][1][2:4] == (6 * n, B) and tuple(scal.shape) == (B, 4)
    assert all(c[1][-2] is None for c in fake_lib.calls[-3:])
    assert kops.launches["sift_describe"] == kops.launches["l2_top2"] == 1
    assert kops.launches["residual_chi2"] == 1 and kops.launches["chain_apply"] == 1
    assert kops.launches["chain_factor"] == 2 and kops.launches["pcg"] == 3


def test_slice9_kernel_argument_checks_raise(fake_lib):
    b = torch.bool
    with pytest.raises(ValueError, match="window: shape"):
        kops.sift_describe(_meta(1, 48, 64), _meta(1, 5, 2), _meta(8, 8))
    with pytest.raises(ValueError, match="width 256"):
        kops.l2_top2(_meta(10, 256), _meta(10, 256), _meta(10, dtype=b), _meta(10, dtype=b),
                     0.64, 1.0)
    with pytest.raises(ValueError, match="at least 2"):
        kops.l2_top2(_meta(10, 128), _meta(1, 128), _meta(10, dtype=b), _meta(1, dtype=b),
                     0.64, 1.0)
    with pytest.raises(ValueError, match="in 3 instances"):
        kops.residual_chi2(_meta(64, 7), _meta(10, dtype=torch.int32),
                           _meta(10, dtype=torch.int32), _meta(10, 7), _meta(10, 6, 6),
                           _meta(10), 1.0, 3)
    with pytest.raises(ValueError, match="one CTA each"):
        kops.pcg_init(_meta(2 * 6000, 6), _meta(2 * 6000, 6), 2)
    with pytest.raises(ValueError, match="refresh flag needs a held factor"):
        kops.chain_factor(_meta(128, 6, 6), _meta(128, 6, 6), 16, 2, need=_meta(2, dtype=b))
    assert fake_lib.calls == []


# ---------------------------------------------------------------------------
# Slice 10: K1's column mask (the planar solve) and its reduce hook
# ---------------------------------------------------------------------------

def test_masked_linearize_plain_matches_jax_under_optimize_xy_only():
    """K1's plain version with the planar column mask against JAX's
    ``_make_fused_linearize`` under ``optimize_xy_only``, all six outputs,
    at perturbed poses (Huber weights below 1 present): within 1e-4 of
    each array's largest entry (W 1e-5), as tests/test_torch_solver.py
    holds the unmasked form."""
    import jax
    import jax.numpy as jnp

    from uzliti_slam_tpu.graph import factors as jfactors
    from uzliti_slam_tpu.graph import solver as jsolver
    from uzliti_slam_tpu.io import synthetic as jsynthetic
    from uzliti_slam_tpu.ops import lie as jlie
    from uzliti_slam_tpu_torch.graph import solver as tsolver
    from uzliti_slam_tpu_torch.graph import state as tstate

    g = jax.jit(lambda k: jsynthetic.make_pose_graph(k, 64, loop_closure_every=8)[0])(
        jax.random.PRNGKey(4))
    free = (g.node_valid & ~jsolver.gauge_fix_mask(g, jsolver.connected_components(g))).astype(
        jnp.float32)
    rng = np.random.default_rng(0)
    dx = jnp.asarray(0.05 * rng.normal(size=(g.node_capacity, 6)).astype(np.float32))
    poses = jlie.pose_retract(g.pose, dx)
    r = jfactors.batched_residuals(poses[g.e_from], poses[g.e_to], g.e_transform)
    adj = jax.vmap(lambda m: jlie.se3_adjoint(jlie.pose_inverse(m)))(g.e_transform)
    cfg = jsolver.SolverConfig(optimize_xy_only=True)
    ref = jsolver._make_fused_linearize(g, free, cfg, adj)(r)

    gt = tstate.from_numpy({k: np.asarray(v) for k, v in g._asdict().items()}, device="cpu")
    p = tsolver._Problem(gt, torch.from_numpy(np.array(free)),
                         tsolver.SolverConfig(optimize_xy_only=True))
    assert p.col_mask == tsolver.XY_COLUMNS == (1.0, 1.0, 0.0, 0.0, 0.0, 1.0)
    args = (torch.from_numpy(np.array(r)), torch.from_numpy(np.array(adj)), gt.e_info, p.valid,
            gt.e_from, gt.e_to, p.free, p.both_free, p.is_chain, 1.0)
    got = kops.linearize_plain(*args, col_mask=p.col_mask)
    assert np.asarray(ref[2]).min() < np.asarray(g.e_info).max()
    for name, a, b in zip(("Ji", "Jj", "W", "grad", "Hb", "U"), got, ref):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, atol=(1e-5 if name == "W" else 1e-4)
                                   * np.abs(b).max(), err_msg=name)
    # the masked columns are exact zeros, and the unmasked form differs
    assert not got[0][:, :, 2:5].any() and not got[3][:, 2:5].any()
    assert not got[4][:, 2:5].any() and not got[4][:, :, 2:5].any()
    assert got[3].abs().max() > 0 and kops.linearize_plain(*args)[0][:, :, 2:5].any()


def test_linearize_reduce_sees_the_packed_node_sums():
    rng = np.random.default_rng(3)
    n, E = 6, 5
    r = torch.from_numpy(0.1 * rng.normal(size=(E, 6)).astype(np.float32))
    eye = torch.eye(6).expand(E, 6, 6).contiguous()
    ef = torch.arange(E, dtype=torch.int32)
    ones_e, ones_n = torch.ones(E), torch.ones(n)
    args = (r, eye, eye, ones_e, ef, ef + 1, ones_n, ones_n, ones_e, 1.0)
    seen = []

    def double(t):
        seen.append(t.clone())
        t.mul_(2)

    base = kops.linearize(*args)
    out = kops.linearize(*args, reduce=double)
    assert len(seen) == 1 and seen[0].shape == (78 * n,)
    for a, b in zip(out[3:], base[3:]):
        assert torch.equal(a, 2 * b)
    assert torch.equal(torch.cat([t.reshape(-1) for t in base[3:]]), seen[0])
    with pytest.raises(ValueError, match="col_mask"):
        kops.linearize(*args, col_mask=(1.0, 0.5, 0.0, 0.0, 0.0, 1.0))


def test_linearize_passes_the_column_mask_as_bits(fake_lib):
    n, E = 8, 16
    i32 = torch.int32
    args = (_meta(E, 6), _meta(E, 6, 6), _meta(E, 6, 6), _meta(E), _meta(E, dtype=i32),
            _meta(E, dtype=i32), _meta(n), _meta(n), _meta(E), 1.0)
    table = kops.IncidenceTable(_meta(n + 1, dtype=i32), _meta(2 * E, dtype=i32))
    kops.linearize(*args, table=table)
    calls = []
    kops.linearize(*args, col_mask=(1.0, 1.0, 0.0, 0.0, 0.0, 1.0), reduce=calls.append,
                   table=table)
    # (…, huber_delta, n_edges, n_nodes, col_keep, …): bits 0, 1 and 5 kept
    assert [c[1][9:13] for c in fake_lib.calls] == [(1.0, E, n, 63), (1.0, E, n, 35)]
    assert len(calls) == 1 and tuple(calls[0].shape) == (78 * n,)
    assert kops.launches["linearize"] == 2


# ---------------------------------------------------------------------------
# Slice 14: K36 (the LM tail) and K9 in one launch, in the loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("early_exit, batch", [(False, 1), (True, 1), (False, 3), (True, 3)],
                         ids=["fixed", "early_exit", "fleet_fixed", "fleet_early_exit"])
def test_an_lm_iteration_is_two_k36_launches_and_k9_one(fake_lib, early_exit, batch):
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.graph import state as gstate

    n, E, iterations = 64, 96, 6
    g = gstate.empty_graph(batch * n, batch * E, "meta")
    cfg = solver.SolverConfig(iterations=iterations, pcg_iterations=4, chain_dense_cutoff=16,
                               precond_refresh=3, early_exit=early_exit)
    poses, lam, hist, acc = solver._lm(g, _meta(batch * n), cfg, batch)
    names = [c[0] for c in fake_lib.calls]
    assert names.count("uz_lm_candidate") == names.count("uz_lm_accept") == iterations
    assert names.count("uz_residual_chi2") == 1                  # χ²₀ only
    factors = names.count("uz_chain_factor")
    assert factors == (iterations if early_exit else iterations // cfg.precond_refresh)
    assert kops.launches["lm_candidate"] == kops.launches["lm_accept"] == iterations
    assert kops.launches["chain_factor"] == factors
    assert tuple(hist.shape) == (batch, iterations + 1) and tuple(acc.shape) == (batch, iterations)
    assert tuple(lam.shape) == (batch,) and tuple(poses.shape) == (batch * n, 7)
    # each iteration: candidate then accept, after the PCG
    order = [c for c in names if c in ("uz_lm_candidate", "uz_lm_accept")]
    assert order == ["uz_lm_candidate", "uz_lm_accept"] * iterations
    cands = [c[1] for c in fake_lib.calls if c[0] == "uz_lm_candidate"]
    accepts = [c[1] for c in fake_lib.calls if c[0] == "uz_lm_accept"]
    for a in cands:
        assert len(a) == len(_build.SIGNATURES["uz_lm_candidate"])
        # (huber δ, nodes, edges, instances) after the eight input pointers
        assert a[8:12] == (1.0, n, E, batch)
    for it, a in enumerate(accepts):
        assert len(a) == len(_build.SIGNATURES["uz_lm_accept"])
        # (nodes, edges, instances, it, iterations, early exit), then the
        # rules: 1/factor, factor, λ_min, λ_max, λ_init, tol, refresh
        assert a[3:9] == (n, E, batch, it, iterations, int(early_exit))
        assert a[9:16] == pytest.approx((1 / 3.0, 3.0, 1e-9, 1e2, 1e-4, 1e-6, 3))
    # the early exit's K9 reads the accept's refresh flag from the second
    # iteration on (the factor's 13th argument)
    k9 = [c[1] for c in fake_lib.calls if c[0] == "uz_chain_factor"]
    assert k9[0][12] is None
    assert all((a[12] is not None) == early_exit for a in k9[1:])
    # the damped form: Hb with damp and free, no lift outside the planar solve
    assert all(a[2] is not None and a[3] is not None and a[4] is None for a in k9)


def test_the_fast_planar_loop_hands_k9_its_lift(fake_lib):
    from uzliti_slam_tpu_torch.graph import solver
    from uzliti_slam_tpu_torch.graph import state as gstate

    n, E = 64, 96
    g = gstate.empty_graph(n, E, "meta")
    cfg = solver.SolverConfig(iterations=2, pcg_iterations=2, chain_dense_cutoff=16,
                               early_exit=False, optimize_xy_only=True)
    solver._lm(g, _meta(n), cfg, 1)
    k9 = [c[1] for c in fake_lib.calls if c[0] == "uz_chain_factor"]
    assert k9 and all(a[4] is not None for a in k9)


def test_k36_argument_checks_raise(fake_lib):
    i32 = torch.int32
    B, n, E = 2, 8, 12
    args = [_meta(B * n, 7), _meta(B * n, 6), _meta(B * n), _meta(B * E, dtype=i32),
            _meta(B * E, dtype=i32), _meta(B * E, 7), _meta(B * E, 6, 6), _meta(B * E)]
    with pytest.raises(ValueError, match="in 3 instances"):
        kops.lm_candidate(*args, 1.0, 3)
    bad = list(args)
    bad[1] = _meta(B * n, 7)
    with pytest.raises(ValueError, match="dx: shape"):
        kops.lm_candidate(*bad, 1.0, B)
    cand, r, chi2 = kops.lm_candidate(*args, 1.0, B)
    assert tuple(cand.shape) == (B * n, 7) and tuple(r.shape) == (B * E, 6)
    assert tuple(chi2.shape) == (B,)
    s = kops.lm_state(_meta(B * n, 7), _meta(B * E, 6), _meta(B), 4, 1e-4, B)
    rules = kops.LmRules(3.0, 1e-9, 1e2, 1e-4, 1e-6, 5, True)
    with pytest.raises(ValueError, match="iteration 4 of 4"):
        kops.lm_accept(s, cand, r, chi2, 4, rules)
    with pytest.raises(ValueError, match="chi2_new: shape"):
        kops.lm_accept(s, cand, r, _meta(B + 1), 0, rules)
    kops.lm_accept(s, cand, r, chi2, 0, rules)
    assert [c[0] for c in fake_lib.calls] == ["uz_lm_candidate", "uz_lm_accept"]
    assert kops.launches["lm_candidate"] == kops.launches["lm_accept"] == 1


def test_epoch_call_sites_launch_k5_twice_and_k6_once(fake_lib):
    """On the card each K5 call site of the epoch is K5's table and one
    relaxation entry, and the filter's clustering is one K6 launch (the
    roots entry): on meta tensors, with the library's calls recorded."""
    from uzliti_slam_tpu_torch.graph import filter as gfilter
    from uzliti_slam_tpu_torch.graph import shortest_path
    from uzliti_slam_tpu_torch.graph import state as gstate

    g = gstate.empty_graph(512, 4096, device="cpu").to("meta")
    pairs = _meta(256, dtype=torch.int32)
    shortest_path.pairwise_graph_distance(g, pairs, pairs)
    shortest_path.reevaluate_uncertainty(g)
    gfilter.cluster_roots(g, pairs, cand_mask=_meta(256, dtype=torch.bool))
    assert [c[0] for c in fake_lib.calls] == ["uz_relax_table", "uz_relax_pairs",
                                              "uz_relax_table", "uz_relax_uncertainty",
                                              "uz_cluster_roots"]
    assert {k: v for k, v in kops.launches.items() if v} == {
        "relax_table": 2, "relax_pairs": 1, "relax_uncertainty": 1, "cluster_roots": 1}
    table, pairs_call, _, unc_call, roots = (c[1] for c in fake_lib.calls)
    assert table[3:5] == (512, 4096)
    # (rows, N, n_iters, threads, list capacity, rows in shared memory, E, the
    # table's copy there too); no scratch
    assert pairs_call[4:12] == (256, 512, 64, kops.RELAX_THREADS, 512, 1, 4096, 1)
    assert pairs_call[13] is None
    assert unc_call[5:12] == (512, 64, kops.RELAX_ROOT_THREADS, 512, 1, 4096, 1)
    assert table[6] is None                               # the table's cursors in shared memory
    # the heuristic's mask per candidate (mask_by_edge 0), 51 root rows
    assert roots[4] == 0 and roots[7:13] == (256, pytest.approx(5.0), 16, 5,
                                             pytest.approx(2.0), 51)


def test_k5_rows_above_the_shared_memory_cut_take_a_scratch(fake_lib):
    n = 40_000
    kops.relax_min(_meta(3, n), _meta(64, dtype=torch.int32), _meta(64, dtype=torch.int32),
                   _meta(64), 64)
    call = fake_lib.calls[-1]
    assert call[0] == "uz_relax_min" and call[1][7:11] == (kops.RELAX_LIST_CAP, 0, 64, 0)
    assert call[1][12] is not None                       # 3 x 2N floats of scratch
    assert kops.launches["relax_table"] == 1 and kops.launches["relax_min"] == 1


def _relax_smem(n, e, cap, rows, table):
    """The relaxations' dynamic shared memory (``csrc/relax_min.cu:smem_bytes``)."""
    return ((8 * n if rows else 0) + 4 * (2 * ((n + 31) // 32) + 2 * cap)
            + (4 * ((n + 2) & ~1) + 16 * e if table else 0))


def test_k5_layout_leaves_room_for_the_static_shared_memory(fake_lib):
    """The three relaxation kernels hold count[3] (and relax_unc_kernel its
    argmin partials) in static shared memory; the dynamic part the layout
    picks must fit beside it, or cudaFuncSetAttribute refuses the launch."""
    static = 4 * 3 + 2 * 4 * (512 // 32)
    assert kops.RELAX_STATIC_SMEM >= static
    # the rows' cut: the largest N on the shared-memory route, and the N past it
    n_cut = max(n for n in range(27_000, 27_400) if kops.relax_layout(n, 64)[1])
    cap = kops.RELAX_LIST_CAP
    assert _relax_smem(n_cut, 64, cap, True, False) + kops.RELAX_STATIC_SMEM <= kops._SMEM_BYTES
    assert (_relax_smem(n_cut + 1, 64, cap, True, False) + kops.RELAX_STATIC_SMEM
            > kops._SMEM_BYTES)
    assert not kops.relax_layout(27_181, 64)[1] and not kops.relax_layout(27_182, 64)[1]
    # the table's cut at 512 nodes: the largest E whose copy joins the rows
    e_cut = max(e for e in range(13_000, 14_500) if kops.relax_layout(512, e)[2])
    assert _relax_smem(512, e_cut, 512, True, True) + kops.RELAX_STATIC_SMEM <= kops._SMEM_BYTES
    assert not kops.relax_layout(512, e_cut + 1)[2]
    # every route picked near both cuts fits beside the static part
    for n, e in [(n, 64) for n in range(n_cut - 40, n_cut + 40)] + [
            (512, e) for e in range(e_cut - 40, e_cut + 40)]:
        cap_n, rows, table, _ = kops.relax_layout(n, e)
        assert _relax_smem(n, e, cap_n, rows, table) + static <= kops._SMEM_BYTES
    # the call at the cut and past it: rows in shared memory, then a scratch
    i32, bl = torch.int32, torch.bool
    edges = (_meta(64, dtype=i32), _meta(64, dtype=i32), _meta(64))
    for n, on_chip in ((n_cut, 1), (n_cut + 1, 0)):
        kops.relax_uncertainty(_meta(n), _meta(n, dtype=bl), _meta(n), *edges, 64)
        call = fake_lib.calls[-1]
        assert call[0] == "uz_relax_uncertainty" and call[1][5] == n
        assert call[1][9] == on_chip and (call[1][13] is None) == bool(on_chip)


def test_k6_raises_beyond_its_shared_memory(fake_lib):
    # the one-CTA form holds B <= 256 (8 column words a lane), the epoch's
    # candidates; above it neither entry raises: both take the grid route,
    # one cooperative launch with a global scratch of cluster_scratch words
    b = kops.CLUSTER_CTA_MAX
    assert b == 256
    from uzliti_slam_tpu_torch import pipeline
    assert pipeline.MAX_CANDIDATES <= b
    i32, bl = torch.int32, torch.bool
    for n in (1, b, b + 1, 1024, 4096):
        kops.cluster_labels(_meta(n), _meta(n), _meta(n, dtype=bl), 5.0, 16)
        call = fake_lib.calls[-1][1]
        # (sf, st, valid, b, max_dt, n_iters, labels, scratch, words, stream)
        assert call[3] == n and (call[7] is None) == (n <= b)
        assert call[8] == (0 if n <= b else kops.cluster_scratch(n, False))
        kops.cluster_roots(_meta(n, dtype=i32), _meta(64, dtype=i32), _meta(64, dtype=i32),
                           _meta(64, dtype=bl), _meta(32, dtype=bl), _meta(32), 5.0, 5, 2.0, 16)
        call = fake_lib.calls[-1][1]
        r = kops.cluster_root_count(n, 5)
        assert call[7] == n and call[12] == r and (call[-3] is None) == (n <= b)
        assert call[-2] == (0 if n <= b else kops.cluster_scratch(n, True, r))
    assert [c[0] for c in fake_lib.calls] == ["uz_cluster_labels", "uz_cluster_roots"] * 5
    assert kops.launches["cluster_labels"] == kops.launches["cluster_roots"] == 5
    # the scratch's words (csrc/cluster_labels.cu:grid_scratch_ints): the bit
    # matrix (B x ⌈B/32⌉, 2 MB at B = 4,096) and 5B + 3 words + 3 more; the
    # roots add 5 (B + 1) segment entries, 2 words + 1 and the R slots
    assert kops.cluster_scratch(4096, False) == 4096 * 128 + 5 * 4096 + 3 * 128 + 3
    assert (kops.cluster_scratch(300, True, 60) - kops.cluster_scratch(300, False)
            == 5 * 301 + 2 * 10 + 1 + 60)


@pytest.mark.parametrize("levels", [8, 9, 10, 16, 17])
def test_k12_k13_launch_once_per_eight_levels(fake_lib, levels):
    """More than 8 pyramid levels (``FrontendConfig.pyramid_levels`` is free):
    K12 and K13 launch ⌈L/8⌉ times, 8 levels a launch, over slices of the
    same outputs."""
    nms_tables = []

    def fast_nms_levels(table, n_levels, C, t, stream):
        nms_tables.append(np.array((ctypes.c_longlong * (4 * n_levels)).from_address(table)))
        fake_lib.calls.append(("uz_fast_nms_levels", (table, n_levels, C, t, stream)))
        return 0

    fake_lib.uz_fast_nms_levels = fast_nms_levels
    shapes = [(max(round(120 / 1.2 ** lv), 32), max(round(160 / 1.2 ** lv), 32))
              for lv in range(levels)]
    maps = kops.fast_nms([_meta(2, h, w) for h, w in shapes], 20.0)
    n_launch = -(-levels // 8)
    assert kops.launches["fast_nms"] == n_launch and len(maps) == levels
    parts = [min(8, levels - 8 * i) for i in range(n_launch)]
    assert [c[1][1] for c in fake_lib.calls] == parts
    rows = np.concatenate([t.reshape(-1, 4) for t in nms_tables])
    assert rows[:, 2:].tolist() == [list(hw) for hw in shapes]
    assert rows[:, 1].tolist() == [m.data_ptr() for m in maps]
    assert all(m._base is maps[0]._base for m in maps)
    fake_lib.calls.clear()
    uv, resp, valid = kops.grid_topk([_meta(2, h, w) for h, w in shapes], 30, 4)
    assert tuple(uv.shape) == (levels, 2, 30, 2) and tuple(valid.shape) == (levels, 2, 30)
    assert kops.launches["grid_topk"] == n_launch
    calls = [c[1] for c in fake_lib.calls]
    assert [c[1] for c in calls] == parts
    # each launch writes its levels' slices: 8 levels of uv, resp and valid on
    step = 8 * 2 * 30
    assert [c[7] - calls[0][7] for c in calls] == [4 * 2 * step * i for i in range(n_launch)]
    assert [c[8] - calls[0][8] for c in calls] == [4 * step * i for i in range(n_launch)]
    assert [c[9] - calls[0][9] for c in calls] == [step * i for i in range(n_launch)]
    # 16 cells x 1 > k = 30? no: 16 <= 30, no global pass, no scratch
    assert all(c[6] is None for c in calls)
