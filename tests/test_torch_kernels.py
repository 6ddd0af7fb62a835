"""The port's kernel layer on a machine without a GPU or nvcc.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against its plain version there).  Here: the build is lazy and
hash-keyed, a failed nvcc lookup raises, every exported C function has a
ctypes signature of its arity, wrappers on CPU tensors run the plain
version without counting a launch, and the argument checks raise.
"""

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
        "gicp.cu", "pnp.cu"}


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
    e_valid = torch.from_numpy(rng.random(E) < 0.7)
    labels = kops.components_plain(ef, et, e_valid, n, 8)
    return [
        ("relax_min", (dist0, ef, et, w, 4)),
        ("cluster_labels", (stamps[0], stamps[1], valid_b, 5.0, 16)),
        ("ransac_rigid", (pts, pts + 0.01, torch.ones(2, 8, dtype=torch.bool), tri, 0.3, 3,
                          0.01)),
        ("components", (ef, et, e_valid, n, 8)),
        ("gauge_fix", (labels, torch.arange(n) < 10, torch.arange(n) == 3,
                       torch.from_numpy(rng.uniform(0, 5, n).astype(np.float32)))),
    ]


@pytest.mark.parametrize("case", range(5), ids=["relax_min", "cluster_labels", "ransac_rigid",
                                                 "components", "gauge_fix"])
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
    D, bin0, Wray = map(torch.from_numpy, occupancy.center_tables(size, 0.1, bins))
    scans = torch.from_numpy((0.5 + rng.random((5, bins))).astype(np.float32))
    scans[1, 3] = torch.inf
    cx = torch.tensor([16, 10, 20, 40, 16], dtype=torch.int32)
    cy = torch.tensor([16, 12, 18, 5, 16], dtype=torch.int32)
    kbin = torch.tensor([0, 5, -7, 2, 1], dtype=torch.int32)
    idx = torch.tensor([0, 1, 4, 0, 0], dtype=torch.int32)
    return (torch.zeros(size, size), cx, cy, kbin, scans, idx, torch.tensor(3, dtype=torch.int32),
            D, bin0, Wray, 0.1, 1.5, 0.85, -0.4, 10.0, True)


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
    kops.reset_launches()
    return lib


def test_chain_factor_launches_one_level_kernel_per_level_and_the_root(fake_lib):
    levels, root_inv, n = kops.chain_factor(_meta(200, 6, 6), _meta(200, 6, 6), 16)
    names = [c[0] for c in fake_lib.calls]
    assert names == ["uz_chain_factor_level"] * 4 + ["uz_chain_factor_root"]
    # (float64 input?, valid rows, halves): the caller's float32 D, U first
    assert [c[1][2:5] for c in fake_lib.calls[:4]] == [
        (0, 200, 128), (1, 128, 64), (1, 64, 32), (1, 32, 16)]
    assert fake_lib.calls[-1][1][2:5] == (1, 16, 16) and tuple(root_inv.shape) == (96, 96)
    # no flag: always build (the flag is the level's 13th and the root's 8th argument)
    assert all(c[1][12] is None for c in fake_lib.calls[:4]) and fake_lib.calls[4][1][7] is None
    assert kops.launches["chain_factor"] == 1 and n == 200
    held = (levels, root_inv, n)
    kops.chain_factor(_meta(200, 6, 6), _meta(200, 6, 6), 16, held=held,
                      need=_meta((), dtype=torch.bool))
    assert kops.launches["chain_factor"] == 2 and len(fake_lib.calls) == 10
    kops.chain_apply(held, _meta(200, 6))
    names = [c[0] for c in fake_lib.calls[10:]]
    assert names == ["uz_chain_forward"] * 4 + ["uz_chain_root"] + ["uz_chain_backward"] * 4
    kops.chain_apply(kops.chain_factor(_meta(12, 6, 6), _meta(12, 6, 6)), _meta(12, 6))
    root_call = fake_lib.calls[-1]
    assert root_call[0] == "uz_chain_root" and root_call[1][2:6] == (12, 96, 0, 12)
    assert kops.launches["chain_apply"] == 2


@pytest.mark.parametrize("n, grid", [(10, False), (5461, False), (5462, True), (100_000, True)])
def test_pcg_launches_through_the_library_on_its_route(fake_lib, n, grid):
    x, r, p, scal = kops.pcg_init(_meta(n, 6), _meta(n, 6))
    kops.pcg_alpha(p, _meta(n, 6), x, r, scal, 1e-8)
    kops.pcg_beta(r, _meta(n, 6), p, scal)
    assert [c[0] for c in fake_lib.calls] == ["uz_pcg_init", "uz_pcg_alpha", "uz_pcg_beta"]
    assert fake_lib.calls[0][1][2] == 6 * n and kops.launches["pcg"] == 3
    # the grid route's partials: two per 4096-float chunk; none on one CTA
    partials = [c[1][-2] for c in fake_lib.calls]
    assert all((ptr is not None) == grid for ptr in partials)
    assert tuple(scal.shape) == (4,)


def test_project_rays_launches_through_the_library(fake_lib):
    i32 = torch.int32
    out = kops.project_rays(_meta(32, 32), _meta(5, dtype=i32), _meta(5, dtype=i32),
                            _meta(5, dtype=i32), _meta(5, 36), _meta(5, dtype=i32),
                            _meta((), dtype=i32), _meta(1024), _meta(1024, dtype=i32),
                            _meta(1024), 0.1, 6.0, 0.85, -0.4, 10.0, True)
    assert tuple(out.shape) == (32, 32) and kops.launches["project_rays"] == 1
    assert fake_lib.calls[-1][0] == "uz_project_rays"
    assert fake_lib.calls[-1][1][12:20] == pytest.approx((0.1, 0.071, 6.0, 0.85, -0.4, 10.0, 1,
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
        kops.chain_factor(D, D, 16, need=_meta((), dtype=torch.bool))
    with pytest.raises(ValueError, match="at most 64"):
        kops.chain_factor(D, D, 128)
    held = kops.chain_factor(_meta(100, 6, 6), _meta(100, 6, 6), 16)
    with pytest.raises(ValueError, match="other shapes"):
        kops.chain_factor(D, D, 16, held=held, need=_meta((), dtype=torch.bool))
    held = kops.chain_factor(D, D, 16)
    with pytest.raises(TypeError, match="need: dtype"):
        kops.chain_factor(D, D, 16, held=held, need=_meta(()))
    with pytest.raises(ValueError, match="U: shape"):
        kops.chain_factor(D, _meta(199, 6, 6), 16)
    with pytest.raises(ValueError, match="Hp: shape"):
        kops.pcg_alpha(_meta(4, 6), _meta(5, 6), _meta(4, 6), _meta(4, 6), _meta(4), 1e-8)
    with pytest.raises(ValueError, match="scal: shape"):
        kops.pcg_beta(_meta(4, 6), _meta(4, 6), _meta(4, 6), _meta(3))
    i32 = torch.int32
    good = [_meta(32, 32), _meta(5, dtype=i32), _meta(5, dtype=i32), _meta(5, dtype=i32),
            _meta(5, 36), _meta(5, dtype=i32), _meta((), dtype=i32), _meta(1024),
            _meta(1024, dtype=i32), _meta(1024)]
    for pos, bad, err in ((5, _meta(5, dtype=torch.int64), "idx: dtype"),
                          (6, _meta(1, dtype=i32), "count: shape"),
                          (8, _meta(1024), "bin0: dtype"),
                          (4, _meta(5, 36, dtype=torch.float64), "scans: dtype")):
        args = list(good)
        args[pos] = bad
        with pytest.raises((TypeError, ValueError), match=err):
            kops.project_rays(*args, 0.1, 6.0, 0.85, -0.4, 10.0, True)
    # only the two factors built for the held-factor cases reached the library
    assert {c[0] for c in fake_lib.calls} == {"uz_chain_factor_level", "uz_chain_factor_root"}


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
        ("grid_topk", (score, 16, 4)),
        ("grid_topk", (score, 8, 4)),
        ("orb_describe", (img, uv, features.pattern("brief", "cpu"))),
        ("scan_bins", (depth, cam, xf, 90, -np.pi, np.pi, (-0.4, 0.6), 6.0, 0.3)),
    ]


@pytest.mark.parametrize("case", range(5), ids=["fast_nms", "grid_topk", "grid_topk_global",
                                                 "orb_describe", "scan_bins"])
def test_frontend_kernel_wrappers_run_their_plain_version_on_cpu(case):
    name, args = _frontend_cases()[case]
    kops.reset_launches()
    got, ref = getattr(kops, name)(*args), getattr(kops, f"{name}_plain")(*args)
    for a, b in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert kops.launches == {k: 0 for k in kops.launches}


def test_frontend_kernels_launch_through_the_library(fake_lib):
    from uzliti_slam_tpu_torch.frontend import camera

    assert tuple(kops.fast_nms(_meta(2, 48, 64), 20.0).shape) == (2, 48, 64)
    assert fake_lib.calls[-1][0] == "uz_fast_nms" and fake_lib.calls[-1][1][1:5] == (2, 48, 64, 20.0)
    # 16 cells x 4 = k_total: no scratch; 16 cells x 1 > 8: the global top-k's scratch
    uv, resp, valid = kops.grid_topk(_meta(2, 48, 64), 64, 4)
    assert fake_lib.calls[-1][1][4:8] == (4, 4, 64, None)
    assert tuple(uv.shape) == (2, 64, 2) and valid.dtype == torch.bool
    kops.grid_topk(_meta(2, 48, 64), 8, 4)
    assert fake_lib.calls[-1][1][4:7] == (4, 1, 8) and fake_lib.calls[-1][1][7] is not None
    ang, desc = kops.orb_describe(_meta(2, 48, 64), _meta(2, 16, 2), _meta(256, 2, 2))
    assert fake_lib.calls[-1][0] == "uz_orb_describe" and fake_lib.calls[-1][1][3:8] == (
        2, 48, 64, 16, 0)
    assert tuple(desc.shape) == (2, 16, 32) and desc.dtype == torch.uint8
    given = _meta(2, 16)
    ang, _ = kops.orb_describe(_meta(2, 48, 64), _meta(2, 16, 2), _meta(256, 2, 2), angles=given)
    assert ang is given and fake_lib.calls[-1][1][7] == 1
    cam = camera.PinholeCamera(40.0, 40.0, 16.0, 12.0, 64, 48)
    near, far = kops.scan_bins(_meta(2, 48, 64), cam, _meta(2, 12), 360, -np.pi, np.pi,
                               (-0.4, 0.6), 6.0, 0.3)
    assert tuple(near.shape) == tuple(far.shape) == (2, 360)
    args = fake_lib.calls[-1][1]
    assert fake_lib.calls[-1][0] == "uz_scan_bins" and args[2:5] == (2, 48, 64)
    assert args[9] == 360 and args[12] == pytest.approx(360 / (2 * np.pi), rel=1e-6)
    assert args[17] == pytest.approx((2**21 - 1) / 6.006, rel=1e-6)
    assert kops.launches["fast_nms"] == 1 and kops.launches["grid_topk"] == 2
    assert kops.launches["orb_describe"] == 2 and kops.launches["scan_bins"] == 1


def test_frontend_kernel_argument_checks_raise(fake_lib):
    from uzliti_slam_tpu_torch.frontend import camera

    with pytest.raises(ValueError, match="expected \\(C, H, W\\)"):
        kops.fast_nms(_meta(48, 64), 20.0)
    with pytest.raises(TypeError, match="img: dtype"):
        kops.fast_nms(_meta(1, 48, 64, dtype=torch.float64), 20.0)
    with pytest.raises(ValueError, match="per cell"):
        kops.grid_topk(_meta(1, 8, 8), 128, 4)
    with pytest.raises(ValueError, match="pattern: shape"):
        kops.orb_describe(_meta(1, 48, 64), _meta(1, 4, 2), _meta(128, 2, 2))
    with pytest.raises(ValueError, match="angles: shape"):
        kops.orb_describe(_meta(1, 48, 64), _meta(1, 4, 2), _meta(256, 2, 2), angles=_meta(1, 5))
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
    out = kops.bilateral(_meta(2, 480, 640), _meta(2, 480, 640))
    args = fake_lib.calls[-1][1]
    assert fake_lib.calls[-1][0] == "uz_bilateral" and args[2:5] == (2, 480, 640)
    assert args[6] == kops.NEG_INV_2SC2 and tuple(out.shape) == (2, 480, 640)
    pose, frac, mse, cov, iok = kops.icp(_meta(1, 360, 2), _meta(1, 360, dtype=b),
                                         _meta(1, 360, 2), _meta(1, 360, dtype=b), _meta(1, 3),
                                         20, 0.25, 0.25, 1.5, 0.8, 0.0004)
    args = fake_lib.calls[-1][1]
    assert fake_lib.calls[-1][0] == "uz_icp" and args[5:9] == (1, 360, 360, 20)
    assert args[9:14] == pytest.approx((0.25, 0.25, 1.5, 0.8, 0.0004))
    assert tuple(cov.shape) == (1, 3, 3) and iok.dtype == b
    # the matching and the GIST query are one kernel, one count
    assert kops.launches["hamming_top2"] == 2
    assert kops.launches["bilateral"] == 1 and kops.launches["icp"] == 1


def test_keyframe_kernel_argument_checks_raise(fake_lib):
    u8, i32, b = torch.uint8, torch.int32, torch.bool
    with pytest.raises(TypeError, match="cslot: dtype"):
        kops.hamming_top2(_meta(8, 32, dtype=u8), _meta(4, 16, 32, dtype=u8), _meta(4, 16, dtype=b),
                          _meta(2, dtype=torch.int64), _meta(8, dtype=b), 0.9, 64.0)
    with pytest.raises(ValueError, match="shared memory"):
        kops.hamming_top2(_meta(8, 32, dtype=u8), _meta(4, 8000, 32, dtype=u8),
                          _meta(4, 8000, dtype=b), _meta(2, dtype=i32), _meta(8, dtype=b), 0.9, 64.0)
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
    r = torch.from_numpy(rng.uniform(0.0, 7.0, (2, 300)).astype(np.float32))
    ok = torch.from_numpy(rng.random((2, 300)) < 0.7)
    bins = torch.from_numpy(rng.integers(0, 30, (2, 300)).astype(np.int32))
    return [
        ("merge_pairs", (g.pose, g.stamp, g.node_valid, 0.3, 20.0, 16)),
        ("calib_gn", (cal.pose[ef], cal.pose[et], cal.e_transform, torch.zeros(E, dtype=torch.bool),
                      (cal.e_type == 104) & cal.e_valid, zeros, zeros,
                      torch.tensor([[0.0, 0, 0, 1, 0, 0, 0]]), 3, 1e2, 1e-6)),
        ("bin_min_max", (r, ok, bins, 30, 6.0)),
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
    """The plain bin_min_max on a batch gives, row for row, what the plain
    ``scan._bin_min_max`` gives one flat scan; K15's scan_bins plain
    version reduces through it too."""
    from uzliti_slam_tpu_torch.ops import scan

    _, (r, ok, bins, n_bins, max_range) = _maintenance_cases()[2]
    near, far = kops.bin_min_max_plain(r, ok, bins, n_bins, max_range)
    for b in range(2):
        n1, f1 = scan._bin_min_max(r[b], ok[b], bins[b], n_bins, max_range)
        assert torch.equal(near[b], n1) and torch.equal(far[b], f1)
    n1, f1 = kops.bin_min_max_plain(r[0], ok[0] & (bins[0] != 3), bins[0], n_bins, max_range)
    assert n1[3] == math.inf and f1[3] == -math.inf


def test_maintenance_kernels_launch_through_the_library(fake_lib):
    i32, b = torch.int32, torch.bool
    keep, absorb, ok = kops.merge_pairs(_meta(500, 7), _meta(500), _meta(500, dtype=b), 0.25,
                                        15.0, 16)
    args = fake_lib.calls[-1][1]
    assert fake_lib.calls[-1][0] == "uz_merge_pairs" and args[3:7] == (500, 0.25, 15.0, 16)
    assert tuple(keep.shape) == (16,) and keep.dtype == i32 and ok.dtype == b
    theta, hist = kops.calib_gn(_meta(4096, 7), _meta(4096, 7), _meta(4096, 7),
                                _meta(4096, dtype=b), _meta(4096, dtype=b),
                                _meta(4096, dtype=i32), _meta(4096, dtype=i32), _meta(2, 7), 20,
                                1e2, 1e-6)
    args = fake_lib.calls[-1][1]
    # 16 CTAs of 256 threads over 4,096 edges; √100 = 10
    assert fake_lib.calls[-1][0] == "uz_calib_gn" and args[8:14] == (4096, 2, 20, 10.0,
                                                                       1e-6, 16)
    assert tuple(theta.shape) == (15,) and tuple(hist.shape) == (21,)
    near, far = kops.bin_min_max(_meta(16, 720), _meta(16, 720, dtype=b),
                                 _meta(16, 720, dtype=i32), 360, 6.0)
    args = fake_lib.calls[-1][1]
    assert fake_lib.calls[-1][0] == "uz_bin_min_max" and args[3:6] == (16, 720, 360)
    assert tuple(near.shape) == tuple(far.shape) == (16, 360)
    assert kops.launches["merge_pairs"] == kops.launches["calib_gn"] == 1
    assert kops.launches["bin_min_max"] == 1


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
    with pytest.raises(ValueError, match="1..1023"):
        kops.bin_min_max(_meta(2, 9), _meta(2, 9, dtype=b), _meta(2, 9, dtype=i32), 2000, 6.0)
    with pytest.raises(TypeError, match="bins: dtype"):
        kops.bin_min_max(_meta(2, 9), _meta(2, 9, dtype=b), _meta(2, 9, dtype=torch.int64), 90,
                         6.0)
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
    samples, poses = kops.pnp_hypotheses_plain(X, xn, pvalid, depth, keys)
    return [
        ("voxel_grid", (pts, lab, valid, 20.0, 64)),
        ("knn_normals", (cloud, cvalid)),
        ("gicp", (src, lab[:40], cvalid[0], cloud, lab[:40].expand(2, 40, 3).contiguous(), cvalid,
                  normals, lie.pose_identity((2,)), 5, 0.04, 0.002, 0.3, 1.0, math.pi / 6)),
        ("pnp_hypotheses", (X, xn, pvalid, depth, keys)),
        ("pnp_refine", (X, xn, pvalid, depth, samples, poses, 3.6e-5, 0.04, 8.0, 4, 250000.0)),
    ]


@pytest.mark.parametrize("case", range(5), ids=["voxel_grid", "knn_normals", "gicp",
                                                 "pnp_hypotheses", "pnp_refine"])
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
    b, i32 = torch.bool, torch.int32
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
    smp, poses = kops.pnp_hypotheses(_meta(10, 256, 3), _meta(10, 256, 2), _meta(10, 256, dtype=b),
                                     _meta(10, 256), _meta(10, 64, 256))
    assert fake_lib.calls[-1][0] == "uz_pnp_hypotheses" and fake_lib.calls[-1][1][5:8] == (
        10, 256, 64)
    assert tuple(smp.shape) == (10, 64, 6) and tuple(poses.shape) == (10, 192, 7)
    kops.pnp_hypotheses(_meta(10, 256, 3), _meta(10, 256, 2), _meta(10, 256, dtype=b), None,
                        _meta(10, 64, 256))
    assert fake_lib.calls[-1][1][3] is None   # no depth: a null pointer, two families
    out = kops.pnp_refine(_meta(10, 256, 3), _meta(10, 256, 2), _meta(10, 256, dtype=b),
                          _meta(10, 256), _meta(10, 64, 6, dtype=i32), _meta(10, 192, 7), 3.6e-5,
                          0.04, 10.0, 8, 275625.0)
    assert fake_lib.calls[-1][0] == "uz_pnp_refine"
    assert fake_lib.calls[-1][1][6:15] == pytest.approx((10, 256, 64, 192, 3.6e-5, 0.04, 10.0, 8,
                                                         275625.0))
    assert out[1].dtype == i32 and tuple(out[5].shape) == (10, 192)
    # K28's two entry points are one kernel
    assert kops.launches["voxel_grid"] == kops.launches["knn_normals"] == 1
    assert kops.launches["gicp"] == 1 and kops.launches["pnp"] == 3


def test_registration_kernel_argument_checks_raise(fake_lib):
    b, i32 = torch.bool, torch.int32
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
        kops.pnp_hypotheses(_meta(2, 30, 3), _meta(2, 30, 2), _meta(2, 30, dtype=b), None,
                            _meta(2, 8, 31))
    with pytest.raises(ValueError, match="a draw takes 6"):
        kops.pnp_hypotheses(_meta(2, 5, 3), _meta(2, 5, 2), _meta(2, 5, dtype=b), None,
                            _meta(2, 8, 5))
    with pytest.raises(ValueError, match="192 hypotheses for 32 draws"):
        kops.pnp_refine(_meta(2, 30, 3), _meta(2, 30, 2), _meta(2, 30, dtype=b), _meta(2, 30),
                        _meta(2, 32, 6, dtype=i32), _meta(2, 192, 7), 3.6e-5, 0.04, 10.0, 8, 1.0)
    with pytest.raises(ValueError, match="shared memory"):
        kops.pnp_refine(_meta(1, 2048, 3), _meta(1, 2048, 2), _meta(1, 2048, dtype=b),
                        _meta(1, 2048), _meta(1, 16384, 6, dtype=i32), _meta(1, 49152, 7), 3.6e-5,
                        0.04, 10.0, 8, 1.0)
    assert fake_lib.calls == []
