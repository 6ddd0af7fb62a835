"""The port's kernel layer on a machine without a GPU or nvcc.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against its plain version there).  Here: the build is lazy and
hash-keyed, a failed nvcc lookup raises, every exported C function has a
ctypes signature of its arity, wrappers on CPU tensors run the plain
version without counting a launch, and the argument checks raise.
"""

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
        "cluster_labels.cu", "ransac_rigid.cu", "components.cu"}


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
