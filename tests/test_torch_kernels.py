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
        "linearize.cu", "hvp.cu", "chain_apply.cu", "residual_chi2.cu"}


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
