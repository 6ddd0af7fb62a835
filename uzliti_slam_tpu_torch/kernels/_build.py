"""Build and load the package's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` for Hopper
(``sm_90a``), all started together, and the objects are linked into one
shared library with a plain C interface, loaded with ``ctypes``.  The
library lands in ``build/uzliti_slam_tpu_torch/`` at the repository root,
named by a hash of the sources, so an edited source rebuilds and an unedited
one is reused.  Nothing is built when the package is imported: ``load()``
runs at the first launch on a CUDA tensor.  Compiled without
``--use_fast_math``, so the small-angle branches of the Lie algebra keep the
reference's accurate sin/cos/atan2.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "uzliti_slam_tpu_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signature of every exported function: (argtypes), all return cudaError_t.
SIGNATURES = {
    "uz_linearize": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I,
                     _P, _P, _P, _P, _P, _P, _P],
    "uz_pcg_chain_solve": [_P, _I, _I, _I] + [_P] * 10 + [_I, _P, _I, _F] + [_P] * 9,
    "uz_hvp": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _P],
    "uz_chain_forward": [_P, _I, _I, _P, _P, _I, _I, _P, _P],
    "uz_chain_backward": [_P, _I, _I, _P, _P, _P, _P, _I, _I, _P, _I, _P],
    "uz_residual_chi2": [_P, _P, _P, _P, _P, _P, _F, _I, _I, _P, _P, _P, _P],
    "uz_relax_table": [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    "uz_relax_min": [_P, _P, _P] + [_I] * 8 + [_P, _P, _P],
    "uz_relax_pairs": [_P] * 4 + [_I] * 8 + [_P, _P, _P],
    "uz_relax_uncertainty": [_P] * 5 + [_I] * 7 + [_P, _P, _P],
    "uz_cluster_labels": [_P, _P, _P, _I, _F, _I, _P, _P, _L, _P],
    "uz_cluster_roots": [_P] * 4 + [_I, _P, _P, _I, _F, _I, _I, _F, _I] + [_P] * 8 + [_L, _P],
    "uz_ransac_rigid": [_P, _L, _P, _L, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _F, _F,
                        _P, _P, _P, _P, _P, _P, _P, _P, _P],
    "uz_components_gauge": [_P, _P, _P, _I, _I, _I] + [_P] * 9,
    "uz_chain_root": [_P, _P, _I, _I, _I, _I, _P, _I, _P],
    "uz_chain_factor": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _L, _P, _P, _I, _P],
    "uz_lm_candidate": [_P] * 8 + [_F, _I, _I, _I] + [_P] * 6,
    "uz_lm_accept": [_P] * 3 + [_I] * 6 + [_F] * 6 + [_I] + [_P] * 10,
    "uz_pcg_init": [_P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
    "uz_pcg_alpha": [_P, _P, _I, _I, _F, _P, _P, _P, _P, _P],
    "uz_pcg_beta": [_P, _P, _I, _I, _P, _P, _P, _P],
    "uz_pcg_chain_start": [_P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "uz_pcg_chain_step": [_P, _F, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    "uz_pcg_grid_ctas": [],
    "uz_pcg_grid_start": [_P, _I, _I, _I, _P] + [_P] * 6 + [_L, _P, _I, _P],
    "uz_pcg_grid_step": [_P, _F, _P, _I, _I, _I, _P] + [_P] * 6 + [_L, _P, _I, _P],
    "uz_pcg_fleet_solve": [_P, _I, _I, _I, _I, _I, _P] + [_P] * 9 + [_P, _I, _F] + [_P] * 5,
    "uz_project_rays": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _F, _F, _I, _F,
                        _P, _P],
    "uz_fast_nms_levels": [_P, _I, _I, _F, _P],
    "uz_grid_topk": [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P],
    "uz_orb_describe_rows": [_P, _I, _P],
    "uz_scan_bins": [_P, _P, _I, _I, _I, _F, _F, _F, _F, _I, _F, _F, _F, _F, _F, _F, _F, _F,
                     _F, _P, _P, _P],
    "uz_hamming_top2": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P],
    "uz_gist_topk": [_P, _P, _P, _P, _P, _I, _I, _F, _F, _P, _P, _P, _P],
    "uz_bilateral": [_P, _P, _I, _I, _I, _P, _F, _P, _P, _P],
    "uz_icp": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P, _P, _P, _P, _P, _P],
    "uz_bin_min_max": [_P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F, _F, _P, _P],
    "uz_merge_pairs": [_P, _P, _P, _I, _F, _F, _F, _I, _P, _P, _P, _P, _P, _P, _P],
    "uz_calib_gn": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P],
    "uz_feature_votes": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F,
                         _P, _P, _P, _P, _P],
    "uz_repo_nearest": [_P, _P, _P, _P, _I, _I, _F, _P, _P, _P, _P, _P],
    "uz_repo_votes": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _F,
                      _P, _P, _P, _P, _P],
    "uz_word_assign": [_P, _P, _P, _I, _I, _P, _P, _P, _P],
    "uz_word_majority": [_P, _P, _P, _P, _I, _I, _P, _P, _P],
    "uz_bow_query": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P, _P],
    "uz_voxel_grid": [_P, _P, _P, _I, _F, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "uz_knn_normals": [_P, _P, _I, _I, _P, _P],
    "uz_gicp": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                _P, _P, _P, _P, _P, _P],
    "uz_pnp_ransac": [_P] * 5 + [_I] * 3 + [_F, _F, _F, _I, _F] + [_P] * 10,
    "uz_sift_describe": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "uz_l2_top2": [_P, _P, _P, _P, _I, _I, _I, _F, _F, _P, _P, _P, _P],
    "uz_uid_slots": [_P, _P, _I, _P, _I, _P, _P],
    "uz_edge_key_match": [_P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P],
    "uz_delta_upsert": [_P] * 8 + [_I] + [_P] * 10 + [_I] + [_P] * 6 + [_I] + [_P] * 10
                       + [_I, _I, _P, _P, _P],
    "uz_scope_merge": [_P] * 8 + [_I] + [_P] * 4 + [_I, _P],
}

_lib = None
last_build_seconds = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libuzkernels_{source_hash()}.so"


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        nvcc = str(cand) if cand.is_file() else None
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "uzliti_slam_tpu_torch kernels are built at first use on a CUDA machine"
        )
    return nvcc


def build() -> Path:
    """Compile the sources if the library for their hash is missing: one
    ``nvcc -c`` per source, all running at once, then one link."""
    global last_build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in sources():
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        logs, failed = [], []
        for cmd, _, proc in jobs:   # wait for every compile, failed or not
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{err}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = Path(tmp) / out.name
        cmd = [nvcc, "-shared", "-o", str(lib), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (exit {proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stderr}")
        last_build_seconds = time.perf_counter() - t0
        # ptxas -v: registers, shared memory and spills per kernel
        (BUILD_DIR / f"ptxas_{source_hash()}.log").write_text("".join(logs))
        os.replace(lib, out)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, then load the library once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
