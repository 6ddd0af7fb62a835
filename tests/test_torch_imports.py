"""The port stands alone: no module of uzliti_slam_tpu_torch, and not
chip_smoke.py, imports JAX or the JAX package.

The machine with the card has no JAX.  The check reads the source (AST),
since the test process itself has JAX imported.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "uzliti_slam_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "uzliti_slam_tpu")


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_the_files_exist():
    assert len(FILES) >= 12 and all(p.is_file() for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_check_catches_a_jax_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import numpy\nfrom uzliti_slam_tpu.ops import lie\n"
                 "def f():\n    import jax.numpy as jnp\n")
    assert [m for m in _imported_modules(p) if _forbidden(m)] == [
        "uzliti_slam_tpu.ops", "jax.numpy"]
    assert not _forbidden("uzliti_slam_tpu_torch.graph")
