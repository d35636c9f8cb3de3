"""Static check: the port and chip_smoke.py import no JAX.

An AST scan, not a sys.modules check: tests/conftest.py imports jax before
any test runs. The port may read two framework-free modules of the JAX
package (its config dataclasses and the native decoder's ctypes bindings);
chip_smoke.py imports the port only.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "image_retrieval_tpu_torch").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax"}
JAX_PACKAGE_ALLOWED = {"image_retrieval_tpu.config", "image_retrieval_tpu.utils.native"}


def imported_modules(path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
            for alias in node.names:  # `from image_retrieval_tpu import config`
                yield f"{node.module}.{alias.name}"


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES}
    for module in ("ops/flash_attention.py", "ops/int4.py", "ops/int4_screen.py",
                   "parallel/collectives.py", "index/filters.py"):
        assert f"image_retrieval_tpu_torch/{module}" in names
    assert len(names) >= 21


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_imports_no_jax(path):
    smoke = path.name == "chip_smoke.py"
    for mod in imported_modules(path):
        root = mod.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {mod}"
        if root == "image_retrieval_tpu":
            assert not smoke, f"chip_smoke.py imports the JAX package ({mod})"
            assert mod in JAX_PACKAGE_ALLOWED or any(
                mod.startswith(a + ".") for a in JAX_PACKAGE_ALLOWED) or (
                mod in {"image_retrieval_tpu", "image_retrieval_tpu.utils"}), \
                f"{path.name} imports {mod} from the JAX package"
