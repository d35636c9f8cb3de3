"""Static check: the port and chip_smoke.py import no JAX (and no pandas,
which the machine with the card lacks).

An AST scan, not a sys.modules check: tests/conftest.py imports jax before
any test runs. Neither the port nor chip_smoke.py imports anything of the JAX
package, not even a module there that does not import JAX: the port keeps
its own copies (config.py, utils/native.py, the fixture BPE vocabulary;
tests/test_torch_config.py pins them to the originals). Nor does either
read a file under the JAX package's directory: a path into it, built from
string parts for a call or a pathlib `/`, is rejected too.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "image_retrieval_tpu_torch").rglob("*.py"))
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "pandas"}
JAX_PACKAGE_ALLOWED = frozenset()  # modules of the JAX package the port may import
# the modules of the durable ingest-and-serve slice, new or grown
DURABLE_SLICE = ("utils/profiling.py", "models/encoder.py", "app/embed.py",
                 "index/journal.py", "index/evaluation.py", "index/vector_index.py",
                 "app/search.py", "app/server.py", "app/pipeline.py", "app/cli.py",
                 "app/webui.py", "index/compat.py")
# the tiers beyond the resident sweep
TIERS = ("index/streaming.py", "index/screen.py")
# the IVF tier and the planner
IVF_SLICE = ("index/ivf.py", "index/plan.py")
# the color-analysis slice: binning and MI, the dataset builder, the
# analyzers and their plots, the workflow (app/cli.py and app/pipeline.py
# above grew with it)
ANALYSIS_SLICE = ("ops/binning.py", "ops/mi.py", "data/__init__.py", "data/color.py",
                  "data/dataset.py", "data/synthetic.py", "analysis/__init__.py",
                  "analysis/pair_mi.py", "analysis/color_mi.py", "analysis/plots.py",
                  "app/workflow.py")
# the rest of models/ and the checkpoint path
MODELS_SLICE = ("models/histogram.py", "models/weights.py", "models/preprocess.py",
                "app/validate_pretrained.py")


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
                   "parallel/collectives.py", "index/filters.py", "config.py",
                   "utils/native.py", "train/__init__.py", "train/trainer.py",
                   "train/data.py") + DURABLE_SLICE + TIERS + IVF_SLICE + ANALYSIS_SLICE + MODELS_SLICE:
        assert f"image_retrieval_tpu_torch/{module}" in names
    assert len(names) >= 40


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_imports_no_jax(path):
    for mod in imported_modules(path):
        root = mod.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {mod}"
        if root == "image_retrieval_tpu":
            assert mod in JAX_PACKAGE_ALLOWED, \
                f"{path.name} imports {mod} from the JAX package"


JAX_DIR = "image_retrieval_tpu"


def _into_jax_dir(node) -> bool:
    """A string constant that names the JAX package's directory or a path
    under it (a label such as "image_retrieval_tpu/ops/x.py:12" inside a
    dict or an f-string is not a path the program opens)."""
    return (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and (node.value == JAX_DIR or node.value.startswith(JAX_DIR + "/")))


def jax_dir_paths(path):
    """Line numbers where `path` builds a path into the JAX package's
    directory: such a constant as an argument of a call (os.path.join,
    open, Path) or as an operand of a pathlib `/`."""
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            args = list(node.args) + [k.value for k in node.keywords]
            if any(_into_jax_dir(a) for a in args):
                yield node.lineno
        elif isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
            if _into_jax_dir(node.left) or _into_jax_dir(node.right):
                yield node.lineno


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_reads_nothing_under_the_jax_package(path):
    assert list(jax_dir_paths(path)) == [], \
        f"{path.name} builds a path into the JAX package's directory"


def test_scan_sees_a_path_into_the_jax_package(tmp_path):
    """The path scan itself: the form tokenizer.py used before it kept its
    own fixture, and a pathlib join, are both seen; a label is not."""
    f = tmp_path / "m.py"
    f.write_text(
        "import os, pathlib\n"
        "D = os.path.join(os.path.dirname(__file__), 'image_retrieval_tpu', 'models')\n"
        "P = pathlib.Path('.') / 'image_retrieval_tpu/models/bpe_fixture'\n"
        "L = {'replaces': 'image_retrieval_tpu/ops/flash_attention.py:12'}\n"
        "M = [m for m in () if m in ('jax', 'image_retrieval_tpu')]\n")
    assert list(jax_dir_paths(f)) == [2, 3]


def test_scan_sees_a_jax_package_import(tmp_path):
    """The scan itself: both import forms of a JAX-package module are seen."""
    f = tmp_path / "m.py"
    f.write_text("from image_retrieval_tpu import config\n"
                 "def g():\n    import image_retrieval_tpu.utils.native as n\n")
    mods = set(imported_modules(f))
    assert {"image_retrieval_tpu", "image_retrieval_tpu.config",
            "image_retrieval_tpu.utils.native"} <= mods
