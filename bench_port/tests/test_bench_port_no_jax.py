"""Nothing the benchmark runs loads JAX, Flax or the JAX package, and nothing
it runs reads the JAX package's benchmark files."""

import os
import re
import subprocess
import sys

from bench_port import harness

REPO = harness.REPO


def test_forbidden_names_are_compared_whole(monkeypatch):
    fake = {"image_retrieval_tpu_torch": 1, "image_retrieval_tpu_torch.ops": 1,
            "jaxtyping": 1, "flaxen": 1}
    for name in fake:
        monkeypatch.setitem(sys.modules, name, object())
    assert harness.forbidden_modules() == [] or all(
        n.split(".")[0] in harness.FORBIDDEN for n in harness.forbidden_modules())
    assert not set(fake) & set(harness.forbidden_modules())
    for name in ("jax", "jaxlib.xla_client", "flax.linen", "image_retrieval_tpu",
                 "image_retrieval_tpu.models"):
        monkeypatch.setitem(sys.modules, name, object())
        assert name in harness.forbidden_modules()


def _run(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_the_reference_imports_nothing_of_the_program():
    got = _run("import sys\n"
               "import bench_port.reference.clip, bench_port.reference.search\n"
               "import bench_port.reference.tokenizer, bench_port.compare, bench_port.bounds\n"
               "print(sorted({n.split('.')[0] for n in sys.modules}))")
    names = eval(got)
    assert "image_retrieval_tpu_torch" not in names
    assert not set(names) & set(harness.FORBIDDEN)


def test_a_whole_run_loads_no_jax():
    got = _run("import sys, time\n"
               "sys.path.insert(0, 'bench_port/tests')\n"
               "from conftest import run_tiny\n"
               "from bench_port import harness\n"
               "for w in ('b32-search-f32-4m', 'l14-ingest-u8-b256'):\n"
               "    r, _ = run_tiny(w, seconds=0.6)\n"
               "    assert r['correct'], r\n"
               "print(harness.forbidden_modules(), 'image_retrieval_tpu_torch' in sys.modules)")
    assert got.strip() == "[] True"


def test_no_file_reads_the_jax_benchmarks():
    pat = re.compile(r"bench\.py|BENCH_r|BASELINE|bench_results|MULTICHIP|tools/tpu_|"
                     r"import jax|from jax|import flax|(from|import) image_retrieval_tpu[. \n]|"
                     r"image_retrieval_tpu/")
    for root, _, files in os.walk(harness.HERE):
        if "__pycache__" in root or root.endswith("tests"):
            continue
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert not pat.search(text), (f, pat.search(text).group(0))


def test_no_cuda_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "bench_port/run.py", "--workload",
                          "b32-search-f32-4m", "--seed", "1", "--seconds", "1"],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
