"""The port's headless color-analysis workflow, the CLI's `mi` /
`geometric` / `analyze` and ImageSearchApp's MI methods against the JAX
package's: the fake-encoder workflow's npz and results.json equal, each
package's analysis of the other's npz equal; a tiny CLIP (2 layers, 224
input, float32) carried across by params_from_jax: embeddings within 1e-4,
row cosine >= 0.9999, the analysis of one npz equal, full-chain MI within
0.05 (the JAX e2e test's limit); the CLI's stdout equal."""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from image_retrieval_tpu.analysis.color_mi import ColorMIAnalyzer as JaxAnalyzer
from image_retrieval_tpu.app import cli as jax_cli
from image_retrieval_tpu.app import workflow as jax_workflow
from image_retrieval_tpu.app.pipeline import ImageSearchApp as JaxApp
from image_retrieval_tpu.config import Config, ModelConfig
from image_retrieval_tpu.data.dataset import prepare_color_dataset as jax_prepare
from image_retrieval_tpu.models import encoder as jax_encoder_mod
from image_retrieval_tpu.models.clip import init_params as jax_init_params
from image_retrieval_tpu_torch.analysis import plots
from image_retrieval_tpu_torch.analysis.color_mi import ColorMIAnalyzer
from image_retrieval_tpu_torch.app import cli, workflow
from image_retrieval_tpu_torch.app.pipeline import ImageSearchApp
from image_retrieval_tpu_torch.models import encoder as encoder_mod
from image_retrieval_tpu_torch.models.tokenizer import get_tokenizer
from image_retrieval_tpu_torch.models.weights import params_from_jax

EMB_ATOL, EMB_MIN_COS = 1e-4, 0.9999  # tests/test_torch_slice.py's limits
CHAIN_MI_ATOL = 0.05  # tests/test_e2e_workflow_parity.py's full-chain limit


def _npz(path):
    with np.load(path, allow_pickle=True) as z:
        return z["embeddings"].item()


def _results(out):
    with open(os.path.join(out, "analysis_results", "results.json")) as f:
        return f.read()


def _run_both(out, keep, run_jax, run_port):
    """The JAX workflow into `out`, its npz and results.json kept under
    `keep`, `out` cleared, then the port's workflow into the same `out` (the
    npz keys are paths under it)."""
    want = run_jax(out)
    os.makedirs(keep)
    for name in ("color_embeddings.npz", os.path.join("analysis_results", "results.json")):
        shutil.copy(os.path.join(out, name), os.path.join(keep, os.path.basename(name)))
    shutil.rmtree(out)
    return want, run_port(out)


def _cross_analyses(out, keep):
    """Each package's analysis of the other's npz over the (byte-identical)
    dataset the port built."""
    base = os.path.join(out, "color_dataset")
    port_on_jax = ColorMIAnalyzer(base_dir=base).run_full_analysis(
        os.path.join(keep, "color_embeddings.npz"), os.path.join(keep, "p"), make_plots=False)
    jax_on_port = JaxAnalyzer(base_dir=base).run_full_analysis(
        os.path.join(out, "color_embeddings.npz"), os.path.join(keep, "j"), make_plots=False)
    return port_on_jax["results"], jax_on_port["results"]


def _no_plots(monkeypatch, port=True):
    """Skip drawing (slow on the CPU): analysis/plots.py is held in
    tests/test_torch_analysis.py and here by the port's fake-encoder run."""
    monkeypatch.setattr("image_retrieval_tpu.analysis.plots.make_all", lambda an, out: {})
    if port:
        monkeypatch.setattr(plots, "available", lambda: False)


def test_fake_encoder_workflow_equals_jax(tmp_path, monkeypatch):
    _no_plots(monkeypatch, port=False)
    out, keep = str(tmp_path / "out"), str(tmp_path / "jax")
    want, got = _run_both(
        out, keep,
        lambda o: jax_workflow.run_workflow(output_dir=o, synthetic=True, fake_encoder=True,
                                            num_examples=2),
        lambda o: workflow.run_workflow(output_dir=o, synthetic=True, fake_encoder=True,
                                        num_examples=2))
    assert got == want and set(got) == {"general_mi", "color_mi", "optimal_weights"}
    with open(os.path.join(keep, "results.json")) as f:
        assert _results(out) == f.read()
    emb_t, emb_j = _npz(os.path.join(out, "color_embeddings.npz")), _npz(
        os.path.join(keep, "color_embeddings.npz"))
    assert list(emb_t) == list(emb_j) and len(emb_t) == 60
    for p in emb_t:
        assert emb_t[p].dtype == np.float32
        np.testing.assert_array_equal(emb_t[p], emb_j[p])
    assert sorted(os.listdir(os.path.join(out, "analysis_results"))) == sorted(
        ["angle_distribution.png", "color_metrics_comparison.png", "precision_recall_curves.png",
         "summary.png", "results.json"] + [f"{m}_density.png" for m in got["color_mi"]])
    port_on_jax, jax_on_port = _cross_analyses(out, keep)
    assert port_on_jax == want and jax_on_port == want


@pytest.fixture(scope="module")
def tiny_clip():
    vocab = get_tokenizer().vocab_size
    model = ModelConfig(image_size=224, patch_size=32, vision_width=64, vision_layers=2,
                        vision_heads=2, text_width=32, text_layers=2, text_heads=2,
                        vocab_size=vocab, context_length=77, embed_dim=32, dtype="float32")
    _, params = jax_init_params(model, seed=0)
    params = jax.tree.map(np.asarray, params)
    cfg = Config(model=model)
    return (cfg, jax_encoder_mod.CLIPEncoder(cfg, params=params),
            encoder_mod.CLIPEncoder(cfg, params=params_from_jax(params, model), device="cpu"))


def _row_cos(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_tiny_clip_workflow_equals_jax(tiny_clip, tmp_path, monkeypatch):
    cfg, jax_enc, enc = tiny_clip
    data = str(tmp_path / "color_dataset")
    jax_prepare(base_dir=data, num_examples=2)  # one dataset for both (dataset_dir)
    built = []

    def port_encoder(config=None, fake=False, **kw):
        built.append(kw)
        return enc

    monkeypatch.setattr(jax_encoder_mod, "get_encoder", lambda **kw: jax_enc)
    monkeypatch.setattr(encoder_mod, "get_encoder", port_encoder)
    _no_plots(monkeypatch)
    out, keep = str(tmp_path / "out"), str(tmp_path / "jax")
    want, got = _run_both(
        out, keep,
        lambda o: jax_workflow.run_workflow(output_dir=o, config=cfg, dataset_dir=data),
        lambda o: workflow.run_workflow(output_dir=o, config=cfg, dataset_dir=data,
                                        device="cpu"))
    assert built == [{"device": "cpu"}]
    emb_t, emb_j = _npz(os.path.join(out, "color_embeddings.npz")), _npz(
        os.path.join(keep, "color_embeddings.npz"))
    assert list(emb_t) == list(emb_j) and len(emb_t) == 60
    a, b = np.stack(list(emb_t.values())), np.stack(list(emb_j.values()))
    np.testing.assert_allclose(a, b, rtol=0, atol=EMB_ATOL)
    assert _row_cos(a, b).min() >= EMB_MIN_COS
    for part in ("general_mi", "color_mi"):
        for metric, mi in want[part].items():
            assert got[part][metric] == pytest.approx(mi, abs=CHAIN_MI_ATOL), (part, metric)
    # the analysis of one npz is the same in both packages
    base = data
    port_on_jax = ColorMIAnalyzer(base_dir=base).run_full_analysis(
        os.path.join(keep, "color_embeddings.npz"), str(tmp_path / "p"), make_plots=False)
    assert port_on_jax["results"] == want
    jax_on_port = JaxAnalyzer(base_dir=base).run_full_analysis(
        os.path.join(out, "color_embeddings.npz"), str(tmp_path / "j"), make_plots=False)
    assert jax_on_port["results"] == got


def test_workflow_guards_equal_jax(tmp_path):
    with pytest.raises(FileNotFoundError, match="does not exist"):
        workflow.run_workflow(output_dir=str(tmp_path / "o"), dataset_dir=str(tmp_path / "x"))
    empty = tmp_path / "empty"
    empty.mkdir()
    for run in (workflow.run_workflow, jax_workflow.run_workflow):
        assert run(output_dir=str(tmp_path / "o"), dataset_dir=str(empty),
                   fake_encoder=True) is None  # no metadata.csv
    with pytest.raises(SystemExit):
        workflow.main(["--output_dir", str(tmp_path / "o")])  # neither COCO nor --synthetic


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("cli") / "color_dataset")
    jax_prepare(base_dir=base, num_examples=1)
    return base


@pytest.mark.parametrize("argv", [
    ["mi", "--num-pairs", "60"],
    ["geometric", "--optimize", "--grid-size", "2", "--num-bins", "10", "--apply", "--ci",
     "--plot", "bar.png"],
])
def test_cli_stdout_equals_jax(folder, argv, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # new_embeddings.npz lands here; no cache is found
    assert jax_cli.main([argv[0], "--folder", folder, "--fake-encoder", *argv[1:]]) == 0
    want = capsys.readouterr().out
    os.remove("new_embeddings.npz")
    assert cli.main([argv[0], "--folder", folder, "--fake-encoder", "--device", "cpu",
                     *argv[1:]]) == 0
    got = capsys.readouterr().out
    assert got == want
    assert want.count("bits") >= 5
    if argv[0] == "geometric":
        assert "Applied optimal parameters to searcher." in got
        assert os.path.getsize("bar.png") > 0


def test_cli_analyze_equals_jax_and_needs_the_card(tmp_path, monkeypatch, capsys):
    _no_plots(monkeypatch)
    monkeypatch.chdir(tmp_path)
    args = ["analyze", "--synthetic", "--fake-encoder", "--num_examples", "1",
            "--output_dir", "out"]
    assert jax_cli.main(args) == 0
    want = capsys.readouterr().out
    shutil.rmtree("out")
    assert cli.main(args) == 0
    got = capsys.readouterr().out
    assert got == want and set(json.loads(got)) == {"general_mi", "color_mi", "optimal_weights"}
    if torch.cuda.is_available():
        return
    # without the fake encoder the CLIP encoder is built on the card: no fallback
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["analyze", "--synthetic", "--skip-dataset", "--output_dir", "out"])


def test_app_mi_methods_equal_jax(tmp_path):
    rng = np.random.default_rng(11)
    embs = {f"img/{i}.jpg": (rng.normal(size=32) * (2 if i % 3 else 1)).astype(np.float32)
            for i in range(30)}
    port = ImageSearchApp(encoder=encoder_mod.FakeEncoder(dim=32), device="cpu")
    ref = JaxApp(encoder=jax_encoder_mod.FakeEncoder(dim=32))
    for app in (port, ref):
        assert app.run_mi_analysis() == (None, None)
        assert app.run_enhanced_mi_analysis() == (None, None)
        assert app.run_enhanced_mi_analysis_coco() == (None, None)
        app.embeddings = dict(embs)
    an_t, got = port.run_mi_analysis(num_pairs=90, num_bins=10)
    an_j, want = ref.run_mi_analysis(num_pairs=90, num_bins=10)
    assert got == want and an_t.mi_values == an_j.mi_values and an_t.pairs == an_j.pairs
    an_t, got = port.run_enhanced_mi_analysis(num_pairs=5000, num_bins=10)
    an_j, want = ref.run_enhanced_mi_analysis(num_pairs=5000, num_bins=10)
    assert got == want and an_t.num_pairs == an_j.num_pairs == 435  # min(cap, C(30, 2))
    an_t, got = port.run_enhanced_mi_analysis_coco(num_pairs=120, keep_unnormalized=False)
    an_j, want = ref.run_enhanced_mi_analysis_coco(num_pairs=120, keep_unnormalized=False)
    assert got == want and an_t.labels == an_j.labels
    for name in ("create_mi_visualization", "create_enhanced_mi_visualization"):
        path = str(tmp_path / f"{name}.png")
        assert getattr(port, name)(path) == getattr(ref, name)(path) == path
        assert os.path.getsize(path) > 0


def test_new_entry_points_default_to_the_card():
    """Every entry point of the slice that can touch a device takes
    device= with the card as its default (the CPU tests pass "cpu")."""
    import inspect

    from image_retrieval_tpu_torch.analysis.color_mi import analyze_color_embeddings
    from image_retrieval_tpu_torch.app.pipeline import run_color_analysis
    from image_retrieval_tpu_torch.data.color import dominant_colors_batch, extract_dominant_color
    from image_retrieval_tpu_torch.data.dataset import ColorDatasetManager, prepare_color_dataset

    for fn in (dominant_colors_batch, extract_dominant_color, ColorDatasetManager,
               prepare_color_dataset, ColorMIAnalyzer, analyze_color_embeddings,
               run_color_analysis, workflow.run_workflow):
        param = inspect.signature(fn).parameters["device"]
        assert param.default == "cuda" and param.kind == param.KEYWORD_ONLY, fn


def test_cli_mi_helpers_equal_jax():
    for mi in (-0.1, 0.0, 0.005, 0.01, 0.03, 0.1, 0.3, 0.5, 2.0):
        assert cli.interpret_mi_value(mi) == jax_cli.interpret_mi_value(mi)
    rng = np.random.default_rng(2)
    values, labels = rng.normal(size=300), rng.integers(-1, 3, size=300)
    got = cli.mi_confidence_interval(values, labels, n_bins=10, n_boot=50)
    assert got == jax_cli.mi_confidence_interval(values, labels, n_bins=10, n_boot=50)
    assert got[0] <= got[1]
