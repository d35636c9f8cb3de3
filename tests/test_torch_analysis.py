"""The port's analysis/{pair_mi,color_mi,plots}.py against the JAX
package's on the same inputs: the pair analyzers' pairs, labels, MI values
and grid search equal (==); ColorMIAnalyzer's results.json equal (==) on
tests/test_analysis.py's fixture in the strict (host float64) form, the
precision="device" form on the CPU within 5e-3 of it (its tables within
1e-5 + 1e-5 |v|); make_all writing the JAX form's file names."""

import json
import os

import numpy as np
import pytest

from image_retrieval_tpu.analysis.color_mi import ColorMIAnalyzer as JaxAnalyzer
from image_retrieval_tpu.analysis.pair_mi import EnhancedPairMIAnalysis as JaxEnhanced
from image_retrieval_tpu.analysis.pair_mi import PairMIAnalysis as JaxPair
from image_retrieval_tpu_torch.analysis import plots
from image_retrieval_tpu_torch.analysis.color_mi import (
    METRIC_NAMES,
    ColorMIAnalyzer,
    _pair_metric_table,
    _pair_metric_table_device,
    analyze_color_embeddings,
)
from image_retrieval_tpu_torch.analysis.pair_mi import EnhancedPairMIAnalysis, PairMIAnalysis
from tests.test_analysis import color_dataset, make_embedding_list  # noqa: F401 (fixture)

WEIGHT_KEYS = ("w_angle", "w_l1", "w_l2", "w_inf", "w_mag")
DEVICE_MI_ATOL = 5e-3  # tests/test_analysis.py::test_device_precision_close_to_strict


@pytest.mark.parametrize("n, num_pairs, max_comparisons", [(40, 30, 500), (25, 1000, 50000),
                                                           (9, 30, 500)])
def test_pair_analysis_equals_jax(n, num_pairs, max_comparisons):
    embs = make_embedding_list(np.random.default_rng(n), n=n)
    got = PairMIAnalysis(embs, num_pairs=num_pairs, max_comparisons=max_comparisons)
    want = JaxPair(embs, num_pairs=num_pairs, max_comparisons=max_comparisons)
    got.generate_pairs()
    want.generate_pairs()
    assert got.num_pairs == want.num_pairs
    assert got.pairs == want.pairs and got.labels == want.labels
    assert got.angles == want.angles
    assert (len(got.pairs) == 0) == (n < 10)  # under 10 embeddings: no pairs


@pytest.mark.parametrize("coco", [False, True])
@pytest.mark.parametrize("keep_unnormalized", [True, False])
def test_enhanced_analysis_equals_jax(coco, keep_unnormalized):
    embs = make_embedding_list(np.random.default_rng(3), n=24)
    got = EnhancedPairMIAnalysis(embs, num_pairs=60, num_bins=10,
                                 keep_unnormalized=keep_unnormalized)
    want = JaxEnhanced(embs, num_pairs=60, num_bins=10, keep_unnormalized=keep_unnormalized)
    for an in (got, want):
        an.generate_coco_pairs() if coco else an.generate_pairs()
    assert got.pairs == want.pairs and got.labels == want.labels
    assert ("related_category" in got.labels) == coco  # its label is -1
    assert got.compute_mi_for_all_metrics() == want.compute_mi_for_all_metrics()
    assert got.mi_values == want.mi_values
    assert got.distance_measures == want.distance_measures
    grid = {k: [0.0, 0.5, 1.0] for k in WEIGHT_KEYS}
    res = got.find_optimal_parameters(grid)
    assert res == want.find_optimal_parameters(grid)
    assert got.optimal_params == want.optimal_params
    params = {"w_angle": 0.7, "w_l1": 0.3, "w_l2": 0.9, "w_inf": 0.2, "w_mag": 0.5}
    assert (got.compute_mi_for_optimized_similarity(params)
            == want.compute_mi_for_optimized_similarity(params))
    assert got.find_optimal_parameters() == want.find_optimal_parameters()


def test_enhanced_analysis_drops_missing_pairs_like_jax():
    """A pair whose embedding is gone is dropped and the labels are taken
    by the kept indices, not truncated."""
    embs = make_embedding_list(np.random.default_rng(4), n=20)
    got, want = EnhancedPairMIAnalysis(embs, num_pairs=30), JaxEnhanced(embs, num_pairs=30)
    for an in (got, want):
        an.generate_pairs()
        gone = an.pairs[3][0]
        an._emb_by_path.pop(gone)
        an._orig_by_path.pop(gone)
        an.invalidate_pairs_cache()
    np.testing.assert_array_equal(got._pair_matrices()[4], want._pair_matrices()[4])
    assert len(got._pair_matrices()[4]) < len(got.pairs)
    assert got.compute_mi_for_all_metrics() == want.compute_mi_for_all_metrics()
    with pytest.raises(ValueError, match="No pairs generated"):
        EnhancedPairMIAnalysis(embs).compute_mi_for_all_metrics()


def test_metric_tables_equal_jax_and_device_within_limit():
    rng = np.random.default_rng(6)
    a = rng.normal(size=(300, 64)).astype(np.float32) * rng.uniform(0.5, 9, (300, 1))
    b = rng.normal(size=(300, 64)).astype(np.float32) * rng.uniform(0.5, 9, (300, 1))
    a[7] = 0.0  # a zero row: cosine 0, as the reference
    from image_retrieval_tpu.analysis.color_mi import _pair_metric_table as jax_table

    strict, want = _pair_metric_table(a, b), jax_table(a, b)
    assert strict.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(strict[k], want[k])
    dev = _pair_metric_table_device(a, b, "cpu")
    for k in list(METRIC_NAMES) + ["cosine_similarity"]:
        assert dev[k].dtype == np.float64
        assert np.all(np.abs(dev[k] - strict[k]) <= 1e-5 + 1e-5 * np.abs(strict[k])), k
    assert strict["cosine_similarity"][7] == dev["cosine_similarity"][7] == 0.0


def test_run_full_analysis_equals_jax(color_dataset, tmp_path):  # noqa: F811
    base, emb_file, _ = color_dataset
    got = ColorMIAnalyzer(base_dir=base).run_full_analysis(emb_file, str(tmp_path / "t"))
    want = JaxAnalyzer(base_dir=base).run_full_analysis(emb_file, str(tmp_path / "j"))
    assert got["results"] == want["results"]
    with open(tmp_path / "t" / "results.json") as ft, open(tmp_path / "j" / "results.json") as fj:
        assert ft.read() == fj.read()
    assert got["visualizations"].keys() == want["visualizations"].keys()
    assert sorted(os.listdir(tmp_path / "t")) == sorted(os.listdir(tmp_path / "j"))
    assert "summary.png" in os.listdir(tmp_path / "t")


def test_analysis_parts_equal_jax(color_dataset):  # noqa: F811
    base, emb_file, _ = color_dataset
    got, want = ColorMIAnalyzer(base_dir=base, bin_count=10), JaxAnalyzer(base_dir=base,
                                                                          bin_count=10)
    for an in (got, want):
        assert an.load_dataset(emb_file)[0]
    assert got.metadata == want.metadata.astype(str).to_dict("records")
    got.calculate_distances()
    want.calculate_distances()
    assert got.distances == want.distances
    assert got.calculate_mutual_information() == want.calculate_mutual_information()
    assert got.calculate_color_specific_mi() == want.calculate_color_specific_mi()
    assert got.optimize_weights(grid_size=2) == want.optimize_weights(grid_size=2)
    assert got.mi_results == want.mi_results
    table, labels = got._color_table()
    for th_p_r_got, th_p_r_want in zip(got.precision_recall(table["cosine_distance"], labels),
                                       want.precision_recall(table["cosine_distance"], labels)):
        np.testing.assert_array_equal(th_p_r_got, th_p_r_want)
    th, p, r = got.precision_recall(table["cosine_distance"], labels)
    assert got.f1_optimal_threshold(th, p, r) == want.f1_optimal_threshold(th, p, r)
    q_got = ColorMIAnalyzer(base_dir=base, bin_count=10, bin_strategy="quantile")
    q_want = JaxAnalyzer(base_dir=base, bin_count=10, bin_strategy="quantile")
    for an in (q_got, q_want):
        an.load_dataset(emb_file)
    assert q_got.calculate_mutual_information() == q_want.calculate_mutual_information()


def test_device_precision_on_the_cpu_within_limit(color_dataset, tmp_path):  # noqa: F811
    base, emb_file, _ = color_dataset
    strict = ColorMIAnalyzer(base_dir=base)
    dev = ColorMIAnalyzer(base_dir=base, precision="device", device="cpu")
    for an in (strict, dev):
        an.load_dataset(emb_file)
    for rel in strict.relationship_types:
        ts, td = strict._table_for(rel), dev._table_for(rel)
        np.testing.assert_array_equal(ts["_keep"], td["_keep"])
        for k in list(METRIC_NAMES) + ["cosine_similarity"]:
            assert np.all(np.abs(td[k] - ts[k]) <= 1e-5 + 1e-5 * np.abs(ts[k])), (rel, k)
    s = strict.run_full_analysis(emb_file, str(tmp_path / "s"), make_plots=False)["results"]
    d = dev.run_full_analysis(emb_file, str(tmp_path / "d"), make_plots=False)["results"]
    for part in ("general_mi", "color_mi"):
        for m in METRIC_NAMES:
            assert d[part][m] == pytest.approx(s[part][m], abs=DEVICE_MI_ATOL), (part, m)
    assert os.listdir(tmp_path / "d") == ["results.json"]


def test_analysis_errors_equal_jax(color_dataset, tmp_path):  # noqa: F811
    base, emb_file, _ = color_dataset
    for cls in (ColorMIAnalyzer, JaxAnalyzer):
        assert cls(base_dir=str(tmp_path / "none")).load_dataset(emb_file)[0] is False
        other = tmp_path / "other.npz"
        np.savez(other, embeddings=np.array({"x.jpg": np.ones(4, np.float32)}, dtype=object))
        out = cls(base_dir=base).run_full_analysis(str(other), str(tmp_path / cls.__module__))
        assert "path mismatch" in out["error"]


def test_analyze_color_embeddings_draws_only_with_matplotlib(color_dataset, tmp_path,  # noqa: F811
                                                             monkeypatch):
    base, emb_file, _ = color_dataset
    monkeypatch.setattr(plots, "available", lambda: False)
    out = analyze_color_embeddings(emb_file, base, str(tmp_path / "r"), device="cpu")
    assert out["visualizations"] == {}
    assert os.listdir(tmp_path / "r") == ["results.json"]
    with open(tmp_path / "r" / "results.json") as f:
        assert json.load(f) == json.loads(json.dumps(out["results"]))


def test_mi_bar_chart_writes_a_png(tmp_path):
    mi = {"l1": 0.3, "angular": 0.1, "l2": 0.2}
    plots.mi_bar_chart(mi, str(tmp_path / "bar.png"), ci={"l1": (0.25, 0.35)})
    assert (tmp_path / "bar.png").stat().st_size > 0
    assert plots.available()
