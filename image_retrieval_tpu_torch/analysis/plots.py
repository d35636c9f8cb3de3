"""Analysis visualizations — the reference's 8 PNG artifacts; port of
``image_retrieval_tpu/analysis/plots.py``. matplotlib (Agg) and seaborn are
imported where a plot is drawn, so the module imports without them.

Same artifact names and content as reference mi_analysis.py:560-1147
(angle_distribution.png, color_metrics_comparison.png, <metric>_density.png,
precision_recall_curves.png, summary.png), with all P/R and MI math
vectorized (analysis/color_mi.py) instead of per-threshold Python loops.
visualize_bin_sensitivity exists but make_all does not call it — matching
the reference, whose run_full_analysis has the call commented out
(mi_analysis.py:1230-1232), so no bin_sensitivity.png is produced.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import numpy as np

from image_retrieval_tpu_torch.ops.mi import mutual_info_from_labels

logger = logging.getLogger(__name__)


def available() -> bool:
    """Whether the plots can be drawn here (matplotlib and seaborn)."""
    import importlib.util

    return all(importlib.util.find_spec(m) is not None for m in ("matplotlib", "seaborn"))


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _angles_from_cosine_distances(distances) -> np.ndarray:
    """Clamped cos-dist -> angle conversion (reference mi_analysis.py:569-574)."""
    d = np.minimum(np.asarray(distances, float), 1.999)
    return np.arccos(np.clip(1 - d, -1.0, 1.0))


def _title(s: str) -> str:
    return s.replace("_", " ").title()


def visualize_angle_distributions(analyzer, output_path: Optional[str] = None):
    plt = _plt()
    fig = plt.figure(figsize=(12, 8))
    angle_data = {}
    for rel_type in analyzer.relationship_types:
        vals = analyzer.distances.get("cosine_distance", {}).get(rel_type, [])
        if len(vals):
            angle_data[rel_type] = _angles_from_cosine_distances(vals)
    if not angle_data:
        plt.text(0.5, 0.5, "No angle data available", ha="center", va="center",
                 transform=plt.gca().transAxes)
    else:
        for rel_type, angles in angle_data.items():
            plt.hist(angles, bins=20, alpha=0.7, label=_title(rel_type), density=True)
        all_angles = np.concatenate(list(angle_data.values()))
        all_labels = np.concatenate(
            [
                np.full(len(angle_data.get(r, [])), i)
                for i, r in enumerate(analyzer.relationship_types)
                if r in angle_data
            ]
        )
        mi = mutual_info_from_labels(
            all_angles, all_labels, analyzer.bin_count, analyzer.bin_strategy
        )
        plt.annotate(f"MI: {mi:.4f} bits", xy=(0.7, 0.9), xycoords="axes fraction",
                     fontsize=12)
    plt.xlabel("Angle (radians)")
    plt.ylabel("Frequency")
    plt.title("Angle Distribution by Semantic Relationship")
    plt.legend()
    if output_path:
        plt.savefig(output_path, dpi=150)
    plt.close(fig)
    return fig


def visualize_color_metrics_comparison(analyzer, output_path: Optional[str] = None):
    plt = _plt()
    color_mi = analyzer.mi_results.get("color_specific") or analyzer.calculate_color_specific_mi()
    fig = plt.figure(figsize=(10, 6))
    metrics = list(color_mi.keys())
    vals = np.array([color_mi[m] for m in metrics])
    order = np.argsort(vals)[::-1]
    plt.bar(
        range(len(metrics)),
        vals[order],
        color=plt.cm.viridis(np.linspace(0, 1, len(metrics))),
    )
    plt.xticks(range(len(metrics)), [_title(metrics[i]) for i in order], rotation=45)
    plt.xlabel("Metric")
    plt.ylabel("Mutual Information (bits)")
    plt.title("Color Discrimination Power by Geometric Metric")
    plt.tight_layout()
    if output_path:
        plt.savefig(output_path, dpi=150)
    plt.close(fig)
    return fig


def visualize_metric_density_plots(analyzer, output_dir: Optional[str] = None) -> List:
    plt = _plt()
    import seaborn as sns

    figures = []
    for metric in analyzer.metric_names:
        fig = plt.figure(figsize=(10, 6))
        for rel_type in analyzer.relationship_types:
            vals = analyzer.distances.get(metric, {}).get(rel_type, [])
            if len(vals) > 1:
                sns.kdeplot(np.asarray(vals), label=_title(rel_type))
        plt.xlabel(_title(metric))
        plt.ylabel("Density")
        plt.title(f"{metric.title()} Distribution by Relationship Type")
        plt.legend()
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            plt.savefig(os.path.join(output_dir, f"{metric}_density.png"), dpi=150)
        plt.close(fig)
        figures.append(fig)
    return figures


def visualize_precision_recall_curves(analyzer, output_path: Optional[str] = None):
    plt = _plt()
    # cached combined color-pair table (honors precision='device' too)
    table, labels = analyzer._color_table()
    fig = plt.figure(figsize=(10, 6))
    if table:
        th, p, r = analyzer.precision_recall(table["cosine_distance"], labels)
        plt.plot(th, p, "b-", label="Cosine Precision")
        plt.plot(th, r, "b--", label="Cosine Recall")
        best = analyzer.f1_optimal_threshold(th, p, r)
        plt.axvline(best, color="b", linestyle=":", label=f"Cosine Optimal ({best:.2f})")
        if analyzer.optimal_weights:
            from image_retrieval_tpu_torch.ops.metrics import (
                optimized_similarity_from_metrics,
            )

            # one formula, one home: the negated optimized similarity
            scores = -np.asarray(
                optimized_similarity_from_metrics(table, analyzer.optimal_weights)
            )
            th2, p2, r2 = analyzer.precision_recall(scores, labels)
            plt.plot(th2, p2, "r-", label="Optimized Precision")
            plt.plot(th2, r2, "r--", label="Optimized Recall")
            best2 = analyzer.f1_optimal_threshold(th2, p2, r2)
            plt.axvline(best2, color="r", linestyle=":",
                        label=f"Optimized Optimal ({best2:.2f})")
    else:
        plt.text(0.5, 0.5, "Insufficient data", ha="center", va="center")
    plt.xlabel("Threshold")
    plt.ylabel("Score")
    plt.title("Precision-Recall vs. Threshold for Color Discrimination")
    plt.legend()
    plt.grid(True, alpha=0.3)
    if output_path:
        plt.savefig(output_path, dpi=150)
    plt.close(fig)
    return fig


def visualize_bin_sensitivity(analyzer, output_path: Optional[str] = None,
                              bin_counts=None):
    """MI vs bin count (reference mi_analysis.py:844-903)."""
    plt = _plt()
    bin_counts = list(bin_counts or range(10, 51, 5))
    saved = analyzer.bin_count
    mi_values: Dict[str, List[float]] = {}
    for bc in bin_counts:
        analyzer.bin_count = bc
        mi = analyzer.calculate_mutual_information()
        for metric, value in mi.items():
            mi_values.setdefault(metric, []).append(value)
    analyzer.bin_count = saved
    analyzer.calculate_mutual_information()  # restore cached results
    fig = plt.figure(figsize=(10, 6))
    for metric, values in mi_values.items():
        plt.plot(bin_counts, values, marker="o", label=_title(metric))
        bi = int(np.argmax(values))
        plt.scatter([bin_counts[bi]], [values[bi]], color="red", s=60, zorder=5)
    plt.xlabel("Number of Bins")
    plt.ylabel("Mutual Information (bits)")
    plt.title("Bin Count Sensitivity Analysis")
    plt.legend()
    plt.grid(True, alpha=0.3)
    if output_path:
        plt.savefig(output_path, dpi=150)
    plt.close(fig)
    return fig


def create_summary_visualization(analyzer, output_path: Optional[str] = None):
    """2x2 summary panel (reference mi_analysis.py:905-1147)."""
    plt = _plt()
    import seaborn as sns

    if not analyzer.mi_results.get("general"):
        analyzer.calculate_mutual_information()
    if not analyzer.mi_results.get("color_specific"):
        analyzer.calculate_color_specific_mi()
    fig, axes = plt.subplots(2, 2, figsize=(16, 12))

    ax1 = axes[0, 0]
    for rel_type in analyzer.relationship_types:
        vals = analyzer.distances.get("cosine_distance", {}).get(rel_type, [])
        if len(vals):
            angles = _angles_from_cosine_distances(vals)
            angles = angles[~np.isnan(angles)]
            if len(angles):
                sns.histplot(angles, bins=20, alpha=0.7, label=_title(rel_type),
                             ax=ax1, kde=len(angles) > 1)
    ax1.set_xlabel("Angle (radians)")
    ax1.set_title("Angle Distribution by Semantic Relationship")
    ax1.legend()

    ax2 = axes[0, 1]
    # .get: a pairs.json without same_object_diff_color pairs legitimately
    # yields no color-specific MI — render an empty panel, don't crash
    color_mi = analyzer.mi_results.get("color_specific", {})
    metrics = list(color_mi.keys())
    order = []
    if metrics:
        vals = np.array([color_mi[m] for m in metrics])
        order = np.argsort(vals)[::-1]
        ax2.bar(range(len(metrics)), vals[order],
                color=plt.cm.viridis(np.linspace(0, 1, len(metrics))))
        ax2.set_xticks(range(len(metrics)))
        ax2.set_xticklabels([_title(metrics[i]) for i in order], rotation=45)
    else:
        ax2.text(0.5, 0.5, "no same-object color pairs", ha="center", va="center")
    ax2.set_title("Color Discrimination Power by Geometric Metric")

    ax3 = axes[1, 0]
    top_metrics = [metrics[i] for i in order[:2]]
    for metric in top_metrics:
        for rel_type in ("same_object_same_color", "same_object_diff_color"):
            v = analyzer.distances.get(metric, {}).get(rel_type, [])
            if len(v) > 1:
                sns.kdeplot(np.asarray(v), label=f"{_title(metric)} - {_title(rel_type)}",
                            ax=ax3)
    ax3.set_xlabel("Distance Value")
    ax3.set_title("Distance Distribution for Color Comparison")
    ax3.legend()

    ax4 = axes[1, 1]
    table, labels = analyzer._color_table()
    if table:
        th, p, r = analyzer.precision_recall(table["cosine_distance"], labels)
        ax4.plot(th, p, "b-", label="Cosine Precision")
        ax4.plot(th, r, "b--", label="Cosine Recall")
        best = analyzer.f1_optimal_threshold(th, p, r)
        ax4.axvline(best, color="b", linestyle=":", label=f"Cosine Optimal ({best:.2f})")
        if top_metrics:
            th2, p2, r2 = analyzer.precision_recall(table[top_metrics[0]], labels)
            ax4.plot(th2, p2, "r-", label=f"{top_metrics[0].title()} Precision")
            ax4.plot(th2, r2, "r--", label=f"{top_metrics[0].title()} Recall")
        ax4.set_title("Precision-Recall vs. Threshold for Color Discrimination")
        ax4.legend()
        ax4.grid(True, alpha=0.3)
    else:
        ax4.text(0.5, 0.5, "Insufficient data for precision-recall analysis",
                 ha="center", va="center")
    plt.tight_layout()
    if output_path:
        plt.savefig(output_path, dpi=150)
    plt.close(fig)
    return fig


def mi_bar_chart(
    mi_values: Dict[str, float],
    output_path: Optional[str] = None,
    ci: Optional[Dict[str, tuple]] = None,
    title: str = "Mutual Information by Metric",
):
    """MI bar chart with optional (honest, bootstrap) confidence intervals —
    the reference GUI's create_mi_bar_chart (main.py:483-549) whose error
    bars were fabricated (main.py:551-570)."""
    plt = _plt()
    fig = plt.figure(figsize=(10, 6))
    metrics = sorted(mi_values, key=mi_values.get, reverse=True)
    vals = [mi_values[m] for m in metrics]
    yerr = None
    if ci:
        lows = [max(mi_values[m] - ci[m][0], 0) if m in ci else 0 for m in metrics]
        highs = [max(ci[m][1] - mi_values[m], 0) if m in ci else 0 for m in metrics]
        yerr = np.array([lows, highs])
    plt.bar(range(len(metrics)), vals, yerr=yerr, capsize=4,
            color=plt.cm.viridis(np.linspace(0, 1, len(metrics))))
    plt.xticks(range(len(metrics)), [_title(m) for m in metrics], rotation=30)
    plt.ylabel("Mutual Information (bits)")
    plt.title(title)
    plt.tight_layout()
    if output_path:
        plt.savefig(output_path, dpi=150)
    plt.close(fig)
    return fig


def make_all(analyzer, output_dir: str) -> Dict[str, object]:
    """All run_full_analysis artifacts (reference mi_analysis.py:1207-1237)."""
    os.makedirs(output_dir, exist_ok=True)
    out = {}
    out["angle_distribution"] = visualize_angle_distributions(
        analyzer, os.path.join(output_dir, "angle_distribution.png"))
    out["color_metrics_comparison"] = visualize_color_metrics_comparison(
        analyzer, os.path.join(output_dir, "color_metrics_comparison.png"))
    out["density_plots"] = visualize_metric_density_plots(analyzer, output_dir)
    out["precision_recall_curves"] = visualize_precision_recall_curves(
        analyzer, os.path.join(output_dir, "precision_recall_curves.png"))
    out["summary"] = create_summary_visualization(
        analyzer, os.path.join(output_dir, "summary.png"))
    return out
