"""Color-relationship MI analysis engine (the reference's headline evaluator) —
port of ``image_retrieval_tpu/analysis/color_mi.py``.

Vectorized re-design of ColorMIAnalyzer (reference mi_analysis.py:156-1267):
every per-pair Python loop becomes a gather + batched metric evaluation, and
the 5-dim weight grid search becomes one matrix product over a precomputed
per-pair metric tensor. Output contract preserved:

    results.json = {"general_mi": {metric: mi},
                    "color_mi":   {metric: mi},
                    "optimal_weights": {w_angle, w_l1, w_l2, w_inf, w_mag}}
                                        (reference mi_analysis.py:1240-1260)

Numerics: distances and MI run in host float64 by default ("strict" mode,
digit-parity with the sklearn pipeline; the same code as the JAX package's,
so results.json is equal); `precision="device"` computes the per-pair
metric tables in f32 on `device` with the port's ops/metrics.py::pair_metrics
(for very large pair sets). metadata.csv is read with the csv module.

MI units note: values are natural-log nats (sklearn mutual_info_score), which
the reference logs/reports as "bits" (mi_analysis.py:351); we keep the
reference's labeling for parity.
"""

from __future__ import annotations

import json
import logging
import os
from itertools import product
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from image_retrieval_tpu_torch.data.dataset import read_metadata
from image_retrieval_tpu_torch.device import DeviceLike
from image_retrieval_tpu_torch.ops.mi import mutual_info_from_labels

logger = logging.getLogger(__name__)

RELATIONSHIP_TYPES = [
    "same_object_same_color",
    "same_object_diff_color",
    "diff_object_same_color",
    "diff_object_diff_color",
]

METRIC_NAMES = [
    "cosine_distance",
    "l1_distance",
    "l2_distance",
    "linf_distance",
    "magnitude_difference",
]

_WEIGHT_KEYS = ("w_angle", "w_l1", "w_l2", "w_inf", "w_mag")


def _pair_metric_table_device(a: np.ndarray, b: np.ndarray,
                              device: DeviceLike = "cuda") -> Dict[str, np.ndarray]:
    """Device (f32, batched) variant of _pair_metric_table on `device` —
    used by precision="device" for very large pair sets."""
    import torch

    from image_retrieval_tpu_torch.device import resolve_device
    from image_retrieval_tpu_torch.ops.metrics import pair_metrics

    dev = resolve_device(device)
    out = pair_metrics(torch.as_tensor(np.asarray(a, np.float32), device=dev),
                       torch.as_tensor(np.asarray(b, np.float32), device=dev))
    return {k: v.cpu().numpy().astype(np.float64) for k, v in out.items()}


def _pair_metric_table(a: np.ndarray, b: np.ndarray) -> Dict[str, np.ndarray]:
    """All 6 per-pair quantities in float64: row-aligned a[i] vs b[i].

    Mirrors get_all_metrics semantics (reference geometric_metrics.py:114-129)
    including zero-norm cosine -> 0 and the /D, /sqrt(D) normalizations."""
    a = a.astype(np.float64)
    b = b.astype(np.float64)
    d = a.shape[1]
    na = np.linalg.norm(a, axis=1)
    nb = np.linalg.norm(b, axis=1)
    denom = na * nb
    dots = np.einsum("pd,pd->p", a, b)
    cos = np.where(denom > 0, dots / np.where(denom > 0, denom, 1.0), 0.0)
    diff = np.abs(a - b)
    return {
        "cosine_similarity": cos,
        "cosine_distance": 1.0 - cos,
        "angular_distance": np.arccos(np.clip(cos, -1.0, 1.0)),
        "l1_distance": diff.sum(1) / d,
        "l2_distance": np.sqrt((diff * diff).sum(1)) / np.sqrt(d),
        "linf_distance": diff.max(1),
        "magnitude_difference": np.abs(na - nb),
    }


class ColorMIAnalyzer:
    """MI between geometric metrics and color/object relationships."""

    def __init__(
        self,
        base_dir: str = "color_dataset",
        bin_count: int = 20,
        bin_strategy: str = "uniform",
        precision: str = "strict",
        *,
        device: DeviceLike = "cuda",
    ):
        """`device` holds the metric tables of precision="device" (the
        strict form runs on the host and touches no device)."""
        self.base_dir = Path(base_dir)
        self.bin_count = bin_count
        self.bin_strategy = bin_strategy
        self.precision = precision
        self.device = device
        self.relationship_types = list(RELATIONSHIP_TYPES)
        self.metric_names = list(METRIC_NAMES)
        self.embeddings: Dict[str, np.ndarray] = {}
        self.metadata: Optional[List[Dict[str, str]]] = None
        self.pairs: Dict[str, List[Tuple[str, str]]] = {}
        self.distances: Dict[str, Dict[str, List[float]]] = {}
        self.mi_results: Dict[str, Any] = {}
        self.optimal_weights: Dict[str, float] = {}
        # cache: per-relationship (valid pair metric table)
        self._tables: Dict[str, Dict[str, np.ndarray]] = {}
        self._color_tbl = None  # combined color-pair table cache

    # -- loading ------------------------------------------------------------

    def load_dataset(self, embeddings_file: str) -> Tuple[bool, str]:
        """metadata.csv + pairs.json (abs-path resolved) + npz embeddings
        (reference mi_analysis.py:199-254)."""
        metadata_path = self.base_dir / "metadata.csv"
        if not metadata_path.exists():
            return False, f"Metadata file not found: {metadata_path}"
        self.metadata = read_metadata(metadata_path)

        pairs_path = self.base_dir / "pairs.json"
        if not pairs_path.exists():
            return False, f"Pairs file not found: {pairs_path}"
        with open(pairs_path) as f:
            raw_pairs = json.load(f)
        for rel_type, rel_pairs in raw_pairs.items():
            self.pairs[rel_type] = [
                (
                    p1 if os.path.isabs(p1) else os.path.join(self.base_dir, p1),
                    p2 if os.path.isabs(p2) else os.path.join(self.base_dir, p2),
                )
                for p1, p2 in rel_pairs
            ]

        try:
            data = np.load(embeddings_file, allow_pickle=True)
            if isinstance(data, np.lib.npyio.NpzFile):
                if "embeddings" in data:
                    self.embeddings = data["embeddings"].item()
                else:
                    return False, f"No 'embeddings' array found in {embeddings_file}"
            else:
                self.embeddings = data.item()
            self._tables = {}
            self._color_tbl = None  # embeddings changed: drop cached tables
            logger.info(f"Loaded embeddings for {len(self.embeddings)} images")
            return True, "Dataset loaded successfully"
        except Exception as e:
            return False, f"Error loading embeddings: {e}"

    # -- distances ----------------------------------------------------------

    def _valid_pair_arrays(self, pair_list) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Gather (A, B, valid_mask) embedding matrices for a pair list,
        dropping pairs with missing embeddings (reference behavior,
        mi_analysis.py:279-281) while preserving order."""
        ia, ib, keep = [], [], []
        for i, (p1, p2) in enumerate(pair_list):
            if p1 in self.embeddings and p2 in self.embeddings:
                ia.append(self.embeddings[p1])
                ib.append(self.embeddings[p2])
                keep.append(i)
        if not ia:
            return np.zeros((0, 1)), np.zeros((0, 1)), np.array([], int)
        return np.stack(ia), np.stack(ib), np.array(keep, int)

    def _table_for(self, rel_type: str) -> Dict[str, np.ndarray]:
        if rel_type not in self._tables:
            a, b, keep = self._valid_pair_arrays(self.pairs.get(rel_type, []))
            if a.shape[0] == 0:
                self._tables[rel_type] = {m: np.array([]) for m in
                                          list(METRIC_NAMES) + ["cosine_similarity", "angular_distance"]}
                self._tables[rel_type]["_keep"] = keep
            else:
                t = self._metric_table(a, b)
                t["_keep"] = keep
                self._tables[rel_type] = t
        return self._tables[rel_type]

    def _metric_table(self, a: np.ndarray, b: np.ndarray) -> Dict[str, np.ndarray]:
        """precision="strict": host float64 (digit parity);
        precision="device": batched f32 on the accelerator (large pair sets)."""
        if self.precision == "device":
            return _pair_metric_table_device(a, b, self.device)
        return _pair_metric_table(a, b)

    def calculate_distances(self) -> None:
        """Populate self.distances[metric][rel_type] lists
        (reference mi_analysis.py:256-297), one batched pass per type."""
        self.distances = {m: {} for m in self.metric_names}
        for rel_type in self.relationship_types:
            if rel_type not in self.pairs:
                logger.warning(f"No pairs found for relationship type: {rel_type}")
                for m in self.metric_names:
                    self.distances[m][rel_type] = []
                continue
            table = self._table_for(rel_type)
            for m in self.metric_names:
                self.distances[m][rel_type] = list(np.asarray(table[m], float))

    # -- MI -----------------------------------------------------------------

    def calculate_mutual_information(self) -> Dict[str, float]:
        """General MI per metric across the 4 relationship classes
        (reference mi_analysis.py:299-354)."""
        if not self.distances:
            self.calculate_distances()
        mi_values: Dict[str, float] = {}
        for m in self.metric_names:
            all_d, all_y = [], []
            for i, rel_type in enumerate(self.relationship_types):
                vals = self.distances[m].get(rel_type, [])
                all_d.extend(vals)
                all_y.extend([i] * len(vals))
            if not all_d:
                logger.warning(f"No valid distances for {m}")
                mi_values[m] = 0.0
                continue
            mi_values[m] = mutual_info_from_labels(
                np.array(all_d), np.array(all_y), self.bin_count, self.bin_strategy
            )
            logger.info(f"MI for {m}: {mi_values[m]:.4f} bits")
        self.mi_results["general"] = mi_values
        return mi_values

    def _color_pairs_and_labels(self):
        diff = self.pairs.get("same_object_diff_color", [])
        same = self.pairs.get("same_object_same_color", [])
        return diff + same, [1] * len(diff) + [0] * len(same)

    def _color_table(self):
        """Cached (metric table, labels) over the combined color-pair set.
        Computed once and reused by color MI, the weight grid search, and
        the PR/summary plots — previously recomputed up to 4x per
        run_full_analysis, and the plots bypassed precision='device'."""
        if self._color_tbl is None:
            all_pairs, all_labels = self._color_pairs_and_labels()
            a, b, keep = self._valid_pair_arrays(all_pairs)
            if a.shape[0] == 0:
                self._color_tbl = ({}, np.array([], int))
            else:
                self._color_tbl = (
                    self._metric_table(a, b), np.array(all_labels)[keep]
                )
        return self._color_tbl

    def calculate_color_specific_mi(self) -> Dict[str, float]:
        """Binary same/diff-color MI on same-object pairs
        (reference mi_analysis.py:356-429)."""
        if "same_object_diff_color" not in self.pairs:
            logger.warning("No 'same_object_diff_color' pairs found")
            return {}
        table, labels = self._color_table()
        color_mi: Dict[str, float] = {}
        if not table:
            for m in self.metric_names:
                color_mi[m] = 0.0
            self.mi_results["color_specific"] = color_mi
            return color_mi
        for m in self.metric_names:
            color_mi[m] = mutual_info_from_labels(
                table[m], labels, self.bin_count, self.bin_strategy
            )
            logger.info(f"Color-specific MI for {m}: {color_mi[m]:.4f} bits")
        self.mi_results["color_specific"] = color_mi
        return color_mi

    # -- weight optimization -------------------------------------------------

    def optimize_weights(self, grid_size: int = 5) -> Dict[str, float]:
        """Grid search over 5 weights maximizing color-discrimination MI.

        The reference loops grid_size^5 combinations, recomputing every
        pairwise distance per combination (mi_analysis.py:431-511). Here the
        five base metrics are computed once; every combination's score
        vector is one row of  S = B @ W^T  where B is (pairs, 5); binning +
        MI then run per combination. First-strictly-better argmax semantics
        and itertools.product ordering preserved."""
        if "same_object_diff_color" not in self.pairs or "same_object_same_color" not in self.pairs:
            logger.warning("No valid pairs found for parameter optimization")
            return dict(zip(_WEIGHT_KEYS, (1.0, 0.0, 0.0, 0.0, 0.0)))
        table, labels = self._color_table()
        if not table:
            logger.warning("No valid pairs found for parameter optimization")
            return dict(zip(_WEIGHT_KEYS, (1.0, 0.0, 0.0, 0.0, 0.0)))
        # optimized_distance = -(w_a*cos - w_l1*l1 - w_l2*l2 - w_inf*linf - w_mag*dmag)
        basis = np.stack(
            [
                -table["cosine_similarity"],
                table["l1_distance"],
                table["l2_distance"],
                table["linf_distance"],
                table["magnitude_difference"],
            ],
            axis=1,
        )  # (P, 5)
        grid = np.linspace(0.0, 1.0, grid_size)
        combos = np.array(list(product(grid, repeat=5)))  # (C, 5) product order
        scores = combos @ basis.T  # (C, P) float64
        best_mi, best_idx = -np.inf, 0
        for ci in range(combos.shape[0]):
            mi = mutual_info_from_labels(
                scores[ci], labels, self.bin_count, self.bin_strategy
            )
            if mi > best_mi:
                best_mi, best_idx = mi, ci
        best = dict(zip(_WEIGHT_KEYS, (float(x) for x in combos[best_idx])))
        self.optimal_weights = best
        self.mi_results["optimized"] = {"parameters": best, "mi_value": float(best_mi)}
        logger.info(f"Optimal parameters found: {best}, MI: {best_mi:.4f}")
        return best

    # -- PR curves (vectorized) ----------------------------------------------

    def precision_recall(
        self, distances: np.ndarray, labels: np.ndarray, thresholds: Optional[np.ndarray] = None
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """P/R over thresholds as one broadcast comparison
        (reference mi_analysis.py:774-798: predict different-color when
        distance <= threshold)."""
        if thresholds is None:
            thresholds = np.linspace(0, 1, 100)
        d = np.asarray(distances, float)
        y = np.asarray(labels)
        valid = ~np.isnan(d)
        d, y = d[valid], y[valid]
        pred = d[None, :] <= thresholds[:, None]  # (T, P)
        pos = y == 1
        tp = (pred & pos[None, :]).sum(1).astype(float)
        fp = (pred & ~pos[None, :]).sum(1).astype(float)
        fn = ((~pred) & pos[None, :]).sum(1).astype(float)
        precision = np.where(tp + fp > 0, tp / np.maximum(tp + fp, 1), 0.0)
        recall = np.where(tp + fn > 0, tp / np.maximum(tp + fn, 1), 0.0)
        return thresholds, precision, recall

    @staticmethod
    def f1_optimal_threshold(
        thresholds: np.ndarray, precision: np.ndarray, recall: np.ndarray
    ) -> float:
        """F1-argmax threshold (reference mi_analysis.py:806-813) — also the
        implementation of the GUI's undefined find_optimal_threshold
        (reference main.py:353)."""
        f1 = np.where(
            precision + recall > 0,
            2 * precision * recall / np.maximum(precision + recall, 1e-300),
            0.0,
        )
        return float(thresholds[int(np.argmax(f1))])

    # -- full pipeline -------------------------------------------------------

    def run_full_analysis(
        self, embeddings_file: str, output_dir: str = "results", make_plots: bool = True
    ) -> Dict[str, Any]:
        """7-step pipeline -> plots + results.json
        (reference mi_analysis.py:1149-1267)."""
        os.makedirs(output_dir, exist_ok=True)
        ok, message = self.load_dataset(embeddings_file)
        if not ok:
            logger.error(f"Failed to load dataset: {message}")
            return {"error": message}
        if len(self.embeddings) == 0:
            return {"error": "No valid embeddings found in the embedding file"}

        self.calculate_distances()
        if not any(
            len(self.distances[m].get(r, []))
            for m in self.metric_names
            for r in self.relationship_types
        ):
            return {
                "error": "No valid distances could be calculated - path mismatch "
                "between embeddings and pairs"
            }

        general_mi = self.calculate_mutual_information()
        color_mi = self.calculate_color_specific_mi()
        optimal_weights = self.optimize_weights(grid_size=3)

        visualizations = {}
        if make_plots:
            from image_retrieval_tpu_torch.analysis import plots

            visualizations = plots.make_all(self, output_dir)

        results = {
            "general_mi": general_mi,
            "color_mi": color_mi,
            "optimal_weights": optimal_weights,
        }
        with open(os.path.join(output_dir, "results.json"), "w") as f:
            json.dump(_to_serializable(results), f, indent=2)
        logger.info(f"Analysis complete. Results saved to {output_dir}")
        return {"results": results, "visualizations": visualizations}


def _to_serializable(obj):
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_serializable(v) for v in obj]
    return obj


def analyze_color_embeddings(
    embeddings_file: str,
    dataset_dir: str = "color_dataset",
    output_dir: str = "results",
    bin_count: int = 20,
    *,
    device: DeviceLike = "cuda",
) -> Dict[str, Any]:
    """Module entry point (reference mi_analysis.py:1625-1642). The plots
    are drawn where matplotlib and seaborn are installed; elsewhere (the
    machine with the card has neither) results.json alone is written and a
    warning says so."""
    from image_retrieval_tpu_torch.analysis import plots

    analyzer = ColorMIAnalyzer(base_dir=dataset_dir, bin_count=bin_count, device=device)
    make_plots = plots.available()
    if not make_plots:
        logger.warning("matplotlib or seaborn is not installed: results.json is "
                       "written, the plots are not drawn")
    return analyzer.run_full_analysis(embeddings_file, output_dir, make_plots=make_plots)
