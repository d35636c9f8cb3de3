"""Self-supervised pair MI analysis (reference MIAnalysis/EnhancedMIAnalysis) —
a copy of ``image_retrieval_tpu/analysis/pair_mi.py`` (host float64) over
the port's ``ops/mi.py``.

Re-design of reference mi_analysis.py:28-153 and :1270-1621:
  * pair sampling keeps the reference's seeded Python-random call sequence
    (random.seed(42), random.sample; mi_analysis.py:54,70-75,102-110) so the
    sampled pair sets reproduce — but dedup uses a set instead of O(n) list
    membership, and similarity stratification (80th/50th percentiles) is
    computed from one vectorized cosine pass instead of a per-pair loop.
  * embedding lookup is a dict index, replacing the accidental O(pairs x N)
    linear scans (reference mi_analysis.py:1469-1488, :1540-1558).
  * per-metric distances over pairs run as one batched evaluation; the
    weight grid search reuses a precomputed (pairs, 5) basis.

Label conventions preserved exactly, including the reference quirk that
"related_category" is absent from label_map and maps to -1
(mi_analysis.py:46,1432,1498).
"""

from __future__ import annotations

import logging
import random
from itertools import product
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from image_retrieval_tpu_torch.ops.mi import mutual_info_from_labels

logger = logging.getLogger(__name__)

LABEL_MAP = {"same_object": 0, "same_category": 1, "different_categories": 2}


def _cosine_rows(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    # zero-norm guard (cos -> 0): one zero embedding would otherwise NaN the
    # percentile stratification and silently yield 0 pairs
    na = np.linalg.norm(a, axis=1)
    nb = np.linalg.norm(b, axis=1)
    denom = na * nb
    dots = np.einsum("pd,pd->p", a, b)
    return np.where(denom > 0, dots / np.where(denom > 0, denom, 1.0), 0.0)


class PairMIAnalysis:
    """Similarity-stratified pair generation + angle MI
    (reference MIAnalysis, mi_analysis.py:28-153)."""

    def __init__(
        self,
        embeddings: List[Tuple[str, np.ndarray]],
        num_pairs: int = 1000,
        num_bins: int = 20,
        max_comparisons: int = 50000,
        seed: int = 42,
    ):
        self.embeddings = embeddings
        n = len(embeddings)
        self.num_pairs = min(num_pairs, n * (n - 1) // 2)
        self.num_bins = num_bins
        self.max_comparisons = max_comparisons
        self.seed = seed
        self.pairs: List[Tuple[str, str]] = []
        self.angles: List[float] = []
        self.labels: List[str] = []
        self.label_map = dict(LABEL_MAP)
        self.label_names = ["Same Object", "Same Category", "Different Categories"]
        self._emb_by_path = {p: e for p, e in embeddings}
        # monotonically bumped by invalidate_pairs_cache(); memo key for
        # _pair_matrices (object identity alone can recycle ids — ADVICE r2)
        self._pairs_gen = 0

    def invalidate_pairs_cache(self) -> None:
        """Call after (re)assigning self.pairs / self.embeddings /
        self._emb_by_path externally; pair-generating methods call it."""
        self._pairs_gen += 1
        self._pair_matrices_cache = None

    # -- sampling ------------------------------------------------------------

    def _sample_index_pairs(self) -> Tuple[List[Tuple[int, int]], "random.Random"]:
        """(sampled (i<j) index pairs, the seeded Random instance) — same
        RNG call sequence as the reference's loop (mi_analysis.py:63-75),
        set-based dedup; callers reuse the Random for later draws."""
        rnd = random.Random()
        rnd.seed(self.seed)
        n = len(self.embeddings)
        max_comparisons = min(self.max_comparisons, n * (n - 1) // 2)
        indices = list(range(n))
        seen = set()
        sampled: List[Tuple[int, int]] = []
        for _ in range(max_comparisons):
            i, j = rnd.sample(indices, 2)
            if i > j:
                i, j = j, i
            if (i, j) not in seen:
                seen.add((i, j))
                sampled.append((i, j))
        return sampled, rnd

    def _stratify(self, sampled, rnd, labels_by_band: Tuple[str, str, str]):
        """Percentile stratification + band sampling
        (reference mi_analysis.py:84-143), vectorized cosine pass."""
        if len(self.embeddings) < 10:
            logger.warning("Not enough embeddings for meaningful analysis")
            return
        ii = np.array([i for i, _ in sampled])
        jj = np.array([j for _, j in sampled])
        mat = np.stack([e for _, e in self.embeddings]).astype(np.float64)
        sims = _cosine_rows(mat[ii], mat[jj])
        pairs_data = sorted(
            ((int(i), int(j), float(s)) for i, j, s in zip(ii, jj, sims)),
            key=lambda x: x[2],
            reverse=True,
        )
        similarities = [p[2] for p in pairs_data]
        high = np.percentile(similarities, 80)
        med = np.percentile(similarities, 50)
        per_type = min(self.num_pairs // 3, len(pairs_data) // 3)
        high_band = [p for p in pairs_data if p[2] >= high]
        med_band = [p for p in pairs_data if med <= p[2] < high]
        low_band = [p for p in pairs_data if p[2] < med]
        sampled_high = rnd.sample(high_band, min(per_type, len(high_band)))
        sampled_med = rnd.sample(med_band, min(per_type, len(med_band)))
        sampled_low = rnd.sample(low_band, min(per_type, len(low_band)))
        for band, label in zip(
            (sampled_high, sampled_med, sampled_low), labels_by_band
        ):
            for i, j, _ in band:
                p1, e1 = self.embeddings[i]
                p2, e2 = self.embeddings[j]
                self.pairs.append((p1, p2))
                self.angles.append(self.compute_angle(e1, e2))
                self.labels.append(label)
        self.invalidate_pairs_cache()
        logger.info(f"Generated {len(self.pairs)} pairs for MI analysis")

    def generate_pairs(self) -> None:
        """Reference band labels: high->same_category, med->same_object,
        low->different_categories (mi_analysis.py:113-138)."""
        sampled, rnd = self._sample_index_pairs()
        self._stratify(sampled, rnd, ("same_category", "same_object", "different_categories"))

    def compute_angle(self, emb1: np.ndarray, emb2: np.ndarray) -> float:
        e1 = np.asarray(emb1, np.float64)
        e2 = np.asarray(emb2, np.float64)
        cos = np.dot(e1 / np.linalg.norm(e1), e2 / np.linalg.norm(e2))
        return float(np.arccos(np.clip(cos, -1.0, 1.0)))


class EnhancedPairMIAnalysis(PairMIAnalysis):
    """Multi-metric, unnormalized-aware MI + weight search
    (reference EnhancedMIAnalysis, mi_analysis.py:1270-1621)."""

    DISTANCE_KEYS = ("angular", "l1", "l2", "linf", "magnitude_diff")

    def __init__(
        self,
        embeddings: List[Tuple[str, np.ndarray]],
        num_pairs: int = 1000,
        num_bins: int = 20,
        keep_unnormalized: bool = True,
        **kw,
    ):
        super().__init__(embeddings, num_pairs, num_bins, **kw)
        self.keep_unnormalized = keep_unnormalized
        self.original_embeddings = (
            [(p, e.copy()) for p, e in embeddings] if keep_unnormalized else []
        )
        self._orig_by_path = {p: e for p, e in self.original_embeddings}
        self.distance_measures: Dict[str, List[float]] = {
            k: [] for k in self.DISTANCE_KEYS
        }
        self.mi_values: Dict[str, float] = {}
        self.optimal_params = {
            "w_angle": 1.0, "w_l1": 0.0, "w_l2": 0.0, "w_inf": 0.0, "w_mag": 0.0,
        }

    def generate_coco_pairs(self) -> None:
        """Full O(n^2) stratification as one matmul
        (reference mi_analysis.py:1369-1446); med band labeled
        related_category (absent from label_map -> -1)."""
        if len(self.embeddings) < 10:
            logger.warning("Not enough embeddings for meaningful analysis")
            return
        rnd = random.Random()
        rnd.seed(self.seed)
        n = len(self.embeddings)
        mat = np.stack([e for _, e in self.embeddings]).astype(np.float64)
        norms = np.linalg.norm(mat, axis=1)
        denom = np.outer(norms, norms)
        sims = np.where(denom > 0, (mat @ mat.T) / np.where(denom > 0, denom, 1.0), 0.0)
        iu, ju = np.triu_indices(n, k=1)
        pairs_data = sorted(
            ((int(i), int(j), float(s)) for i, j, s in zip(iu, ju, sims[iu, ju])),
            key=lambda x: x[2],
            reverse=True,
        )
        similarities = [p[2] for p in pairs_data]
        high = np.percentile(similarities, 80)
        med = np.percentile(similarities, 50)
        per_type = min(self.num_pairs // 3, len(pairs_data) // 3)
        high_band = [p for p in pairs_data if p[2] >= high]
        med_band = [p for p in pairs_data if med <= p[2] < high]
        low_band = [p for p in pairs_data if p[2] < med]
        for band, label in zip(
            (
                rnd.sample(high_band, min(per_type, len(high_band))),
                rnd.sample(med_band, min(per_type, len(med_band))),
                rnd.sample(low_band, min(per_type, len(low_band))),
            ),
            ("same_category", "related_category", "different_categories"),
        ):
            for i, j, _ in band:
                p1, e1 = self.embeddings[i]
                p2, e2 = self.embeddings[j]
                self.pairs.append((p1, p2))
                self.angles.append(self.compute_angle(e1, e2))
                self.labels.append(label)
        self.invalidate_pairs_cache()
        logger.info(f"Generated {len(self.pairs)} pairs for MI analysis")

    # -- batched metric computation ------------------------------------------

    def _pair_matrices(self):
        """(A, B, A_orig, B_orig, keep) for pairs present in the embedding
        dict, order-preserving (indexed lookup, not linear scan). `keep`
        holds the kept PAIR indices — labels must be selected with it, not
        truncated, or a dropped pair mid-list misaligns every later row.

        Memoized per pairs GENERATION (bumped by invalidate_pairs_cache,
        called by every pair-generating method): compute_mi_for_all_metrics,
        compute_mi_for_optimized_similarity, and find_optimal_parameters
        all consume the same matrices, and the O(pairs) Python loop is
        expensive on a single-core host (same fix as color_mi's
        _color_table)."""
        token = (self._pairs_gen, len(self.pairs))
        cached = getattr(self, "_pair_matrices_cache", None)
        if cached is not None and cached[0] == token:
            return cached[1]
        a, b, ao, bo, keep = [], [], [], [], []
        for idx, (p1, p2) in enumerate(self.pairs):
            e1 = self._emb_by_path.get(p1)
            e2 = self._emb_by_path.get(p2)
            if e1 is None or e2 is None:
                continue
            if self.keep_unnormalized:
                o1 = self._orig_by_path.get(p1)
                o2 = self._orig_by_path.get(p2)
                if o1 is None or o2 is None:
                    continue
                ao.append(o1)
                bo.append(o2)
            a.append(e1)
            b.append(e2)
            keep.append(idx)
        A = np.stack(a) if a else np.zeros((0, 1))
        B = np.stack(b) if b else np.zeros((0, 1))
        AO = np.stack(ao) if ao else A
        BO = np.stack(bo) if bo else B
        out = (A, B, AO, BO, np.array(keep, dtype=int))
        self._pair_matrices_cache = (token, out)
        return out

    def compute_mi_for_all_metrics(self) -> Dict[str, float]:
        """Angle on normalized inputs; L1/L2/Linf/magnitude on unnormalized
        originals when kept (reference mi_analysis.py:1512-1621)."""
        if not self.pairs:
            raise ValueError("No pairs generated. Run generate_pairs() first.")
        A, B, AO, BO, kept = self._pair_matrices()
        A64, B64 = A.astype(np.float64), B.astype(np.float64)
        AO64, BO64 = AO.astype(np.float64), BO.astype(np.float64)
        d = A64.shape[1]
        cos = _cosine_rows(A64, B64)
        angular = np.arccos(np.clip(cos, -1.0, 1.0))
        diff = np.abs(AO64 - BO64)
        self.distance_measures = {
            "angular": list(angular),
            "l1": list(diff.sum(1) / d),
            "l2": list(np.sqrt((diff * diff).sum(1)) / np.sqrt(d)),
            "linf": list(diff.max(1)),
            "magnitude_diff": list(
                np.abs(np.linalg.norm(AO64, axis=1) - np.linalg.norm(BO64, axis=1))
            ),
        }
        numeric = np.array(
            [self.label_map.get(self.labels[i], -1) for i in kept]
        )
        self.mi_values = {}
        for name, vals in self.distance_measures.items():
            self.mi_values[name] = mutual_info_from_labels(
                np.array(vals), numeric, self.num_bins, "uniform"
            )
            logger.info(f"MI for {name}: {self.mi_values[name]:.4f} bits")
        return self.mi_values

    def _optimized_basis(self) -> Tuple[np.ndarray, np.ndarray]:
        """(P, 5) basis for weighted similarity over valid pairs + labels.

        Reference computes optimized_similarity on the ORIGINAL unnormalized
        embeddings when kept (mi_analysis.py:1480-1492)."""
        A, B, AO, BO, kept = self._pair_matrices()
        X = (AO if self.keep_unnormalized else A).astype(np.float64)
        Y = (BO if self.keep_unnormalized else B).astype(np.float64)
        d = X.shape[1]
        cos = _cosine_rows(X, Y)
        diff = np.abs(X - Y)
        basis = np.stack(
            [
                cos,
                -diff.sum(1) / d,
                -np.sqrt((diff * diff).sum(1)) / np.sqrt(d),
                -diff.max(1),
                -np.abs(np.linalg.norm(X, axis=1) - np.linalg.norm(Y, axis=1)),
            ],
            axis=1,
        )
        numeric = np.array(
            [self.label_map.get(self.labels[i], -1) for i in kept]
        )
        return basis, numeric

    def compute_mi_for_optimized_similarity(self, params: Dict[str, float]) -> float:
        if not self.pairs:
            raise ValueError("No pairs generated. Run generate_pairs() first.")
        basis, labels = self._optimized_basis()
        w = np.array([params.get(k, 0.0) for k in
                      ("w_angle", "w_l1", "w_l2", "w_inf", "w_mag")])
        scores = basis @ w
        return mutual_info_from_labels(scores, labels, self.num_bins, "uniform")

    def find_optimal_parameters(self, param_grid: Optional[Dict[str, Sequence[float]]] = None):
        """Grid search (reference mi_analysis.py:1314-1367) as one batched
        scoring pass over the precomputed basis."""
        if param_grid is None:
            grid = np.linspace(0, 1, 5)
            param_grid = {k: grid for k in
                          ("w_angle", "w_l1", "w_l2", "w_inf", "w_mag")}
        names = list(param_grid.keys())
        combos = list(product(*param_grid.values()))
        basis, labels = self._optimized_basis()
        key_order = ("w_angle", "w_l1", "w_l2", "w_inf", "w_mag")
        best_mi, best_params = -np.inf, {}
        for combo in combos:
            params = dict(zip(names, combo))
            w = np.array([params.get(k, 0.0) for k in key_order])
            mi = mutual_info_from_labels(basis @ w, labels, self.num_bins, "uniform")
            if mi > best_mi:
                best_mi, best_params = mi, dict(params)
        self.optimal_params = best_params
        logger.info(f"Optimal parameters found: {best_params}, MI: {best_mi:.4f}")
        return {"parameters": best_params, "mi_value": float(best_mi)}
