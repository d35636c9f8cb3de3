"""Text->image search read path — port of ``image_retrieval_tpu/app/search.py``.

Candidates are a cosine top-(k * overfetch) from the index, optionally
under an attribute filter, followed by the same optional optimized rerank,
threshold and dedup as the JAX searcher; ``search_by_image`` runs the same
chain for an image query (a path, excluded from its own results, or pixels);
``search_with_multiple_metrics`` ranks the candidates by every metric on the
host and compares the rankings. The query encodes run inside the
``search/encode_text`` and ``search/encode_image`` trace ranges. With
``ann=`` (an ``index/ivf.py::IVFIndex`` or an
``index/screen.py::ScreenedSearch`` over the same rows) the unfiltered
candidates come from that tier and the rerank stays exact; a filter rides
the exact index.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List

import numpy as np

from image_retrieval_tpu_torch.config import (
    DEFAULT_SIMILARITY_PARAMS,
    SCORE_THRESHOLD,
)
from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.models.encoder import Encoder
from image_retrieval_tpu_torch.utils.profiling import trace

logger = logging.getLogger(__name__)


def _all_metrics_rows(q: np.ndarray, g: np.ndarray) -> Dict[str, np.ndarray]:
    """Host float64 metrics of one query vs candidate rows (tiny set)."""
    q = q.astype(np.float64)
    g = g.astype(np.float64)
    d = g.shape[1]
    nq = np.linalg.norm(q)
    ng = np.linalg.norm(g, axis=1)
    denom = nq * ng
    dots = g @ q
    cos = np.where(denom > 0, dots / np.where(denom > 0, denom, 1.0), 0.0)
    diff = np.abs(g - q[None, :])
    return {
        "cosine_similarity": cos,
        "cosine_distance": 1 - cos,
        "angular_distance": np.arccos(np.clip(cos, -1.0, 1.0)),
        "l1_distance": diff.sum(1) / d,
        "l2_distance": np.sqrt((diff * diff).sum(1)) / np.sqrt(d),
        "linf_distance": diff.max(1),
        "magnitude_difference": np.abs(ng - nq),
    }


def image_query(encoder: Encoder, image, size: int):
    """(unnormalized embedding, path or None) of an image query: a file path
    (decoded and transformed like the gallery) or (H, W, 3) pixels, which
    get the full CLIP transform to `size` (uint8, or float in [0, 255] or
    [0, 1]), since the tower's positional embeddings are fixed-size."""
    if isinstance(image, (str, bytes)) or hasattr(image, "__fspath__"):
        path = os.fsdecode(image)
        return encoder.encode_images([path])[0], path
    pixels = np.asarray(image)
    if pixels.ndim != 3:
        raise ValueError(f"expected a path or (H, W, 3) pixels, got shape {pixels.shape}")
    from image_retrieval_tpu_torch.models.preprocess import preprocess_host

    if pixels.dtype != np.uint8:
        arr = np.asarray(pixels, np.float32)
        if arr.size and float(arr.max()) <= 1.0:
            arr = arr * 255.0  # the [0, 1] float convention
        pixels = np.clip(np.rint(arr), 0, 255).astype(np.uint8)
    return encoder.encode_pixels(preprocess_host(pixels, size=size)[None])[0], None


def ann_valid_candidates(ann, index, q_unit: np.ndarray, limit: int):
    """The valid candidates of an ANN tier for one unit query: (cosines,
    index row ids) with its -1 padding slots dropped. Every ANN consumer
    goes through this: a -1 id fed to index.paths or get_vectors would
    silently read the last row."""
    cos, idx = ann.search(q_unit, top_k=min(limit, len(index)))
    valid = idx >= 0
    return cos[valid], idx[valid]


def _optimized_rows(m: Dict[str, np.ndarray], p: Dict[str, float]) -> np.ndarray:
    return (
        p.get("w_angle", 1.0) * m["cosine_similarity"]
        - p.get("w_l1", 0.0) * m["l1_distance"]
        - p.get("w_l2", 0.0) * m["l2_distance"]
        - p.get("w_inf", 0.0) * m["linf_distance"]
        - p.get("w_mag", 0.0) * m["magnitude_difference"]
    )


class TextImageSearcher:
    """Text->image search over the exact index, or over an ANN tier's
    candidates (`ann`, an IVFIndex or a ScreenedSearch over the same rows)
    with the rerank exact."""

    def __init__(self, encoder: Encoder, index: ShardedVectorIndex, ann=None):
        self.encoder = encoder
        self.index = index
        self.ann = ann
        self.similarity_params = dict(DEFAULT_SIMILARITY_PARAMS)

    def set_similarity_params(self, params: dict) -> None:
        self.similarity_params = params

    def generate_text_embedding(self, text: str) -> np.ndarray:
        """Unnormalized text embedding."""
        if not text.strip():
            raise ValueError("Text query cannot be empty")
        return self.encoder.encode_texts([text])[0]

    def _candidates(self, text_embedding: np.ndarray, limit: int, filter_expr=None):
        """Cosine top-`limit` of the unit query: (scores, indices), from the
        ANN tier when one is set and no filter is (the ANN tiers do not see
        attribute columns), else from the exact index."""
        qn = text_embedding / max(float(np.linalg.norm(text_embedding)), 1e-12)
        if self.ann is not None and filter_expr is None:
            return ann_valid_candidates(self.ann, self.index, qn, limit)
        if self.ann is not None:
            logger.info("filter set: using the exact index, not the ANN")
        return self.index.search(qn, top_k=min(limit, len(self.index)), flt=filter_expr)

    def search(self, text_query: str, top_k: int = 5,
               score_threshold: float = SCORE_THRESHOLD,
               use_optimized_similarity: bool = False,
               filter_expr=None) -> List[dict]:
        """Candidate overfetch -> optional optimized rerank -> threshold ->
        dedup -> top_k; [{'path', 'score'}]."""
        with trace("search/encode_text", self.index.device):
            text_embedding = self.generate_text_embedding(text_query)
        return self._search_with_embedding(
            text_embedding, top_k, score_threshold, use_optimized_similarity,
            filter_expr=filter_expr)

    def search_by_image(self, image, top_k: int = 5,
                        score_threshold: float = SCORE_THRESHOLD,
                        use_optimized_similarity: bool = False,
                        exclude_self: bool = True, filter_expr=None) -> List[dict]:
        """Image -> image search through the same candidate -> rerank ->
        threshold -> dedup chain as a text query. `image` is a file path or
        (H, W, 3) pixels; a path is excluded from its own results (compared
        by real path, so another spelling of it is excluded too) unless
        exclude_self=False."""
        size = getattr(getattr(getattr(self.encoder, "config", None), "model", None),
                       "image_size", 224) or 224
        with trace("search/encode_image", self.index.device):
            emb, path = image_query(self.encoder, image, size)
        exclude = frozenset([path]) if exclude_self and path is not None else frozenset()
        return self._search_with_embedding(
            np.asarray(emb), top_k, score_threshold, use_optimized_similarity,
            exclude_paths=exclude, filter_expr=filter_expr)

    def _search_with_embedding(self, embedding: np.ndarray, top_k: int,
                               score_threshold: float,
                               use_optimized_similarity: bool,
                               exclude_paths: frozenset = frozenset(),
                               filter_expr=None) -> List[dict]:
        """Shared query chain: candidates -> optional optimized rerank ->
        threshold (min-max-relative when reranked) -> dedup and exclusion
        -> top_k."""
        self.index.load()
        try:
            # overfetch one more per excluded path: the query's own row
            cos_scores, idx = self._candidates(
                embedding, (top_k + len(exclude_paths)) * 3, filter_expr)
            if filter_expr is not None:
                # sub-overfetch matches pad with (-inf, -1); drop them so no
                # -1 picks the last path, nor skews the min-max rerank
                keep = np.isfinite(cos_scores) & (idx >= 0)
                cos_scores, idx = cos_scores[keep], idx[keep]
            if use_optimized_similarity:
                cand = self.index.get_vectors(idx)
                scores = _optimized_rows(_all_metrics_rows(embedding, cand),
                                         self.similarity_params)
            else:
                scores = cos_scores
            matches = [{"path": self.index.paths[int(i)], "score": float(s)}
                       for s, i in zip(scores, idx)]
            matches.sort(key=lambda x: x["score"], reverse=True)
            if use_optimized_similarity:
                if matches:
                    lo = min(m["score"] for m in matches)
                    hi = max(m["score"] for m in matches)
                else:
                    lo, hi = 0, 1
                cut = lo + score_threshold * (hi - lo)
                filtered = [m for m in matches if m["score"] >= cut]
            else:
                filtered = [m for m in matches if m["score"] >= score_threshold]
            # exclusion compares real paths: the caller's spelling of the
            # query path rarely equals the indexed string byte for byte
            excl_real = {os.path.realpath(p) for p in exclude_paths}
            seen, unique = set(exclude_paths), []
            for m in filtered:  # dedup by path, best score first
                if (m["path"] not in seen
                        and os.path.realpath(m["path"]) not in excl_real):
                    seen.add(m["path"])
                    unique.append(m)
                    if len(unique) >= top_k:
                        break
            return unique
        finally:
            self.index.release()

    def search_with_multiple_metrics(self, text_query: str, top_k: int = 5) -> dict:
        """Per-metric rankings of the cosine top-(5 * top_k) candidates plus
        the intersection / unique-contribution analysis: {metric: [candidate
        dicts, best first], "analysis": {...}}."""
        text_embedding = self.generate_text_embedding(text_query)
        self.index.load()
        try:
            _, idx = self._candidates(text_embedding, top_k * 5)
            m = _all_metrics_rows(text_embedding, self.index.get_vectors(idx))
            opt = _optimized_rows(m, self.similarity_params)
            shown = ("cosine_similarity", "angular_distance", "l1_distance", "l2_distance",
                     "linf_distance", "magnitude_difference")
            candidates = [
                {"path": self.index.paths[int(i)],
                 **{name: float(m[name][r]) for name in shown},
                 "optimized_similarity": float(opt[r])}
                for r, i in enumerate(idx)
            ]
            descending = ("cosine_similarity", "optimized_similarity")
            metric_results = {
                name: sorted(candidates, key=lambda x: x[name],
                             reverse=name in descending)[:top_k]
                for name in ("cosine_similarity", "l1_distance", "l2_distance",
                             "linf_distance", "magnitude_difference", "optimized_similarity")
            }
            metric_results["analysis"] = self._analyze_metric_results(metric_results)
            return metric_results
        finally:
            self.index.release()

    @staticmethod
    def _analyze_metric_results(metric_results: dict) -> dict:
        """Pairwise intersections and unique contributions of the metrics'
        result lists."""
        paths_by_metric = {metric: [r["path"] for r in results]
                           for metric, results in metric_results.items()
                           if metric != "analysis"}
        intersections = {}
        for m1, p1 in paths_by_metric.items():
            for m2, p2 in paths_by_metric.items():
                if m1 < m2:
                    inter = set(p1) & set(p2)
                    intersections[f"{m1}_vs_{m2}"] = {
                        "intersection_size": len(inter),
                        "intersection_ratio": len(inter) / len(p1) if p1 else 0,
                        "common_items": list(inter),
                    }
        unique_contributions = {}
        for metric, paths in paths_by_metric.items():
            others = set()
            for om, op in paths_by_metric.items():
                if om != metric:
                    others.update(op)
            uniq = set(paths) - others
            unique_contributions[metric] = {
                "unique_count": len(uniq),
                "unique_ratio": len(uniq) / len(paths) if paths else 0,
                "unique_items": list(uniq),
            }
        return {"intersections": intersections,
                "unique_contributions": unique_contributions}

    def compare_search_methods(self, text_query: str, top_k: int = 5) -> dict:
        """Standard (cosine) against optimized search of one query."""
        standard = self.search(text_query, top_k, use_optimized_similarity=False)
        optimized = self.search(text_query, top_k, use_optimized_similarity=True)
        sp = [r["path"] for r in standard]
        op = [r["path"] for r in optimized]
        inter = set(sp) & set(op)
        return {
            "standard_results": standard,
            "optimized_results": optimized,
            "metrics": {
                "intersection_size": len(inter),
                "intersection_ratio": len(inter) / top_k if top_k > 0 else 0,
                "unique_to_standard": list(set(sp) - set(op)),
                "unique_to_optimized": list(set(op) - set(sp)),
            },
        }

    def search_batch(self, text_queries: List[str], top_k: int = 5) -> List[List[dict]]:
        """Encode all queries at once and score them in one gallery sweep."""
        if not text_queries:
            return []
        for q in text_queries:
            if not q.strip():
                raise ValueError("Text query cannot be empty")
        embs = self.encoder.encode_texts(text_queries)
        qn = embs / np.maximum(np.linalg.norm(embs, axis=1, keepdims=True), 1e-12)
        vals, idx = self.index.search(qn, top_k=min(top_k, len(self.index)))
        return [[{"path": self.index.paths[int(i)], "score": float(v)}
                 for v, i in zip(vrow, irow)]
                for vrow, irow in zip(vals, idx)]
