"""Application facade — port of ``image_retrieval_tpu/app/pipeline.py``.

``ImageSearchApp`` discovers cached embeddings, encodes a folder (the
loader's decode overlapping the encoder's batches in flight), keeps the rows
in one exact index on `device` (the card unless the caller names the CPU)
and answers text queries (``search_images``), image queries
(``find_similar_images``) and the multi-metric comparison
(``search_with_multiple_metrics``, one five-plane pass of the index). With
``journal_dir`` the index is durable (``ShardedVectorIndex.open``): rows are
recovered from the directory, only new paths are encoded, every insert is
flushed before the index is used, and ``checkpoint()`` seals the log.
``SearchConfig.ann = "ivf"`` (an IVFIndex, the reference's Milvus IVF_FLAT;
nlist / nprobe 0 = ``recommended_ivf``'s operating point) or ``"screen"``
(a ScreenedSearch) takes the candidates of text and image queries from that
tier over the index (rebuilt when the index or the tier's settings change),
reranked exactly.

The MI analyses (``run_mi_analysis``, ``run_enhanced_mi_analysis``,
``run_enhanced_mi_analysis_coco``) run the pair analyzers of
``analysis/pair_mi.py`` over the processed embeddings on the host, as the
JAX facade does; ``run_color_analysis`` is the color-analysis entry of the
headless workflow.

The encoder is built once and reused; nothing falls back to another
encoder or to the CPU when it cannot be built.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from image_retrieval_tpu_torch.config import DEFAULT_SIMILARITY_PARAMS, Config
from image_retrieval_tpu_torch.device import DeviceLike
from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.models.encoder import Encoder

logger = logging.getLogger(__name__)

# Embedding-cache discovery list, in the order the JAX facade tries it.
EMBEDDING_CACHE_PATHS = [
    "color_embeddings.npz",
    "color_analysis/color_embeddings.npz",
    "../color_embeddings.npz",
    "embeddings.npz",
    "color_dataset/embeddings.npz",
    "~/Desktop/color_embeddings.npz",
    "~/Desktop/color_analysis/color_embeddings.npz",
]


class SimpleSearcher:
    """Similarity-params holder."""

    def __init__(self):
        self.similarity_params = dict(DEFAULT_SIMILARITY_PARAMS)

    def set_similarity_params(self, params):
        self.similarity_params.update(params)
        logger.info(f"Updated similarity parameters: {self.similarity_params}")


class ImageSearchApp:
    """Self-contained search application over local image folders."""

    def __init__(self, encoder: Optional[Encoder] = None, config: Optional[Config] = None,
                 journal_dir: Optional[str] = None, *, device: DeviceLike = "cuda"):
        """`journal_dir` makes the index durable (index/journal.py): rows
        already there are recovered on first use, every mutation is
        write-ahead logged and checkpoint() seals the log into a snapshot.
        Without it the index lives in memory only. `device` holds the index
        and, when no `encoder` is given, the CLIP encoder built on first
        use."""
        self.config = config or Config()
        self.encoder = encoder
        self.journal_dir = journal_dir
        self.device = device
        self.embeddings: Dict[str, np.ndarray] = {}
        self.searcher = SimpleSearcher()
        self._index: Optional[ShardedVectorIndex] = None
        self._index_dirty = True
        self._ann = None  # the ANN tier of SearchConfig.ann, built on first use
        self._ann_key = None  # (index generation, ann settings) it was built from

    def _get_encoder(self) -> Encoder:
        if self.encoder is None:
            from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

            self.encoder = CLIPEncoder(config=self.config, device=self.device)
        return self.encoder

    # -- ingestion -----------------------------------------------------------

    def scan_folders(self, folder: str) -> List[Path]:
        """*.jpg then *.png under `folder`, recursively, each sorted; the
        parent directory becomes the `dir` attribute of a row."""
        p = Path(folder)
        return sorted(p.rglob("*.jpg")) + sorted(p.rglob("*.png"))

    def process_images(self, image_paths: Sequence) -> None:
        """Recover rows from the journal (when one is configured), adopt
        cached embeddings when a cache file matches (exact path, then an
        unambiguous file name), else encode."""
        logger.info(f"Processing {len(image_paths)} images...")
        if self.journal_dir is not None:
            image_paths = self._recover_from_journal(image_paths)
            if not image_paths:
                logger.info("All images recovered from the journal")
                return
        embeddings_file = next(
            (c for c in map(os.path.expanduser, EMBEDDING_CACHE_PATHS) if os.path.exists(c)),
            None)
        if embeddings_file:
            logger.info(f"Found embeddings file: {embeddings_file}")
            try:
                if self._adopt_cached(embeddings_file, image_paths):
                    return
                logger.warning("No matching embeddings found for selected images")
            except Exception as e:
                logger.warning(f"Failed to load pre-computed embeddings: {e}")
        logger.info("Generating new embeddings...")
        self._generate_embeddings(image_paths)

    def _adopt_cached(self, embeddings_file: str, image_paths: Sequence) -> bool:
        """Take the cached embedding of every path found in the cache; a file
        name matches only where it is unique on both sides (category trees
        repeat names). Returns whether any matched."""
        data = np.load(embeddings_file, allow_pickle=True)
        if not (isinstance(data, np.lib.npyio.NpzFile) and "embeddings" in data):
            return False
        stored = data["embeddings"].item()
        stored_names = Counter(Path(k).name for k in stored)
        by_name = {Path(k).name: v for k, v in stored.items() if stored_names[Path(k).name] == 1}
        scan_names = Counter(Path(str(p)).name for p in image_paths)
        matched = 0
        for image_path in image_paths:
            s = str(image_path)
            name = Path(s).name
            if s in stored:
                self.embeddings[s] = stored[s]
                matched += 1
            elif scan_names[name] == 1 and name in by_name:
                self.embeddings[s] = by_name[name]
                matched += 1
        if matched:
            logger.info(f"Matched {matched}/{len(image_paths)} images")
            self._index_dirty = True
        return matched > 0

    def _generate_embeddings(self, image_paths: Sequence) -> None:
        """Streamed decode -> batched encode, then the npz cache save."""
        from image_retrieval_tpu_torch.data.loader import encode_folder

        ok_paths, embs = encode_folder(
            self._get_encoder(), [str(p) for p in image_paths],
            batch_size=self.config.batch_size, size=self.config.model.image_size,
            use_native=False)
        if ok_paths:
            for p, e in zip(ok_paths, embs):
                self.embeddings[p] = e
            self._index_dirty = True
            try:
                np.savez("new_embeddings.npz", embeddings=np.array(self.embeddings, dtype=object))
                logger.info("Saved new embeddings to new_embeddings.npz")
            except Exception as e:
                logger.warning(f"Failed to save embeddings: {e}")
        logger.info(f"Generated {len(self.embeddings)} embeddings")

    def _open_journaled_index(self) -> ShardedVectorIndex:
        """Open (recovering) the journaled index once; cached thereafter."""
        if self._index is None:
            cfg = self.config.index
            if self.embeddings:
                dim = next(iter(self.embeddings.values())).shape[0]
                if cfg.embedding_dim != dim:
                    cfg = dataclasses.replace(cfg, embedding_dim=dim)
            self._index = ShardedVectorIndex.open(self.journal_dir, config=cfg,
                                                  device=self.device)
            self._index_dirty = True
        return self._index

    def _recover_from_journal(self, image_paths: Sequence) -> List[str]:
        """Open (recover) the journaled index, adopt the embeddings (unit x
        magnitude) of the rows it already holds, and return the paths that
        still need encoding: a restart over an unchanged folder encodes
        nothing."""
        idx = self._open_journaled_index()
        todo = [str(p) for p in image_paths]
        if not len(idx):
            return todo
        live = idx.live_mask()
        row_of = {p: i for i, p in enumerate(idx.paths) if live[i]}
        hit = [p for p in todo if p in row_of]
        if hit:
            rows = np.asarray([row_of[p] for p in hit])
            vecs = idx.get_vectors(rows) * idx.get_magnitudes(rows)[:, None]
            for p, v in zip(hit, np.asarray(vecs, np.float32)):
                self.embeddings[p] = v
            self._index_dirty = True
            logger.info(f"Recovered {len(hit)}/{len(todo)} images from "
                        f"journal {self.journal_dir}")
        return [p for p in todo if p not in row_of]

    @staticmethod
    def _dir_attrs(paths):
        """The `dir` attribute: each path's parent directory name."""
        return [os.path.basename(os.path.dirname(os.path.abspath(p))) for p in paths]

    def _ensure_index(self) -> Optional[ShardedVectorIndex]:
        if self.journal_dir is not None:
            return self._ensure_journaled_index()
        if not self.embeddings:
            return None
        if self._index is None or self._index_dirty:
            dim = next(iter(self.embeddings.values())).shape[0]
            self._index = ShardedVectorIndex(dim=dim, config=self.config.index,
                                             device=self.device)
            paths = list(self.embeddings.keys())
            self._index.insert(paths, np.stack([self.embeddings[p] for p in paths]),
                               attrs={"dir": self._dir_attrs(paths)})
            self._index_dirty = False
            self._ann = None  # a new index: its ANN tier is built on demand
        return self._index

    def _ensure_journaled_index(self) -> Optional[ShardedVectorIndex]:
        """Recover the journaled index once, then insert the embeddings of
        paths it does not hold yet (a second process_images after a restart
        must not duplicate rows), flushed before the index is used."""
        self._open_journaled_index()
        if self._index_dirty:
            live = self._index.live_mask()
            have = {p for p, alive in zip(self._index.paths, live) if alive}
            new = [p for p in self.embeddings if p not in have]
            if new:
                self._index.insert(new, np.stack([self.embeddings[p] for p in new]),
                                   attrs={"dir": self._dir_attrs(new)})
                self._index.flush()
                self._ann = None
            self._index_dirty = False
        return self._index if len(self._index) else None

    def checkpoint(self) -> None:
        """Seal the journal into a snapshot (bounds the replay at restart).
        Requires journal_dir; a no-op when the index was never built."""
        idx = self._ensure_index()
        if idx is not None:
            idx.checkpoint()

    def _ensure_ann(self, index: ShardedVectorIndex):
        """The candidate tier of SearchConfig.ann: None for "exact" (or a
        gallery with no live row), an IVFIndex for "ivf" (the reference's
        Milvus IVF_FLAT, ImageEmbeddingSystem.py:56-61; nlist or nprobe 0 =
        the recommended_ivf operating point, and the exact tier below its
        crossover), a ScreenedSearch for "screen"; rebuilt when the index's
        generation or the tier's settings change."""
        sc = self.config.search
        if sc.ann not in ("ivf", "screen") or index is None or index.live_count == 0:
            return None
        key = (index.generation, sc.ann, sc.nlist, sc.nprobe, sc.screen_dims,
               sc.screen_candidates)
        if self._ann is not None and self._ann_key == key:
            return self._ann
        if sc.ann == "screen":
            from image_retrieval_tpu_torch.index.screen import ScreenedSearch

            self._ann = ScreenedSearch.from_index(index, sketch_dims=sc.screen_dims,
                                                  candidates=sc.screen_candidates)
        else:
            from image_retrieval_tpu_torch.index.ivf import IVFIndex, recommended_ivf

            nlist, nprobe = sc.nlist, sc.nprobe
            if nlist == 0 or nprobe == 0:
                rec = recommended_ivf(index.live_count)
                if rec is None:
                    return None
                nlist, nprobe = nlist or rec[0], nprobe or rec[1]
            self._ann = IVFIndex.from_index(index, nlist=min(nlist, index.live_count),
                                            nprobe=nprobe)
        self._ann_key = key
        return self._ann

    # -- search --------------------------------------------------------------

    def _get_query_embedding(self, query: str) -> np.ndarray:
        return self._get_encoder().encode_texts([query])[0]

    def search_images(self, query: str, top_k: int = 10,
                      use_optimized_similarity: bool = False,
                      filter_expr: Optional[str] = None) -> List[dict]:
        """Exact search over all processed images, ranked by abs(score)
        when SearchConfig.rank_by_abs. `filter_expr` restricts rows by
        attribute expression; every row carries `dir`, its parent
        directory's name."""
        logger.info(f"Searching for: '{query}' (optimized: {use_optimized_similarity})")
        index = self._ensure_index()
        if index is None:
            logger.warning("No embeddings available for search")
            return []
        q = self._get_query_embedding(query)
        return self._rank_with_embedding(index, q, top_k, use_optimized_similarity,
                                         filter_expr=filter_expr)

    def find_similar_images(self, image, top_k: int = 10,
                            use_optimized_similarity: bool = False,
                            exclude_self: bool = True,
                            filter_expr: Optional[str] = None) -> List[dict]:
        """Image -> image similarity over the processed gallery, ranked like
        search_images. `image` is a path or (H, W, 3) pixels; a query path
        in the index (as given or absolute) is dropped from its own results
        unless exclude_self=False."""
        index = self._ensure_index()
        if index is None:
            logger.warning("No embeddings available for search")
            return []
        from image_retrieval_tpu_torch.app.search import image_query

        q, path = image_query(self._get_encoder(), image, self.config.model.image_size)
        exclude: frozenset = frozenset()
        if exclude_self and path is not None:
            exclude = frozenset({path, os.path.abspath(path)})
        logger.info(f"Image-query search (optimized: {use_optimized_similarity})")
        return self._rank_with_embedding(index, np.asarray(q), top_k, use_optimized_similarity,
                                         exclude_paths=exclude, filter_expr=filter_expr)

    def _rank_with_embedding(self, index: ShardedVectorIndex, q: np.ndarray, top_k: int,
                             use_optimized_similarity: bool,
                             exclude_paths: frozenset = frozenset(),
                             filter_expr: Optional[str] = None) -> List[dict]:
        """The ranking chain of text and image queries: the candidates (the
        ANN tier's, overfetched, or the exact index's full score row of the
        query), the optimized rerank, abs() when SearchConfig.rank_by_abs,
        tombstoned and filtered rows dropped after abs(), the excluded paths
        skipped, top_k. A filter rides the exact index."""
        k_eff = top_k + len(exclude_paths)
        metric = "optimized_similarity" if use_optimized_similarity else "cosine_similarity"
        ann = self._ensure_ann(index)
        if filter_expr is not None and ann is not None:
            logger.info("filter set: using the exact index, not the ANN")
            ann = None
        pool = None
        if ann is not None:
            from image_retrieval_tpu_torch.app.search import (
                _all_metrics_rows,
                _optimized_rows,
                ann_valid_candidates,
            )

            limit = min(k_eff * self.config.search.overfetch, len(index))
            qn = q / max(np.linalg.norm(q), 1e-12)
            cos, cand = ann_valid_candidates(ann, index, qn, limit)
            if self.config.search.rank_by_abs:
                # abs-ranking also surfaces strongly negative cosines: the
                # ANN candidates are the best descending, so probe the
                # antipode too and take the union
                ncos, ncand = ann_valid_candidates(ann, index, -qn, limit)
                keep = ~np.isin(ncand, cand)
                cand = np.concatenate([cand, ncand[keep]])
                cos = np.concatenate([cos, -ncos[keep]])
            if use_optimized_similarity:
                rows = index.get_vectors(cand) * index.get_magnitudes(cand)[:, None]
                scores = _optimized_rows(_all_metrics_rows(q, rows),
                                         self.searcher.similarity_params)
            else:
                scores = cos
            pool = np.asarray(cand)
        else:
            scores = index.scores(
                q, metric=metric,
                params=self.searcher.similarity_params if use_optimized_similarity else None)
        rank_scores = np.abs(scores) if self.config.search.rank_by_abs else scores
        if pool is None:
            # scores() covers tombstoned rows too: drop them after abs(),
            # where abs(-inf) would rank first; a filter drops its misses
            mask = (index.filter_mask(filter_expr) if filter_expr is not None
                    else index.live_mask())
            rank_scores = np.where(mask, rank_scores, -np.inf)
        order = np.argsort(-rank_scores, kind="stable")[:k_eff]
        out = []
        for i in order:
            if not np.isfinite(rank_scores[i]):
                continue
            path = index.paths[int(i if pool is None else pool[int(i)])]
            if path in exclude_paths:
                continue
            out.append({"path": path, "score": float(rank_scores[i])})
            if len(out) >= top_k:
                break
        return out

    # -- MI analyses (reference app_pipeline.py:200-240) ----------------------

    def run_mi_analysis(self, num_pairs: int = 1000, num_bins: int = 20):
        """(analyzer, {"default": the largest per-metric MI}), or (None, None)
        without embeddings."""
        if not self.embeddings:
            logger.warning("No embeddings available for MI analysis")
            return None, None
        from image_retrieval_tpu_torch.analysis.pair_mi import EnhancedPairMIAnalysis

        analyzer = EnhancedPairMIAnalysis(list(self.embeddings.items()), num_pairs, num_bins)
        analyzer.generate_pairs()
        mi_results = analyzer.compute_mi_for_all_metrics()
        default_mi = max(mi_results.values()) if mi_results else 0.0
        return analyzer, {"default": default_mi}

    def run_enhanced_mi_analysis(self, num_pairs: int = 1000, num_bins: int = 20,
                                 keep_unnormalized: bool = True):
        """(analyzer, per-metric MI) over at most 1,000 pairs (the
        reference's cap, app_pipeline.py:230)."""
        if not self.embeddings:
            logger.warning("No embeddings available for enhanced MI analysis")
            return None, None
        from image_retrieval_tpu_torch.analysis.pair_mi import EnhancedPairMIAnalysis

        analyzer = EnhancedPairMIAnalysis(list(self.embeddings.items()), min(num_pairs, 1000),
                                          num_bins, keep_unnormalized)
        analyzer.generate_pairs()
        mi_results = analyzer.compute_mi_for_all_metrics()
        logger.info(f"MI analysis complete. Results: {mi_results}")
        return analyzer, mi_results

    def run_enhanced_mi_analysis_coco(self, num_pairs: int = 1000, num_bins: int = 20,
                                      keep_unnormalized: bool = True):
        """The COCO-pair variant (the orphaned module-level function in the
        reference, app_pipeline.py:403-427): every pair stratified."""
        if not self.embeddings:
            return None, None
        from image_retrieval_tpu_torch.analysis.pair_mi import EnhancedPairMIAnalysis

        embeddings_list = list(self.embeddings.items())
        n = len(embeddings_list)
        analyzer = EnhancedPairMIAnalysis(embeddings_list, min(num_pairs, n * (n - 1) // 2),
                                          num_bins, keep_unnormalized)
        analyzer.generate_coco_pairs()
        return analyzer, analyzer.compute_mi_for_all_metrics()

    # -- visual placeholders (reference app_pipeline.py:242-276) --------------

    def create_mi_visualization(self, filename: str) -> str:
        return self._placeholder_plot(filename, "Standard MI Analysis")

    def create_enhanced_mi_visualization(self, filename: str) -> str:
        return self._placeholder_plot(filename, "Enhanced MI Analysis")

    def _placeholder_plot(self, filename: str, title: str) -> str:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.figure(figsize=(8, 6))
        if self.embeddings:
            plt.text(0.5, 0.5,
                     f"{title}\nEmbeddings loaded: {len(self.embeddings)}\n"
                     "Run analysis to see results",
                     ha="center", va="center", fontsize=12)
        else:
            plt.text(0.5, 0.5, f"{title}\nNo embeddings loaded",
                     ha="center", va="center", fontsize=14)
        plt.title(title)
        plt.axis("off")
        plt.savefig(filename, dpi=150, bbox_inches="tight")
        plt.close()
        return filename

    # -- multi-metric search --------------------------------------------------

    def search_with_multiple_metrics(self, query: str, top_k: int = 5) -> dict:
        """Top-k by cosine, L1 and L2 from one five-plane pass of the index
        (multi_metric_topk), their pairwise intersections and each one's
        unique contributions. Checks the index, not self.embeddings: after
        a journaled restart the rows live in the recovered index alone."""
        index = self._ensure_index()
        if index is None or len(index) == 0:
            return {"analysis": {"intersections": {}, "unique_contributions": {}}}
        q = self._get_query_embedding(query)
        paths = index.paths
        mm = index.multi_metric_topk(q, top_k=top_k)

        def top_entries(key, negate):
            vals, idx = mm[key]
            vals = np.atleast_2d(np.asarray(vals))[0]
            idx = np.atleast_2d(np.asarray(idx))[0]
            return [{"path": paths[int(i)], key: float(v), "score": float(-v if negate else v)}
                    for v, i in zip(vals, idx) if i >= 0 and np.isfinite(v)]

        results = {
            "cosine_similarity": top_entries("cosine_similarity", negate=False),
            "l1_distance": top_entries("l1_distance", negate=True),
            "l2_distance": top_entries("l2_distance", negate=True),
        }
        cp = set(r["path"] for r in results["cosine_similarity"])
        p1 = set(r["path"] for r in results["l1_distance"])
        p2 = set(r["path"] for r in results["l2_distance"])
        denom = top_k if top_k > 0 else 1
        intersections = {
            "cosine_vs_l1": {"intersection_size": len(cp & p1),
                             "intersection_ratio": len(cp & p1) / denom},
            "cosine_vs_l2": {"intersection_size": len(cp & p2),
                             "intersection_ratio": len(cp & p2) / denom},
            "l1_vs_l2": {"intersection_size": len(p1 & p2),
                         "intersection_ratio": len(p1 & p2) / denom},
        }
        allp = cp | p1 | p2
        na = len(allp) if allp else 1
        unique_contributions = {
            "cosine_similarity": {"unique_count": len(cp - p1 - p2),
                                  "unique_ratio": len(cp - p1 - p2) / na},
            "l1_distance": {"unique_count": len(p1 - cp - p2),
                            "unique_ratio": len(p1 - cp - p2) / na},
            "l2_distance": {"unique_count": len(p2 - cp - p1),
                            "unique_ratio": len(p2 - cp - p1) / na},
        }
        results["analysis"] = {"intersections": intersections,
                               "unique_contributions": unique_contributions}
        return results


def run_color_analysis(embeddings_file: str, dataset_dir: str, results_dir: str, *,
                       device: DeviceLike = "cuda"):
    """Compatibility entry (reference app_pipeline.py:393-400): the color
    analysis of an embeddings npz over a prepared dataset, results.json (and
    the plots, where matplotlib is installed) under `results_dir`."""
    from image_retrieval_tpu_torch.analysis.color_mi import analyze_color_embeddings

    return analyze_color_embeddings(embeddings_file, dataset_dir, results_dir, device=device)
