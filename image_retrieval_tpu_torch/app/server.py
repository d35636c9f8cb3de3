"""Micro-batching query server — port of ``image_retrieval_tpu/app/server.py``.

One gallery sweep serves a whole query batch at nearly the cost of one
query, so serving is a batching problem: the server collects concurrent
requests into micro-batches (up to `max_batch` or `max_wait_ms`, whichever
comes first) and runs one batched text encode and one batched exact search
per tick.

Usage:
    server = SearchServer(encoder, index)
    server.start()
    results = server.search("a brown dog", top_k=10)   # thread-safe
    server.stop()

A request names its metric (any the index searches by, or
"optimized_similarity" with the five weights) and an optional attribute
filter; a micro-batch is split into groups of equal (metric, weights,
filter), each one exact sweep of the index. Image queries
(``search_similar``) are encoded in the caller's thread and ride the same
sweeps, their own path excluded. Live ingest and delete (``add_images``,
``remove_images``) change the serving index in place and call its
``flush()`` before they return, so with a journaled index
(``ShardedVectorIndex.open``) an acknowledged insert or delete survives a
crash. ``approx`` (per request, or the server's ``approx_select``) is
accepted and the answers are exact (the index's ``approx_select``). With
``ann=`` (an IVFIndex or a ScreenedSearch over the same rows) unfiltered
cosine and optimized requests take overfetched candidates from that tier,
reranked exactly. An IVF follows mutations: ``add_images`` hands it the new
rows (its exactly swept tail), and after ``remove_images`` its candidates of
deleted rows are dropped. A tier without ``add`` (the screen) cannot follow
a mutation, so ``add_images`` / ``remove_images`` detach it before they
change the index, and serving falls back to the exact sweep; a batch that
took it just before is served by the exact sweep too: the tier's staleness
is checked under the index's lock.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.models.encoder import Encoder
from image_retrieval_tpu_torch.ops.metrics import WEIGHT_KEYS

logger = logging.getLogger(__name__)


@dataclass
class _Request:
    query: str
    top_k: int
    metric: str = "cosine_similarity"
    weights: Optional[tuple] = None  # (w_angle, w_l1, w_l2, w_inf, w_mag)
    flt: Optional[str] = None  # boolean attribute expression (index/filters.py)
    # image queries arrive embedded (search_similar): they skip the batch's
    # text encode but share its sweeps
    embedding: Optional[np.ndarray] = None
    exclude_path: Optional[str] = None  # the query image's own row
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[dict]] = None
    error: Optional[Exception] = None


class SearchServer:
    """Thread-safe text-search server with request micro-batching."""

    def __init__(self, encoder: Encoder, index: ShardedVectorIndex,
                 max_batch: int = 64, max_wait_ms: float = 2.0, ann=None,
                 overfetch: int = 3, approx_select: Optional[bool] = None):
        """`ann`: an ANN tier over the same rows (an IVFIndex or a
        ScreenedSearch), whose overfetched (x `overfetch`) candidates serve
        unfiltered cosine and optimized requests. `approx_select` (and a request's `approx`):
        accepted; the answers are exact."""
        self.encoder = encoder
        self.index = index
        self.ann = ann
        self.overfetch = overfetch
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.stats: Dict[str, float] = {
            "requests": 0, "batches": 0, "max_observed_batch": 0,
            "groups": 0,  # index sweeps: one per (metric, weights, filter) of a batch
        }

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None:
            return
        self.index.load()  # stage the gallery on the device before serving
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        # _stop first, so _enqueue fails fast from here on and the drain
        # below cannot race a later put
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
        while True:  # fail requests still queued instead of timing them out
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            req.error = RuntimeError("server stopped")
            req.done.set()

    def _enqueue(self, req: _Request) -> None:
        if self._stop.is_set():
            raise RuntimeError("server stopped")
        self._queue.put(req)
        if self._stop.is_set() and not req.done.is_set():
            # stop() may have drained between the check and the put
            req.error = RuntimeError("server stopped")
            req.done.set()

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- live ingest ---------------------------------------------------------

    def add_images(self, image_paths: Sequence, batch_size: Optional[int] = None,
                   attrs_fn=None):
        """Live ingest: decode, embed and insert into the serving index
        without a restart. In-flight micro-batches are safe through the
        index's lock; the rows appear from the next batch after the insert.
        The index is flushed before this returns (the durability barrier of
        a journaled index). Returns (inserted, failed)."""
        from image_retrieval_tpu_torch.app.embed import ImageEmbeddingSystem

        image_paths = list(image_paths)
        if image_paths and not hasattr(self.ann, "add"):
            self._detach_ann("insertions")
        emb = ImageEmbeddingSystem(self.encoder, index=self.index, attrs_fn=attrs_fn)
        start = len(self.index)
        ok, failed = emb.process_and_store_images(image_paths, batch_size=batch_size)
        ann = self.ann
        if ann is not None and ok:
            # an IVF follows: the new rows go to its exactly swept tail, under
            # the index's lock that its searches take
            with self.index._lock:
                ann.add(self.index.get_vectors(range(start, start + ok)))
        self.index.flush()
        self.stats["ingested"] = self.stats.get("ingested", 0) + ok
        return ok, failed

    def remove_images(self, image_paths: Sequence) -> int:
        """Live delete: tombstone every row of these paths (the sweeps mask
        tombstones; an attached IVF stays, its candidates of deleted rows are
        dropped), flushed before this returns, so an acknowledged delete does
        not come back after a restart. Returns rows deleted."""
        image_paths = list(image_paths)
        if image_paths and not hasattr(self.ann, "add"):
            self._detach_ann("deletions")
        n = self.index.delete(image_paths)
        if n:
            self.index.flush()
        self.stats["removed"] = self.stats.get("removed", 0) + n
        return n

    def _detach_ann(self, what: str) -> None:
        """A tier without ``add`` (a ScreenedSearch) goes stale on a mutation
        and would raise on every later search: serve from the exact sweep."""
        ann, self.ann = self.ann, None
        if ann is not None:
            logger.warning("the ANN tier (%s) cannot follow %s; detached: serving falls "
                           "back to the exact sweep (rebuild and re-attach it)",
                           type(ann).__name__, what)

    def _ann_search(self, ann, q_unit, q_in, k, metric, params):
        """Two-phase serving through the ANN tier `ann`: k x overfetch
        cosine candidates, rows tombstoned since the tier was built dropped,
        the optimized metric reranked exactly on the host. Padding slots
        come back as (-inf, -1), which the result builder skips. None when
        the index has changed since the tier was built (the caller sweeps
        exactly); the index's lock keeps a mutation out until the
        candidates are read."""
        from image_retrieval_tpu_torch.app.search import _all_metrics_rows, _optimized_rows

        with self.index._lock:
            if getattr(ann, "stale", False):
                return None
            limit = min(k * self.overfetch, len(self.index))
            cos, cand = ann.search(q_unit, top_k=limit)
            live = self.index.live_mask()
        if len(live):
            dead = (cand >= 0) & ~live[np.clip(cand, 0, len(live) - 1)]
            cos = np.where(dead, -np.inf, cos)
            cand = np.where(dead, -1, cand)
        width = min(k, limit)
        vals = np.full((len(q_unit), width), -np.inf, np.float32)
        idx = np.full((len(q_unit), width), -1, np.int64)
        for r in range(len(q_unit)):
            cr = cand[r][cand[r] >= 0]
            if metric == "cosine_similarity":
                m = min(width, len(cr))
                vals[r, :m], idx[r, :m] = cos[r][cand[r] >= 0][:m], cr[:m]
            elif len(cr):
                rows = self.index.get_vectors(cr) * self.index.get_magnitudes(cr)[:, None]
                s = _optimized_rows(_all_metrics_rows(q_in[r], rows), params or {})
                order = np.argsort(-s, kind="stable")[:width]
                vals[r, : len(order)], idx[r, : len(order)] = s[order], cr[order]
        return vals, idx

    # -- client API ----------------------------------------------------------

    @staticmethod
    def _weights(weights: Optional[dict]) -> Optional[tuple]:
        """The request's hashable weights: the index's 5-tuple, or None."""
        return None if weights is None else ShardedVectorIndex._weights_tuple(weights)

    def _wait(self, req: _Request, timeout: float) -> List[dict]:
        self._enqueue(req)
        if not req.done.wait(timeout):
            raise TimeoutError(f"search timed out after {timeout}s")
        if req.error is not None:
            raise req.error
        return req.result

    def search(self, query: str, top_k: int = 10, timeout: float = 30.0,
               metric: str = "cosine_similarity", weights: Optional[dict] = None,
               flt: Optional[str] = None, approx: Optional[bool] = None) -> List[dict]:
        """Blocking search; safe to call from many threads concurrently.
        Returns [{'path', 'score'}] best first.

        metric: "cosine_similarity" (default), another metric of the index,
        or "optimized_similarity" with the 5-weight params dict `weights`.
        flt: boolean attribute expression (index/filters.py); requests with
        the same filter share a micro-batch group and the cached mask.
        approx: accepted; the answers are exact."""
        return self._wait(_Request(query=query, top_k=top_k, metric=metric,
                                   weights=self._weights(weights), flt=flt), timeout)

    def search_similar(self, image, top_k: int = 10, timeout: float = 30.0,
                       metric: str = "cosine_similarity",
                       weights: Optional[dict] = None, exclude_self: bool = True,
                       flt: Optional[str] = None,
                       approx: Optional[bool] = None) -> List[dict]:
        """Image-query search: encode `image` (a path or (H, W, 3) pixels)
        in the calling thread, then ride the micro-batched sweeps like a
        text request. A gallery path equal to the query path (or the same
        file by real path) is dropped from its own results unless
        exclude_self=False."""
        exclude = None
        if isinstance(image, (str, bytes)) or hasattr(image, "__fspath__"):
            path = os.fsdecode(image)
            emb = self.encoder.encode_images([path])[0]
            if exclude_self:
                exclude = path
        else:
            pixels = np.asarray(image)
            if pixels.ndim != 3:
                raise ValueError(
                    f"expected a path or (H, W, 3) pixels, got shape {pixels.shape}")
            emb = self.encoder.encode_pixels(pixels[None])[0]
        return self._wait(_Request(query="", top_k=top_k, metric=metric,
                                   weights=self._weights(weights), flt=flt,
                                   embedding=np.asarray(emb, np.float32),
                                   exclude_path=exclude), timeout)

    def search_many(self, queries: Sequence[str], top_k: int = 10,
                    timeout: float = 30.0, metric: str = "cosine_similarity",
                    weights: Optional[dict] = None, flt: Optional[str] = None,
                    approx: Optional[bool] = None) -> List[List[dict]]:
        """Enqueue all queries before waiting, so they share micro-batches.
        Results are in input order; per-request errors re-raise."""
        wt = self._weights(weights)
        reqs = [_Request(query=q, top_k=top_k, metric=metric, weights=wt, flt=flt)
                for q in queries]
        for r in reqs:
            self._enqueue(r)
        deadline = time.perf_counter() + timeout
        out = []
        for r in reqs:
            if not r.done.wait(max(deadline - time.perf_counter(), 0.0)):
                raise TimeoutError(f"batch search timed out after {timeout}s")
            if r.error is not None:
                raise r.error
            out.append(r.result)
        return out

    # -- batching loop -------------------------------------------------------

    def _collect(self) -> List[_Request]:
        try:
            first = self._queue.get(timeout=0.05)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.perf_counter() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self._queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    @staticmethod
    def _ann_serves(ann, metric: str, flt) -> bool:
        """Whether the ANN tier `ann` answers a request: unfiltered cosine
        and optimized ones (the tiers see no attribute columns)."""
        return (ann is not None and flt is None
                and metric in ("cosine_similarity", "optimized_similarity"))

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                # one batched text encode per batch; image queries arrive
                # embedded and slot straight in
                text_rows = [i for i, r in enumerate(batch) if r.embedding is None]
                parts = [r.embedding for r in batch]
                if text_rows:
                    tembs = self.encoder.encode_texts([batch[i].query for i in text_rows])
                    for row, i in enumerate(text_rows):
                        parts[i] = np.asarray(tembs[row])
                embs = np.stack(parts).astype(np.float32)
                norms = np.linalg.norm(embs, axis=1, keepdims=True)
                qn = embs / np.where(norms > 0, norms, 1.0)
                # one index sweep per (metric, weights, filter) group
                groups: Dict[tuple, List[int]] = {}
                for i, r in enumerate(batch):
                    groups.setdefault((r.metric, r.weights, r.flt), []).append(i)
                ann = self.ann  # one read a batch: add_images may detach it
                for (metric, weights, flt), rows in groups.items():
                    self.stats["groups"] += 1
                    try:
                        # one more for a request that drops its own row
                        k = max(batch[i].top_k + (batch[i].exclude_path is not None)
                                for i in rows)
                        # the optimized metric scores the unnormalized query
                        q_in = embs[rows] if metric == "optimized_similarity" else qn[rows]
                        params = dict(zip(WEIGHT_KEYS, weights)) if weights is not None else None
                        got = (self._ann_search(ann, qn[rows], q_in, k, metric, params)
                               if self._ann_serves(ann, metric, flt) else None)
                        vals, idx = got if got is not None else self.index.search(
                            q_in, top_k=min(k, len(self.index)), metric=metric,
                            params=params, flt=flt)
                        for row, i in enumerate(rows):
                            r = batch[i]
                            hits = []
                            for v, j in zip(vals[row], idx[row]):
                                if j < 0:  # a filter's short tail: fewer hits
                                    continue
                                p = self.index.paths[int(j)]
                                if r.exclude_path is not None and (
                                        p == r.exclude_path
                                        or os.path.realpath(p)
                                        == os.path.realpath(r.exclude_path)):
                                    continue
                                hits.append({"path": p, "score": float(v)})
                                if len(hits) >= r.top_k:
                                    break
                            r.result = hits
                            r.done.set()
                    except Exception as e:
                        # a bad metric/weights group fails only its own requests
                        logger.exception("group failed")
                        for i in rows:
                            batch[i].error = e
                            batch[i].done.set()
                self.stats["requests"] += len(batch)
                self.stats["batches"] += 1
                self.stats["max_observed_batch"] = max(
                    self.stats["max_observed_batch"], len(batch))
            except Exception as e:  # surfaced to every caller of the batch
                logger.exception("batch failed")
                for r in batch:
                    r.error = e
                    r.done.set()
