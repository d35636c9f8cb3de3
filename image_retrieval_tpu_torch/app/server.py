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

Scores are exact cosine over the index. Not ported yet (ROADMAP.md): the
IVF candidate path (ann=), live ingest and delete, image queries, other and
weighted metrics, filters and approximate selection.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.models.encoder import Encoder

logger = logging.getLogger(__name__)


@dataclass
class _Request:
    query: str
    top_k: int
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[List[dict]] = None
    error: Optional[Exception] = None


class SearchServer:
    """Thread-safe text-search server with request micro-batching."""

    def __init__(self, encoder: Encoder, index: ShardedVectorIndex,
                 max_batch: int = 64, max_wait_ms: float = 2.0, ann=None):
        if ann is not None:
            raise NotImplementedError(
                "ann= (IVF candidates) is not ported yet (see ROADMAP.md)")
        self.encoder = encoder
        self.index = index
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.stats: Dict[str, float] = {
            "requests": 0, "batches": 0, "max_observed_batch": 0,
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

    # -- client API ----------------------------------------------------------

    def search(self, query: str, top_k: int = 10, timeout: float = 30.0) -> List[dict]:
        """Blocking search; safe to call from many threads concurrently.
        Returns [{'path', 'score'}] best first."""
        req = _Request(query=query, top_k=top_k)
        self._enqueue(req)
        if not req.done.wait(timeout):
            raise TimeoutError(f"search timed out after {timeout}s")
        if req.error is not None:
            raise req.error
        return req.result

    def search_many(self, queries: Sequence[str], top_k: int = 10,
                    timeout: float = 30.0) -> List[List[dict]]:
        """Enqueue all queries before waiting, so they share micro-batches.
        Results are in input order; per-request errors re-raise."""
        reqs = [_Request(query=q, top_k=top_k) for q in queries]
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

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if not batch:
                continue
            try:
                # one batched text encode and one gallery sweep per batch
                embs = np.asarray(self.encoder.encode_texts([r.query for r in batch]),
                                  np.float32)
                norms = np.linalg.norm(embs, axis=1, keepdims=True)
                qn = embs / np.where(norms > 0, norms, 1.0)
                k = max(r.top_k for r in batch)
                vals, idx = self.index.search(qn, top_k=min(k, len(self.index)))
                for row, r in enumerate(batch):
                    r.result = [
                        {"path": self.index.paths[int(j)], "score": float(v)}
                        for v, j in zip(vals[row][: r.top_k], idx[row][: r.top_k])
                    ]
                    r.done.set()
                self.stats["requests"] += len(batch)
                self.stats["batches"] += 1
                self.stats["max_observed_batch"] = max(
                    self.stats["max_observed_batch"], len(batch))
            except Exception as e:  # surfaced to every caller of the batch
                logger.exception("batch failed")
                for r in batch:
                    r.error = e
                    r.done.set()
