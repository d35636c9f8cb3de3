"""Resident exact vector index on one device — the port of
``image_retrieval_tpu/index/vector_index.py``'s float32 tier.

Rows are stored as (unit vector, magnitude), like the JAX index and the
Milvus schema it replaces. Host numpy buffers are the source of truth; the
device copy is refreshed lazily on the first search after a mutation, so N
inserts cost one upload. Search is one f32 product of the queries with the
unit rows, tombstones masked to -inf, and an exact top-k with lowest-index
ties (ops/topk.py) — the semantics of ``parallel/collectives.py``'s
``sharded_search_topk`` on one shard.

Not ported yet (each raises NotImplementedError; ROADMAP.md, queue 1): the
bf16/int8/int4 tiers, metrics other than cosine, attribute filters (flt=),
approximate selection, the streamed beyond-HBM tier and the journal.
"""

from __future__ import annotations

import functools
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from image_retrieval_tpu_torch.config import IndexConfig
from image_retrieval_tpu_torch.device import (
    DeviceLike,
    require_full_f32,
    resolve_device,
)
from image_retrieval_tpu_torch.ops.topk import exact_topk


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to image_retrieval_tpu_torch yet (see ROADMAP.md)")


def _locked(fn):
    """Serialize public index operations under the per-index RLock (a
    mutation mid-search would swap the device copy under the sweep)."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


def _cosine_scores(queries: torch.Tensor, unit_rows: torch.Tensor) -> torch.Tensor:
    """(Q, D) raw queries x (N, D) unit rows -> (Q, N) cosine, f32.

    <q, g> / ||q|| directly (the rows are unit norm); a zero-norm query
    scores 0 against every row (collectives.py:80-91)."""
    q = queries.to(torch.float32)
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    dots = q @ unit_rows.t()
    return torch.where(qn > 0, dots / torch.where(qn > 0, qn, 1.0), 0.0)


class ShardedVectorIndex:
    """Exact cosine index over (unit row, magnitude) pairs on `device`."""

    def __init__(self, dim: int = 512, config: Optional[IndexConfig] = None,
                 *, device: DeviceLike):
        self.config = config or IndexConfig(embedding_dim=dim)
        if self.config.dtype != "float32":
            raise _not_ported(f"IndexConfig.dtype={self.config.dtype!r}")
        if self.config.stream_threshold_bytes is not None:
            raise _not_ported("IndexConfig.stream_threshold_bytes (streamed tier)")
        if self.config.approx_select:
            raise _not_ported("IndexConfig.approx_select")
        self._lock = threading.RLock()
        self.dim = dim
        self.device = resolve_device(device)
        self.paths: List[str] = []
        self.count = 0
        self.capacity = 0
        self._host_gallery = None  # (capacity, D) f32 unit rows
        self._host_mags = None  # (capacity,) f32
        self._host_valid = None  # (capacity,) bool, False = tombstone/padding
        self._gallery = None  # (count, D) device copy
        self._valid = None  # (count,) device copy
        self._device_dirty = True

    # -- storage ------------------------------------------------------------

    def _grow_to(self, n: int) -> None:
        step = max(self.config.capacity_step, 1)
        cap = -(-n // step) * step
        if cap <= self.capacity:
            return
        g = np.zeros((cap, self.dim), np.float32)
        m = np.zeros((cap,), np.float32)
        v = np.zeros((cap,), bool)
        if self.count:
            g[: self.count] = self._host_gallery[: self.count]
            m[: self.count] = self._host_mags[: self.count]
            v[: self.count] = self._host_valid[: self.count]  # keep tombstones
        self.capacity = cap
        self._host_gallery, self._host_mags, self._host_valid = g, m, v
        self._device_dirty = True

    @_locked
    def insert(self, paths: Sequence[str], embeddings: np.ndarray,
               magnitudes: Optional[Sequence[float]] = None) -> int:
        """Bulk insert. Without `magnitudes`, rows may be unnormalized and
        are stored as (unit vector, magnitude); a zero row stays zero with
        magnitude 0. With `magnitudes`, rows are stored as given (already
        unit). Returns the number inserted."""
        emb = np.asarray(embeddings, np.float32)
        if emb.ndim == 1:
            emb = emb[None]
        if emb.shape[1] != self.dim:
            raise ValueError(f"insert(): rows of dim {emb.shape[1]}, index dim {self.dim}")
        if len(paths) != emb.shape[0]:
            raise ValueError(
                f"insert(): {len(paths)} paths for {emb.shape[0]} embedding rows")
        if magnitudes is None:
            mags = np.linalg.norm(emb, axis=1)
            unit = emb / np.where(mags > 0, mags, 1.0)[:, None]
        else:
            mags = np.asarray(magnitudes, np.float32)
            if mags.shape != (emb.shape[0],):
                raise ValueError(f"insert(): magnitudes shape {mags.shape} for "
                                 f"{emb.shape[0]} embedding rows")
            unit = emb
        n_new, start = emb.shape[0], self.count
        self._grow_to(start + n_new)
        self._host_gallery[start: start + n_new] = unit
        self._host_mags[start: start + n_new] = mags
        self._host_valid[start: start + n_new] = True
        self._device_dirty = True
        self.paths.extend(str(p) for p in paths)
        self.count += n_new
        return n_new

    @_locked
    def delete(self, paths: Sequence[str]) -> int:
        """Tombstone every live row whose path is in `paths`. Returns the
        number deleted."""
        targets = set(str(p) for p in paths)
        deleted = 0
        for i, p in enumerate(self.paths[: self.count]):
            if p in targets and self._host_valid[i]:
                self._host_valid[i] = False
                deleted += 1
        if deleted:
            self._device_dirty = True
        return deleted

    @_locked
    def delete_rows(self, row_indices) -> int:
        """Tombstone rows by global index; dead and out-of-range indices are
        ignored. Returns rows newly deleted."""
        idx = np.unique(np.asarray(row_indices, np.int64).ravel())
        idx = idx[(idx >= 0) & (idx < self.count)]
        idx = idx[self._host_valid[idx]] if self._host_valid is not None else idx
        if len(idx):
            self._host_valid[idx] = False
            self._device_dirty = True
        return int(len(idx))

    @property
    def live_count(self) -> int:
        if self._host_valid is None:
            return 0
        return int(self._host_valid[: self.count].sum())

    def _sync_device(self) -> None:
        if not self._device_dirty or self._host_gallery is None:
            return
        self._gallery = torch.from_numpy(self._host_gallery[: self.count]).to(self.device)
        self._valid = torch.from_numpy(self._host_valid[: self.count]).to(self.device)
        self._device_dirty = False

    @_locked
    def load(self) -> None:
        """Stage the gallery on the device (Milvus collection.load())."""
        self._sync_device()

    def release(self) -> None:
        pass

    @_locked
    def flush(self) -> None:
        """Durability barrier; a no-op without a journal (not ported)."""

    @classmethod
    def open(cls, journal_dir: str, **kwargs):
        """A journaled index (the JAX package's write-ahead log)."""
        raise _not_ported("ShardedVectorIndex.open (the journal)")

    def __len__(self) -> int:
        return self.count

    # -- search -------------------------------------------------------------

    @_locked
    def search(self, queries: np.ndarray, top_k: int = 5,
               metric: str = "cosine_similarity", flt=None,
               approx: Optional[bool] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k cosine. Returns numpy (scores (Q, k) f32, indices
        (Q, k) int32), or 1-D for a single 1-D query; k = min(top_k, live
        rows). Equal scores rank by ascending row index."""
        if self.count == 0:
            raise ValueError("index is empty")
        if metric == "cosine":
            metric = "cosine_similarity"
        if metric != "cosine_similarity":
            raise _not_ported(f"metric {metric!r}")
        if flt is not None:
            raise _not_ported("search(flt=) (attribute filters)")
        if approx:
            raise _not_ported("search(approx=True)")
        self._sync_device()
        q = np.asarray(queries, np.float32)
        single = q.ndim == 1
        if single:
            q = q[None]
        require_full_f32(self.device)  # the f32 tier's contract: full-f32 scores
        with torch.inference_mode():
            scores = _cosine_scores(torch.from_numpy(q).to(self.device), self._gallery)
            scores = scores.masked_fill(~self._valid, float("-inf"))
            vals, idx = exact_topk(scores, min(top_k, self.live_count))
            vals, idx = vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()
        if single:
            return vals[0], idx[0]
        return vals, idx

    @_locked
    def get_vectors(self, indices: Sequence[int]) -> np.ndarray:
        """Stored unit vectors for global indices."""
        return self._host_gallery[np.asarray(indices, int)].astype(np.float32)

    @_locked
    def get_magnitudes(self, indices: Sequence[int]) -> np.ndarray:
        return self._host_mags[np.asarray(indices, int)].astype(np.float32)

    @_locked
    def query(self, limit: int = 1000, with_magnitude: bool = False):
        """Stored (path, unit_embedding[, magnitude]) tuples of live rows."""
        if self.count == 0:
            return []
        live = np.flatnonzero(self._host_valid[: self.count])[:limit]
        rows = self._host_gallery[live]
        if with_magnitude:
            return [(self.paths[int(i)], rows[j], float(self._host_mags[i]))
                    for j, i in enumerate(live)]
        return [(self.paths[int(i)], rows[j]) for j, i in enumerate(live)]

    @_locked
    def reconstruct_original_embeddings(self, limit: int = 1000):
        """(path, unit * magnitude) round-trip."""
        return [(p, e * m) for p, e, m in self.query(limit, with_magnitude=True)]
