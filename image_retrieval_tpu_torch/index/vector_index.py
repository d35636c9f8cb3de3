"""Resident vector index sharded over a mesh of devices — the port of
``image_retrieval_tpu/index/vector_index.py``'s resident tiers.

Rows are stored as (unit vector, magnitude), like the JAX index and the
Milvus schema it replaces. Host numpy buffers are the source of truth; the
device copy is refreshed lazily on the first search after a mutation, so N
inserts cost one upload. The device rows split in equal blocks over the
mesh's ``IndexConfig.shard_axis`` (``parallel/mesh.py``; a mesh with a
``slice`` axis shards over ('slice', 'data') and merges hierarchically), and
every search runs ``parallel/collectives.py``'s per-shard sweep and k-sized
merge. ``ShardedVectorIndex()`` spans every visible card; ``device=`` names
one device, ``mesh=`` any mesh. Save files and journals do not depend on
the mesh: a file saved on one mesh reopens on another with the same
answers. ``IndexConfig.dtype`` picks the storage tier:

- ``float32``: f32 queries x f32 unit rows (full f32: TF32 is refused).
- ``bfloat16``: rows stored in bf16 (the host keeps their bit patterns);
  f32 queries x rows upcast to f32.
- ``int8``: symmetric per-row int8 with norm-preserving scales; the unit
  query rounded to bf16 x the int8 rows, f32 sums, x the row's scale.
- ``int4``, the capacity tier: the device holds only the nibble-packed rows,
  their int4 scales and the valid mask (a quarter of f32's bytes per row);
  the int8 rows stay in host RAM. Search is two-phase: the int4 screen
  (the Hopper kernel of ``ops/int4_screen.py``) selects ``rerank_c``
  candidates per query, whose int8 rows are gathered on the host and
  reranked exactly on the device. ``rerank_device=True`` (latency mode)
  also keeps the int8 rows on the device and gathers there.

``approx_select`` (or ``search(approx=True)``) and ``l1_shadow`` are
accepted, journaled and saved, so configurations and journals of the JAX
package open, and they change nothing: off a TPU the JAX package's
approximate selector is exact, and its bf16 shadow gives the int8 weighted
scores bit for bit, far slower than the kernel does
(``parallel/collectives.py``).

Past ``stream_threshold_bytes`` of device rows the int8 and int4 tiers
stream: the rows stay in host RAM (pinned) and every cosine search sweeps
them through the mesh's first device in chunks (``index/streaming.py``;
int4 chunks through the int4 screen kernel, then the exact rerank from the
host int8 rows). The streamed tier is cosine-only: other metrics, ``multi_metric_topk`` and
``scores`` raise ValueError there. A compact that brings the gallery back
under the threshold returns it to the resident tier.

Every tier takes attribute filters (``flt=``, ``index/filters.py``): the
filter mask replaces the valid mask; when fewer rows match than top_k, the
tail pads with (-inf, -1). Tombstoned and filtered rows score -inf before
an exact top-k with lowest-index ties (``ops/topk.py``), the semantics of
``parallel/collectives.py``'s ``sharded_search_topk`` on one shard.

The f32, bf16 and int8 tiers search by every metric of ``ops/metrics.py``
and by ``optimized_similarity`` (the weighted combination, against the
magnitude-reconstructed rows), return all five metrics' top-k from one pass
(``multi_metric_topk``) and full score matrices (``scores``); ascending
metrics pad with (+inf, -1). The sweeps are ``parallel/collectives.py``'s:
on the card the int8 tier's weighted score and the multi-metric planes run
through the hand-written kernels of ``ops/fused_metrics.py``. The int4 tier
is cosine-only and raises ValueError for the rest.

Persistence keeps the JAX package's on-disk formats, so a saved index or
a journal directory written by either package reopens in the other:
``save`` writes the rows as portable f32 (dequantized) in an npz with JSON
sidecars (paths, attributes, the tier configuration, ``meta``) and
``load_from`` re-tiers them per the saved configuration; ``open`` attaches
the write-ahead journal of ``index/journal.py`` (``ops.jsonl``,
``seg-<seq>.npz``, ``snap-<seq>/``, ``CURRENT``): every mutation is logged,
``flush`` is the durability barrier and ``checkpoint`` seals the log into a
snapshot.
"""

from __future__ import annotations

import dataclasses
import errno
import functools
import json
import logging
import os
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from image_retrieval_tpu_torch.config import IndexConfig
from image_retrieval_tpu_torch.device import DeviceLike, require_full_f32
from image_retrieval_tpu_torch.index.filters import AttributeStore, parse_filter
from image_retrieval_tpu_torch.ops.int4 import quantize_pack_int4, rerank_int8_topk, unit_queries
from image_retrieval_tpu_torch.ops.metrics import WEIGHT_KEYS
from image_retrieval_tpu_torch.parallel.collectives import (
    multislice_search_topk,
    sharded_int4_screen_topk,
    sharded_int4_two_phase_topk,
    sharded_multimetric_topk,
    sharded_scores,
    sharded_search_topk,
)
from image_retrieval_tpu_torch.parallel.mesh import (
    Mesh,
    axis_size,
    entry_mesh,
    shard_devices,
    shard_rows,
)

logger = logging.getLogger(__name__)

DTYPES = ("float32", "bfloat16", "int8", "int4")
# Rows per task of the host quantization. Every step of it is row-wise, so
# its bits do not depend on how the rows are split; a large insert spreads
# the tasks over the host's cores (numpy releases the GIL in its loops).
# Tasks of 2^13 rows keep a task's temporaries (16 MiB at D = 512) in the
# allocator's reused memory instead of fresh pages for every task.
QUANT_ROWS = 1 << 13


def _config_from_saved(saved: dict) -> IndexConfig:
    """IndexConfig from a persisted dict, ignoring unknown keys (a config
    saved by a newer version); shared by journal recovery and load_from."""
    known = {fl.name for fl in dataclasses.fields(IndexConfig)}
    return IndexConfig(**{k: v for k, v in saved.items() if k in known})


def _locked(fn):
    """Serialize public index operations under the per-index RLock (a
    mutation mid-search would swap the device copy under the sweep)."""

    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)

    return wrapper


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """f32 -> bf16 bit patterns (uint16), round to nearest even."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().view(np.uint16)


def bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bf16 bit patterns (uint16) -> f32, exactly."""
    return (np.asarray(bits, np.uint16).astype(np.uint32) << 16).view(np.float32)


def quantize_int8(unit: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-row int8 on the absmax/127 grid, with the
    norm-preserving scale ||int8 row|| * scale == ||unit row||, exactly as
    the JAX index's insert computes it. Returns (int8 rows, f32 scales)."""
    t = np.abs(unit)
    absmax = np.maximum(t.max(axis=1), 1e-12)
    grid = (absmax / 127.0).astype(np.float32)
    # the grid values, rounded and clipped, in place in one f32 buffer: they
    # are the int8 rows exactly, so their norm is the int8 rows' norm
    np.divide(unit, grid[:, None], out=t)
    np.clip(np.rint(t, out=t), -127, 127, out=t)
    qnorm = np.linalg.norm(t, axis=1)
    unorm = np.linalg.norm(unit, axis=1)
    return t.astype(np.int8), (unorm / np.where(qnorm > 0, qnorm, 1.0)).astype(np.float32)


def _host_zeros(shape, dtype, pinned: bool) -> np.ndarray:
    """A zeroed host array, in pinned memory when `pinned`."""
    if not pinned:
        return np.zeros(shape, dtype)
    from image_retrieval_tpu_torch.index.streaming import pinned_empty

    out = pinned_empty(shape, dtype)
    out.fill(0)
    return out


class ShardedVectorIndex:
    """Exact multi-metric index over (unit row, magnitude) pairs, row-sharded
    over `mesh` (every visible card unless the caller names a `device`, a
    one-device mesh, or a mesh; never both)."""

    def __init__(self, dim: int = 512, config: Optional[IndexConfig] = None,
                 *, device: Optional[DeviceLike] = None, mesh: Optional[Mesh] = None):
        self.config = config or IndexConfig(embedding_dim=dim)
        if self.config.dtype not in DTYPES:
            raise ValueError(f"IndexConfig.dtype={self.config.dtype!r}: one of {DTYPES}")
        if self.config.dtype == "int4" and dim % 2:
            raise ValueError(f"the int4 tier packs dim pairs: dim {dim} is odd")
        self._lock = threading.RLock()
        # the write-ahead journal (index/journal.py), attached by open();
        # _replaying keeps operations applied from it out of it
        self._journal = None
        self._replaying = False
        self.dim = dim
        self.mesh = entry_mesh(device, mesh)
        self.device = self.mesh.first  # merges, the host rerank, the streamed tier
        self.axis = self.config.shard_axis
        # multi-slice mode: a mesh with a "slice" axis shards rows over
        # (slice, data) and merges each slice's shards before the slices
        self._multislice = ("slice" in self.mesh.axis_names
                            and self.axis in self.mesh.axis_names)
        self._row_axes = ("slice", self.axis) if self._multislice else self.axis
        self._nshards = axis_size(self.mesh, self._row_axes)
        self.paths: List[str] = []
        # small JSON metadata that survives save() and journal recovery
        # without rows behind it (e.g. the Milvus shim's partition names)
        self.meta: Dict[str, object] = {}
        self.count = 0
        self.capacity = 0
        self._host_gallery = None  # (capacity, D): f32, bf16 bits, or int8
        self._host_mags = None  # (capacity,) f32
        self._host_valid = None  # (capacity,) bool, False = tombstone/padding
        self._host_scales = None  # (capacity,) f32, int8/int4 tiers
        self._host_packed = None  # (capacity, D/2) uint8, int4 tier only
        self._host_scales4 = None  # (capacity,) f32, int4 tier only
        # the device copies, each a list of row shards in shard order over
        # the first count rows rounded up to the shard count (_device_rows;
        # the padding rows are invalid); the streamed tier's valid mask is
        # one tensor on self.device
        self._gallery = None  # (rows, D) (int4: latency mode only)
        self._valid = None  # (rows,) bool
        self._mags = None  # (rows,) f32 (not in the int4 tier)
        self._scales = None  # (rows,) f32, int8 (and int4 latency mode)
        self._packed = None  # (rows, D/2) uint8, int4 tier
        self._scales4 = None  # (rows,) f32, int4 tier
        self._device_dirty = True
        # the streamed tier (stream_threshold_bytes): the engine over views
        # of the host rows
        self._stream = None
        # bumps on every mutation; the filter-mask cache and live_count key on it
        self.generation = 0
        self._live = (-1, 0)  # (generation, live rows)
        self.attrs = AttributeStore()
        # expression -> (generation, device mask): repeated serving traffic
        # with the same filter reuses the mask
        self._filter_cache: Dict[str, Tuple[int, torch.Tensor]] = {}

    # -- storage ------------------------------------------------------------

    @property
    def _np_dtype(self):
        if self.config.dtype == "bfloat16":
            return np.uint16  # bf16 bit patterns (numpy has no bf16)
        if self.config.dtype in ("int8", "int4"):
            # int4 keeps the HOST rows at int8: the exact-rerank source
            return np.int8
        return np.float32

    @property
    def _quantized(self) -> bool:
        return self.config.dtype in ("int8", "int4")

    @property
    def _packed4(self) -> bool:
        return self.config.dtype == "int4"

    def _grow_to(self, n: int) -> None:
        step = max(self.config.capacity_step, self._nshards)
        cap = -(-n // step) * step
        # capacity splits evenly over the shards
        cap = -(-cap // self._nshards) * self._nshards
        if cap <= self.capacity:
            return
        # the rows the streamed tier would stream live in pinned host memory
        # on the card's index: they then upload without a copy
        pin = self.config.stream_threshold_bytes is not None and self.device.type == "cuda"
        g = _host_zeros((cap, self.dim), self._np_dtype,
                        pin and self.config.dtype == "int8")
        m = np.zeros((cap,), np.float32)
        v = np.zeros((cap,), bool)
        sc = np.ones((cap,), np.float32) if self._quantized else None
        pk = _host_zeros((cap, self.dim // 2), np.uint8, pin) if self._packed4 else None
        sc4 = np.ones((cap,), np.float32) if self._packed4 else None
        if self.count:
            g[: self.count] = self._host_gallery[: self.count]
            m[: self.count] = self._host_mags[: self.count]
            v[: self.count] = self._host_valid[: self.count]  # keep tombstones
            if self._quantized:
                sc[: self.count] = self._host_scales[: self.count]
            if self._packed4:
                pk[: self.count] = self._host_packed[: self.count]
                sc4[: self.count] = self._host_scales4[: self.count]
        self.capacity = cap
        self._host_gallery, self._host_mags, self._host_valid = g, m, v
        self._host_scales = sc
        self._host_packed, self._host_scales4 = pk, sc4
        self._device_dirty = True

    @_locked
    def insert(self, paths: Sequence[str], embeddings: np.ndarray,
               magnitudes: Optional[Sequence[float]] = None,
               attrs: Optional[Dict[str, Sequence]] = None) -> int:
        """Bulk insert. Without `magnitudes`, rows may be unnormalized and
        are stored as (unit vector, magnitude); a zero row stays zero with
        magnitude 0. With `magnitudes`, rows are stored as given (already
        unit). `attrs` maps a field name to one scalar per row (str or
        number) for filtered search. Returns the number inserted."""
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
        # validates and commits the attributes before the gallery mutates
        self.attrs.append(attrs, emb.shape[0])
        n_new, start = emb.shape[0], self.count
        self._grow_to(start + n_new)
        new = slice(start, start + n_new)
        if self._quantized:
            self._quantize_into(unit, start)
        elif self.config.dtype == "bfloat16":
            self._host_gallery[new] = bf16_bits(unit)
        else:
            self._host_gallery[new] = unit
        self._host_mags[new] = mags
        self._host_valid[new] = True
        self._device_dirty = True
        self.generation += 1
        self.paths.extend(str(p) for p in paths)
        self.count += n_new
        if self._journal is not None and not self._replaying:
            # the (unit, mags) form: replaying it through insert()
            # re-quantizes identically for every tier
            self._journal.log_insert(paths, unit, mags, attrs)
        return n_new

    def _quantize_into(self, unit: np.ndarray, start: int) -> None:
        """int8 rows and scales (and, for int4, an independent int4
        quantization of the same unit rows: the device screen, while the
        int8 rows are the rerank source) of `unit`, written from row
        `start` on, QUANT_ROWS rows per task."""

        def task(lo: int) -> None:
            u = unit[lo: lo + QUANT_ROWS]
            at = slice(start + lo, start + lo + u.shape[0])
            self._host_gallery[at], self._host_scales[at] = quantize_int8(u)
            if self._packed4:
                self._host_packed[at], self._host_scales4[at] = quantize_pack_int4(u)

        spans = range(0, unit.shape[0], QUANT_ROWS)
        if len(spans) <= 1:
            for lo in spans:
                task(lo)
            return
        with ThreadPoolExecutor(min(len(spans), os.cpu_count() or 1)) as pool:
            for done in [pool.submit(task, lo) for lo in spans]:
                done.result()

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
            self.generation += 1
            if self._journal is not None and not self._replaying:
                self._journal.log_delete(paths)
        return deleted

    @_locked
    def delete_where(self, flt) -> int:
        """Tombstone every live row matching a boolean attribute expression
        (Milvus `collection.delete(expr)`). Returns rows deleted."""
        return self.delete_rows(np.flatnonzero(self.filter_mask(flt)))

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
            self.generation += 1
            if self._journal is not None and not self._replaying:
                self._journal.log_delete_rows(idx)
        return int(len(idx))

    @_locked
    def filter_mask(self, flt) -> np.ndarray:
        """(count,) bool: live rows matching the filter, a boolean
        expression string (index/filters.py) or a precomputed (count,) bool
        mask."""
        if isinstance(flt, np.ndarray):
            if flt.shape != (self.count,):
                raise ValueError(f"filter mask shape {flt.shape} != ({self.count},)")
            mask = flt.astype(bool, copy=True)
        else:
            mask = self.attrs.evaluate(parse_filter(flt), self.count)
        if self._host_valid is not None:
            mask = mask & self._host_valid[: self.count]
        return mask

    def _device_rows(self) -> int:
        """Rows of the device copy: count rounded up to the shard count."""
        return -(-self.count // self._nshards) * self._nshards

    def _shard(self, a: np.ndarray) -> List[torch.Tensor]:
        """The first _device_rows() rows of a host buffer, row-sharded over
        the mesh."""
        return shard_rows(a[: self._device_rows()], self.mesh, self._row_axes)

    def _filtered_valid(self, flt) -> List[torch.Tensor]:
        """Sharded device mask (filter AND live), a drop-in for the valid
        mask. Expression strings are cached per (expression, generation);
        mask arrays are shipped fresh each call."""
        key = flt if isinstance(flt, str) else None
        if key is not None:
            hit = self._filter_cache.get(key)
            if hit is not None and hit[0] == self.generation:
                return hit[1]
        full = np.zeros((self._device_rows(),), bool)
        full[: self.count] = self.filter_mask(flt)
        dev = self._shard(full)
        if key is not None:
            if len(self._filter_cache) >= 16:  # bound device-mask memory
                self._filter_cache.pop(next(iter(self._filter_cache)))
            self._filter_cache[key] = (self.generation, dev)
        return dev

    @property
    def live_count(self) -> int:
        """Rows not tombstoned; counted once per generation (a search reads
        it, and summing 8M flags costs ~5 ms of host time)."""
        if self._host_valid is None:
            return 0
        if self._live[0] != self.generation:
            self._live = (self.generation, int(np.count_nonzero(self._host_valid[: self.count])))
        return self._live[1]

    def live_mask(self) -> np.ndarray:
        """(count,) bool, True for non-tombstoned rows."""
        if self._host_valid is None:
            return np.zeros((0,), bool)
        return self._host_valid[: self.count].copy()

    @_locked
    def compact(self) -> int:
        """Reclaim tombstoned rows in place: live rows slide down, paths,
        attributes and per-row sidecars stay aligned. Returns rows
        reclaimed."""
        if self._host_valid is None:
            return 0
        live = np.flatnonzero(self._host_valid[: self.count])
        reclaimed = self.count - len(live)
        if reclaimed == 0:
            return 0
        keep = slice(0, len(live))
        self._host_gallery[keep] = self._host_gallery[live]
        self._host_mags[keep] = self._host_mags[live]
        if self._quantized:
            self._host_scales[keep] = self._host_scales[live]
        if self._packed4:
            self._host_packed[keep] = self._host_packed[live]
            self._host_scales4[keep] = self._host_scales4[live]
        self._host_valid[:] = False
        self._host_valid[keep] = True
        self.paths = [self.paths[int(i)] for i in live]
        self.attrs.take(live)
        self.count = len(live)
        self._device_dirty = True
        self.generation += 1
        if self._journal is not None and not self._replaying:
            self._journal.log_compact()
        return reclaimed

    def _warn_if_too_big(self) -> None:
        """Latency mode holds the packed rows, the int8 rows and their
        scales: warn when a card's shards exceed its free memory."""
        per_shard = self._device_rows() // self._nshards * (self.dim // 2 + self.dim + 9)
        held: Dict[torch.device, int] = {}
        for d in shard_devices(self.mesh, self._row_axes):
            held[d] = held.get(d, 0) + per_shard
        for d, need in held.items():
            if d.type != "cuda":
                continue
            free, _ = torch.cuda.mem_get_info(d)
            if need > free:
                logger.warning(
                    "rerank_device: ~%.1f GiB of rows exceeds the %.1f GiB free on %s; "
                    "expect an out-of-memory error; use the capacity configuration "
                    "(rerank_device=False) or more devices", need / (1 << 30),
                    free / (1 << 30), d)

    def _stream_active(self) -> bool:
        """Whether the stored device rows exceed stream_threshold_bytes: the
        int8 rows, or for int4 the packed rows (plus the int8 rows in
        latency mode). A compacted gallery that fits again is resident."""
        thr = self.config.stream_threshold_bytes
        if thr is None or self._host_gallery is None:
            return False
        if self._packed4:
            row_bytes = (self.dim // 2 + self.dim if self.config.rerank_device
                         else self.dim // 2)
        else:
            row_bytes = self._host_gallery.itemsize * self.dim
        return self.count * row_bytes > thr

    def _drop_stream(self) -> None:
        if self._stream is not None:
            self._stream.close()
        self._stream = None

    def _sync_device(self) -> None:
        if not self._device_dirty or self._host_gallery is None:
            return
        # drop the old copies first: a re-upload never holds two galleries
        self._drop_stream()
        self._gallery = self._valid = self._scales = self._mags = None
        self._packed = self._scales4 = None
        if self._stream_active():
            self._sync_streamed()
            self._device_dirty = False
            return

        up = self._shard
        self._valid = up(self._host_valid)
        if self._packed4:
            # capacity tier: the screen copy only; the int8 rows stay on the
            # host unless latency mode asks for them too. Magnitudes never
            # ship: the tier is cosine-only.
            if self.config.rerank_device:
                self._warn_if_too_big()
            self._packed = up(self._host_packed)
            self._scales4 = up(self._host_scales4)
            if self.config.rerank_device:
                self._gallery = up(self._host_gallery)
                self._scales = up(self._host_scales)
        else:
            self._mags = up(self._host_mags)
            if self.config.dtype == "bfloat16":
                self._gallery = [g.view(torch.bfloat16)
                                 for g in up(self._host_gallery.view(np.int16))]
            else:
                self._gallery = up(self._host_gallery)
            if self._quantized:
                self._scales = up(self._host_scales)
        self._device_dirty = False

    def _sync_streamed(self) -> None:
        """The streamed tier: an engine over views of the host buffers (no
        copy of the gallery) and the valid mask on the device; tombstones
        are masked in every sweep until compact(), as on the resident
        tiers."""
        from image_retrieval_tpu_torch.index import streaming

        if not self._quantized:
            raise ValueError(
                "stream_threshold_bytes exceeded with dtype="
                f"'{self.config.dtype}': the streamed tier requires int8 storage "
                "(IndexConfig(dtype='int8')): streaming f32 would quadruple the "
                "bytes every sweep moves")
        n = self.count
        rows, sc = self._host_gallery[:n], self._host_scales[:n]
        self._valid = torch.from_numpy(self._host_valid[:n]).to(self.device)
        if self._packed4:
            # each sweep moves the packed rows; the int8 rows stay on the
            # host as the exact-rerank source
            self._stream = streaming.StreamingGallerySearch(
                self._host_packed[:n], self._host_scales4[:n], streaming.CHUNK_ROWS,
                self.device, packed4=True, rerank_rows=rows, rerank_scales=sc,
                rerank_c=self.config.rerank_c)
        else:
            self._stream = streaming.StreamingGallerySearch(rows, sc, streaming.CHUNK_ROWS,
                                                            self.device)

    @_locked
    def load(self) -> None:
        """Stage the gallery on the device (Milvus collection.load())."""
        self._sync_device()

    def release(self) -> None:
        pass

    @_locked
    def set_meta(self, key: str, value) -> None:
        """Set a small JSON-serializable metadata value; journaled (when a
        journal is attached) and saved, so it survives crash recovery and
        checkpoints without rows behind it."""
        self.meta[str(key)] = value
        if self._journal is not None and not self._replaying:
            self._journal.log_meta(key, value)

    @_locked
    def flush(self) -> None:
        """Durability barrier (Milvus collection.flush()): with a journal
        (open()), fsync the pending segments and the op log, so every
        mutation so far survives a process crash. A no-op without one."""
        if self._journal is not None:
            self._journal.flush()

    def __len__(self) -> int:
        return self.count

    # -- search -------------------------------------------------------------

    def _prep_queries(self, queries) -> Tuple[torch.Tensor, bool]:
        q = np.asarray(queries, np.float32)
        single = q.ndim == 1
        if single:
            q = q[None]
        return torch.from_numpy(q).to(self.device), single

    @staticmethod
    def _weights_tuple(params: Optional[Dict[str, float]]) -> Tuple[float, ...]:
        """(w_angle, w_l1, w_l2, w_inf, w_mag) as Python floats; w_angle
        defaults to 1, the rest to 0."""
        params = params or {}
        return tuple(float(params.get(k, 1.0 if k == "w_angle" else 0.0))
                     for k in WEIGHT_KEYS)

    @_locked
    def search(self, queries: np.ndarray, top_k: int = 5,
               metric: str = "cosine_similarity",
               params: Optional[Dict[str, float]] = None, flt=None,
               approx: Optional[bool] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Exact top-k. Returns numpy (scores (Q, k) f32, indices (Q, k)
        int32), or 1-D for a single 1-D query; k = min(top_k, live rows).
        Equal scores rank by ascending row index.

        metric: any name of ops.metrics.METRIC_NAMES, or
        "optimized_similarity": the weighted combination with `params`
        ({"w_angle", "w_l1", "w_l2", "w_inf", "w_mag"}), computed against
        the magnitude-reconstructed stored vectors, for which the query is
        passed unnormalized. Similarities rank descending, distances
        ascending. The int4 and streamed tiers are cosine-only.

        flt: an attribute expression or a (count,) bool mask; rows outside
        it never appear, and a tail the filter cannot fill pads with index
        -1 and the metric's worst score (-inf descending, +inf ascending):
        check `idx < 0`, not the score.

        approx: this call's IndexConfig.approx_select; accepted, and the
        answers are the exact ones on every tier (module docstring)."""
        if self.count == 0:
            raise ValueError("index is empty")
        if metric == "cosine":
            metric = "cosine_similarity"
        # f32 products throughout: the f32/bf16 tiers need them, and the
        # int8/int4 ones (exact in TF32) keep the same one rule
        require_full_f32(self.device)
        self._sync_device()
        # the streamed and int4 tiers are cosine-only by design
        if self._stream is not None:
            return self._search_streamed(queries, top_k, metric, flt)
        if self._packed4:
            return self._search_int4(queries, top_k, metric, flt)
        valid = self._valid if flt is None else self._filtered_valid(flt)
        q, single = self._prep_queries(queries)
        weights = self._weights_tuple(params) if metric == "optimized_similarity" else None
        with torch.inference_mode():
            args = (q, self._gallery, valid, self._mags, min(top_k, self.live_count),
                    metric, weights, self._scales)
            if self._multislice:
                vals, idx = multislice_search_topk(*args, mesh=self.mesh, slice_axis="slice",
                                                   data_axis=self.axis)
            else:
                vals, idx = sharded_search_topk(*args, mesh=self.mesh, axis=self.axis)
            vals, idx = vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()
        if flt is not None:
            idx = np.where(np.isfinite(vals), idx, -1)
        if single:
            return vals[0], idx[0]
        return vals, idx

    def _search_int4(self, queries, top_k: int, metric: str,
                     flt=None) -> Tuple[np.ndarray, np.ndarray]:
        """The int4 capacity tier: two-phase exact-rerank search.

        Phase 1 (device): the int4 screen selects c = min(max(rerank_c, k),
        count) candidates per query. Phase 2: their int8 rows, gathered on
        the host (or on the device in latency mode), are reranked exactly
        with the resident int8 sweep's math, so returned scores equal what
        dtype='int8' reports for the same rows. Tombstones and filters mask
        inside phase 1."""
        if metric != "cosine_similarity":
            raise ValueError(
                f"metric '{metric}' is not available in the int4 capacity tier "
                "(cosine-only two-phase search); use dtype='int8' for "
                "multi-metric galleries")
        valid = self._valid if flt is None else self._filtered_valid(flt)
        q, single = self._prep_queries(queries)
        k = int(min(top_k, self.live_count))
        if k == 0:  # fully tombstoned: the resident tiers' k = 0 shape
            ev, ei = np.zeros((q.shape[0], 0), np.float32), np.zeros((q.shape[0], 0), np.int32)
            return (ev[0], ei[0]) if single else (ev, ei)
        c = int(min(max(self.config.rerank_c, k), self.count))
        with torch.inference_mode():
            if self._gallery is not None:  # latency mode: one device pass
                vals, idx = sharded_int4_two_phase_topk(
                    q, self._packed, valid, self._scales4, self._gallery,
                    self._scales, c, k, mesh=self.mesh, axis=self._row_axes)
                vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
            else:
                vals4, gidx = sharded_int4_screen_topk(q, self._packed, valid,
                                                       self._scales4, c, mesh=self.mesh,
                                                       axis=self._row_axes)
                vals4, gidx = vals4.cpu().numpy(), gidx.cpu().numpy()
                ok = np.isfinite(vals4)
                safe = np.where(ok, gidx, 0)
                dev = lambda a: torch.from_numpy(a).to(self.device)
                vals, pos = rerank_int8_topk(
                    q, dev(self._host_gallery[safe]), dev(self._host_scales[safe]),
                    dev(ok), k)
                vals = vals.cpu().numpy()
                idx = np.take_along_axis(gidx, pos.cpu().numpy(), axis=1)
        # sub-k matches (filters/tombstones): the -1 sentinel of every tier
        idx = np.where(np.isfinite(vals), idx, -1).astype(np.int32)
        if single:
            return vals[0], idx[0]
        return vals, idx

    def _search_streamed(self, queries, top_k: int, metric: str,
                         flt=None) -> Tuple[np.ndarray, np.ndarray]:
        """The streamed tier's cosine search (index/streaming.py): the unit
        query as the resident int8 sweep forms it, so the answers equal the
        resident tier's; tombstones and a filter become the engine's mask."""
        if metric != "cosine_similarity":
            raise ValueError(
                f"metric '{metric}' is not available in the streamed beyond-HBM tier "
                "(cosine only); raise stream_threshold_bytes for multi-metric search "
                "at this scale")
        q, single = self._prep_queries(queries)
        mask = None
        if flt is not None:
            mask = self.filter_mask(flt)  # tombstones already out
        elif self.live_count < self.count:
            mask = self._host_valid[: self.count]
        vals, idx = self._stream.search(unit_queries(q), top_k=min(top_k, self.live_count),
                                        mask=mask)
        return (vals[0], idx[0]) if single else (vals, idx)

    @_locked
    def multi_metric_topk(self, queries: np.ndarray, top_k: int = 5,
                          flt=None) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
        """Exact per-metric top-k for all five metrics in one gallery pass:
        {metric: (scores (Q, k), indices (Q, k))} for cosine_similarity
        (descending) and the l1/l2/linf/magnitude distances (ascending).
        `flt` filters rows like search()."""
        if self.count == 0:
            raise ValueError("index is empty")
        require_full_f32(self.device)
        self._sync_device()
        if self._stream is not None:
            raise ValueError("multi-metric search is not available in the streamed "
                             "beyond-HBM tier; raise stream_threshold_bytes")
        if self._packed4:
            raise ValueError("multi-metric search is not available in the int4 "
                             "capacity tier (cosine-only); use dtype='int8'")
        valid = self._valid if flt is None else self._filtered_valid(flt)
        q, single = self._prep_queries(queries)
        with torch.inference_mode():
            out = sharded_multimetric_topk(q, self._gallery, valid, self._mags,
                                           min(top_k, self.live_count), self._scales,
                                           mesh=self.mesh, axis=self._row_axes)
        result = {}
        for name, (vals, idx) in out.items():
            vals, idx = vals.cpu().numpy(), idx.to(torch.int32).cpu().numpy()
            if flt is not None:
                idx = np.where(np.isfinite(vals), idx, -1)
            result[name] = (vals[0], idx[0]) if single else (vals, idx)
        return result

    @_locked
    def search_paths(self, queries: np.ndarray, top_k: int = 5,
                     metric: str = "cosine_similarity",
                     params: Optional[Dict[str, float]] = None) -> List[Dict[str, float]]:
        """Single-query search returning [{'path': ..., 'score': ...}]."""
        vals, idx = self.search(queries, top_k, metric, params)
        if vals.ndim != 1:
            raise ValueError("search_paths takes a single query vector")
        return [{"path": self.paths[int(i)], "score": float(v)} for v, i in zip(vals, idx)]

    @_locked
    def scores(self, queries: np.ndarray, metric: str = "cosine_similarity",
               params: Optional[Dict[str, float]] = None) -> np.ndarray:
        """Full (Q, count) score matrix (for analysis-scale galleries),
        tombstoned rows included. The int8 tier dequantizes its rows and
        scores them with the f32 functions, so these scores differ from
        search()'s int8 fast paths at the int8/bf16 rounding level."""
        if self.count == 0:
            raise ValueError("index is empty")
        if metric == "cosine":
            metric = "cosine_similarity"
        require_full_f32(self.device)
        self._sync_device()
        if self._stream is not None:
            raise ValueError("scores() materializes (Q, count): not available in the "
                             "streamed beyond-HBM tier (use search())")
        if self._packed4:
            raise ValueError("scores() is not available in the int4 capacity "
                             "tier (two-phase top-k only); use dtype='int8'")
        q, single = self._prep_queries(queries)
        weights = self._weights_tuple(params) if metric == "optimized_similarity" else None
        with torch.inference_mode():
            s = sharded_scores(q, self._gallery, self._mags, metric, weights,
                               self._scales, mesh=self.mesh,
                               axis=self._row_axes)[:, : self.count].cpu().numpy()
        return s[0] if single else s

    def _rows_f32(self, indices) -> np.ndarray:
        """Dequantized f32 unit rows of the given global indices only."""
        rows = self._host_gallery[indices]
        rows = bf16_to_f32(rows) if self.config.dtype == "bfloat16" else rows.astype(np.float32)
        if self._quantized and rows.size:
            rows = rows * self._host_scales[indices][:, None]
        return rows

    @_locked
    def get_vectors(self, indices: Sequence[int]) -> np.ndarray:
        """Stored unit vectors for global indices (dequantized)."""
        return self._rows_f32(np.asarray(indices, int))

    @_locked
    def get_magnitudes(self, indices: Sequence[int]) -> np.ndarray:
        return self._host_mags[np.asarray(indices, int)].astype(np.float32)

    @_locked
    def query(self, limit: int = 1000, with_magnitude: bool = False):
        """Stored (path, unit_embedding[, magnitude]) tuples of live rows;
        only the emitted rows are dequantized."""
        if self.count == 0:
            return []
        live = np.flatnonzero(self._host_valid[: self.count])[:limit]
        rows = self._rows_f32(live)
        if with_magnitude:
            return [(self.paths[int(i)], rows[j], float(self._host_mags[i]))
                    for j, i in enumerate(live)]
        return [(self.paths[int(i)], rows[j]) for j, i in enumerate(live)]

    @_locked
    def reconstruct_original_embeddings(self, limit: int = 1000):
        """(path, unit * magnitude) round-trip."""
        return [(p, e * m) for p, e, m in self.query(limit, with_magnitude=True)]

    # -- persistence --------------------------------------------------------

    @_locked
    def save(self, path: str) -> None:
        """Persist as npz (rows as portable dequantized f32, magnitudes,
        attribute columns) + JSON sidecars: paths, attributes, the tier
        configuration and meta. Tombstoned rows are compacted away first,
        so deletes survive the save/load cycle."""
        self.compact()
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        g = (self._rows_f32(slice(0, self.count)) if self.count
             else np.zeros((0, self.dim), np.float32))
        m = (self._host_mags[: self.count].astype(np.float32)
             if self.count else np.zeros((0,), np.float32))
        attr_arrays, attr_meta = self.attrs.to_arrays()
        np.savez(path, embeddings=g, magnitudes=m, **attr_arrays)
        # np.savez appends .npz when absent: key the sidecars off the final
        # name, so save('gallery') / load_from('gallery') round-trip
        npz_path = path if path.endswith(".npz") else path + ".npz"
        with open(npz_path + ".paths.json", "w") as f:
            json.dump(self.paths, f)
        if attr_arrays:
            with open(npz_path + ".attrs.json", "w") as f:
                json.dump(attr_meta, f)
        with open(npz_path + ".config.json", "w") as f:
            json.dump(dataclasses.asdict(self.config), f)
        if self.meta:
            with open(npz_path + ".meta.json", "w") as f:
                json.dump(self.meta, f)

    @_locked
    def checkpoint(self) -> None:
        """Seal the journal: save a full snapshot into the journal
        directory, publish it atomically, truncate the op log and remove
        the segments it consumed. Requires an index opened with open()."""
        if self._journal is None:
            raise ValueError("checkpoint() requires a journaled index: use "
                             "ShardedVectorIndex.open(journal_dir)")
        seq, base = self._journal.begin_checkpoint()
        if seq is None:
            return  # nothing logged since the last checkpoint
        # save() compacts: the snapshot embodies that compact, and the log
        # it would be written to is truncated anyway
        self._replaying = True
        try:
            self.save(base)
        finally:
            self._replaying = False
        self._journal.commit_checkpoint(seq)

    @classmethod
    def open(cls, journal_dir: str, config: Optional[IndexConfig] = None, *,
             device: Optional[DeviceLike] = None,
             mesh: Optional[Mesh] = None) -> "ShardedVectorIndex":
        """Open (or create) a journaled index on `device` or `mesh` (the
        constructor's rule): load the newest
        checkpoint under `journal_dir` if there is one, replay the op log
        on top and attach the journal, so every later mutation is logged.
        `config` applies to a new directory; afterwards the saved one wins
        unless `config` overrides it."""
        from image_retrieval_tpu_torch.index.journal import IndexJournal

        journal = IndexJournal(journal_dir)
        snap = journal.snapshot_path()
        if snap is not None:
            idx = cls.load_from(snap, config=config, device=device, mesh=mesh)
        else:
            # no checkpoint yet: the tier configuration comes from the
            # directory itself, or a 64-dim int8 index would replay into a
            # fresh 512-dim f32 one
            if config is None:
                saved = journal.load_config()
                if saved is not None:
                    config = _config_from_saved(saved)
            cfg = config or IndexConfig()
            idx = cls(dim=cfg.embedding_dim, config=config, device=device, mesh=mesh)
        journal.store_config(dataclasses.asdict(idx.config))
        for rec in journal.pending():
            op = rec["op"]
            if op == "insert":
                try:
                    unit, mags = journal.load_segment(rec["seq"])
                except (FileNotFoundError, KeyError, OSError, ValueError,
                        zipfile.BadZipFile) as e:
                    # a torn or missing segment: this record and all after
                    # it are the tail that no flush() made durable; drop
                    # them. A transient resource error re-raises instead of
                    # destroying flushed records.
                    if isinstance(e, OSError) and e.errno in (
                            errno.ENOMEM, errno.EMFILE, errno.ENFILE):
                        raise
                    journal.drop_from(rec["seq"])
                    break
                idx.insert(rec["paths"], unit, mags, attrs=rec.get("attrs"))
            elif op == "delete":
                idx.delete(rec["paths"])
            elif op == "delete_rows":
                idx.delete_rows(rec["rows"])
            elif op == "compact":
                idx.compact()
            elif op == "meta":
                idx.meta[rec["key"]] = rec["value"]
        idx._journal = journal
        return idx

    @classmethod
    def load_from(cls, path: str, config: Optional[IndexConfig] = None, *,
                  device: Optional[DeviceLike] = None,
                  mesh: Optional[Mesh] = None) -> "ShardedVectorIndex":
        """Rebuild from save() on `device` or `mesh`, which need not be the
        one it was saved from. The saved tier configuration is
        restored (insert() re-quantizes the portable f32 rows for it);
        `config` overrides it, e.g. to re-tier on load."""
        npz_path = path if path.endswith(".npz") else path + ".npz"
        data = np.load(npz_path)
        with open(npz_path + ".paths.json") as f:
            paths = json.load(f)
        if config is None and os.path.exists(npz_path + ".config.json"):
            with open(npz_path + ".config.json") as f:
                config = _config_from_saved(json.load(f))
        emb = data["embeddings"]
        dim = emb.shape[1] if emb.size else (config.embedding_dim if config else 512)
        idx = cls(dim=dim, config=config, device=device, mesh=mesh)
        if len(paths):
            idx.insert(paths, emb, data["magnitudes"])
        attr_arrays = {k: data[k] for k in data.files if k.startswith("attr__")}
        if attr_arrays and os.path.exists(npz_path + ".attrs.json"):
            with open(npz_path + ".attrs.json") as f:
                idx.attrs = AttributeStore.from_arrays(attr_arrays, json.load(f))
        if os.path.exists(npz_path + ".meta.json"):
            with open(npz_path + ".meta.json") as f:
                idx.meta = json.load(f)
        return idx
