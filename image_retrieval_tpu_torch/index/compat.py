"""pymilvus-style compatibility layer over ShardedVectorIndex — port of
``image_retrieval_tpu/index/compat.py``, over the port's index on every
visible card, or on `device` or `mesh` when the caller names one.

Lets code written against the reference's Milvus usage
(reference ImageEmbeddingSystem.py:35-66,136-137,158-171 and
image_search.py:85-95) run unchanged against the on-device index:

    collection = Collection("image_embeddings")
    collection.insert([paths, embeddings, magnitudes])
    collection.flush(); collection.load()
    results = collection.search(data=[q], anns_field="embedding",
                                param={"metric_type": "COSINE", ...},
                                limit=k, output_fields=["image_path", "embedding"])
    for hits in results:
        for hit in hits:
            hit.score, hit.entity.get("image_path"), hit.entity.get("embedding")
    collection.query(expr="id >= 0", output_fields=[...], limit=n)
    collection.release()

Supported metric_type values: COSINE (descending, default), L2 (ascending,
over magnitude-reconstructed vectors). `nprobe` is accepted and ignored —
search is exact, recall is 1.0 by construction.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from image_retrieval_tpu_torch.device import DeviceLike
from image_retrieval_tpu_torch.index.vector_index import ShardedVectorIndex
from image_retrieval_tpu_torch.parallel.mesh import Mesh

_REGISTRY: Dict[str, "Collection"] = {}


class _Entity:
    def __init__(self, fields: dict):
        self._fields = fields

    def get(self, name: str):
        return self._fields.get(name)


class _Hit:
    def __init__(self, score: float, entity: dict, pk: int):
        self.score = score
        self.distance = score
        self.id = pk
        self.entity = _Entity(entity)


class Collection:
    """Named collection facade (process-local registry mirrors Milvus's
    server-side collection namespace)."""

    def __init__(self, name: str, dim: Optional[int] = None,
                 index: Optional[ShardedVectorIndex] = None,
                 journal_dir: Optional[str] = None, *, device: Optional[DeviceLike] = None,
                 mesh: Optional[Mesh] = None):
        """`Collection(name)` opens an existing collection (pymilvus
        semantics); pass `dim` to declare the schema — an EXPLICIT dim that
        conflicts with the registered collection raises here instead of as
        a bare assert deep inside a later insert. `journal_dir` makes the
        collection durable across processes (the Milvus WAL+volume analog,
        index/journal.py): existing state is recovered from the directory
        and every mutation is logged; flush() becomes a real barrier."""
        self.name = name
        reg = _REGISTRY.get(name)
        if reg is not None and index is None and (
            journal_dir is None or journal_dir == reg._journal_dir
        ):
            # reuse the registered instance — including when the SAME
            # journal_dir is passed again: a second ShardedVectorIndex.open
            # on a live directory would run two IndexJournals with
            # independent seq counters over one ops.jsonl (duplicate seqs,
            # overwritten segments — silent corruption; r5 review)
            impl = reg._impl
            if dim is not None and impl.dim != dim:
                raise ValueError(
                    f"collection {name!r} exists with dim={impl.dim}, "
                    f"requested dim={dim}"
                )
            self._impl = impl
            self._partitions = reg._partitions
            self._journal_dir = reg._journal_dir
        elif reg is not None and journal_dir is not None:
            raise ValueError(
                f"collection {name!r} is already open"
                + (f" on journal_dir={reg._journal_dir!r}"
                   if reg._journal_dir else " without a journal")
                + f"; refusing a second live journal on {journal_dir!r}"
            )
        else:
            if index is not None:
                self._impl = index
            elif journal_dir is not None:
                from image_retrieval_tpu_torch.config import IndexConfig

                cfg = IndexConfig(embedding_dim=dim) if dim else None
                self._impl = ShardedVectorIndex.open(journal_dir, config=cfg,
                                                     device=device, mesh=mesh)
            else:
                self._impl = ShardedVectorIndex(
                    dim=dim if dim is not None else 512, device=device, mesh=mesh
                )
            self._partitions = {"_default"}
            self._journal_dir = journal_dir
            if journal_dir is not None:
                # recover the partition name SET from journaled index
                # metadata (create/drop log it via set_meta) — Milvus
                # persists partitions even when they hold no rows, so
                # recovery can't rely on the _partition row column alone
                self._partitions |= set(
                    self._impl.meta.get("partitions", []))
                # legacy directories predating the meta record: fall back
                # to the names present in the journaled _partition column
                vocab = self._impl.attrs.vocab.get("_partition", {})
                if vocab and self._impl.count:
                    col = self._impl.attrs.columns["_partition"][
                        : self._impl.count]
                    present = set(
                        np.asarray(col)[self._impl.live_mask()].tolist())
                    self._partitions |= {
                        s for s, c in vocab.items() if c in present}
        _REGISTRY[name] = self

    # -- schema/lifecycle no-ops kept for API parity -------------------------

    def create_index(self, field_name: str = "embedding", index_params: Optional[dict] = None):
        return None  # exact search needs no ANN index build

    def load(self):
        self._impl.load()

    def release(self):
        self._impl.release()

    def flush(self):
        self._impl.flush()

    @property
    def num_entities(self) -> int:
        return len(self._impl)

    # -- partitions -----------------------------------------------------------
    # Milvus partitions map onto the attribute-filter machinery: every row
    # carries a hidden dictionary-encoded `_partition` column, and
    # partition_names= becomes a `_partition in [...]` mask ANDed into the
    # same masked device scan filters/tombstones ride — so partition-scoped
    # search costs nothing extra and compiles nothing new.

    def create_partition(self, partition_name: str):
        if not partition_name or partition_name.startswith("_default"):
            if partition_name != "_default":
                raise ValueError(f"invalid partition name {partition_name!r}")
        self._partitions.add(partition_name)
        self._persist_partitions()

    def _persist_partitions(self) -> None:
        """Record the non-default partition names as index metadata so they
        survive restart even with zero rows (COMPAT.md §15; Milvus persists
        empty partitions)."""
        self._impl.set_meta(
            "partitions", sorted(self._partitions - {"_default"}))

    def has_partition(self, partition_name: str) -> bool:
        return partition_name in self._partitions

    @property
    def partitions(self) -> List[str]:
        return sorted(self._partitions)

    def drop_partition(self, partition_name: str) -> int:
        """Drop a partition AND its rows (Milvus drop_partition deletes the
        partition's data). Returns rows deleted."""
        if partition_name == "_default":
            raise ValueError("cannot drop the _default partition")
        if partition_name not in self._partitions:
            raise ValueError(f"partition {partition_name!r} does not exist")
        # delete rows FIRST: discarding the name before a failed delete
        # (e.g. a device error mid-sweep) would leave the rows live but
        # the partition unreachable (r5 review)
        mask = self._partition_mask([partition_name]) & self._impl.live_mask()
        deleted = self._impl.delete_rows(np.flatnonzero(mask))
        self._partitions.discard(partition_name)
        self._persist_partitions()
        return deleted

    def _partition_mask(self, partition_names: Sequence[str]) -> np.ndarray:
        from image_retrieval_tpu_torch.index.filters import FilterError, parse_filter

        # ensure_ascii=False: the filter tokenizer's unescape would turn
        # json's \uXXXX into 'uXXXX' and non-ASCII partition names would
        # silently match zero rows (r5 review)
        names = ", ".join(json.dumps(p, ensure_ascii=False)
                          for p in partition_names)
        try:
            return self._impl.attrs.evaluate(
                parse_filter(f"_partition in [{names}]"), self._impl.count
            )
        except FilterError:
            # no row ever carried the hidden column (all inserts bypassed
            # the shim): everything belongs to the default partition
            return np.full(self._impl.count,
                           "_default" in partition_names, bool)

    # -- data ----------------------------------------------------------------

    def insert(self, data: Sequence, attrs: Optional[dict] = None,
               partition_name: Optional[str] = None):
        """[paths, embeddings, magnitudes] column layout
        (reference ImageEmbeddingSystem.py:136). `attrs` adds scalar
        fields for boolean-expr filtering (index/filters.py);
        `partition_name` routes the rows to a Milvus-style partition
        (default `_default`)."""
        part = partition_name or "_default"
        if part not in self._partitions:
            raise ValueError(f"partition {part!r} does not exist; "
                             f"create_partition first")
        paths, embeddings = data[0], np.asarray(data[1], np.float32)
        magnitudes = data[2] if len(data) > 2 else None
        attrs = dict(attrs or {})
        n = embeddings.shape[0] if embeddings.ndim > 1 else 1
        attrs["_partition"] = [part] * n
        return self._impl.insert(paths, embeddings, magnitudes, attrs=attrs)

    def search(
        self,
        data: Sequence[np.ndarray],
        anns_field: str = "embedding",
        param: Optional[dict] = None,
        limit: int = 10,
        output_fields: Optional[List[str]] = None,
        expr: Optional[str] = None,
        partition_names: Optional[Sequence[str]] = None,
        **_,
    ) -> List[List[_Hit]]:
        param = param or {}
        metric_type = (param.get("metric_type") or "COSINE").upper()
        metrics = {"COSINE": "cosine_similarity", "L2": "l2_distance"}
        if metric_type not in metrics:
            # anything else (IP, a typo, ...) must not silently fall back to
            # a different ranking
            raise ValueError(
                f"unsupported metric_type {metric_type!r}; supported: "
                f"{sorted(metrics)}"
            )
        metric = metrics[metric_type]
        output_fields = output_fields or ["image_path"]
        # evaluate the expr HERE (not via flt=expr) so the virtual
        # id/image_path columns work on search like on query/delete;
        # partition scoping ANDs into the same mask
        flt = self._expr_mask(expr) if expr else None
        if partition_names:
            for p in partition_names:
                if p not in self._partitions:
                    raise ValueError(f"partition {p!r} does not exist")
            pm = self._partition_mask(partition_names)
            flt = pm if flt is None else (flt & pm)
        if self._impl.live_count == 0 or len(data) == 0:
            # pymilvus returns empty hits, not an error (and an empty
            # query list returns [] rather than tripping np.stack)
            return [[] for _ in data]
        # ONE batched device dispatch for the whole query list — the
        # gallery sweep serves Q queries at ~the cost of one (pymilvus
        # likewise ships the list in one gRPC call); per-query dispatch
        # would pay Q device round-trips
        qs = np.stack([np.asarray(q, np.float32) for q in data])
        all_vals, all_idx = self._impl.search(
            qs, top_k=limit, metric=metric, flt=flt)
        results = []
        for vals, idx in zip(np.atleast_2d(all_vals), np.atleast_2d(all_idx)):
            hits = []
            for v, i in zip(np.atleast_1d(vals), np.atleast_1d(idx)):
                if i < 0:  # filtered search pads sub-limit results
                    continue
                entity = {}
                if "image_path" in output_fields:
                    entity["image_path"] = self._impl.paths[int(i)]
                if "embedding" in output_fields:
                    entity["embedding"] = self._impl.get_vectors([int(i)])[0]
                if "magnitude" in output_fields:
                    entity["magnitude"] = float(self._impl.get_magnitudes([int(i)])[0])
                hits.append(_Hit(float(v), entity, int(i)))
            results.append(hits)
        return results

    def _expr_mask(self, expr: str) -> np.ndarray:
        """(count,) bool for a boolean expr over scalar attrs plus the
        virtual `id` (row number) and `image_path` columns."""
        from image_retrieval_tpu_torch.index.filters import parse_filter

        count = self._impl.count
        extra = {
            "id": ("num", np.arange(count, dtype=np.float64)),
            "image_path": ("rawstr",
                           np.asarray(self._impl.paths[:count], object)),
        }
        return self._impl.attrs.evaluate(parse_filter(expr), count, extra)

    def query(
        self,
        expr: str = "id >= 0",
        output_fields: Optional[List[str]] = None,
        limit: int = 1000,
        partition_names: Optional[Sequence[str]] = None,
        **_,
    ) -> List[dict]:
        """`id` is the global row number — the same pk search() hits carry,
        so query/delete/search ids compose like Milvus primary keys."""
        output_fields = output_fields or ["image_path", "embedding"]
        count = self._impl.count
        mask = (self._expr_mask(expr) if expr
                else np.ones(count, bool)) & self._impl.live_mask()
        if partition_names:
            for p in partition_names:
                if p not in self._partitions:
                    raise ValueError(f"partition {p!r} does not exist")
            mask &= self._partition_mask(partition_names)
        ids = np.flatnonzero(mask)[:limit]
        vecs = (self._impl.get_vectors(ids)
                if "embedding" in output_fields and len(ids) else None)
        mags = (self._impl.get_magnitudes(ids)
                if "magnitude" in output_fields and len(ids) else None)
        out = []
        for r, i in enumerate(ids):
            row = {"id": int(i)}
            if "image_path" in output_fields:
                row["image_path"] = self._impl.paths[int(i)]
            if "embedding" in output_fields:
                row["embedding"] = vecs[r]
            if "magnitude" in output_fields:
                row["magnitude"] = float(mags[r])
            out.append(row)
        return out

    def delete(self, expr: str) -> int:
        """Milvus delete-by-expr: tombstone rows matching the boolean
        expression (scalar attrs + virtual id/image_path). Exact on row
        ids — duplicate paths do NOT drag unmatched rows along (Milvus
        pk-deletes are exact; delete(paths) is the path-keyed form)."""
        mask = self._expr_mask(expr) & self._impl.live_mask()
        return self._impl.delete_rows(np.flatnonzero(mask))


def has_collection(name: str) -> bool:
    """utility.has_collection equivalent."""
    return name in _REGISTRY


def drop_collection(name: str) -> None:
    _REGISTRY.pop(name, None)
