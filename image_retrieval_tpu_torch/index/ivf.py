"""IVF (inverted-file) approximate cosine index — the port of
``image_retrieval_tpu/index/ivf.py``.

The exact sweep stays the default. IVF trades exactness for reading only
the probed clusters' rows, the reference's Milvus deployment (IVF_FLAT,
nlist=1024, nprobe=10, COSINE; reference ImageEmbeddingSystem.py:56-61,
image_search.py:88).

  build:  spherical k-means over unit rows in f32 on the device (Lloyd
          steps: an argmax of rows x centroids, ties to the lowest cluster
          id, then a scatter-add of the rows into (C, D) sums, renormalized);
          rows re-packed contiguously by cluster into flat, padded
          (nlist * lmax, D) slabs with row ids (-1 padding), so a probed
          cluster is one slab.
  search: unit queries x centroids -> the top-nprobe clusters (lowest id
          first among ties) -> each query's probed slabs scored in probe
          order -> masked exact top-k over the (probe rank, slot) order ->
          the row ids.

int8 slabs hold the rows quantized on the host (per-row absmax / 127 scales,
``rint``, clip to +-127: the JAX package's host code, bit for bit) and score
as the bf16-rounded unit query times the int8 row, products and sums in f32,
times the row's scale. f32 products are full f32 (TF32 is refused).

``offload`` keeps the slabs in pinned host RAM and serves a query batch by
gathering only its unique probed slabs on the host and uploading them once;
the answers are the resident index's, bit for bit. ``add`` appends to an
exactly swept tail; ``save`` / ``load`` keep the JAX package's npz layout,
so a file that either package saves loads in the other.

The full-set build (no ``train_size``) draws its k-means init from
``np.random.default_rng(seed)``, where the JAX package uses
``jax.random.choice(PRNGKey(seed))``: the two packages start such builds
from different rows. The ``train_size`` build makes the JAX package's numpy
draws in the same order and starts from the same init.

Over a mesh (``attach_mesh``, which ``from_index`` calls for an index
row-sharded over more than one device) the cluster slabs split over the
mesh axis in contiguous cluster ranges (``sharded``): the centroids are
replicated, every shard selects the same nprobe clusters and scores only
those it owns, and the shards' k-lists merge on the first device
(``sharded_ivf_search``). nlist pads with empty clusters to a multiple of
the axis. The build, ``add``'s tail and an offloaded index stay on the
index's first device.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from image_retrieval_tpu_torch.device import DeviceLike, require_full_f32, resolve_device
from image_retrieval_tpu_torch.ops.int4 import unit_queries
from image_retrieval_tpu_torch.ops.topk import exact_topk
from image_retrieval_tpu_torch.parallel.mesh import (
    Mesh,
    entry_mesh,
    on_device,
    replicate,
    shard_devices,
    shard_rows,
)

# The gathered f32 slab rows of one scoring step stay within this many bytes:
# a step scores as many queries as fit, at least one.
STEP_BYTES = 256 << 20
# Rows per device block of the full-set k-means and of the assignment passes.
ROW_CHUNK = 131072
# Rows per task of the host passes (norms, quantization and packing,
# rebalance preferences), run on up to HOST_WORKERS threads; each step is
# row-wise, so the bits do not depend on the split. Tasks of 2^13 rows keep
# a task's f32 temporaries (16 MiB at D = 512) in the allocator's reused
# memory instead of fresh pages for every task.
HOST_ROWS = 1 << 13
HOST_WORKERS = min(8, os.cpu_count() or 1)
# An offloaded search gathers its slabs on HOST_WORKERS threads past this
# many bytes, on the calling thread below it.
GATHER_THREADS_BYTES = 64 << 20


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _row_tasks(n: int, fn) -> None:
    """fn(slice) over HOST_ROWS-row slices of n rows, on the host's cores
    (numpy releases the GIL in its loops)."""
    spans = [slice(i, min(i + HOST_ROWS, n)) for i in range(0, n, HOST_ROWS)]
    if len(spans) <= 1:
        for sl in spans:
            fn(sl)
        return
    with ThreadPoolExecutor(HOST_WORKERS) as pool:
        list(pool.map(fn, spans))


def _renormalize(sums: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    norms = torch.linalg.vector_norm(sums, dim=1, keepdim=True)
    return torch.where(norms > 1e-9, sums / torch.clamp(norms, min=1e-9), c)


def _assign(rows: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row: the first maximum, so the lowest id among
    ties (``jnp.argmax``'s rule)."""
    return torch.argmax(rows @ c.t(), dim=1)


def _chunk_sums(chunks, c: torch.Tensor) -> torch.Tensor:
    """One Lloyd step's (C, D) sums: each chunk's rows scatter-added into
    its own partial sums, the partials added in chunk order."""
    sums = torch.zeros_like(c)
    for rc in chunks:
        part = torch.zeros_like(c)
        part.index_put_((_assign(rc, c),), rc, accumulate=True)
        sums += part
    return sums


def _kmeans_chunked(rows3: torch.Tensor, centroids: torch.Tensor, iters: int) -> torch.Tensor:
    """Spherical k-means Lloyd iterations over (nchunks, chunk, D) training
    rows from the (C, D) init; one (chunk, C) similarity block is alive at a
    time. Returns the (C, D) unit centroids."""
    require_full_f32(rows3.device)
    c = centroids
    for _ in range(iters):
        c = _renormalize(_chunk_sums(rows3, c), c)
    return c


def _kmeans_unit(rows: torch.Tensor, seed: int, nlist: int,
                 iters: int = 10) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spherical k-means over all unit rows -> ((nlist, D) unit centroids,
    (N,) assignment). The init is nlist distinct rows drawn by
    ``np.random.default_rng(seed)`` (the JAX package draws them with
    ``jax.random.choice``); the Lloyd steps run in ROW_CHUNK-row blocks."""
    require_full_f32(rows.device)
    n = rows.shape[0]
    init = np.random.default_rng(seed).choice(n, size=nlist, replace=False)
    c = rows[torch.from_numpy(init).to(rows.device)]
    chunks = torch.split(rows, ROW_CHUNK)
    for _ in range(iters):
        c = _renormalize(_chunk_sums(chunks, c), c)
    return c, torch.cat([_assign(rc, c) for rc in chunks])


def _top_r_centroids(rows: torch.Tensor, centroids: torch.Tensor, r: int) -> torch.Tensor:
    """Top-r centroid ids per row, lowest ids first among ties."""
    if r == 1:
        return _assign(rows, centroids)[:, None]
    return exact_topk(rows @ centroids.t(), r)[1]


def _score_probed(qu: torch.Tensor, probe: torch.Tensor, packed: torch.Tensor,
                  ids: torch.Tensor, lmax: int, k: int,
                  scales: Optional[torch.Tensor],
                  owned: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query top-k over its probed cluster slabs.

    `probe` (Q, nprobe) holds slab positions into `packed` (cluster ids on
    the resident path; positions among the gathered slabs when offloaded;
    local cluster ids on a shard, where `owned` (Q, nprobe) marks the
    probes the shard owns and the others count as empty slabs).
    A step gathers its queries' slabs into (Qs, nprobe * lmax, D) f32 rows
    (within STEP_BYTES), scores them (int8: the bf16-rounded unit query x
    the int8 values, f32 sums, x the scales; f32: the f32 unit query x the
    rows), masks -1 slots to -inf and keeps the exact top-k in (probe rank,
    slot) order. Returns (values f32, row ids int32), each (Q, k)."""
    nq, npb = probe.shape
    d = packed.shape[1]
    slabs, slab_ids = packed.view(-1, lmax, d), ids.view(-1, lmax)
    slab_sc = None if scales is None else scales.view(-1, lmax)
    qv = qu if scales is None else qu.to(torch.bfloat16).to(torch.float32)
    step = max(1, STEP_BYTES // (npb * lmax * d * 4))
    vals, out = [], []
    for lo in range(0, nq, step):
        p = probe[lo: lo + step]
        rows = slabs[p].reshape(len(p), npb * lmax, d).to(torch.float32)
        s = torch.bmm(rows, qv[lo: lo + step, :, None])[..., 0]
        if slab_sc is not None:
            s = s * slab_sc[p].reshape(len(p), -1)
        rid = slab_ids[p].reshape(len(p), -1)
        if owned is not None:
            rid = rid.masked_fill(~owned[lo: lo + step].repeat_interleave(lmax, dim=1), -1)
        v, local = exact_topk(s.masked_fill(rid < 0, float("-inf")), k)
        vals.append(v)
        out.append(torch.gather(rid, 1, local))
    return torch.cat(vals), torch.cat(out)


def sharded_ivf_search(queries: torch.Tensor, centroids, packed_flat, ids_flat, lmax: int,
                       nprobe: int, k: int, scales_flat=None, *, mesh: Mesh,
                       axis: str = "data",
                       nlist_real: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """IVF search with the cluster slabs sharded over `axis`.

    centroids (C, D), replicated: a tensor, or {device: copy}; packed_flat
    (C * lmax, D) f32 or int8 slabs, ids_flat (C * lmax,) int32 row ids (-1
    empty) and scales_flat (C * lmax,) for int8: whole tensors (split here)
    or lists of per-shard blocks, shard i holding clusters [i * C / n,
    (i + 1) * C / n). Every shard takes the same top-nprobe clusters of the
    unit queries (lowest id first among ties; ids >= nlist_real, the
    divisibility padding, never probed), scores only the probes it owns (a
    query's owned probes in rank order, padded to the most any query owns,
    the padding counting as empty slabs) with the one-device scoring, and
    keeps its top-k in (probe rank, slot) order; the shards' lists are concatenated in shard
    order on the first device and the k best kept by a stable sort (shard
    order, then probe rank, among ties), as the JAX package merges them.
    Returns (values (Q, k) f32, row ids (Q, k) int32; -1 where the probed
    clusters hold fewer than k rows). Raises ValueError for an nlist that
    the axis does not divide: trailing clusters would be unreachable and
    every later shard mis-addressed."""
    devs = shard_devices(mesh, axis)
    ndev = len(devs)
    cent = centroids if isinstance(centroids, dict) else replicate(centroids, mesh)
    nlist = next(iter(cent.values())).shape[0]
    if nlist % ndev:
        raise ValueError(f"sharded_ivf_search requires nlist ({nlist}) divisible by the "
                         f"'{axis}' mesh axis size ({ndev})")
    per = nlist // ndev

    def split(x):
        if x is None:
            return [None] * ndev
        return list(x) if isinstance(x, (list, tuple)) else shard_rows(x, mesh, axis)

    packed, ids, scales = split(packed_flat), split(ids_flat), split(scales_flat)
    vals, out = [], []
    for s, dev in enumerate(devs):
        with on_device(dev):
            require_full_f32(dev)
            qu = unit_queries(queries.to(dev))
            sims = qu @ cent[dev].t()
            if nlist_real is not None and nlist_real < nlist:
                sims[:, nlist_real:] = float("-inf")
            _, probe = exact_topk(sims, nprobe)
            if ndev == 1:  # every probe owned: the one-device scoring, no merge
                return _score_probed(qu, probe, packed[0], ids[0], lmax,
                                     min(k, nprobe * lmax), scales[0])
            local = probe - s * per
            owned = (local >= 0) & (local < per)
            # each query's owned probes first, in probe rank order: the shard
            # gathers and scores only as many probes as a query owns at most
            first = torch.sort((~owned).to(torch.int8), dim=1, stable=True)[1]
            width = int(owned.sum(1).max())
            if width == 0:
                continue
            local = torch.gather(local, 1, first[:, :width])
            owned = torch.gather(owned, 1, first[:, :width])
            v, i = _score_probed(qu, local.clamp(0, per - 1), packed[s], ids[s], lmax,
                                 min(k, width * lmax), scales[s], owned)
            vals.append(v)
            out.append(i)
    dst = devs[0]
    all_vals = torch.cat([v.to(dst) for v in vals], 1)
    all_ids = torch.cat([i.to(dst) for i in out], 1)
    top, order = torch.sort(all_vals, dim=1, descending=True, stable=True)
    return top[:, :k], torch.gather(all_ids, 1, order[:, :k])


def recommended_ivf(n_rows: int) -> Optional[Tuple[int, int]]:
    """The IVF operating point for a gallery of n_rows: (nlist, nprobe), or
    None for the exact tier.

    This is the JAX package's rule, unchanged, so that both packages pick the
    same tier for the same gallery: below 4 x 2^20 rows the exact sweep is
    kept; above it nlist is ~2 sqrt(N) floored to a power of two and clipped
    to [1024, 16384] (2^23 rows -> 4096, 2^25 -> 8192), keeping the mean
    cluster, and so a probe's slab, growing as sqrt(N); nprobe = 8 is the
    rule's knee. On i.i.d. (unclustered) rows IVF recall collapses whatever
    the operating point; such galleries should stay exact at any size.

    What this card makes of the rule is measured by chip_smoke.py's phase 11
    (PERF.md section 5): at 2^23 clustered 512-d rows, (4096, 8) over int8
    slabs, recall@10 against the exact int8 tier and the p50 latency of one
    and of 64 queries beside the exact int8 tier's.
    """
    if n_rows < (4 << 20):
        return None
    nlist = 1 << int(np.floor(np.log2(2.0 * np.sqrt(float(n_rows)))))
    return int(np.clip(nlist, 1024, 16384)), 8


def _rebalance_assign(
    unit: np.ndarray, centroids: np.ndarray, assign: np.ndarray, cap: int,
    chunk: int = 65536, rows: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Greedy capacity-capped reassignment: rows of over-full clusters move
    to their best centroid with free capacity, least-confident rows first.
    Host numpy, the JAX package's code; chunked, so neither the (N, C)
    similarities nor an (N, D) gathered copy is ever held.

    rows: optional map from assignment entries to `unit` row indices
    (multi-assignment passes each row once per replica)."""
    nlist = centroids.shape[0]
    counts = np.bincount(assign, minlength=nlist)
    if counts.max() <= cap:
        return assign
    assign = assign.copy()
    nm = len(assign)
    if rows is None:
        rows = np.arange(nm)
    # confidence = similarity to the assigned centroid, computed only for
    # members of over-full clusters (the only entries that can spill)
    over = np.flatnonzero(counts > cap)
    over_mask = np.isin(assign, over)
    cand = np.flatnonzero(over_mask)
    conf = np.empty(nm, np.float32)  # read only at `cand` positions
    for i in range(0, len(cand), 1 << 20):
        sl = cand[i: i + (1 << 20)]
        conf[sl] = np.einsum(
            "nd,nd->n", unit[rows[sl]], centroids[assign[sl]]
        )
    # the members of each over-full cluster in ascending order: the
    # candidates grouped by one stable sort, not a full pass per cluster
    grouped = cand[np.argsort(assign[cand], kind="stable")]
    bounds = np.searchsorted(assign[grouped], over, side="left")
    ends = np.searchsorted(assign[grouped], over, side="right")
    overflow_rows = []
    for c, lo, hi in zip(over, bounds, ends):
        members = grouped[lo:hi]
        order = members[np.argsort(conf[members])]  # least confident first
        spill = order[: counts[c] - cap]
        overflow_rows.append(spill)
        assign[spill] = -1
        counts[c] = cap
    overflow = np.concatenate(overflow_rows)
    # per-cluster remaining capacity; the greedy placement below is one
    # entry at a time, so it walks Python lists (the same choices as the
    # JAX package's loop over numpy scalars, several times faster)
    free = (cap - counts).tolist()
    for i in range(0, len(overflow), chunk):
        ent = overflow[i : i + chunk]
        sims = unit[rows[ent]] @ centroids.T  # (chunk, C)
        # a small partial head first; only the stragglers are argsorted
        head = min(8, nlist)
        prefs_head = np.empty((len(ent), head), np.int64)

        def prefer(sl):
            ph = np.argpartition(-sims[sl], head - 1, axis=1)[:, :head]
            hs = np.take_along_axis(sims[sl], ph, axis=1)
            prefs_head[sl] = np.take_along_axis(ph, np.argsort(-hs, axis=1), axis=1)

        _row_tasks(len(ent), prefer)
        prefs_head = prefs_head.tolist()
        for j, e in enumerate(ent.tolist()):
            placed = False
            for c in prefs_head[j]:
                if free[c] > 0:
                    assign[e] = c
                    free[c] -= 1
                    placed = True
                    break
            if not placed:
                for c in np.argsort(-sims[j]).tolist():
                    if free[c] > 0:
                        assign[e] = c
                        free[c] -= 1
                        break
    assert (assign >= 0).all()
    return assign


def _unit_rows(emb: np.ndarray) -> np.ndarray:
    """Unit rows: `emb` itself when every row is already unit to 1e-5 (no
    copy), else emb / norm (zero rows stay zero)."""
    n = emb.shape[0]
    norms = np.empty((n, 1), np.float32)

    def task(sl):
        norms[sl] = np.linalg.norm(emb[sl], axis=1, keepdims=True)

    _row_tasks(n, task)
    if abs(float(norms.max(initial=1.0)) - 1.0) < 1e-5 and (
            abs(float(norms.min(initial=1.0)) - 1.0) < 1e-5):
        return emb
    out = np.empty_like(emb)

    def divide(sl):
        out[sl] = emb[sl] / np.where(norms[sl] > 0, norms[sl], 1.0)

    _row_tasks(n, divide)
    return out


def _quantize(unit: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(int8 rows, f32 scales): am / 127 per row, rint, clip to +-127."""
    am = np.maximum(np.abs(unit).max(axis=1), 1e-12)
    sc = (am / 127.0).astype(np.float32)
    return np.clip(np.rint(unit / sc[:, None]), -127, 127).astype(np.int8), sc


def _host_array(a: np.ndarray, pinned: bool) -> np.ndarray:
    if not pinned:
        return a
    from image_retrieval_tpu_torch.index.streaming import pinned_rows

    return pinned_rows(a)


class IVFIndex:
    """Approximate cosine index over unit vectors on `device` (the card
    unless the caller names the CPU), built from raw rows or from a
    ShardedVectorIndex's stored rows (``from_index``)."""

    def __init__(self, nlist: int = 1024, nprobe: int = 10, seed: int = 0,
                 dtype: str = "float32", *, device: DeviceLike = "cuda"):
        if dtype not in ("float32", "int8"):
            raise ValueError(f"IVFIndex dtype {dtype!r}: 'float32' or 'int8'")
        self.nlist = nlist
        self.nprobe = nprobe
        self.seed = seed
        self.dtype = dtype  # "float32" | "int8" (a quarter of the probe bytes)
        self.device = resolve_device(device)
        self.paths: list = []
        # True once a path was given: save() then stores them (the default
        # str(row) paths are never materialized for the check)
        self._custom_paths = False
        self._centroids = None  # (nlist, D) f32 on the device
        self._packed = None  # (nlist * lmax, D) f32 | int8 on the device
        self._row_ids = None  # (nlist * lmax,) int32, -1 padding
        self._scales = None  # (nlist * lmax,) f32, int8 slabs
        self._lmax = 0
        self._replicas = 1
        self.count = 0
        # the incremental-insert tail: host rows (dtype-matched to the
        # slabs) and their device copy, made at the first search after add
        self._tail_rows = None
        self._tail_scales = None
        self._tail_n = 0
        self._tail_dev = None
        # offloaded serving: the slabs in (pinned) host RAM; a search
        # uploads only the query batch's probed slabs
        self._offloaded = False
        self._host_packed = None
        self._host_ids = None
        self._host_slab_scales = None
        self.build_seconds: dict = {}  # the last build's parts
        self.last_upload_bytes = 0  # slab bytes the last offloaded search moved
        # cluster-sharded serving (attach_mesh): the mesh, its axis and the
        # sharded search, made at the first search after a (re)build
        self._mesh: Optional[Mesh] = None
        self._mesh_axis = "data"
        self._sharded_fn = None

    @property
    def _pin(self) -> bool:
        return self.device.type == "cuda"

    def _up(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- build --------------------------------------------------------------

    def build(self, embeddings: np.ndarray, paths: Optional[Sequence[str]] = None,
              iters: int = 10, balance: Optional[float] = 1.5,
              replicas: int = 1, train_size: Optional[int] = None,
              assign_chunk: int = ROW_CHUNK, offload: bool = False) -> "IVFIndex":
        """balance: cluster-size cap as a multiple of the mean (None = the
        raw k-means assignment). The cap bounds lmax (memory is nlist * lmax
        * D and every probe reads lmax rows) at a small recall cost for rows
        pushed to their second-best centroid.

        replicas: each row joins its `replicas` nearest lists (boundary rows
        become findable from either side, at replicas x the memory and
        lmax); search drops the duplicates.

        train_size: k-means trains on a seeded subsample of this many rows
        (chunked Lloyd steps) and the assignment runs in assign_chunk-row
        blocks over the full set, the train/add split of FAISS and of the
        reference's Milvus IVF_FLAT.

        offload: the slabs never go to the device (``offload()``'s state).
        build_seconds records the parts: k-means, assignment, rebalance,
        packing, upload."""
        dev = self.device
        require_full_f32(dev)
        t = time.perf_counter()
        times = {}
        self._offloaded = False
        self._host_packed = self._host_ids = self._host_slab_scales = None
        self._packed = self._row_ids = self._scales = None
        emb = np.asarray(embeddings, np.float32)
        unit = _unit_rows(emb)
        n, d = unit.shape
        # a (re)build defines the full row set: any tail is superseded
        self._tail_rows = self._tail_scales = self._tail_dev = None
        self._tail_n = 0
        nlist = min(self.nlist, n)
        replicas = max(1, min(replicas, nlist))
        with torch.inference_mode():
            if train_size is not None and train_size < n:
                rng = np.random.default_rng(self.seed)
                sel = np.sort(rng.choice(n, size=train_size, replace=False))
                chunk = min(32768, train_size)
                nchunks = max(train_size // chunk, 1)
                train = unit[sel][: nchunks * chunk].reshape(nchunks, chunk, d)
                init = train.reshape(-1, d)[
                    rng.choice(nchunks * chunk, size=nlist, replace=False)
                ]
                centroids = _kmeans_chunked(self._up(train), self._up(init), iters)
                del train
                _sync(dev)
                times["kmeans"] = time.perf_counter() - t
                t = time.perf_counter()
                assign = np.empty(n, np.int32)
                for i in range(0, n, assign_chunk):
                    assign[i: i + assign_chunk] = _assign(
                        self._up(unit[i: i + assign_chunk]), centroids).cpu().numpy()
            else:
                centroids, dev_assign = _kmeans_unit(self._up(unit), self.seed, nlist, iters)
                _sync(dev)
                times["kmeans"] = time.perf_counter() - t
                t = time.perf_counter()
                assign = dev_assign.cpu().numpy()
            if replicas > 1:
                # memberships = each row's top-`replicas` centroids, in row
                # chunks on the device
                tops = np.empty((n, replicas), np.int32)
                for i in range(0, n, ROW_CHUNK):
                    tops[i: i + ROW_CHUNK] = _top_r_centroids(
                        self._up(unit[i: i + ROW_CHUNK]), centroids, replicas).cpu().numpy()
                tops[:, 0] = assign  # keep the primary
                m_rows = np.repeat(np.arange(n, dtype=np.int64), replicas)
                m_assign = tops.reshape(-1).astype(np.int64)
            else:
                m_rows = np.arange(n, dtype=np.int64)
                m_assign = assign.astype(np.int64)
            cent_np = centroids.cpu().numpy()
        times["assign"] = time.perf_counter() - t
        t = time.perf_counter()
        if balance is not None and nlist > 1:
            m_assign = _rebalance_assign(
                unit, cent_np, m_assign.astype(np.int64),
                cap=int(np.ceil(balance * len(m_rows) / nlist)),
                rows=m_rows,
            )
        times["rebalance"] = time.perf_counter() - t
        t = time.perf_counter()
        nm = len(m_rows)
        counts = np.bincount(m_assign, minlength=nlist)
        lmax = int(counts.max())
        # stable sort by cluster; slot = rank within the cluster. int8 rows
        # quantize before packing (a packed f32 copy is never made).
        order = np.argsort(m_assign, kind="stable")
        sorted_assign = m_assign[order]
        starts = np.zeros(nlist, np.int64)
        starts[1:] = np.cumsum(counts)[:-1]
        dest = (np.arange(nm) - starts[sorted_assign]) + sorted_assign * lmax
        src = m_rows[order]
        self._replicas = replicas
        self._lmax = lmax
        row_ids = np.full(nlist * lmax, -1, np.int32)
        row_ids[dest] = src.astype(np.int32)
        pin = offload and self._pin
        int8 = self.dtype == "int8"
        flat = np.zeros((nlist * lmax, d), np.int8 if int8 else np.float32)
        sc_flat = np.zeros(nlist * lmax, np.float32) if int8 else None

        def pack(sl):
            # each entry's row, quantized where the slabs are int8 (a row
            # quantizes to the same bits wherever it is packed)
            if int8:
                flat[dest[sl]], sc_flat[dest[sl]] = _quantize(unit[src[sl]])
            else:
                flat[dest[sl]] = unit[src[sl]]

        _row_tasks(nm, pack)
        times["pack"] = time.perf_counter() - t
        t = time.perf_counter()
        self._centroids = centroids
        if offload:
            # a build past the device's memory: the slabs never touch it
            self._host_packed = _host_array(flat, pin)
            self._host_slab_scales = None if sc_flat is None else _host_array(sc_flat, pin)
            self._host_ids = row_ids
            self._offloaded = True
        else:
            self._packed = self._up(flat)
            self._scales = None if sc_flat is None else self._up(sc_flat)
            self._row_ids = self._up(row_ids)
        _sync(dev)
        times["upload"] = time.perf_counter() - t
        self.build_seconds = times
        self._sharded_fn = None  # the sharded slabs are made anew from these
        self.paths = list(paths) if paths is not None else [str(i) for i in range(n)]
        self._custom_paths = paths is not None
        self.count = n
        self.nlist = nlist
        return self

    # -- incremental tail -----------------------------------------------------

    def add(self, embeddings: np.ndarray,
            paths: Optional[Sequence[str]] = None) -> int:
        """Incremental insert without a rebuild (the Milvus insert after
        create_index, reference ImageEmbeddingSystem.py:136-137).

        New rows land in a tail swept exactly at search time and merged with
        the probed candidates (their recall is 1.0). Past ~10% of the packed
        rows (``needs_rebuild``) a rebuild restores the nlist/nprobe cost.
        Returns the first id assigned to the new rows (contiguous)."""
        if self._packed is None and not self._offloaded:
            raise ValueError(
                "add() before build(): build (or load/from_index) the "
                "packed index first; add() is for incremental growth of a "
                "built index"
            )
        emb = np.asarray(embeddings, np.float32)
        if emb.ndim == 1:
            emb = emb[None]
        norms = np.linalg.norm(emb, axis=1, keepdims=True)
        unit = emb / np.where(norms > 0, norms, 1.0)
        n_new, d = unit.shape
        if self.dtype == "int8":
            rows, sc = _quantize(unit)
        else:
            rows, sc = unit.astype(np.float32), np.ones(n_new, np.float32)
        if self._tail_rows is None:
            self._tail_rows = rows
            self._tail_scales = sc
        else:
            self._tail_rows = np.concatenate([self._tail_rows[: self._tail_n],
                                              rows])
            self._tail_scales = np.concatenate(
                [self._tail_scales[: self._tail_n], sc])
        self._tail_n = len(self._tail_rows)
        self._tail_dev = None
        first = self.count
        self.paths.extend(
            list(paths) if paths is not None
            else [str(first + i) for i in range(n_new)]
        )
        if paths is not None:
            self._custom_paths = True
        self.count += n_new
        return first

    @property
    def tail_count(self) -> int:
        return self._tail_n

    @property
    def needs_rebuild(self) -> bool:
        """True when the exactly swept tail exceeds ~10% of the packed rows:
        past that the tail sweep starts to dominate the probed slabs' cost
        and a rebuild restores the nlist/nprobe model."""
        packed_rows = self.count - self._tail_n
        return self._tail_n > max(packed_rows // 10, 1024)

    def _tail_topk(self, qu: torch.Tensor, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(vals, ids) of the exact top-min(k, tail) over the tail rows, for
        the unit queries `qu`; int8 rows with the slabs' scoring."""
        if self._tail_dev is None:
            self._tail_dev = (self._up(self._tail_rows[: self._tail_n]),
                              self._up(self._tail_scales[: self._tail_n]))
        rows, sc = self._tail_dev
        if self.dtype == "int8":
            s = (qu.to(torch.bfloat16).to(torch.float32) @ rows.to(torch.float32).t()) * sc
        else:
            s = qu @ rows.t()
        vals, local = exact_topk(s, min(k, self._tail_n))
        base = self.count - self._tail_n
        return vals.cpu().numpy(), local.cpu().numpy() + base

    # -- persistence and offload ----------------------------------------------

    def save(self, path: str) -> None:
        """The built index as an uncompressed npz in the JAX package's
        layout: centroids, packed, row_ids, meta (nlist, nprobe, seed, lmax,
        replicas, count, tail rows, offloaded), dtype, and scales, the tail
        and the paths where present (paths only when given)."""
        if self._packed is None and not self._offloaded:
            raise ValueError("save() before build()")
        arrays = dict(
            centroids=self._centroids.cpu().numpy(),
            packed=self._host_packed if self._offloaded else self._packed.cpu().numpy(),
            row_ids=self._host_ids if self._offloaded else self._row_ids.cpu().numpy(),
            meta=np.array([self.nlist, self.nprobe, self.seed, self._lmax,
                           self._replicas, self.count, self._tail_n,
                           int(self._offloaded)],
                          np.int64),
            dtype=np.array(self.dtype),
        )
        if self._offloaded:
            if self._host_slab_scales is not None:
                arrays["scales"] = self._host_slab_scales
        elif self._scales is not None:
            arrays["scales"] = self._scales.cpu().numpy()
        if self._tail_n:
            arrays["tail_rows"] = self._tail_rows[: self._tail_n]
            arrays["tail_scales"] = self._tail_scales[: self._tail_n]
        if self._custom_paths:
            arrays["paths"] = np.array(self.paths)
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path: str, *, device: DeviceLike = "cuda") -> "IVFIndex":
        """An index saved by either package; one saved offloaded comes back
        offloaded (its slabs in pinned host RAM on the card)."""
        with np.load(path, allow_pickle=False) as z:
            meta = [int(v) for v in z["meta"]]
            nlist, nprobe, seed, lmax, replicas, count, tail_n = meta[:7]
            offloaded = bool(meta[7]) if len(meta) > 7 else False
            ivf = cls(nlist=nlist, nprobe=nprobe, seed=seed,
                      dtype=str(z["dtype"]), device=device)
            ivf._centroids = ivf._up(z["centroids"])
            scales = z["scales"] if "scales" in z.files else None
            if offloaded:
                ivf._host_packed = _host_array(z["packed"], ivf._pin)
                ivf._host_ids = z["row_ids"]
                ivf._host_slab_scales = (None if scales is None
                                         else _host_array(scales, ivf._pin))
                ivf._offloaded = True
            else:
                ivf._packed = ivf._up(z["packed"])
                ivf._row_ids = ivf._up(z["row_ids"])
                ivf._scales = None if scales is None else ivf._up(scales)
            ivf._lmax = lmax
            ivf._replicas = replicas
            ivf.count = count
            if tail_n:
                ivf._tail_rows = z["tail_rows"]
                ivf._tail_scales = z["tail_scales"]
                ivf._tail_n = tail_n
            ivf.paths = (
                [str(p) for p in z["paths"]] if "paths" in z.files
                else [str(i) for i in range(count)]
            )
            ivf._custom_paths = "paths" in z.files
        return ivf

    @classmethod
    def from_index(cls, index, nlist: int = 1024, nprobe: int = 10, seed: int = 0,
                   dtype: Optional[str] = None, **build_kwargs) -> "IVFIndex":
        """Build from a ShardedVectorIndex's stored unit rows, on its device.

        Tombstoned rows are left out and ids are remapped to the index's row
        order, so ``index.paths[id]`` is right and the exact and ANN paths
        agree on deleted content; ``count`` covers the index's full row
        space, so ``add`` never reuses an id. dtype follows the base tier
        (int8 and int4 indexes give int8 slabs) unless given. build_kwargs
        go to build(); train_size defaults to 512k above 2^20 rows. Past the
        index's stream_threshold_bytes the slabs are offloaded: decided
        before the build from the rows' bytes, and checked again after it on
        the padded slabs' bytes. The build runs on the index's first
        device; an index row-sharded over more than one device (and not
        over a multi-slice mesh, whose hierarchical merge is the exact
        tier's) attaches its mesh unless the slabs were offloaded."""
        live = np.flatnonzero(index._host_valid[: index.count])
        rows = index._rows_f32(live)
        if dtype is None:
            dtype = "int8" if index._quantized else "float32"
        if len(rows) > (1 << 20):
            build_kwargs.setdefault("train_size", 512 << 10)
        ivf = cls(nlist=nlist, nprobe=nprobe, seed=seed, dtype=dtype, device=index.device)
        thr = getattr(index.config, "stream_threshold_bytes", None)
        itemsize = 1 if dtype == "int8" else 4
        est_bytes = (len(rows) * build_kwargs.get("replicas", 1)
                     * rows.shape[1] * itemsize) if len(rows) else 0
        if thr is not None and est_bytes > thr:
            build_kwargs.setdefault("offload", True)
        ivf.build(rows, **build_kwargs)
        del rows
        rid = ivf._host_ids if ivf._offloaded else ivf._row_ids.cpu().numpy()
        remapped = np.where(rid >= 0, live[np.maximum(rid, 0)], -1).astype(np.int32)
        if ivf._offloaded:
            ivf._host_ids = remapped
        else:
            ivf._row_ids = ivf._up(remapped)
        ivf.paths = list(index.paths)
        ivf._custom_paths = True
        ivf.count = index.count
        if not ivf._offloaded and thr is not None and (
                ivf._packed.numel() * ivf._packed.element_size() > thr):
            ivf.offload()
        if not ivf._offloaded and not index._multislice and index._nshards > 1:
            ivf.attach_mesh(index.mesh, index.axis)
        return ivf

    def offload(self) -> "IVFIndex":
        """Move the cluster slabs to (pinned) host RAM and serve each query
        batch by uploading only its unique probed slabs: at most
        unique_probed * lmax * D bytes a batch where the streamed exact tier
        moves N * D. The centroids stay on the device for probe selection;
        the answers are the resident index's, bit for bit."""
        if self._packed is None:
            raise ValueError("offload() before build()")
        self._host_packed = _host_array(self._packed.cpu().numpy(), self._pin)
        self._host_ids = self._row_ids.cpu().numpy()
        self._host_slab_scales = (
            None if self._scales is None
            else _host_array(self._scales.cpu().numpy(), self._pin)
        )
        self._packed = self._row_ids = self._scales = None
        self._offloaded = True
        self._sharded_fn = None
        return self

    def _gathered_search(self, qu: torch.Tensor, probe: torch.Tensor, kf: int):
        """Offloaded scoring: the batch's unique probed clusters gathered
        from the host slabs into a staging buffer on the host's cores
        (pinned on the card, sized to a power of two of slabs so the pinned
        allocator reuses it), one upload of those slabs, then the resident
        scoring on positions among them."""
        lmax, d = self._lmax, self._host_packed.shape[1]
        pr = probe.cpu().numpy()
        uniq, inv = np.unique(pr, return_inverse=True)
        u = len(uniq)
        ub = 1 << int(np.ceil(np.log2(max(u, 1))))

        def gather(host, width, dtype):
            staging = torch.empty((ub * lmax * width,), dtype=dtype, pin_memory=self._pin)
            out = staging.numpy()[: u * lmax * width].reshape(u, lmax * width)
            src = host.reshape(-1, lmax * width)

            def take(sl):
                # mode="clip": the ids are in range, and "raise" buffers `out`
                np.take(src, uniq[sl], axis=0, out=out[sl], mode="clip")

            if out.nbytes < GATHER_THREADS_BYTES:
                take(slice(0, u))
            else:
                step = -(-u // HOST_WORKERS)
                with ThreadPoolExecutor(HOST_WORKERS) as pool:
                    list(pool.map(take, [slice(i, i + step) for i in range(0, u, step)]))
            return staging[: u * lmax * width].to(self.device, non_blocking=True)

        slabs = gather(self._host_packed, d, torch.from_numpy(self._host_packed[:0]).dtype)
        ids = gather(self._host_ids, 1, torch.int32)
        scales = (None if self._host_slab_scales is None
                  else gather(self._host_slab_scales, 1, torch.float32))
        self.last_upload_bytes = (slabs.numel() * slabs.element_size() + ids.numel() * 4
                                  + (0 if scales is None else scales.numel() * 4))
        local = torch.from_numpy(inv.reshape(pr.shape).astype(np.int64)).to(self.device)
        return _score_probed(qu, local, slabs.view(-1, d), ids, lmax, kf, scales)

    def attach_mesh(self, mesh: Optional[Mesh], axis: str = "data") -> "IVFIndex":
        """Serve search() cluster-sharded over `mesh` (``sharded``): the
        sharded slabs are made at the first search after a (re)build. Mesh
        None serves on the index's device; an offloaded index through the
        host gather, on one device."""
        self._mesh = mesh
        self._mesh_axis = axis
        self._sharded_fn = None
        return self

    def sharded(self, mesh: Mesh, axis: str = "data"):
        """Shard the built slabs over `axis` of `mesh` and return a search
        callable with search()'s contract.

        Each shard holds nlist / n clusters' slabs (with their int8 scales);
        the centroids are replicated; nlist pads with empty clusters (ids -1,
        never probed) to a multiple of the axis so shard boundaries fall on
        cluster boundaries. The tail stays on the first device and merges
        on the host, as on one device. The whole slabs stay where the build
        put them (save, offload and another mesh read them); a shard on
        their device is a view of them (a padded shard a copy of its part),
        so that device holds them once."""
        if self._packed is None:
            raise ValueError(
                "sharded() needs device-resident slabs (build() first; an "
                "offloaded index serves through the host gather instead)")
        devs = shard_devices(mesh, axis)
        nlist, lmax = self.nlist, self._lmax
        pad = (-nlist) % len(devs)
        rows = (nlist + pad) // len(devs) * lmax  # slab rows a shard

        def split(x, fill):
            # shard i's rows, the last shards filled out with empty clusters
            out = []
            for i, dev in enumerate(devs):
                blk = x[i * rows: (i + 1) * rows]
                if len(blk) < rows:
                    blk = torch.cat([blk, blk.new_full((rows - len(blk),) + blk.shape[1:], fill)])
                out.append(blk.to(dev))
            return out

        cent = self._centroids
        if pad:
            cent = torch.cat([cent, cent.new_zeros((pad, cent.shape[1]))])
        d_cent, d_packed, d_ids = (replicate(cent, mesh), split(self._packed, 0),
                                   split(self._row_ids, -1))
        d_scales = None if self._scales is None else split(self._scales, 0)

        def score(qdev, qu, np_, kf):
            return sharded_ivf_search(qdev, d_cent, d_packed, d_ids, lmax, np_, kf, d_scales,
                                      mesh=mesh, axis=axis, nlist_real=nlist if pad else None)

        return lambda queries, top_k=10, nprobe=None: self._search(queries, top_k, nprobe,
                                                                   score)

    # -- search -------------------------------------------------------------

    def _postprocess(self, vals, ids, nq, k, top_k, qu, single):
        """Raw candidates -> final (vals, ids): keep-first replica dedup,
        then the exact tail merged under a stable argsort."""
        vals, ids = np.asarray(vals)[:nq], np.asarray(ids)[:nq]
        if self._replicas > 1:
            dv = np.full((nq, k), -np.inf, vals.dtype)
            di = np.full((nq, k), -1, ids.dtype)
            for r in range(nq):
                _, first = np.unique(ids[r], return_index=True)
                keep = np.sort(first)  # preserve score order
                keep = keep[ids[r][keep] >= 0][:k]
                dv[r, : len(keep)] = vals[r][keep]
                di[r, : len(keep)] = ids[r][keep]
            vals, ids = dv, di
        else:
            vals, ids = vals[:, :k], ids[:, :k]
        if self._tail_n:
            # exact top-k over the tail, merged with the probed candidates
            tv, ti = self._tail_topk(qu, min(top_k, self._tail_n))
            vals = np.concatenate([vals, tv[:nq]], axis=1)
            ids = np.concatenate([ids, ti[:nq]], axis=1)
            order = np.argsort(-vals, axis=1, kind="stable")
            kk = min(top_k, self.count)
            vals = np.take_along_axis(vals, order, axis=1)[:, :kk]
            ids = np.take_along_axis(ids, order, axis=1)[:, :kk]
        return (vals[0], ids[0]) if single else (vals, ids)

    def _probe_counts(self, top_k: int, nprobe: Optional[int]) -> Tuple[int, int, int]:
        """(clusters probed, results k, candidates kf kept per query)."""
        np_ = min(nprobe or self.nprobe, self.nlist)
        packed_n = self.count - self._tail_n
        # k can't exceed the probed slot count (nprobe * lmax scores exist
        # per query)
        k = min(top_k, packed_n, np_ * self._lmax)
        # multi-assigned rows can appear once per replica among the raw
        # candidates: overfetch by the replica factor, dedup keep-first,
        # truncate. The JAX package's rounding of kf decides which
        # candidates survive the dedup, so it is kept.
        kf = min(k * self._replicas, np_ * self._lmax)
        kf = min(next((b for b in (16, 32, 64, 128, 256) if kf <= b), kf),
                 np_ * self._lmax, packed_n)
        return np_, k, kf

    def search(
        self, queries: np.ndarray, top_k: int = 10, nprobe: Optional[int] = None
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Approximate cosine top-k: (scores f32, ids int32), (Q, k) or 1-D
        for a single query; ids in build() order (index row order after
        from_index), -1 for slots the probed clusters cannot fill. Resident
        slabs serve through ``sharded`` over the attached mesh, or over the
        one-device mesh of the index's device; offloaded slabs through the
        host gather."""
        if self.count == 0:
            raise ValueError("index is empty")
        require_full_f32(self.device)
        if self._offloaded:
            def score(qdev, qu, np_, kf):
                _, probe = exact_topk(qu @ self._centroids.t(), np_)
                return self._gathered_search(qu, probe, kf)

            return self._search(queries, top_k, nprobe, score)
        if self._sharded_fn is None:
            mesh, axis = self._mesh, self._mesh_axis
            if mesh is None:
                mesh, axis = entry_mesh(self.device, None), "data"
            self._sharded_fn = self.sharded(mesh, axis)
        return self._sharded_fn(queries, top_k=top_k, nprobe=nprobe)

    def _search(self, queries, top_k: int, nprobe: Optional[int], score):
        """search()'s body around `score(queries on the device, unit
        queries, nprobe, kf) -> (values, row ids)`, each (Q, kf)."""
        q = np.asarray(queries, np.float32)
        single = q.ndim == 1
        if single:
            q = q[None]
        np_, k, kf = self._probe_counts(top_k, nprobe)
        with torch.inference_mode():
            qdev = self._up(q)
            qu = unit_queries(qdev)
            vals, ids = score(qdev, qu, np_, kf)
            return self._postprocess(vals.cpu().numpy(), ids.cpu().numpy(), q.shape[0], k,
                                     top_k, qu, single)

    def recall_at(self, queries: np.ndarray, exact_ids: np.ndarray, k: int = 10,
                  nprobe: Optional[int] = None) -> float:
        """Mean top-k recall against the exact ids (the nprobe tuning
        measurement)."""
        from image_retrieval_tpu_torch.index.evaluation import mean_recall

        _, got = self.search(queries, top_k=k, nprobe=nprobe)
        return mean_recall(got, exact_ids)
