"""Projection-screened two-phase cosine search — port of
``image_retrieval_tpu/index/screen.py``.

  phase 1  q' = q @ P; sweep an int8 (N, ds) sketch of the rows (ds << D)
           for the top-C candidates per query and shard: ds / D of the
           exact sweep's row bytes.
  phase 2  gather the C candidates' full stored rows and rerank them with
           the resident engine's scoring math (for int8 rows: the bf16 unit
           query x the int8 rows, f32 sums, x the norm-preserving scale), so
           a candidate set that covers the true top-k gives the exact
           engine's answers.

P is the gallery's top-ds principal subspace ("pca": eigenvectors of the
uncentered second moment X^T X, computed on the device; the eigenvectors on
the host with the JAX package's numpy code) or a seeded random rotation
("random"). Recall is a property of the data's clustering: measure it with
``recall_at``.

The resident screen follows its index's mesh, as the JAX package's does:
each shard's moment is summed (float64) over the shards, which is another
order of sums than one device's, so a sharded projection agrees with the
one-device projection to rounding; each shard projects and quantizes its
own rows into its sketch, sweeps it for its top-C, reranks those
candidates against its own rows, and the exact k-lists merge as the exact
tier's do (``parallel/collectives.py``), hierarchically on a multi-slice
mesh. The candidate pool is C a shard.

Over a streamed index (``index/streaming.py``) the screen runs in streamed
mode: the sketch is built in chunked passes over the host rows (one for
"random", two for "pca") and stays on the device; phase 2 gathers only the
Q x C candidate rows from host RAM.

Cosine only. It plugs into the app as ``SearchConfig.ann = "screen"``
through ``search(q_unit, top_k) -> (cos, ids)`` with (-inf, -1) padding, and
is rebuilt when its parent index mutates (``stale``). The streamed screen
stays on the index's first device, as the streamed tier does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from image_retrieval_tpu_torch.device import require_full_f32
from image_retrieval_tpu_torch.ops.int4 import segmented_topc, unit_queries
from image_retrieval_tpu_torch.ops.topk import exact_topk, two_key_topk
from image_retrieval_tpu_torch.parallel.collectives import _merge, _Split
from image_retrieval_tpu_torch.parallel.mesh import on_device

# Resident phase 1: rows per scored block, with a running top-C merge.
_RESIDENT_P1_BLOCK = 1 << 17
# Streamed build: rows per host->device pass.
_STREAM_FIT_CHUNK = 1 << 22
# Streamed phase 1: rows per scored block.
_PHASE1_BLOCK = 1 << 21
# Rows per block of the resident build's passes (the f32 dequantized block).
_BUILD_BLOCK = 1 << 18


def _fit_projection(d: int, ds: int, method: str, seed: int,
                    cov: Optional[np.ndarray]) -> np.ndarray:
    """(D, ds) projection: the top-ds eigenvectors of the uncentered second
    moment `cov` ('pca') or a seeded orthonormal rotation ('random'). Host
    numpy, the JAX package's code, shared by the resident and streamed
    builds."""
    if method == "pca":
        _, vecs = np.linalg.eigh(np.asarray(cov, np.float64))
        return np.ascontiguousarray(vecs[:, ::-1][:, :ds]).astype(np.float32)
    if method == "random":
        rng = np.random.default_rng(seed)
        qmat, _ = np.linalg.qr(rng.standard_normal((d, ds)))
        return qmat[:, :ds].astype(np.float32)
    raise ValueError(f"unknown screen method '{method}'")


def _quantize_rows_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 with a norm-preserving scale (||q row|| x
    scale == ||row||). The divisors are tensors: on the card a division by
    a Python scalar multiplies by its reciprocal."""
    absmax = torch.clamp(x.abs().amax(1), min=1e-12)
    grid = (absmax / torch.full_like(absmax, 127.0))[:, None]
    q = torch.clamp(torch.round(x / grid), -127, 127).to(torch.int8)
    qn = torch.linalg.vector_norm(q.to(torch.float32), dim=1)
    xn = torch.linalg.vector_norm(x, dim=1)
    return q, xn / torch.where(qn > 0, qn, torch.ones_like(qn))


def _dequant(rows: torch.Tensor, scales: Optional[torch.Tensor]) -> torch.Tensor:
    x = rows.to(torch.float32)
    return x if scales is None else x * scales[:, None]


def second_moment(gallery, valid, scales, block: int = _BUILD_BLOCK) -> np.ndarray:
    """(D, D) uncentered second moment of the live dequantized rows: f32
    products a block of rows at a time, summed in float64. Lists of row
    shards (the index's device copy) sum their shards' moments in shard
    order, each computed on its shard's device."""
    if isinstance(gallery, (list, tuple)):
        cov = None
        for s, g in enumerate(gallery):
            with on_device(g.device):
                part = second_moment(g, None if valid is None else valid[s],
                                     None if scales is None else scales[s], block)
            cov = part if cov is None else cov + part
        return cov
    require_full_f32(gallery.device)
    d = gallery.shape[1]
    cov = np.zeros((d, d), np.float64)
    for lo in range(0, gallery.shape[0], block):
        hi = min(lo + block, gallery.shape[0])
        x = _dequant(gallery[lo:hi], None if scales is None else scales[lo:hi])
        if valid is not None:
            x = torch.where(valid[lo:hi, None], x, 0.0)
        cov += (x.t() @ x).cpu().numpy().astype(np.float64)
    return cov


def project_quantize(gallery: torch.Tensor, scales: Optional[torch.Tensor],
                     proj: torch.Tensor, sketch: torch.Tensor, sk_scales: torch.Tensor,
                     at: int = 0, block: int = _BUILD_BLOCK) -> None:
    """sketch[at:], sk_scales[at:] = the int8 quantization of
    dequant(gallery) @ proj, a block of rows at a time."""
    require_full_f32(gallery.device)
    for lo in range(0, gallery.shape[0], block):
        hi = min(lo + block, gallery.shape[0])
        x = _dequant(gallery[lo:hi], None if scales is None else scales[lo:hi])
        sketch[at + lo: at + hi], sk_scales[at + lo: at + hi] = _quantize_rows_int8(x @ proj)


def sketch_topc(qs16: torch.Tensor, sketch: torch.Tensor, sk_scales: torch.Tensor,
                valid: Optional[torch.Tensor], c: int,
                block: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Phase 1: the top-c rows of the sketch sweep (the bf16 query sketch x
    the int8 sketch rows, f32 sums, x the row's scale; rows where `valid`
    is False -inf), `block` rows scored at a time with a running merge. The
    selection is exact with lowest rows first among ties, so the blocked
    sweep equals the direct one. Returns (values, row ids), (Q, min(c, N))."""
    q = qs16.to(torch.float32)

    def seg(off, rows):
        s = (q @ sketch[off: off + rows].to(torch.float32).t()) * sk_scales[off: off + rows]
        return s if valid is None else s.masked_fill(~valid[off: off + rows], float("-inf"))

    n = sketch.shape[0]
    return segmented_topc(seg, n, c, block if n > block and c <= block else max(n, 1))


def rerank_rows(qu16: torch.Tensor, rows: torch.Tensor,
                scales: Optional[torch.Tensor]) -> torch.Tensor:
    """Phase 2: (Q, C) cosines of gathered candidate rows (Q, C, D). int8
    rows: the bf16 unit query x the int8 values (exact products, f32 sums)
    x the scales (Q, C), the resident int8 sweep's math; f32 or bf16 rows:
    the f32 unit query x the rows upcast."""
    r = torch.bmm(rows.to(torch.float32), qu16[:, :, None].to(torch.float32))[..., 0]
    return r if scales is None else r * scales


class ScreenedSearch:
    """Projection-screened cosine search over a ShardedVectorIndex's rows.

    Build with ``from_index``. ``search`` returns exact-reranked candidates:
    descending cosine, (-inf, -1) for slots the live rows cannot fill."""

    def __init__(self, index, proj: np.ndarray, sketch: torch.Tensor,
                 sk_scales: torch.Tensor, candidates: int, method: str,
                 streamed: bool = False):
        if candidates < 1:
            raise ValueError(f"candidates must be >= 1, got {candidates} "
                             "(SearchConfig.screen_candidates / --screen-candidates)")
        self._index = index
        self.proj = proj  # (D, ds) host copy
        self._proj = torch.from_numpy(proj).to(index.device)
        # (N, ds) int8: streamed, one tensor on the index's first device;
        # resident, a list of row shards beside the index's (sk_scales alike)
        self._sketch = sketch
        self._sk_scales = sk_scales
        self.candidates = int(candidates)
        self.method = method
        self.streamed = bool(streamed)
        self.generation = index.generation
        self.sketch_dims = int(proj.shape[1])
        self.p1_block = _RESIDENT_P1_BLOCK  # the resident phase 1's block

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_index(cls, index, sketch_dims: int = 128, candidates: int = 128,
                   method: str = "pca", seed: int = 0) -> "ScreenedSearch":
        """Build the sketch from the index's device rows (resident) or from
        its host rows in chunked passes (streamed). method "pca" (one more
        pass over the rows, for the second moment) or "random"."""
        if index.count == 0:
            raise ValueError("cannot screen an empty index")
        index._sync_device()
        if index._packed4:
            raise ValueError(
                "the screen tier does not stack on an int4 index: dtype='int4' is "
                "already a two-phase screened design (full-dimension int4 screen -> "
                "exact rerank); use dtype='int8' for the projection screen")
        if index._stream is not None:
            return cls._from_streamed(index, sketch_dims, candidates, method, seed)
        d = index.dim
        ds = int(min(sketch_dims, d))
        split = _Split(index._gallery, index.mesh, index._row_axes)
        scales = split.rows(index._scales)
        with torch.inference_mode():
            cov = (second_moment(index._gallery, index._valid, index._scales)
                   if method == "pca" else None)
            proj = _fit_projection(d, ds, method, seed, cov)
            sketch, sk_scales = [], []
            for s, dev in split.each():
                sketch.append(torch.empty((split.nlocal, ds), dtype=torch.int8, device=dev))
                sk_scales.append(torch.empty(split.nlocal, dtype=torch.float32, device=dev))
                project_quantize(split.gallery[s], scales[s], torch.from_numpy(proj).to(dev),
                                 sketch[s], sk_scales[s])
        return cls(index, proj, sketch, sk_scales, candidates, method)

    @classmethod
    def _from_streamed(cls, index, sketch_dims: int, candidates: int, method: str,
                       seed: int) -> "ScreenedSearch":
        """The streamed build: passes of _STREAM_FIT_CHUNK host rows through
        the device, one for 'random', two for 'pca'. The sketch is assembled
        on the device (it fits where the gallery does not: ds << D)."""
        n, d = index.count, index.dim
        rows, scales = index._host_gallery[:n], index._host_scales[:n]
        ds = int(min(sketch_dims, d))
        dev = index.device

        def chunks():
            for s in range(0, n, _STREAM_FIT_CHUNK):
                e = min(s + _STREAM_FIT_CHUNK, n)
                yield s, (torch.from_numpy(np.ascontiguousarray(rows[s:e])).to(dev),
                          torch.from_numpy(np.ascontiguousarray(scales[s:e], np.float32)).to(dev),
                          index._valid[s:e])

        with torch.inference_mode():
            cov = None
            if method == "pca":
                cov = np.zeros((d, d), np.float64)
                for _, (r8, sc, v) in chunks():
                    cov += second_moment(r8, v, sc)
            proj = _fit_projection(d, ds, method, seed, cov)
            pdev = torch.from_numpy(proj).to(dev)
            sketch = torch.empty((n, ds), dtype=torch.int8, device=dev)
            sk_scales = torch.empty(n, dtype=torch.float32, device=dev)
            for s, (r8, sc, _) in chunks():
                project_quantize(r8, sc, pdev, sketch, sk_scales, at=s)
        return cls(index, proj, sketch, sk_scales, candidates, method, streamed=True)

    @property
    def stale(self) -> bool:
        """True when the parent index has mutated since the sketch was built;
        rebuild with from_index."""
        return self.generation != self._index.generation

    def recall_at(self, queries: np.ndarray, exact_ids: np.ndarray, k: int = 10) -> float:
        """Mean top-k recall against the exact ids (the tuning measurement
        of (sketch_dims, candidates))."""
        from image_retrieval_tpu_torch.index.evaluation import mean_recall

        _, got = self.search(queries, top_k=k)
        return mean_recall(got, exact_ids)

    # -- search ----------------------------------------------------------------

    def _pool(self, top_k: int, n: int) -> int:
        """The candidate pool: `candidates` doubled until it holds top_k,
        at most n."""
        c = self.candidates
        while c < top_k:
            c *= 2
        return min(c, n)

    def search(self, queries: np.ndarray, top_k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """(cosines (Q, top_k) f32, row ids (Q, top_k) int32), or 1-D for a
        single query; slots the live rows cannot fill are (-inf, -1)."""
        if self.stale:
            raise ValueError(
                "index mutated since the sketch was built (generation "
                f"{self._index.generation} != {self.generation}); rebuild with "
                "ScreenedSearch.from_index")
        idx = self._index
        require_full_f32(idx.device)
        idx._sync_device()
        q = np.asarray(queries, np.float32)
        single = q.ndim == 1
        q = q[None] if single else q
        with torch.inference_mode():
            qu = unit_queries(torch.from_numpy(q).to(idx.device))
            qs16 = (qu @ self._proj).to(torch.bfloat16)
            if self.streamed:
                vals, gidx = self._search_streamed(qu, qs16, top_k)
            else:
                vals, gidx = self._search_resident(qu, qs16, top_k)
            vals, gidx = vals.cpu().numpy(), gidx.cpu().numpy()
        vals, gidx = _pad(vals, gidx, top_k)
        gidx = np.where(np.isfinite(vals), gidx, -1).astype(np.int32)
        return (vals[0], gidx[0]) if single else (vals, gidx)

    def _search_resident(self, qu, qs16, top_k):
        """Per shard: phase 1 over its sketch, phase 2 over its rows, its
        top-cl; then the k-sized merge of the shards' exact lists."""
        idx = self._index
        split = _Split(idx._gallery, idx.mesh, idx._row_axes)
        scales = split.rows(idx._scales)
        c = self._pool(top_k, idx._device_rows())
        cl = min(c, split.nlocal)
        quantized = idx._quantized
        parts = []
        for s, _ in split.each():
            p1v, cidx = sketch_topc(split.queries(qs16, s), self._sketch[s], self._sk_scales[s],
                                    idx._valid[s], cl, int(self.p1_block))
            q = split.queries(qu, s)
            r = rerank_rows(q.to(torch.bfloat16) if quantized else q, split.gallery[s][cidx],
                            scales[s][cidx] if quantized else None)
            # a pool larger than the live rows carries -inf slots: never reranked in
            r = torch.where(idx._valid[s][cidx] & torch.isfinite(p1v), r, float("-inf"))
            vals, ii = exact_topk(r, cl)
            parts.append((vals, split.offset(torch.gather(cidx, 1, ii), s)))
        return _merge(parts, split, c, True)

    def _search_streamed(self, qu, qs16, top_k):
        """Phase 1 over the device sketch; phase 2 gathers the Q x C
        candidate rows from host RAM (the only gallery bytes that move) and
        reranks them on the device; (score, then row) order."""
        idx = self._index
        n = idx.count
        c = self._pool(top_k, n)
        p1v, cand = sketch_topc(qs16, self._sketch, self._sk_scales, idx._valid, c,
                                _PHASE1_BLOCK)
        host = cand.cpu().numpy()
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(idx.device)
        r = rerank_rows(qu.to(torch.bfloat16), dev(idx._host_gallery[host]),
                        dev(idx._host_scales[host]))
        # tombstones and a pool larger than the live rows: -inf slots
        r = torch.where(idx._valid[cand] & torch.isfinite(p1v), r, float("-inf"))
        return two_key_topk(r, cand, min(top_k, n), True)


def _pad(vals: np.ndarray, ids: np.ndarray, top_k: int):
    """Widen (Q, w) results to top_k columns with (-inf, -1), or cut them."""
    w = vals.shape[1]
    if w >= top_k:
        return vals[:, :top_k], ids[:, :top_k]
    nq = vals.shape[0]
    return (np.concatenate([vals, np.full((nq, top_k - w), -np.inf, np.float32)], 1),
            np.concatenate([ids, np.full((nq, top_k - w), -1, ids.dtype)], 1))
