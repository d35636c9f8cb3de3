"""Beyond-device-memory exact search: the gallery stays in host RAM and
streams through the card in chunks — port of
``image_retrieval_tpu/index/streaming.py``.

The gallery is kept as int8 rows (with per-row norm-preserving scales) in
host memory and swept in fixed-size chunks. On the card the chunks move
through a double buffer: two device chunk buffers, each refilled on a copy
stream from pinned host memory once an event shows that the sweep of the
chunk it held has finished, so the upload of chunk i + 1 overlaps the sweep
of chunk i. The running top-k stays on the device, and one fetch ends a
search. Host rows that are not pinned already are copied once into pinned
memory when the engine is built; if the memory cannot be pinned, that
raises (the chunks never move by pageable copies).

- int8 chunks score as the resident int8 cosine does
  (``parallel/collectives.py``: the bf16-rounded unit query x the int8 rows,
  f32 sums, x the row's scale), so streamed answers equal the resident int8
  tier's.
- ``packed4``: the chunks are the int4 tier's nibble-packed rows (half the
  bytes a sweep moves) and each is screened by the int4 screen kernel (K3,
  ``ops/int4_screen.py::int4_screen_topc``, one launch per 2^21-row segment
  of a chunk); the running state keeps the top ``rerank_c`` candidates, whose
  int8 rows (``rerank_rows``, an array or an ``np.memmap``) are gathered on
  the host and reranked exactly (``ops/int4.py::rerank_int8_topk``).
  Without ``rerank_rows`` the screen's own ranking is returned.
- An optional (N,) bool mask (an attribute filter) excludes rows.

Among equal scores the lower global row wins, as the JAX engine's
``[state, chunk]`` merge gives it. A chunk shorter than ``chunk_rows`` (the
tail) is swept as the prefix of its buffer that the upload filled, so no
padding row is ever scored. The JAX engine's TPU-only paired chunk layout
is not carried over; its per-half ``approx_max_k`` is the exact top-c here,
which is what it computes off the TPU.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from image_retrieval_tpu_torch.device import DeviceLike, require_full_f32, resolve_device
from image_retrieval_tpu_torch.ops.int4 import rerank_int8_topk
from image_retrieval_tpu_torch.ops.int4_screen import int4_screen_topc
from image_retrieval_tpu_torch.ops.topk import exact_topk_wide, two_key_topk
from image_retrieval_tpu_torch.parallel.collectives import INT4_SCREEN_QFORM, _row_dots

# Rows per chunk: the JAX engine's default (a 512-d int8 chunk is 2 GiB).
CHUNK_ROWS = 4_194_304


def quantize_rows_int8(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Norm-preserving symmetric int8 quantization of unit rows: per-row
    absmax grid, scales 1 / ||int8 row||, so raw int8 dot x scale is the
    cosine against a unit query. Host numpy, as the JAX engine's."""
    rows = np.asarray(rows, np.float32)
    grid = np.maximum(np.abs(rows).max(axis=1), 1e-12) / 127.0
    q8 = np.clip(np.rint(rows / grid[:, None]), -127, 127).astype(np.int8)
    qn = np.linalg.norm(q8.astype(np.float32), axis=1)
    scales = (1.0 / np.where(qn > 0, qn, 1.0)).astype(np.float32)
    return q8, scales


def pinned_empty(shape, dtype) -> np.ndarray:
    """An uninitialized host array in pinned memory (torch raises if the
    memory cannot be pinned); the array keeps its buffer alive."""
    return torch.empty(shape, dtype=torch.from_numpy(np.empty(0, dtype)).dtype,
                       pin_memory=True).numpy()


def pinned_rows(rows: np.ndarray) -> np.ndarray:
    """`rows` in pinned host memory: as given when they already lie in it
    (an index allocates its streamed rows pinned), else one copy into a new
    pinned allocation."""
    rows = np.ascontiguousarray(rows)
    if torch.from_numpy(rows).is_pinned():
        return rows
    out = pinned_empty(rows.shape, rows.dtype)
    np.copyto(out, rows)
    return out


class StreamingGallerySearch:
    """Exact cosine top-k over a host-resident int8 gallery, streamed in
    chunks through `device` (the card unless the caller names the CPU).

    rows_int8 (N, D) int8 and scales (N,) f32 (``quantize_rows_int8``'s, or
    the index's norm-preserving ones); chunk_rows rows per upload. With
    packed4, rows_int8 is an (N, D/2) uint8 nibble-packed gallery
    (``ops/int4.py::quantize_pack_int4``) with its int4 scales; rerank_rows
    (N, D) int8 and rerank_scales (N,) then finish with the exact rerank of
    the top rerank_c candidates."""

    def __init__(self, rows_int8: np.ndarray, scales: np.ndarray,
                 chunk_rows: int = CHUNK_ROWS, device: DeviceLike = "cuda",
                 packed4: bool = False, rerank_rows: Optional[np.ndarray] = None,
                 rerank_scales: Optional[np.ndarray] = None, rerank_c: int = 128):
        self.packed4 = bool(packed4)
        if rows_int8.ndim != 2 or rows_int8.dtype != (np.uint8 if self.packed4 else np.int8):
            raise ValueError(f"streamed rows: (N, {'D/2) uint8' if self.packed4 else 'D) int8'}"
                             f" expected, got {rows_int8.shape} {rows_int8.dtype}")
        self.n = rows_int8.shape[0]
        self._store_width = rows_int8.shape[1]
        self.dim = self._store_width * 2 if self.packed4 else self._store_width
        if np.shape(scales) != (self.n,):
            raise ValueError(f"scales of shape {np.shape(scales)} for {self.n} rows")
        if self.packed4 and rerank_rows is not None:
            if rerank_rows.shape != (self.n, self.dim) or rerank_scales is None:
                raise ValueError(f"rerank_rows {rerank_rows.shape} (with rerank_scales) "
                                 f"must be ({self.n}, {self.dim})")
        self._rerank_rows = rerank_rows if self.packed4 else None
        self._rerank_scales = rerank_scales if self.packed4 else None
        self.rerank_c = int(rerank_c)
        self.chunk_rows = int(max(1, min(chunk_rows, self.n)))
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._rows = pinned_rows(rows_int8) if self._cuda else rows_int8
        self._chunks = [(s, min(s + self.chunk_rows, self.n) - s)
                        for s in range(0, self.n, self.chunk_rows)]
        # every row's scale ships once (N x 4 bytes); only rows stream
        self._scales = torch.from_numpy(np.ascontiguousarray(scales, np.float32)).to(self.device)
        self._buffers: List[torch.Tensor] = []  # the double buffer (CUDA)
        self._copy_stream = None
        # a list to receive, per chunk, (chunk, buffer, copy start, copy end,
        # sweep end) CUDA events: how tests see the double buffer's order
        self.timeline: Optional[list] = None

    # -- the double buffer ------------------------------------------------------

    def _host_chunk(self, ci: int) -> torch.Tensor:
        s, nv = self._chunks[ci]
        return torch.from_numpy(self._rows[s: s + nv])

    def _ensure_buffers(self) -> None:
        if self._buffers:
            return
        self._copy_stream = torch.cuda.Stream(self.device)
        dtype = torch.uint8 if self.packed4 else torch.int8
        for _ in range(min(2, len(self._chunks))):
            buf = torch.empty((self.chunk_rows, self._store_width), dtype=dtype,
                              device=self.device)
            buf.record_stream(self._copy_stream)  # written there, read on the sweep's
            self._buffers.append(buf)

    def _device_chunks(self):
        """Yield (chunk index, device rows of the chunk) in order. On the
        card: chunk i + 1's upload is issued before chunk i is handed out,
        into the other buffer, after the copy stream has waited for the
        event recorded when that buffer's previous chunk was swept."""
        if not self._cuda:
            for ci in range(len(self._chunks)):
                yield ci, self._host_chunk(ci)
            return
        self._ensure_buffers()
        compute = torch.cuda.current_stream(self.device)
        swept = [None] * len(self._buffers)  # event: the buffer's last sweep ended
        ready = [None] * len(self._buffers)  # event: the buffer's upload ended
        marks = {}

        def upload(ci):
            b = ci % len(self._buffers)
            nv = self._chunks[ci][1]
            with torch.cuda.stream(self._copy_stream):
                if swept[b] is not None:
                    self._copy_stream.wait_event(swept[b])
                start = self._event(self._copy_stream) if self.timeline is not None else None
                self._buffers[b][:nv].copy_(self._host_chunk(ci), non_blocking=True)
                ready[b] = self._event(self._copy_stream)
            marks[ci] = (b, start, ready[b])

        upload(0)
        for ci in range(len(self._chunks)):
            b = ci % len(self._buffers)
            if ci + 1 < len(self._chunks):
                upload(ci + 1)
            compute.wait_event(ready[b])
            yield ci, self._buffers[b][: self._chunks[ci][1]]
            swept[b] = self._event(compute)
            if self.timeline is not None:
                self.timeline.append((ci, b, marks[ci][1], marks[ci][2], swept[b]))

    def _event(self, stream):
        """An event recorded on `stream` (timed when a timeline is kept)."""
        ev = torch.cuda.Event(enable_timing=self.timeline is not None)
        ev.record(stream)
        return ev

    # -- search -----------------------------------------------------------------

    def search(self, queries_unit, top_k: int = 10,
               mask: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        """queries_unit: (Q, D) or (D,) unit f32 queries (numpy or a tensor).
        Returns numpy (scores (Q, k) f32, row ids (Q, k) int32), k =
        min(top_k, N), exact over all N rows. `mask`: optional (N,) bool;
        rows where it is False are excluded, and a tail it cannot fill pads
        with (-inf, -1)."""
        require_full_f32(self.device)
        q = (queries_unit if isinstance(queries_unit, torch.Tensor)
             else torch.from_numpy(np.asarray(queries_unit, np.float32)))
        q = q.to(self.device, torch.float32)
        if q.dim() == 1:
            q = q[None]
        nq = q.shape[0]
        q16 = q.to(torch.bfloat16).contiguous()
        qf = q16.to(torch.float32)
        k = int(min(top_k, self.n))
        rerank = self.packed4 and self._rerank_rows is not None
        kk = int(min(max(self.rerank_c, k), self.n)) if rerank else k
        keep = None
        if mask is not None:
            mask = np.asarray(mask, bool)
            if mask.shape != (self.n,):
                raise ValueError(f"mask of shape {mask.shape} for {self.n} rows")
            keep = torch.from_numpy(mask).to(self.device)
        vals = torch.full((nq, kk), float("-inf"), dtype=torch.float32, device=self.device)
        idx = torch.full((nq, kk), -1, dtype=torch.int64, device=self.device)
        with torch.inference_mode():
            for ci, rows in self._device_chunks():
                s, nv = self._chunks[ci]
                ck = None if keep is None else keep[s: s + nv]
                cv, cidx = self._chunk_topk(q16, qf, rows, s, nv, ck, min(kk, nv))
                vals, idx = two_key_topk(torch.cat([vals, cv], 1),
                                         torch.cat([idx, cidx + s], 1), kk, True)
            if rerank:
                vals, idx = self._rerank(q, vals, idx, k)
        vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
        idx = np.where(np.isfinite(vals), idx, -1).astype(np.int32)
        return vals, idx

    def _chunk_topk(self, q16, qf, rows, s, nv, keep, kk):
        """One chunk's exact top-kk: (values, chunk-local rows)."""
        sc = self._scales[s: s + nv]
        if self.packed4:
            valid = keep if keep is not None else torch.ones(nv, dtype=torch.bool,
                                                             device=self.device)
            return int4_screen_topc(q16, rows, sc, valid, kk, qform=INT4_SCREEN_QFORM)
        scores = _row_dots(qf, rows) * sc
        if keep is not None:
            scores.masked_fill_(~keep, float("-inf"))
        return exact_topk_wide(scores, kk)

    def _rerank(self, q, vals, idx, k):
        """Exact phase 2 of packed4: the candidates' int8 rows gathered on
        the host (an array or an np.memmap: only these rows are read),
        reranked on the device with the resident int8 sweep's math."""
        v, i = vals.cpu().numpy(), idx.cpu().numpy()
        ok = np.isfinite(v)
        safe = np.where(ok, i, 0)
        dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        rvals, pos = rerank_int8_topk(
            q, dev(np.asarray(self._rerank_rows[safe])),
            dev(np.asarray(self._rerank_scales)[safe].astype(np.float32)), dev(ok), k)
        return rvals, torch.gather(idx, 1, pos)

    def close(self) -> None:
        """Release the device buffers (after the copy stream has drained)."""
        if self._copy_stream is not None:
            self._copy_stream.synchronize()
        self._buffers = []
        self._copy_stream = None

    # -- introspection ----------------------------------------------------------

    @property
    def bytes_per_sweep(self) -> int:
        """Host->device bytes one pass over the gallery moves (the scales
        are resident; packed int4 moves half of int8)."""
        return self.n * self._store_width

    def expected_sweep_seconds(self, transfer_gbps: float,
                               compute_s_per_chunk: float) -> float:
        """The sweep-time model: max(transfer, compute) per chunk, the two
        overlapped by the double buffer."""
        t_xfer = self.chunk_rows * self._store_width / (transfer_gbps * 1e9)
        return len(self._chunks) * max(t_xfer, compute_s_per_chunk)
