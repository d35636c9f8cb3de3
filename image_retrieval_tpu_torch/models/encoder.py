"""Encoder facade: batched embedding generation on one device.

Port of ``image_retrieval_tpu/models/encoder.py``. Two implementations share
one interface:
  CLIPEncoder — the PyTorch CLIP (HF weights when a checkpoint directory is
                configured, seeded random weights otherwise) on the card,
                or on the CPU when the caller asks for it.
  FakeEncoder — the deterministic numpy projection encoder, a verbatim copy
                (bit-identical embeddings to the JAX package's).

Batches snap to the same bucket ladder as the JAX encoder, so both packages
pad a batch to the same shape.
"""

from __future__ import annotations

import hashlib
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from image_retrieval_tpu_torch.config import Config
from image_retrieval_tpu_torch.device import (
    DeviceLike,
    require_full_f32,
    resolve_device,
    torch_dtype,
)
from image_retrieval_tpu_torch.models.clip import CLIP
from image_retrieval_tpu_torch.models.preprocess import (
    normalize_u8_device,
    preprocess_batch,
)
from image_retrieval_tpu_torch.models.tokenizer import get_tokenizer


class Encoder:
    """Interface: paths/texts in, unnormalized f32 embeddings out."""

    dim: int = 512

    def encode_images(self, paths: Sequence[str], batch_size: int = 256) -> np.ndarray:
        raise NotImplementedError

    def encode_pixels(self, pixels: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        raise NotImplementedError

    def encode_stream(self, batches):
        """Iterate (meta, pixels) pairs, yield (meta, embeddings) in order.

        Synchronous here (one encode_pixels per batch); CLIPEncoder keeps
        several batches in flight across the caller's batches."""
        for meta, pixels in batches:
            yield meta, self.encode_pixels(pixels)


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    if x.shape[0] == n:
        return x
    pad = np.zeros((n - x.shape[0],) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad], 0)


class _Pending:
    """One dispatched chunk: its forward is queued on the device (or, on
    the CPU, already done), its result lands in `host_out`; `keep` rows of
    it are real. `staging` and `host_out` are pinned buffers on loan from
    the encoder's pool until fetch."""

    __slots__ = ("host_out", "keep", "event", "staging")

    def __init__(self, host_out, keep, event=None, staging=None):
        self.host_out, self.keep, self.event, self.staging = host_out, keep, event, staging


class CLIPEncoder(Encoder):
    """CLIP on `device` ("cuda", the default, or "cpu"). `params` is a state
    dict from models/weights.py; without one, Config.weights_path or `seed`
    decides.

    Batches are kept in flight: on the card a chunk is staged in a pinned
    host buffer, copied to the device on a copy stream, run on the device's
    current stream once that copy's event has fired, and copied back into a
    pinned buffer behind an event; the host fetches the oldest chunk only
    when _MAX_IN_FLIGHT are queued, so uploads, forwards and fetches overlap
    the caller's host work (decode). On the CPU the same order and window
    run synchronously. Either way the outputs equal the one-at-a-time
    form's bit for bit: the same chunks go through the same forward."""

    # the JAX encoder's bucket ladder (one compile per shape there; here it
    # keeps both packages' padded shapes equal)
    _BUCKETS = (8, 32, 128, 192, 256)
    # chunks dispatched and not yet fetched; each holds a pinned staging and
    # a pinned output buffer until fetched, so the window bounds both the
    # pinned memory and how far the host runs ahead of the card
    _MAX_IN_FLIGHT = 4

    def __init__(self, config: Optional[Config] = None, params=None,
                 seed: int = 0, *, device: DeviceLike = "cuda"):
        self.config = config or Config()
        cfg = self.config.model
        self.dim = cfg.embed_dim
        self.device = resolve_device(device)
        self.model = CLIP(cfg, dtype=torch_dtype(cfg.dtype))
        if params is None:
            if self.config.weights_path:
                from image_retrieval_tpu_torch.models.weights import load_hf_clip_params

                params = load_hf_clip_params(self.config.weights_path, cfg)
            else:
                from image_retrieval_tpu_torch.models.weights import init_params

                params = init_params(cfg, seed=seed)
        self.model.load_state_dict(
            {k: torch.as_tensor(v, dtype=torch.float32) for k, v in params.items()})
        self.model.to(self.device).eval()
        self.tokenizer = get_tokenizer(self.config.weights_path)
        self._copy_stream = None  # created at the first dispatch on the card
        # free pinned buffers by (shape, dtype); a server encodes from several
        # threads at once, hence the lock (it also guards the copy stream)
        self._pinned: Dict[tuple, List[torch.Tensor]] = {}
        self._lock = threading.Lock()

    def _batch_sizes(self, requested: int) -> int:
        for b in self._BUCKETS:
            if requested <= b:
                return b
        return requested

    # -- the in-flight window ------------------------------------------------

    def _take_pinned(self, shape, dtype) -> torch.Tensor:
        with self._lock:
            free = self._pinned.get((tuple(shape), dtype))
            if free:
                return free.pop()
        return torch.empty(tuple(shape), dtype=dtype, pin_memory=True)

    def _give_pinned(self, buf: torch.Tensor) -> None:
        with self._lock:
            self._pinned.setdefault((tuple(buf.shape), buf.dtype), []).append(buf)

    def _launch(self, padded: np.ndarray, keep: int, fn) -> _Pending:
        """Queue one padded chunk's forward; see the class docstring."""
        with torch.inference_mode():
            if self.device.type != "cuda":
                out = fn(torch.from_numpy(padded))
                return _Pending(out.float().numpy(), keep)
            with self._lock:
                if self._copy_stream is None:
                    self._copy_stream = torch.cuda.Stream(self.device)
            compute = torch.cuda.current_stream(self.device)
            staging = self._take_pinned(padded.shape, torch.from_numpy(padded).dtype)
            # the buffer came back from a fetch, which waited on the event
            # recorded after this buffer's last upload: refilling is safe
            staging.numpy()[...] = padded
            with torch.cuda.stream(self._copy_stream):
                x = staging.to(self.device, non_blocking=True)
                uploaded = torch.cuda.Event()
                uploaded.record(self._copy_stream)
            compute.wait_event(uploaded)
            # x was allocated on the copy stream and is read on the compute
            # stream: keep the allocator from reusing it before that read
            x.record_stream(compute)
            out = fn(x).float()
            host_out = self._take_pinned(out.shape, torch.float32)
            host_out.copy_(out, non_blocking=True)
            fetched = torch.cuda.Event()
            fetched.record(compute)
            return _Pending(host_out, keep, fetched, staging)

    def _fetch(self, p: _Pending) -> np.ndarray:
        """Wait for one chunk and return its real rows (a host copy)."""
        if p.event is None:
            return p.host_out[: p.keep]
        p.event.synchronize()
        out = p.host_out.numpy()[: p.keep].copy()
        self._give_pinned(p.host_out)
        self._give_pinned(p.staging)
        return out

    def _chunks(self, x: np.ndarray):
        """(padded chunk, real rows) of `x`, split and padded to the ladder."""
        n = x.shape[0]
        step = self._batch_sizes(min(n, self._BUCKETS[-1])) if n else 1
        for i in range(0, n, step):
            chunk = x[i: i + step]
            yield _pad_to(chunk, self._batch_sizes(chunk.shape[0])), chunk.shape[0]

    def _dispatch(self, x: np.ndarray, fn) -> List[_Pending]:
        """Queue every chunk of `x`: [_Pending]."""
        return [self._launch(padded, keep, fn) for padded, keep in self._chunks(x)]

    def _run_windowed(self, arrays, fn) -> np.ndarray:
        """Queue the chunks of every array of `arrays`, keeping at most
        _MAX_IN_FLIGHT in flight: the oldest is fetched before another is
        queued. Returns the concatenated embeddings."""
        require_full_f32(self.device)  # the towers' f32 projections
        pending, outs = [], []
        for x in arrays:
            for padded, keep in self._chunks(x):
                while len(pending) >= self._MAX_IN_FLIGHT:
                    outs.append(self._fetch(pending.pop(0)))
                pending.append(self._launch(padded, keep, fn))
        while pending:
            outs.append(self._fetch(pending.pop(0)))
        if not outs:
            return np.zeros((0, self.dim), np.float32)
        return np.concatenate(outs, 0)

    # -- the encoder interface -----------------------------------------------

    def _encode_image(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            x = normalize_u8_device(x)  # raw RGB ingest form: 1/4 the bytes
        return self.model.encode_image(x)

    def _encode_text(self, t: torch.Tensor) -> torch.Tensor:
        return self.model.encode_text(t.to(torch.int64))

    @staticmethod
    def _pixels(pixels) -> np.ndarray:
        pixels = np.asarray(pixels)
        if pixels.dtype != np.uint8 and pixels.dtype != np.float32:
            pixels = pixels.astype(np.float32)
        return pixels

    def encode_pixels(self, pixels: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) pixels -> (B, dim) f32 unnormalized embeddings.

        Accepts CLIP-normalized f32 or raw uint8 RGB; uint8 batches are
        normalized on the device. Up to _MAX_IN_FLIGHT chunks in flight."""
        return self._run_windowed([self._pixels(pixels)], self._encode_image)

    def encode_stream(self, batches):
        """Iterate (meta, pixels), yield (meta, embeddings) in order, with up
        to _MAX_IN_FLIGHT chunks queued ahead of the oldest fetch, across
        the caller's batches: batch N is fetched while batch N+1 is being
        decoded by the caller and its upload and forward are queued.

        The window is drained before a batch is dispatched, so it never
        holds more than _MAX_IN_FLIGHT chunks, even for a moment; a batch
        larger than the whole window drains it first and then runs through
        encode_pixels, which bounds its own window."""
        require_full_f32(self.device)
        pending = []  # (meta, [_Pending])

        def fetch(entry):
            meta, parts = entry
            if not parts:
                return meta, np.zeros((0, self.dim), np.float32)
            return meta, np.concatenate([self._fetch(p) for p in parts], 0)

        def in_flight():
            return sum(len(parts) for _, parts in pending)

        big = self._BUCKETS[-1] * self._MAX_IN_FLIGHT
        for meta, pixels in batches:
            pixels = self._pixels(pixels)
            n = pixels.shape[0]
            if n > big:
                while pending:
                    yield fetch(pending.pop(0))
                yield meta, self.encode_pixels(pixels)
                continue
            incoming = max(1, -(-n // self._batch_sizes(min(n, self._BUCKETS[-1]))))
            while pending and in_flight() + incoming > self._MAX_IN_FLIGHT:
                yield fetch(pending.pop(0))
            pending.append((meta, self._dispatch(pixels, self._encode_image)))
        while pending:
            yield fetch(pending.pop(0))

    def encode_images(self, paths: Sequence[str], batch_size: int = 256) -> np.ndarray:
        """Host decode + transform of `batch_size` paths at a time, each
        batch queued before the next is decoded, so decode overlaps the
        forwards in flight."""
        bs = self._batch_sizes(batch_size)
        size = self.config.model.image_size
        return self._run_windowed(
            (preprocess_batch(list(paths[i: i + bs]), size=size)
             for i in range(0, len(paths), bs)), self._encode_image)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        tokens = self.tokenizer(
            list(texts), context_length=self.config.model.context_length)
        # padded rows pool at argmax = 0; harmless, sliced away
        return self._run_windowed([tokens], self._encode_text)


class FakeEncoder(Encoder):
    """Deterministic projection encoder (no weights, instant, reproducible).

    Images: 8x8 mean-pooled RGB grid -> fixed seeded projection to dim.
    Texts: hashed bag-of-words -> same projection family. Norms vary with
    content so magnitude-sensitive metrics stay meaningful."""

    def __init__(self, dim: int = 512, seed: int = 1234):
        self.dim = dim
        rng = np.random.default_rng(seed)
        self._img_proj = rng.normal(size=(8 * 8 * 3, dim)).astype(np.float32) / np.sqrt(192)
        self._txt_proj = rng.normal(size=(256, dim)).astype(np.float32) / np.sqrt(256)

    def encode_pixels(self, pixels: np.ndarray) -> np.ndarray:
        if pixels.dtype == np.uint8:
            # mirror CLIPEncoder's on-device u8 normalize so fake
            # embeddings are identical across the f32/u8 ingest forms
            from image_retrieval_tpu_torch.models.preprocess import (
                CLIP_MEAN,
                CLIP_STD,
            )

            pixels = (pixels.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD
        b, h, w, _ = pixels.shape
        gh, gw = h // 8, w // 8
        x = pixels[:, : gh * 8, : gw * 8, :]
        x = x.reshape(b, 8, gh, 8, gw, 3).mean((2, 4)).reshape(b, -1)
        return (x @ self._img_proj).astype(np.float32) * 4.0

    def encode_images(self, paths: Sequence[str], batch_size: int = 256) -> np.ndarray:
        pixels = preprocess_batch(list(paths))
        return self.encode_pixels(pixels)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        out = np.zeros((len(texts), 256), np.float32)
        for i, t in enumerate(texts):
            for w in t.lower().split():
                h = int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little")
                out[i, h % 256] += 1.0
        return (out @ self._txt_proj).astype(np.float32) * 4.0



def get_encoder(config: Optional[Config] = None, fake: bool = False, **kw) -> Encoder:
    """FakeEncoder when `fake`, else CLIPEncoder(config, **kw) (on the card
    unless kw names device="cpu")."""
    if fake:
        return FakeEncoder(dim=(config.model.embed_dim if config else 512))
    return CLIPEncoder(config=config, **kw)
