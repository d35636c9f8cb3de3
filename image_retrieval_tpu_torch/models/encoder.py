"""Encoder facade: batched embedding generation, data-parallel over a mesh.

Port of ``image_retrieval_tpu/models/encoder.py``. Two implementations share
one interface:
  CLIPEncoder — the PyTorch CLIP (HF weights when a checkpoint directory is
                configured, seeded random weights otherwise) over every
                visible card, or on one device (the CPU when the caller asks
                for it), or over a mesh's ``data`` axis: each padded batch
                splits in equal parts, one a device, each run by that
                device's replica of the model.
  FakeEncoder — the deterministic numpy projection encoder, a verbatim copy
                (bit-identical embeddings to the JAX package's).

Batches snap to the same bucket ladder as the JAX encoder (a bucket the
data axis divides), so both packages pad a batch to the same shape. The
towers treat every example alone, the port's kernels sum a product's terms
in an order set by its width, not by its rows (no split of the sum,
ROADMAP.md queue 2), and the f32 output projection runs in products of one
fixed shape (``models/clip.py::PRODUCT_ROWS``), so on the card a batch split
over the mesh gives the one-device embeddings bit for bit.
"""

from __future__ import annotations

import copy
import hashlib
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from image_retrieval_tpu_torch.config import Config
from image_retrieval_tpu_torch.device import DeviceLike, require_full_f32, torch_dtype
from image_retrieval_tpu_torch.models.clip import CLIP
from image_retrieval_tpu_torch.models.preprocess import (
    normalize_u8_device,
    preprocess_batch,
)
from image_retrieval_tpu_torch.models.tokenizer import get_tokenizer
from image_retrieval_tpu_torch.parallel.mesh import Mesh, entry_mesh, on_device, shard_devices


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


class _Part:
    """One device's part of a dispatched chunk: its forward is queued on the
    device (or, on the CPU, already done), its result lands in `host_out`.
    `staging` and `host_out` are pinned buffers on loan from the encoder's
    pool until fetch."""

    __slots__ = ("host_out", "event", "staging")

    def __init__(self, host_out, event=None, staging=None):
        self.host_out, self.event, self.staging = host_out, event, staging


class _Pending:
    """One dispatched chunk: its parts in mesh order; `keep` rows of their
    concatenation are real."""

    __slots__ = ("parts", "keep")

    def __init__(self, parts, keep):
        self.parts, self.keep = parts, keep


class CLIPEncoder(Encoder):
    """CLIP over `mesh`'s data axis: every visible card (Config.mesh) unless
    the caller names a `device` (a one-device mesh; "cpu" on the host) or a
    mesh, never both. The parameters are copied once to each distinct device
    of the axis; the int8 serving weights each replica quantizes for itself
    on first use. `params` is a state dict from models/weights.py; without
    one, Config.weights_path or `seed` decides.

    Batches are kept in flight: on the card each device's part of a chunk
    is staged in a pinned host buffer, copied to the device on that
    device's copy stream, run on the device's current stream once that
    copy's event has fired, and copied back into a pinned buffer behind an
    event; the host fetches the oldest chunk only when _MAX_IN_FLIGHT are
    queued, so uploads, forwards and fetches overlap the caller's host work
    (decode), and the parts on different cards run at once. On the CPU the
    same order and window run synchronously. Either way the outputs equal
    the one-at-a-time form's bit for bit: the same parts go through the
    same forward."""

    # the JAX encoder's bucket ladder (one compile per shape there; here it
    # keeps both packages' padded shapes equal)
    _BUCKETS = (8, 32, 128, 192, 256)
    # chunks dispatched and not yet fetched; each holds a pinned staging and
    # a pinned output buffer until fetched, so the window bounds both the
    # pinned memory and how far the host runs ahead of the card
    _MAX_IN_FLIGHT = 4

    def __init__(self, config: Optional[Config] = None, params=None,
                 seed: int = 0, *, device: Optional[DeviceLike] = None,
                 mesh: Optional[Mesh] = None):
        self.config = config or Config()
        cfg = self.config.model
        self.dim = cfg.embed_dim
        self.mesh = entry_mesh(device, mesh, self.config.mesh)
        self.device = self.mesh.first
        # the device of each part of a batch, in mesh order
        self._part_devices = shard_devices(self.mesh, "data")
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
        self.model.eval()
        # one replica a distinct device, copied before any weight cache is made
        self._replicas = {d: copy.deepcopy(self.model).to(d)
                          for d in dict.fromkeys(self._part_devices) if d != self.device}
        self._replicas[self.device] = self.model.to(self.device)
        self.tokenizer = get_tokenizer(self.config.weights_path)
        self._copy_streams: Dict[torch.device, torch.cuda.Stream] = {}  # made on first use
        # free pinned buffers by (shape, dtype); a server encodes from several
        # threads at once, hence the lock (it also guards the copy stream)
        self._pinned: Dict[tuple, List[torch.Tensor]] = {}
        self._lock = threading.Lock()

    def _batch_sizes(self, requested: int) -> int:
        """The padded batch: the first bucket that holds `requested` rows
        and that the data axis divides, else `requested` rounded up to the
        axis (the JAX encoder's rule)."""
        nd = len(self._part_devices)
        for b in self._BUCKETS:
            if requested <= b and b % nd == 0:
                return b
        return max(nd, -(-requested // nd) * nd)

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
        """Queue one padded chunk's forward, an equal part on each device of
        the data axis; see the class docstring."""
        per = padded.shape[0] // len(self._part_devices)
        return _Pending([self._launch_part(padded[i * per: (i + 1) * per], dev, fn)
                         for i, dev in enumerate(self._part_devices)], keep)

    def _launch_part(self, part: np.ndarray, dev: torch.device, fn) -> _Part:
        model = self._replicas[dev]
        with torch.inference_mode():
            if dev.type != "cuda":
                return _Part(fn(model, torch.from_numpy(part)).float().numpy())
            with on_device(dev):  # the kernels launch on dev's streams
                with self._lock:
                    copy_stream = self._copy_streams.get(dev)
                    if copy_stream is None:
                        copy_stream = self._copy_streams[dev] = torch.cuda.Stream(dev)
                compute = torch.cuda.current_stream(dev)
                staging = self._take_pinned(part.shape, torch.from_numpy(part).dtype)
                # the buffer came back from a fetch, which waited on the event
                # recorded after this buffer's last upload: refilling is safe
                staging.numpy()[...] = part
                with torch.cuda.stream(copy_stream):
                    x = staging.to(dev, non_blocking=True)
                    uploaded = torch.cuda.Event()
                    uploaded.record(copy_stream)
                compute.wait_event(uploaded)
                # x was allocated on the copy stream and is read on the compute
                # stream: keep the allocator from reusing it before that read
                x.record_stream(compute)
                out = fn(model, x).float()
                host_out = self._take_pinned(out.shape, torch.float32)
                host_out.copy_(out, non_blocking=True)
                fetched = torch.cuda.Event()
                fetched.record(compute)
                return _Part(host_out, fetched, staging)

    def _fetch(self, p: _Pending) -> np.ndarray:
        """Wait for one chunk's parts and return its real rows (a host copy
        on the card)."""
        outs = []
        for part in p.parts:
            if part.event is None:
                outs.append(part.host_out)
                continue
            part.event.synchronize()
            outs.append(part.host_out.numpy().copy())
            self._give_pinned(part.host_out)
            self._give_pinned(part.staging)
        return (outs[0] if len(outs) == 1 else np.concatenate(outs, 0))[: p.keep]

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

    @staticmethod
    def _encode_image(model: CLIP, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            x = normalize_u8_device(x)  # raw RGB ingest form: 1/4 the bytes
        return model.encode_image(x)

    @staticmethod
    def _encode_text(model: CLIP, t: torch.Tensor) -> torch.Tensor:
        return model.encode_text(t.to(torch.int64))

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
