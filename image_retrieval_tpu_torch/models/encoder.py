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
from typing import Optional, Sequence

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
        """Iterate (meta, pixels) pairs, yield (meta, embeddings) in order,
        one synchronous encode_pixels per batch."""
        for meta, pixels in batches:
            yield meta, self.encode_pixels(pixels)


def _pad_to(x: np.ndarray, n: int) -> np.ndarray:
    if x.shape[0] == n:
        return x
    pad = np.zeros((n - x.shape[0],) + x.shape[1:], x.dtype)
    return np.concatenate([x, pad], 0)


class CLIPEncoder(Encoder):
    """CLIP on `device` ("cuda", the default, or "cpu"). `params` is a state
    dict from models/weights.py; without one, Config.weights_path or `seed`
    decides."""

    # the JAX encoder's bucket ladder (one compile per shape there; here it
    # keeps both packages' padded shapes equal)
    _BUCKETS = (8, 32, 128, 192, 256)

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

    def _batch_sizes(self, requested: int) -> int:
        for b in self._BUCKETS:
            if requested <= b:
                return b
        return requested

    def _run_batched(self, x: np.ndarray, fn) -> np.ndarray:
        """Split into bucket-padded chunks, run `fn` on each, unpad."""
        n = x.shape[0]
        if n == 0:
            return np.zeros((0, self.dim), np.float32)
        require_full_f32(self.device)  # the towers' f32 projections
        step = self._batch_sizes(min(n, self._BUCKETS[-1]))
        outs = []
        with torch.inference_mode():
            for i in range(0, n, step):
                chunk = x[i: i + step]
                padded = _pad_to(chunk, self._batch_sizes(chunk.shape[0]))
                out = fn(torch.from_numpy(padded).to(self.device))
                outs.append(out.float().cpu().numpy()[: chunk.shape[0]])
        return np.concatenate(outs, 0)

    def _encode_image(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            x = normalize_u8_device(x)  # raw RGB ingest form: 1/4 the bytes
        return self.model.encode_image(x)

    def encode_pixels(self, pixels: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) pixels -> (B, dim) f32 unnormalized embeddings.

        Accepts CLIP-normalized f32 or raw uint8 RGB; uint8 batches are
        normalized on the device."""
        pixels = np.asarray(pixels)
        if pixels.dtype != np.uint8 and pixels.dtype != np.float32:
            pixels = pixels.astype(np.float32)
        return self._run_batched(pixels, self._encode_image)

    def encode_images(self, paths: Sequence[str], batch_size: int = 256) -> np.ndarray:
        """Host decode + transform, then the batched forward."""
        bs = self._batch_sizes(batch_size)
        outs = [
            self.encode_pixels(preprocess_batch(
                list(paths[i: i + bs]), size=self.config.model.image_size))
            for i in range(0, len(paths), bs)
        ]
        if not outs:
            return np.zeros((0, self.dim), np.float32)
        return np.concatenate(outs, 0)

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        tokens = self.tokenizer(
            list(texts), context_length=self.config.model.context_length)
        # padded rows pool at argmax = 0; harmless, sliced away
        return self._run_batched(
            tokens, lambda t: self.model.encode_text(t.to(torch.int64)))


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

