"""Color-histogram embedding family — the classical baseline encoder.

Port of ``image_retrieval_tpu/models/histogram.py``. Each image becomes a
normalized 8x8x8 RGB occupancy histogram (512 dims, the width of the CLIP
embeddings, so it drops into the same index, search and analysis stack):
channels quantized to 3 bits by truncation, the counts of a batch taken in
one ``bincount`` on the device, L1-normalized by max(sum, 1).

The counts are integers below 2^24, exact in f32 in any order, and the
division is a true f32 division, so a histogram on the card equals the one
on the CPU and the JAX package's bit for bit. The JAX encoder pads a batch
up to a bucket (one compiled shape each on the TPU); the port does not pad,
which changes no row.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from image_retrieval_tpu_torch.device import DeviceLike, resolve_device
from image_retrieval_tpu_torch.models.encoder import Encoder
from image_retrieval_tpu_torch.models.preprocess import CLIP_MEAN, CLIP_STD


def batched_color_histogram(pixels01: torch.Tensor, bins_per_channel: int = 8
                            ) -> torch.Tensor:
    """(B, H, W, 3) f32 in [0, 1] -> (B, bins^3) L1-normalized histograms, on
    the tensor's device."""
    b = pixels01.shape[0]
    nbins = bins_per_channel
    q = torch.clamp((pixels01 * nbins).to(torch.int32), 0, nbins - 1).to(torch.int64)
    flat_idx = (q[..., 0] * nbins * nbins + q[..., 1] * nbins + q[..., 2]).reshape(b, -1)
    # one bincount for the batch: image i's bins sit at i * bins^3 + bin
    offsets = torch.arange(b, device=flat_idx.device).unsqueeze(1) * nbins ** 3
    hist = torch.bincount((flat_idx + offsets).reshape(-1),
                          minlength=b * nbins ** 3).reshape(b, -1).to(torch.float32)
    return hist / torch.clamp(hist.sum(1, keepdim=True), min=1.0)


class HistogramEncoder(Encoder):
    """Drop-in encoder producing 512-d color-histogram embeddings, on
    `device` (the card unless the caller names the CPU).

    encode_pixels accepts the standard CLIP-normalized batches (it undoes
    the normalization on the host to recover [0,1] RGB), so every existing
    pipeline — ImageEmbeddingSystem, loaders, the app facade — works
    unchanged. Text queries hash color/category words onto the matching
    histogram bins, giving a crude but deterministic text->color search."""

    COLOR_WORDS = {
        "red": (0.8, 0.1, 0.1), "green": (0.1, 0.7, 0.1), "blue": (0.1, 0.2, 0.8),
        "white": (0.95, 0.95, 0.95), "black": (0.05, 0.05, 0.05),
        "brown": (0.55, 0.27, 0.07), "yellow": (0.9, 0.85, 0.1),
        "gray": (0.5, 0.5, 0.5), "grey": (0.5, 0.5, 0.5),
        "orange": (0.9, 0.55, 0.1), "purple": (0.5, 0.1, 0.6),
    }

    # images a device batch: the JAX encoder's largest bucket
    CHUNK = 256

    def __init__(self, bins_per_channel: int = 8, *, device: DeviceLike = "cuda"):
        self.bins = bins_per_channel
        self.dim = bins_per_channel ** 3
        self.device = resolve_device(device)

    def encode_pixels(self, pixels: np.ndarray) -> np.ndarray:
        pixels = np.asarray(pixels, np.float32)
        n = pixels.shape[0]
        if n == 0:
            return np.zeros((0, self.dim), np.float32)
        if n > self.CHUNK:
            return np.concatenate([self.encode_pixels(pixels[i: i + self.CHUNK])
                                   for i in range(0, n, self.CHUNK)])
        # undone on the host in f32, as the JAX encoder does, so that a bin
        # edge cannot move between the packages
        x01 = np.clip(pixels * CLIP_STD + CLIP_MEAN, 0.0, 1.0)
        hist = batched_color_histogram(torch.from_numpy(x01).to(self.device), self.bins)
        return hist.cpu().numpy()

    def encode_images(self, paths: Sequence[str], batch_size: int = 256) -> np.ndarray:
        from image_retrieval_tpu_torch.models.preprocess import preprocess_batch

        outs = []
        for i in range(0, len(paths), batch_size):
            outs.append(self.encode_pixels(preprocess_batch(list(paths[i: i + batch_size]))))
        return (np.concatenate(outs, 0) if outs
                else np.zeros((0, self.dim), np.float32))

    def encode_texts(self, texts: Sequence[str]) -> np.ndarray:
        nb = self.bins
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            hits = 0
            for word in text.lower().split():
                rgb = self.COLOR_WORDS.get(word)
                if rgb is None:
                    continue
                q = np.clip((np.array(rgb) * nb).astype(int), 0, nb - 1)
                # soft peak around the named color's bin
                for dr in (-1, 0, 1):
                    for dg in (-1, 0, 1):
                        for db in (-1, 0, 1):
                            r, g, b = q[0] + dr, q[1] + dg, q[2] + db
                            if 0 <= r < nb and 0 <= g < nb and 0 <= b < nb:
                                w = 1.0 / (1 + abs(dr) + abs(dg) + abs(db))
                                out[i, r * nb * nb + g * nb + b] += w
                hits += 1
            if hits == 0:
                out[i] = 1.0  # uniform: matches anything equally
            out[i] /= max(out[i].sum(), 1e-9)
        return out
