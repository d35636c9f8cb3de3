"""Dominant-color extraction — port of ``image_retrieval_tpu/data/color.py``.

The reference runs sklearn KMeans(k=3, n_init=10) over every candidate COCO
image's pixels, one image at a time (reference imageProcessing.py:83-99).
Here Lloyd's iteration clusters a whole batch of images on `device` in
batched tensor operations. The fallback path (bright-pixel-masked mean,
imageProcessing.py:100-110) and the RGB classification thresholds
(imageProcessing.py:113-120) are preserved exactly.

The iteration repeats the JAX form's arithmetic: the initial centres are the
darkest, median and brightest pixel by a stable sort of luminance (the
synthetic images hold long runs of equal luminance, so an unstable sort
would pick other pixels); squared distances summed over r, g, b in that
order; the first index on ties; cluster sums by index_add_ (exact integer
sums, no TF32 product); the dominant cluster chosen by the last step's
counts, which come from the centres before its update, and its centre
returned after that update.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from image_retrieval_tpu_torch.device import DeviceLike, resolve_device

COLOR_NAMES = ("white", "black", "brown", "other")


def classify_rgb(r: float, g: float, b: float) -> str:
    """Reference thresholds (imageProcessing.py:113-120)."""
    if r > 200 and g > 200 and b > 200:
        return "white"
    elif r < 60 and g < 60 and b < 60:
        return "black"
    elif r > 100 and g < 100 and b < 80:
        return "brown"
    else:
        return "other"


def _kmeans_batch(pixels: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Lloyd's k=3 over (B, P, 3) f32 pixels -> (B, 3) dominant RGB centres."""
    b, p, _ = pixels.shape
    lum = pixels.sum(-1)
    order = torch.argsort(lum, dim=-1, stable=True)
    init_idx = torch.stack([order[:, 0], order[:, p // 2], order[:, -1]], 1)  # (B, 3)
    centers = torch.gather(pixels, 1, init_idx[:, :, None].expand(b, 3, 3))
    rows = torch.arange(b, device=pixels.device)[:, None] * 3
    ones = torch.ones(b * p, dtype=torch.float32, device=pixels.device)
    counts = None
    for _ in range(iters):
        diff = pixels[:, :, None, :] - centers[:, None, :, :]  # (B, P, 3, 3)
        sq = diff * diff
        d = sq[..., 0] + sq[..., 1] + sq[..., 2]  # (B, P, 3)
        slot = (d.argmin(-1) + rows).reshape(-1)  # first index on ties
        counts = torch.zeros(b * 3, dtype=torch.float32, device=pixels.device)
        counts = counts.index_add_(0, slot, ones).view(b, 3)
        sums = torch.zeros((b * 3, 3), dtype=torch.float32, device=pixels.device)
        sums = sums.index_add_(0, slot, pixels.reshape(-1, 3)).view(b, 3, 3)
        centers = torch.where(counts[:, :, None] > 0,
                              sums / torch.clamp(counts[:, :, None], min=1), centers)
    dominant = counts.argmax(-1)
    return centers[torch.arange(b, device=pixels.device), dominant]


def _sample_pixels(img: np.ndarray, n: int = 4096, seed: int = 0) -> np.ndarray:
    flat = img.reshape(-1, 3).astype(np.float32)
    if flat.shape[0] <= n:
        reps = -(-n // flat.shape[0])
        return np.tile(flat, (reps, 1))[:n]
    stride = flat.shape[0] // n
    return flat[:: stride][:n]


def dominant_colors_batch(
    images: Sequence[np.ndarray], method: str = "kmeans", sample: int = 4096,
    *, device: DeviceLike = "cuda",
) -> List[str]:
    """Dominant color names for a batch of HxWx3 uint8 images.

    method='kmeans': batched Lloyd's on `device` (reference sklearn path).
    method='mean'  : bright-masked mean on the host (reference fallback
                     path, imageProcessing.py:100-110)."""
    if not len(images):
        return []
    if method == "mean":
        out = []
        for img in images:
            arr = np.asarray(img)
            mask = np.max(arr, axis=2) < 240
            if mask.sum() > 0:
                dom = np.mean(arr[mask], axis=0).astype(int)
            else:
                dom = np.mean(arr, axis=(0, 1)).astype(int)
            out.append(classify_rgb(*dom))
        return out
    batch = np.stack([_sample_pixels(np.asarray(im), sample) for im in images])
    pixels = torch.from_numpy(batch).to(resolve_device(device))
    centers = _kmeans_batch(pixels).cpu().numpy()
    return [classify_rgb(*c.astype(int)) for c in centers]


def extract_dominant_color(image, method: str = "kmeans", *,
                           device: DeviceLike = "cuda") -> str:
    """Single-image API mirroring reference imageProcessing.py:73-120."""
    return dominant_colors_batch([np.asarray(image)], method=method, device=device)[0]
