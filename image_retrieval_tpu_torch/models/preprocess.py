"""Image preprocessing: host decode + on-device normalize.

Port of ``image_retrieval_tpu/models/preprocess.py``. The host transform is
the same CLIPProcessor-equivalent resize/crop/normalize; PIL is imported
inside the functions that decode, since a serving host that only receives
raw uint8 batches needs no PIL. Pixel batches stay NHWC, as in the JAX
package, so both packages take the same arrays.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def decode_image(path: str) -> np.ndarray:
    """Host-side decode to RGB uint8 (H, W, 3)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


def _resize_crop(image, size: int):
    """Short edge pinned to `size` (long edge truncated with int(), as HF's
    get_resize_output_image_size does), bicubic, then a center crop."""
    from PIL import Image

    if isinstance(image, str):
        im = Image.open(image).convert("RGB")
    elif isinstance(image, np.ndarray):
        im = Image.fromarray(image).convert("RGB")
    else:
        im = image.convert("RGB")
    w, h = im.size
    if w <= h:
        nw, nh = size, int(size * h / w)
    else:
        nw, nh = int(size * w / h), size
    im = im.resize((nw, nh), Image.Resampling.BICUBIC)
    left = (nw - size) // 2
    top = (nh - size) // 2
    return im.crop((left, top, left + size, top + size))


def preprocess_host(image, size: int = 224) -> np.ndarray:
    """CLIPProcessor-equivalent single-image transform on host.

    `image` is a path, an (H, W, 3) uint8 array or a PIL image. Returns
    (size, size, 3) float32, normalized."""
    x = np.asarray(_resize_crop(image, size), np.float32) / 255.0
    return (x - CLIP_MEAN) / CLIP_STD


def preprocess_host_u8(image, size: int = 224) -> np.ndarray:
    """Resize + center crop to raw (size, size, 3) uint8; the normalize runs
    on the device (normalize_u8_device)."""
    return np.asarray(_resize_crop(image, size), np.uint8)


def preprocess_batch(paths: Sequence[str], size: int = 224) -> np.ndarray:
    """Host decode+transform for a list of paths -> (B, size, size, 3) f32."""
    return np.stack([preprocess_host(p, size) for p in paths])


def normalize_u8_device(batch_u8: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> CLIP-normalized f32 on the tensor's device.

    Same math and order as preprocess_host's tail and the JAX package's
    normalize_u8_device: (x / 255 - mean) / std, all in f32."""
    mean = torch.as_tensor(CLIP_MEAN, device=batch_u8.device)
    std = torch.as_tensor(CLIP_STD, device=batch_u8.device)
    return (batch_u8.to(torch.float32) / 255.0 - mean) / std
