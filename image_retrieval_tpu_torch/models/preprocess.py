"""Image preprocessing: host decode + on-device resize and normalize.

Port of ``image_retrieval_tpu/models/preprocess.py``. The host transform is
the same CLIPProcessor-equivalent resize/crop/normalize; PIL is imported
inside the functions that decode, since a serving host that only receives
raw uint8 batches needs no PIL. Pixel batches stay NHWC, as in the JAX
package, so both packages take the same arrays.

``preprocess_device`` resizes with ``F.interpolate(mode="bilinear",
antialias=True)`` where JAX runs ``jax.image.resize(..., "bilinear",
antialias=True)``. The two filters are written apart and round apart: on
[0, 1] inputs they differ by at most 1.3e-5 at 320 -> 224 (5.4e-5 after the
division by CLIP's std), by less elsewhere, and by nothing where the side
already equals `size` (tests/test_torch_preprocess_device.py holds 1e-4).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from image_retrieval_tpu_torch.device import DeviceLike, resolve_device

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


def preprocess_device(batch_u8, size: int = 224, *, device: DeviceLike = "cuda"
                      ) -> torch.Tensor:
    """Batched resize + normalize of square (B, H, W, 3) uint8 images to
    (B, size, size, 3) CLIP-normalized f32, the JAX package's
    preprocess_device (models/preprocess.py:58-71): / 255, a bilinear
    resize with antialiasing only where the side differs from `size`, then
    the CLIP mean and std, all in f32. A numpy batch is uploaded to `device`
    (the card unless the caller names the CPU); a tensor stays on its own
    device. For the ingest path whose host decode emits fixed-size
    thumbnails; the exact-bicubic host path stays for parity."""
    if isinstance(batch_u8, torch.Tensor):
        x = batch_u8
    else:
        x = torch.from_numpy(np.ascontiguousarray(batch_u8)).to(resolve_device(device))
    if x.dim() != 4 or x.shape[1] != x.shape[2] or x.shape[3] != 3:
        raise ValueError(f"preprocess_device takes square (B, H, W, 3) images, "
                         f"got {tuple(x.shape)}")
    # divided by a tensor: a CUDA division by a Python scalar multiplies by
    # its reciprocal, which is not the correctly rounded quotient
    x = x.to(torch.float32) / torch.tensor(255.0, device=x.device)
    if x.shape[1] != size:
        x = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="bilinear",
                          antialias=True, align_corners=False).permute(0, 2, 3, 1)
    mean = torch.as_tensor(CLIP_MEAN, device=x.device)
    std = torch.as_tensor(CLIP_STD, device=x.device)
    return ((x - mean) / std).contiguous()
