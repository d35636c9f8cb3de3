"""Synthetic color-dataset generation — a copy of
``image_retrieval_tpu/data/synthetic.py`` (no JAX there; the JPEGs are
byte-identical between the packages).

The reference intended a synthetic fallback when COCO isn't supplied but the
methods it calls are undefined (`_create_synthetic_dataset_from_scratch`,
`create_synthetic_variations`, reference imageProcessing.py:414,417 — they
crash; only the orphaned `_draw_shape` helper exists at :218-284). This
module implements that capability properly: per-category silhouettes drawn
in the requested color on a neutral background, with seeded jitter for
variations. Used by tests and by `ColorDatasetManager.create_dataset()` when
no COCO directory is given.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
from PIL import Image, ImageDraw

COLOR_RGB: Dict[str, Tuple[int, int, int]] = {
    "brown": (139, 69, 19),
    "white": (235, 235, 235),
    "black": (25, 25, 25),
}
_BACKGROUND = (128, 160, 190)  # classified "other" so it never wins k-means


def draw_category_shape(
    draw: ImageDraw.ImageDraw,
    category_idx: int,
    color: Tuple[int, int, int],
    jitter: Tuple[int, int] = (0, 0),
    size: int = 224,
) -> None:
    """Distinct large silhouette per category index, offset by jitter."""
    cx, cy = size // 2 + jitter[0], size // 2 + jitter[1]
    r = size // 3
    k = category_idx % 10
    if k == 0:  # round body + two round ears
        draw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=color)
        draw.ellipse([cx - r, cy - r - 30, cx - r + 40, cy - r + 10], fill=color)
        draw.ellipse([cx + r - 40, cy - r - 30, cx + r, cy - r + 10], fill=color)
    elif k == 1:  # round body + triangular ears
        draw.ellipse([cx - r, cy - r, cx + r, cy + r], fill=color)
        draw.polygon([(cx - r, cy - r + 20), (cx - r + 15, cy - r - 35), (cx - r + 45, cy - r + 5)], fill=color)
        draw.polygon([(cx + r, cy - r + 20), (cx + r - 15, cy - r - 35), (cx + r - 45, cy - r + 5)], fill=color)
    elif k == 2:  # wide oval + head oval
        draw.ellipse([cx - r - 20, cy - r // 2, cx + r + 20, cy + r // 2], fill=color)
        draw.ellipse([cx + r - 10, cy - r, cx + r + 50, cy - r // 3], fill=color)
    elif k == 3:  # small oval + beak triangle
        draw.ellipse([cx - r // 2, cy - r // 3, cx + r // 2, cy + r // 3], fill=color)
        draw.polygon([(cx + r // 2, cy), (cx + r // 2 + 40, cy - 10), (cx + r // 2, cy - 20)], fill=color)
    elif k == 4:  # two stacked rectangles + wheels
        draw.rectangle([cx - r, cy - 10, cx + r, cy + 35], fill=color)
        draw.rectangle([cx - r + 25, cy - 45, cx + r - 25, cy - 10], fill=color)
        draw.ellipse([cx - r + 10, cy + 20, cx - r + 50, cy + 60], fill=color)
        draw.ellipse([cx + r - 50, cy + 20, cx + r - 10, cy + 60], fill=color)
    elif k == 5:  # tall bottle
        draw.rectangle([cx - 25, cy - r, cx + 25, cy + r], fill=color)
        draw.rectangle([cx - 12, cy - r - 35, cx + 12, cy - r], fill=color)
    elif k == 6:  # chair profile
        draw.rectangle([cx - r // 2, cy - 8, cx + r // 2, cy + 8], fill=color)
        draw.rectangle([cx - r // 2, cy - r, cx - r // 2 + 14, cy], fill=color)
        draw.rectangle([cx - r // 2, cy, cx - r // 2 + 14, cy + r], fill=color)
        draw.rectangle([cx + r // 2 - 14, cy, cx + r // 2, cy + r], fill=color)
    elif k == 7:  # head + torso
        draw.ellipse([cx - 28, cy - r - 20, cx + 28, cy - r + 36], fill=color)
        draw.polygon([(cx - 45, cy + r), (cx + 45, cy + r), (cx + 25, cy - r + 36), (cx - 25, cy - r + 36)], fill=color)
    elif k == 8:  # hull + sail
        draw.polygon([(cx - r, cy + 20), (cx + r, cy + 20), (cx + r - 30, cy + 60), (cx - r + 30, cy + 60)], fill=color)
        draw.polygon([(cx, cy + 10), (cx, cy - r - 10), (cx + 60, cy + 10)], fill=color)
    else:  # two wheels + frame
        draw.ellipse([cx - r, cy, cx - r + 60, cy + 60], fill=color)
        draw.ellipse([cx + r - 60, cy, cx + r, cy + 60], fill=color)
        draw.line([(cx - r + 30, cy + 30), (cx, cy - 30), (cx + r - 30, cy + 30)], fill=color, width=12)
        draw.line([(cx, cy - 30), (cx - r + 30, cy + 30)], fill=color, width=12)


def synth_image(
    category_idx: int, color_name: str, variant: int, size: int = 224
) -> Image.Image:
    """Deterministic synthetic example (seeded jitter per variant)."""
    import zlib

    # hash() is salted per process (PYTHONHASHSEED), which silently made
    # every run's "deterministic" jitter different; crc32 is stable
    seed = zlib.crc32(f"{category_idx}/{color_name}/{variant}".encode())
    rng = np.random.default_rng(seed)
    im = Image.new("RGB", (size, size), _BACKGROUND)
    draw = ImageDraw.Draw(im)
    base = np.array(COLOR_RGB[color_name], int)
    jcol = tuple(int(c) for c in np.clip(base + rng.integers(-8, 9, 3), 0, 255))
    jpos = tuple(int(j) for j in rng.integers(-12, 13, 2))
    draw_category_shape(draw, category_idx, jcol, jpos, size)
    return im


def create_synthetic_dataset(
    base_dir: str,
    categories,
    colors,
    num_examples: int = 5,
    size: int = 224,
):
    """Write a full categories x colors x examples tree; returns metadata
    rows in the reference schema (imageProcessing.py:205-211)."""
    metadata = []
    for ci, category in enumerate(categories):
        for color in colors:
            dest = Path(base_dir) / category / color
            os.makedirs(dest, exist_ok=True)
            for i in range(num_examples):
                path = dest / f"{i + 1}.jpg"
                synth_image(ci, color, i, size).save(path)
                metadata.append(
                    {
                        "path": str(path),
                        "category": category,
                        "color": color,
                        "original_id": f"synthetic_{category}_{color}_{i}",
                        "original_path": str(path),
                    }
                )
    return metadata
