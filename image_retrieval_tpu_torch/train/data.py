"""Contrastive (image, caption) batches from a color dataset.

Port of ``image_retrieval_tpu/train/data.py``: each row of a color dataset's
metadata.csv gets the caption "a {color} {category}" (the dataset's own
labels), tokenized and batched with its decoded pixels, in the same
order for the same seed as the JAX package yields them.
"""

from __future__ import annotations

import csv
import logging
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from image_retrieval_tpu_torch.models.preprocess import preprocess_batch
from image_retrieval_tpu_torch.models.tokenizer import get_tokenizer

logger = logging.getLogger(__name__)


def caption_for(row: dict) -> str:
    return f"a {row['color']} {row['category']}"


def contrastive_batches(
    metadata: Sequence[dict],
    batch_size: int,
    image_size: int = 224,
    context_length: int = 77,
    seed: int = 0,
    epochs: Optional[int] = None,
    base_dir: Optional[str] = None,
    tokenizer=None,
) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield (pixels (B,S,S,3) f32, tokens (B,T) i32) batches, shuffled per
    epoch, dropping the ragged tail so that every batch has one shape."""
    tok = tokenizer if tokenizer is not None else get_tokenizer()
    rows = [dict(r) for r in metadata]
    if base_dir:
        base_norm = os.path.normpath(base_dir)
        for r in rows:
            p = os.path.normpath(str(r["path"]))
            # normpath both sides: metadata paths are Path-normalized, so a
            # raw "./out" base_dir would fail startswith and double-join
            if not os.path.isabs(p) and not p.startswith(base_norm + os.sep):
                p = os.path.join(base_norm, p)
            r["path"] = p
    if not rows:
        return
    if batch_size > len(rows):
        # a tiny dataset would otherwise yield nothing and, with
        # epochs=None, loop forever
        logger.warning(f"batch_size {batch_size} > dataset size {len(rows)}; clamping")
        batch_size = len(rows)
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(len(rows))
        for i in range(0, len(rows) - batch_size + 1, batch_size):
            batch = [rows[int(j)] for j in order[i: i + batch_size]]
            pixels = preprocess_batch([r["path"] for r in batch], image_size)
            tokens = tok([caption_for(r) for r in batch], context_length=context_length)
            yield pixels.astype(np.float32), tokens.astype(np.int32)
        epoch += 1


def read_metadata(base_dir: str) -> List[dict]:
    """The rows of `base_dir`/metadata.csv as dicts of strings."""
    with open(os.path.join(base_dir, "metadata.csv"), newline="") as f:
        return list(csv.DictReader(f))


def finetune_on_color_dataset(
    trainer,
    base_dir: str,
    batch_size: int = 32,
    steps: int = 100,
    image_size: Optional[int] = None,
    context_length: Optional[int] = None,
    seed: int = 0,
) -> List[float]:
    """Convenience loop: metadata.csv -> shuffled contrastive batches ->
    trainer.fit, or for a trainer without fit (PipelinedCLIPTrainer) the same
    loop here: steps enqueued with train_step_async, the host waiting for
    the device every 8 steps, the losses fetched in one transfer at the end.
    Returns per-step losses."""
    cfg = trainer.cfg
    batches = contrastive_batches(
        read_metadata(base_dir),
        batch_size,
        image_size=image_size or cfg.image_size,
        context_length=context_length or cfg.context_length,
        seed=seed,
        base_dir=base_dir,
    )
    if hasattr(trainer, "fit"):
        return trainer.fit(batches, steps=steps)
    losses = []
    for i, (pixels, tokens) in enumerate(batches):
        if i >= steps:
            break
        losses.append(trainer.train_step_async(pixels, tokens))
        if len(losses) % 8 == 0:
            losses[-1].item()  # bound the steps in flight
    if not losses:
        return []
    return [float(v) for v in torch.stack(losses).cpu()]
