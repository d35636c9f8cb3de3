"""Contrastive CLIP training on one device: the trainer and its batches."""

from image_retrieval_tpu_torch.train.trainer import (  # noqa: F401
    CLIPTrainer,
    clip_contrastive_loss,
)
