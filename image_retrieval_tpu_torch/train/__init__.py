"""Contrastive CLIP training: the one-device and (data, model) mesh trainer,
the pipelined (data, pipe) trainer and their batches."""

from image_retrieval_tpu_torch.parallel.collectives import sharded_search_topk  # noqa: F401
from image_retrieval_tpu_torch.parallel.mesh import make_mesh, replicate, shard_rows  # noqa: F401
from image_retrieval_tpu_torch.train.data import (  # noqa: F401
    contrastive_batches,
    finetune_on_color_dataset,
)
from image_retrieval_tpu_torch.train.pipelined import PipelinedCLIPTrainer  # noqa: F401
from image_retrieval_tpu_torch.train.trainer import (  # noqa: F401
    CLIPTrainer,
    clip_contrastive_loss,
)
