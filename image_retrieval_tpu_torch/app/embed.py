"""Embedding write path: batched encode -> index insert.

Port of ``image_retrieval_tpu/app/embed.py``: decode in the loader's
background thread, encode with the encoder's batches in flight
(``encode_stream``), and insert (unit vector, magnitude) rows into the index
in one bulk insert, flushed (the durability barrier of a journaled index)
inside the ``embed/index_insert`` trace range.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Tuple

import numpy as np

from image_retrieval_tpu_torch.config import Config
from image_retrieval_tpu_torch.device import DeviceLike
from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.models.encoder import Encoder
from image_retrieval_tpu_torch.parallel.mesh import Mesh
from image_retrieval_tpu_torch.utils.profiling import trace

logger = logging.getLogger(__name__)


class ImageEmbeddingSystem:
    """Generate and store image embeddings. Without an `index`, one is
    created over every visible card, or on `device` or `mesh` when given.
    `attrs_fn`, paths -> {field: [values]}, attaches scalar attribute
    columns to every insert, for searches with a filter expression
    (index/filters.py); without it inserts carry no attributes."""

    def __init__(self, encoder: Encoder, index: Optional[ShardedVectorIndex] = None,
                 config: Optional[Config] = None, attrs_fn=None,
                 device: Optional[DeviceLike] = None, mesh: Optional[Mesh] = None):
        self.encoder = encoder
        self.config = config or Config()
        if index is None:
            index = ShardedVectorIndex(dim=encoder.dim, config=self.config.index,
                                       device=device, mesh=mesh)
        self.index = index
        self.attrs_fn = attrs_fn

    def generate_embedding(self, image_path) -> Tuple[np.ndarray, float]:
        """(unit_embedding, magnitude) for one image; a zero embedding stays
        zero (the index's zero-norm guard)."""
        emb = self.encoder.encode_images([str(image_path)])[0]
        magnitude = float(np.linalg.norm(emb))
        return emb / (magnitude if magnitude > 0 else 1.0), magnitude

    def process_and_store_images(self, image_paths: Sequence,
                                 batch_size: Optional[int] = None) -> Tuple[int, int]:
        """Batched decode + encode + one bulk insert; images that fail to
        decode are skipped and counted. Returns (stored, failed)."""
        if not image_paths:
            logger.warning("No image paths provided for processing.")
            return 0, 0
        from image_retrieval_tpu_torch.data.loader import stream_decoded

        bs = batch_size or self.config.batch_size
        ok_paths: List[str] = []
        ok_embs: List[np.ndarray] = []
        fail_count = [0]
        # PIL decode (use_native=False): the same pixels as the JAX package
        feed = stream_decoded([str(p) for p in image_paths], batch_size=bs,
                              size=self.config.model.image_size,
                              fail_count=fail_count, use_native=False)
        for good_paths, embs in self.encoder.encode_stream(feed):
            ok_paths.extend(good_paths)
            ok_embs.extend(embs)
        if ok_paths:
            with trace("embed/index_insert", self.index.device):
                attrs = self.attrs_fn(ok_paths) if self.attrs_fn else None
                self.index.insert(ok_paths, np.stack(ok_embs), attrs=attrs)
                self.index.flush()  # the durability barrier of a journaled index
            logger.info(f"Inserted batch of {len(ok_paths)} images into index.")
        return len(ok_paths), fail_count[0]

    def get_embeddings(self, limit: int = 1000):
        """[(path, unit_embedding)]."""
        return self.index.query(limit)

    def get_embeddings_with_magnitude(self, limit: int = 1000):
        """[(path, unit_embedding, magnitude)]."""
        return self.index.query(limit, with_magnitude=True)

    def reconstruct_original_embeddings(self, embeddings=None, limit: int = 1000):
        """[(path, unnormalized_embedding)]."""
        if embeddings is not None:
            return [(p, e * m) for p, e, m in embeddings]
        return self.index.reconstruct_original_embeddings(limit)
