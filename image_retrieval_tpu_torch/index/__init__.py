"""The resident exact vector index."""

from image_retrieval_tpu_torch.index.vector_index import ShardedVectorIndex  # noqa: F401
