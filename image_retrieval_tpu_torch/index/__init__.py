"""The resident exact vector index and its write-ahead journal."""

from image_retrieval_tpu_torch.index.journal import IndexJournal  # noqa: F401
from image_retrieval_tpu_torch.index.vector_index import ShardedVectorIndex  # noqa: F401
