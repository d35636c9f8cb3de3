"""The resident exact vector index, its write-ahead journal and the planner."""

from image_retrieval_tpu_torch.index.journal import IndexJournal  # noqa: F401
from image_retrieval_tpu_torch.index.plan import IndexPlan, plan_index  # noqa: F401
from image_retrieval_tpu_torch.index.vector_index import ShardedVectorIndex  # noqa: F401
