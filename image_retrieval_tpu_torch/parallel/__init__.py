"""The device mesh (``mesh.py``), the search collectives over it
(``collectives.py``) and the GPipe schedule (``pipeline.py``)."""

from image_retrieval_tpu_torch.parallel.collectives import sharded_search_topk  # noqa: F401
from image_retrieval_tpu_torch.parallel.mesh import make_mesh, replicate, shard_rows  # noqa: F401
