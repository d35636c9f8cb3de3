"""Configuration: the JAX package's framework-free dataclasses, re-exported.

``image_retrieval_tpu.config`` (and that package's ``__init__``) import no
jax, so both packages read one definition of every setting.
"""

from image_retrieval_tpu.config import (  # noqa: F401
    DEFAULT_SIMILARITY_PARAMS,
    SCORE_THRESHOLD,
    Config,
    IndexConfig,
    ModelConfig,
    serving_config,
    vit_b32_serving,
)
