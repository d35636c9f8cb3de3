"""Unified configuration of the port: model, mesh, index, analysis and
search settings.

The port's own copy of the JAX package's ``config.py``: the same dataclasses
(field names, types, defaults) and the same presets, so a configuration
written for one package reads the same in the other.
``tests/test_torch_config.py`` pins the copy to the original. The port
imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

EMBEDDING_DIM = 512
BATCH_SIZE = 100
SCORE_THRESHOLD = 0.25

# One copy of the default optimized-similarity weights: every search surface
# reads it, so a re-weighting cannot drift between them.
DEFAULT_SIMILARITY_PARAMS = {
    "w_angle": 1.0, "w_l1": 0.0, "w_l2": 0.0, "w_inf": 0.0, "w_mag": 0.0,
}


@dataclasses.dataclass
class ModelConfig:
    """CLIP hyperparameters; the defaults are ViT-B/32
    ("openai/clip-vit-base-patch32")."""

    name: str = "clip-vit-base-patch32"
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    vocab_size: int = 49408
    context_length: int = 77
    embed_dim: int = EMBEDDING_DIM
    dtype: str = "bfloat16"  # compute dtype; params + accumulation stay f32
    remat: bool = False  # rematerialize blocks in the backward pass (training)
    # Pad the vision token sequence (CLS + patches) up to this length with
    # zero tokens whose keys get a -inf attention bias, so the real tokens'
    # outputs are identical. 0 = no padding.
    vision_seq_pad: int = 0
    # Lower the patch conv as reshape -> one matmul (the port always does).
    patch_embed_matmul: bool = False
    # The framework's fused attention call inside the blocks.
    fused_attention: bool = False
    # Bare fused attention kernel (multihead_attention), mask-free towers.
    pallas_attention: bool = False
    # Fuse the pre-LN attention sub-block (LN1 + QKV + attention + out-proj +
    # residual) into one kernel call; with int8_matmuls the projections run
    # int8 x int8 (ops/flash_attention.py attention_block_int8).
    fused_attn_block: bool = False
    # Fuse the pre-LN MLP sub-block (LN2 + fc1 + quick_gelu + fc2 + residual)
    # into one kernel call (mlp_block_int8 with int8_matmuls).
    fused_mlp_block: bool = False
    # Fuse the whole transformer layer into one kernel call; with
    # int8_matmuls that is layer_block_int8 (the vit_b32_serving path).
    fused_layer_block: bool = False
    # Training-oriented VJP of the fused attention sub-block.
    fused_train_vjp: bool = False
    # Serving-time quantization: the big projections (QKV/out, MLP) run as
    # int8 x int8 -> int32 products with per-token activation scales and
    # per-channel weight scales. Inference-only numerics.
    int8_matmuls: bool = False


def vit_b32() -> "ModelConfig":
    return ModelConfig()


def vit_b32_serving() -> "ModelConfig":
    """ViT-B/32 under the serving execution strategy: one int8 kernel call
    per transformer layer (ops/flash_attention.py layer_block_int8), the
    causal mask applied in the kernel for the text tower. Use the default
    config where parity with the training/eval path matters."""
    return serving_config(ModelConfig())


def vit_b16() -> "ModelConfig":
    return dataclasses.replace(ModelConfig(), name="clip-vit-base-patch16",
                               patch_size=16)


def vit_l14() -> "ModelConfig":
    return dataclasses.replace(
        ModelConfig(), name="clip-vit-large-patch14", patch_size=14,
        vision_width=1024, vision_layers=24, vision_heads=16,
        text_width=768, text_layers=12, text_heads=12, embed_dim=768,
    )


def serving_config(base: "ModelConfig") -> "ModelConfig":
    """The serving execution strategy (whole-layer int8 kernels) on any
    architecture preset: `serving_config(vit_b16())`,
    `serving_config(vit_l14())`. Towers wider than 768 take the sub-block
    pair (attention_block_int8 + mlp_block_int8), as in the JAX package."""
    return dataclasses.replace(base, fused_layer_block=True, int8_matmuls=True)


@dataclasses.dataclass
class MeshConfig:
    """Device mesh layout. `data` shards the batch / gallery rows,
    `model` shards weight matrices (tensor parallelism)."""

    data: int = -1  # -1 -> use all devices on the data axis
    model: int = 1
    axis_names: Tuple[str, str] = ("data", "model")


@dataclasses.dataclass
class IndexConfig:
    """Exact-search index settings."""

    embedding_dim: int = EMBEDDING_DIM
    shard_axis: str = "data"  # mesh axis the gallery rows are sharded over
    capacity_step: int = 65536  # the gallery grows in chunks of this many rows
    # Gallery storage dtype (the sweep is bound by memory traffic):
    #   float32  : oracle ranking parity (default)
    #   bfloat16 : half the traffic
    #   int8     : a quarter of the traffic (symmetric per-row scales)
    #   int4     : capacity tier: nibble-packed rows on the device; search is
    #              two-phase (cosine only): packed screen, then an exact int8
    #              rerank of the top rerank_c candidates from the host copy.
    dtype: str = "float32"
    # int4 two-phase: candidates screened per query before the exact rerank.
    rerank_c: int = 128
    # Beyond-device-memory tier: when the (int8) gallery exceeds this many
    # bytes, the cosine path streams host chunks through a device window.
    # None disables (default).
    stream_threshold_bytes: Optional[int] = None
    # int8 + optimized_similarity: keep a pre-dequantized bf16 copy of the
    # rows on the device so the L1/Linf sweep skips the dequant multiply.
    l1_shadow: bool = False
    # int4 latency mode: also keep the int8 rows on the device so the exact
    # rerank needs no host hop. Ignored unless dtype == "int4".
    rerank_device: bool = False
    # Approximate selection for the resident tiers: over-select candidates
    # (whose scores are the true scores) before the exact top-k.
    approx_select: bool = False


@dataclasses.dataclass
class AnalysisConfig:
    """MI-analysis knobs."""

    num_pairs: int = 1000
    num_bins: int = 20
    bin_strategy: str = "uniform"
    grid_size: int = 3  # weight-optimization grid
    max_sampled_comparisons: int = 50000
    seed: int = 42


@dataclasses.dataclass
class SearchConfig:
    """Search behaviour."""

    score_threshold: float = SCORE_THRESHOLD
    rank_by_abs: bool = True  # rank by abs(similarity)
    # Candidate overfetch factor; a no-op for correctness on the exact
    # index, honoured for behavioural parity.
    overfetch: int = 3
    # Candidate generation: "exact", "ivf" or "screen".
    ann: str = "exact"
    # nlist/nprobe = 0 means "auto".
    nlist: int = 1024
    nprobe: int = 10
    # ann="screen": sketch width and the candidate pool reranked exactly.
    screen_dims: int = 128
    screen_candidates: int = 128


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    index: IndexConfig = dataclasses.field(default_factory=IndexConfig)
    analysis: AnalysisConfig = dataclasses.field(default_factory=AnalysisConfig)
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    batch_size: int = BATCH_SIZE
    weights_path: Optional[str] = None  # HF checkpoint dir, if present

    @property
    def similarity_params(self) -> dict:
        """Default optimized-similarity weights."""
        return dict(DEFAULT_SIMILARITY_PARAMS)


def default_config() -> Config:
    return Config()
