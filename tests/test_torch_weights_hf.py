"""The port's reading of an HF checkpoint directory
(image_retrieval_tpu_torch/models/weights.py: ``model_config_from_hf`` and
``load_hf_clip_params``) held against the JAX package's
(image_retrieval_tpu/models/weights.py) on the same directories, which the
tests write: a ``transformers.CLIPConfig`` saved with ``save_pretrained``, a
config.json with keys missing (the HF defaults show), the
openai/clip-vit-base-patch32 layout written as JSON, and a small random
``transformers.CLIPModel`` saved as pytorch_model.bin and as
model.safetensors. The configs must be equal field by field; the weights
bit for bit (both packages only transpose and cast to f32)."""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from image_retrieval_tpu.models import weights as jweights  # noqa: E402
from image_retrieval_tpu_torch.config import vit_b32  # noqa: E402
from image_retrieval_tpu_torch.models import weights as tweights  # noqa: E402


def _fields(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _both(path):
    mine, ref = tweights.model_config_from_hf(path), jweights.model_config_from_hf(path)
    assert _fields(mine) == _fields(ref)
    assert mine.dtype == "float32"
    return mine


def _tiny_hf_config(**vision):
    return transformers.CLIPConfig(
        text_config=dict(vocab_size=320, hidden_size=32, intermediate_size=128,
                         num_hidden_layers=2, num_attention_heads=2,
                         max_position_embeddings=24, hidden_act="quick_gelu"),
        vision_config=dict(hidden_size=48, intermediate_size=192, num_hidden_layers=3,
                           num_attention_heads=4, image_size=32, patch_size=8,
                           hidden_act="quick_gelu", **vision),
        projection_dim=40)


def test_model_config_from_a_saved_clip_config(tmp_path):
    _tiny_hf_config().save_pretrained(str(tmp_path))
    cfg = _both(str(tmp_path))
    assert (cfg.image_size, cfg.patch_size, cfg.vision_width, cfg.vision_layers,
            cfg.vision_heads) == (32, 8, 48, 3, 4)
    assert (cfg.text_width, cfg.text_layers, cfg.text_heads, cfg.vocab_size,
            cfg.context_length, cfg.embed_dim) == (32, 2, 2, 320, 24, 40)


@pytest.mark.parametrize("content", [
    {},
    {"projection_dim": 64},
    {"text_config": {"hidden_size": 256, "num_attention_heads": 4}},
    {"vision_config": {"patch_size": 16, "num_hidden_layers": 24}, "text_config": {}},
], ids=["empty", "projection_only", "text_partial", "vision_partial"])
def test_model_config_defaults_where_keys_are_missing(tmp_path, content):
    """Missing keys take the HF CLIPText/VisionConfig defaults on both sides
    (openai/clip-vit-base-patch32's widths)."""
    (tmp_path / "config.json").write_text(json.dumps(content))
    cfg = _both(str(tmp_path))
    if not content:
        assert dataclasses.replace(cfg, dtype=vit_b32().dtype) == vit_b32()


def test_model_config_of_the_b32_layout(tmp_path):
    """openai/clip-vit-base-patch32's widths written out as its config.json
    lays them: vit_b32() but for the compute dtype."""
    (tmp_path / "config.json").write_text(json.dumps({
        "projection_dim": 512,
        "text_config": {"hidden_size": 512, "intermediate_size": 2048,
                        "num_hidden_layers": 12, "num_attention_heads": 8,
                        "vocab_size": 49408, "max_position_embeddings": 77},
        "vision_config": {"hidden_size": 768, "intermediate_size": 3072,
                          "num_hidden_layers": 12, "num_attention_heads": 12,
                          "patch_size": 32, "image_size": 224},
    }))
    cfg = _both(str(tmp_path))
    assert dataclasses.replace(cfg, dtype=vit_b32().dtype) == vit_b32()


@pytest.mark.parametrize("safe", [False, True], ids=["pytorch_model.bin", "safetensors"])
def test_load_hf_clip_params_matches_jax(tmp_path, safe):
    """A random CLIPModel saved both ways: the port's state dict equals the
    JAX package's tree carried across, leaf by leaf, bit for bit; the config
    read back from the directory describes it."""
    torch.manual_seed(0)
    hf = transformers.CLIPModel(_tiny_hf_config()).eval()
    hf.save_pretrained(str(tmp_path), safe_serialization=safe)
    assert (tmp_path / ("model.safetensors" if safe else "pytorch_model.bin")).exists()
    cfg = _both(str(tmp_path))
    mine = tweights.load_hf_clip_params(str(tmp_path), cfg)
    ref = tweights.params_from_jax(
        jax.tree.map(np.asarray, jweights.load_hf_clip_params(str(tmp_path), cfg)), cfg)
    assert mine.keys() == ref.keys()
    for k, v in ref.items():
        assert mine[k].dtype == torch.float32
        assert torch.equal(mine[k], v), k
    # the mapping reached the HF tensors themselves
    assert torch.equal(mine["vision.blocks.2.mlp.fc1.kernel"],
                       hf.vision_model.encoder.layers[2].mlp.fc1.weight.detach().t())
