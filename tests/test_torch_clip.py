"""The port's CLIP (image_retrieval_tpu_torch/models) held against the JAX
package's: same weights carried across with params_from_jax, same inputs
from a numpy seed, both towers, on the default path and the int8 serving
path. Also the HF weight mapping and the tokenizer copy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.config import ModelConfig, serving_config
from image_retrieval_tpu.models.clip import CLIP as JaxCLIP
from image_retrieval_tpu.models.clip import init_params as jax_init_params
from image_retrieval_tpu_torch.models.clip import CLIP, LAYER, layer_mode
from image_retrieval_tpu_torch.models.weights import (
    init_params,
    params_from_hf_state_dict,
    params_from_jax,
)

# the small widths of tests/test_weights_port.py: 2 layers, W 48 / 32
SMALL = ModelConfig(
    image_size=32, patch_size=8, vision_width=48, vision_layers=2,
    vision_heads=4, text_width=32, text_layers=2, text_heads=2,
    vocab_size=1000, context_length=16, embed_dim=24, dtype="float32",
)


@pytest.fixture(scope="module")
def jax_params():
    _, params = jax_init_params(SMALL, seed=0)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    px = rng.normal(size=(4, 32, 32, 3)).astype(np.float32)
    toks = rng.integers(1, 999, size=(4, 16)).astype(np.int32)
    toks[:, 9] = 999  # EOT = max id: the pooled position
    return px, toks


def _towers(cfg, jax_params, inputs):
    px, toks = inputs
    jm = JaxCLIP(cfg, dtype=jnp.float32)
    want_i = np.asarray(jm.apply(jax_params, jnp.asarray(px), method=JaxCLIP.encode_image))
    want_t = np.asarray(jm.apply(jax_params, jnp.asarray(toks), method=JaxCLIP.encode_text))
    model = CLIP(cfg, torch.float32)
    model.load_state_dict(params_from_jax(jax_params, cfg))
    with torch.no_grad():
        got_i = model.encode_image(torch.from_numpy(px)).numpy()
        got_t = model.encode_text(torch.from_numpy(toks).long()).numpy()
    return (got_i, want_i), (got_t, want_t)


def _row_cos(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_default_path_matches_jax(jax_params, inputs):
    """Same f32 math on both sides (fast-variance LayerNorm, scale-first
    attention, quick_gelu): agreement to f32 summation order, the
    tolerance of tests/test_weights_port.py:93."""
    for got, want in _towers(SMALL, jax_params, inputs):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_serving_path_matches_jax(jax_params, inputs):
    """Every layer through layer_block_int8 on both sides (the JAX kernel
    interpreted). Agreement is to f32 rounding except where an int8 rounding
    flip (test_torch_layer_block.py) shifts a row: per-row cosine bounds it."""
    cfg = serving_config(SMALL)
    assert layer_mode(cfg, cfg.vision_width) == (LAYER, LAYER)
    assert layer_mode(cfg, cfg.text_width, causal=True) == (LAYER, LAYER)
    for got, want in _towers(cfg, jax_params, inputs):
        assert got.shape == want.shape
        assert _row_cos(got, want).min() >= 0.9999


def _hf_configs():
    from transformers import CLIPConfig

    return CLIPConfig(
        text_config=dict(
            vocab_size=1000, hidden_size=32, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=2,
            max_position_embeddings=16, hidden_act="quick_gelu",
            bos_token_id=998, eos_token_id=999,
        ),
        vision_config=dict(
            hidden_size=48, intermediate_size=192, num_hidden_layers=2,
            num_attention_heads=4, image_size=32, patch_size=8,
            hidden_act="quick_gelu",
        ),
        projection_dim=24,
    )


def test_hf_state_dict_mapping(inputs):
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    hf = transformers.CLIPModel(_hf_configs()).eval()
    model = CLIP(SMALL, torch.float32)
    model.load_state_dict(params_from_hf_state_dict(hf.state_dict(), SMALL))
    px, toks = inputs
    ids = torch.from_numpy(toks.astype(np.int64))
    ids[:, 10:] = 0  # after EOT; HF pools at the first EOS, the port at argmax
    with torch.no_grad():
        want_i = hf.get_image_features(pixel_values=torch.from_numpy(px).permute(0, 3, 1, 2))
        want_t = hf.get_text_features(input_ids=ids, attention_mask=torch.ones_like(ids))
        got_i = model.encode_image(torch.from_numpy(px))
        got_t = model.encode_text(ids)
    np.testing.assert_allclose(got_i.numpy(), want_i.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got_t.numpy(), want_t.numpy(), rtol=1e-4, atol=1e-4)


def test_init_params_loads_and_runs():
    cfg = serving_config(SMALL)
    model = CLIP(cfg)
    model.load_state_dict(init_params(cfg, seed=3))  # strict: every name matches
    with torch.no_grad():
        out = model.encode_image(torch.zeros(2, 32, 32, 3))
    assert out.shape == (2, 24) and torch.isfinite(out).all()
    again = init_params(cfg, seed=3)
    assert all(torch.equal(v, again[k]) for k, v in init_params(cfg, seed=3).items())


def test_weights_cached_until_a_parameter_changes():
    """Quantized once; a new state dict or a move quantizes again."""
    model = CLIP(serving_config(SMALL))
    model.load_state_dict(init_params(SMALL, seed=1))
    blk = model.vision.blocks[0]
    first = blk.int8_weights()
    assert blk.int8_weights() is first
    model.load_state_dict(init_params(SMALL, seed=2))
    second = blk.int8_weights()
    assert second is not first
    assert not torch.equal(second.w1_t, first.w1_t)
    model.to("cpu")
    assert blk.int8_weights() is not second
    assert torch.equal(blk.int8_weights().w1_t, second.w1_t)


@pytest.mark.parametrize("text", [
    "a photo of a white car", "The quick brown fox!", "don't   stop 123",
    "", "naïve café ☕", "<|endoftext|> tail",
])
def test_tokenizer_ids_equal(text):
    from image_retrieval_tpu.models.tokenizer import get_tokenizer as jax_tok
    from image_retrieval_tpu_torch.models.tokenizer import get_tokenizer

    np.testing.assert_array_equal(get_tokenizer()([text]), jax_tok()([text]))


def test_encoder_uint8_and_float_forms_agree():
    from image_retrieval_tpu_torch.config import Config
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder
    from image_retrieval_tpu_torch.models.preprocess import CLIP_MEAN, CLIP_STD

    enc = CLIPEncoder(Config(model=SMALL), seed=0, device="cpu")
    u8 = np.random.default_rng(2).integers(0, 256, size=(3, 32, 32, 3), dtype=np.uint8)
    f32 = ((u8.astype(np.float32) / 255.0 - CLIP_MEAN) / CLIP_STD).astype(np.float32)
    a, b = enc.encode_pixels(u8), enc.encode_pixels(f32)
    assert a.shape == (3, 24) and a.dtype == np.float32
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
