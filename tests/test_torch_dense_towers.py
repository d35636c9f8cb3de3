"""The port's encoder under the ModelConfig flags that select the kernels in
the compute dtype (fused_layer_block, fused_attn_block, fused_mlp_block
without int8_matmuls; pallas_attention; fused_attention) held against the JAX
package's towers: the same weights through params_from_jax, the same inputs
from a numpy seed, the JAX Pallas kernels in interpret mode.

Which kernel entry each block took is shown by counting the calls, on both
sides where the two packages route alike, with no launch: on the CPU the
port's wrappers run their plain versions. The JAX package also asks a table
of shapes its TPU compiler accepted (ops/shape_support.py); the shapes here
are ones the table does not hold, so its rule of thumb decides (whole-layer
kernel up to width 512 without int8), and one test shows where the port,
which carries no such table, parts from it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.config import Config, IndexConfig, ModelConfig
from image_retrieval_tpu.models.clip import CLIP as JaxCLIP
from image_retrieval_tpu.models.clip import init_params as jax_init_params
from image_retrieval_tpu.ops import flash_attention as jfa
from image_retrieval_tpu_torch.models import clip as tclip
from image_retrieval_tpu_torch.models.clip import (
    CLIP, DENSE_KERNEL, DENSE_LAYER, PLAIN, QUANT, layer_mode)
from image_retrieval_tpu_torch.models.tokenizer import get_tokenizer
from image_retrieval_tpu_torch.models.weights import params_from_jax

from test_torch_slice import QUERIES, _serve

KERNELS = ("layer_block", "attention_block", "mlp_block", "multihead_attention")

# the small widths of tests/test_torch_clip.py: 17 vision tokens, 16 text
SMALL = dict(image_size=32, patch_size=8, vision_width=48, vision_layers=2,
             vision_heads=4, text_width=32, text_layers=2, text_heads=2,
             vocab_size=1000, context_length=16, embed_dim=24, dtype="float32")
# the ViT-L/14 routing at a small depth: a vision tower wider than the
# whole-layer kernel serves (the sub-block pair) beside a text tower it does
WIDE = dict(image_size=56, patch_size=14, vision_width=1024, vision_layers=2,
            vision_heads=16, text_width=512, text_layers=2, text_heads=8,
            vocab_size=1000, context_length=16, embed_dim=64, dtype="float32")

# No quantization on these routes: both packages run the same f32 math and
# differ by summation order (the tolerance of tests/test_torch_clip.py's
# default path). With int8_matmuls beside pallas_attention the int8 flips of
# tests/test_torch_l14.py come back: per-row cosine.
RTOL = ATOL = 1e-4
MIN_COS_INT8 = 0.9999
# bf16 towers: the two frameworks round at other places (embedding sums, the
# LayerNorm input, XLA's excess precision on the CPU); readings are >= 0.99995
MIN_COS_BF16 = 0.9995


def _row_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _inputs(cfg, n=4):
    rng = np.random.default_rng(0)
    px = rng.normal(size=(n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    toks = rng.integers(1, cfg.vocab_size - 1, size=(n, cfg.context_length)).astype(np.int32)
    toks[:, 9] = cfg.vocab_size - 1  # EOT = max id: the pooled position
    return px, toks


@pytest.fixture
def calls(monkeypatch):
    """Counts, per tower, the kernel entries each package calls."""
    counts = {"jax": {k: 0 for k in KERNELS}, "torch": {k: 0 for k in KERNELS}}

    def counting(side, name, fn):
        def wrapped(*args, **kwargs):
            counts[side][name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name in KERNELS:
        monkeypatch.setattr(jfa, name, counting("jax", name, getattr(jfa, name)))
        monkeypatch.setattr(tclip, name, counting("torch", name, getattr(tclip, name)))

    def take():
        got = {side: dict(c) for side, c in counts.items()}
        for c in counts.values():
            c.update(dict.fromkeys(KERNELS, 0))
        return got

    return take


def _params(base):
    _, params = jax_init_params(ModelConfig(**base), seed=0)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def small_params():
    return _params(SMALL)


@pytest.fixture(scope="module")
def wide_params():
    return _params(WIDE)


def _run_towers(cfg, params, calls, dtype="float32"):
    """Both towers in both packages; returns ((got, want) image, (got, want)
    text, calls of the vision towers, calls of the text towers)."""
    px, toks = _inputs(cfg)
    jm = JaxCLIP(cfg, dtype=getattr(jnp, dtype))
    model = CLIP(cfg, getattr(torch, dtype))
    model.load_state_dict(params_from_jax(params, cfg))
    want_i = np.asarray(jm.apply(params, jnp.asarray(px), method=JaxCLIP.encode_image))
    with torch.no_grad():
        got_i = model.encode_image(torch.from_numpy(px)).numpy()
    vision = calls()
    want_t = np.asarray(jm.apply(params, jnp.asarray(toks), method=JaxCLIP.encode_text))
    with torch.no_grad():
        got_t = model.encode_text(torch.from_numpy(toks).long()).numpy()
    return (got_i, want_i), (got_t, want_t), vision, calls()


def _counts(layer=0, attn=0, mlp=0, mha=0):
    return dict(zip(KERNELS, (layer, attn, mlp, mha)))


# flags -> (vision routes, text routes, kernel calls of a 2-layer vision tower, of the text tower)
ROUTINGS = {
    "A_fused_layer_block": (dict(fused_layer_block=True),
                            (DENSE_LAYER, DENSE_LAYER), (DENSE_LAYER, DENSE_LAYER),
                            _counts(layer=2), _counts(layer=2)),
    "C_pallas_attention": (dict(pallas_attention=True), (PLAIN, PLAIN), (PLAIN, PLAIN),
                           _counts(mha=2), _counts()),
    "C_pallas_attention_int8": (dict(pallas_attention=True, int8_matmuls=True),
                                (QUANT, QUANT), (QUANT, QUANT), _counts(mha=2), _counts()),
    "C_pallas_attention_masked": (dict(pallas_attention=True, vision_seq_pad=24),
                                  (PLAIN, PLAIN), (PLAIN, PLAIN), _counts(), _counts()),
    "D_attn_kernel_only": (dict(fused_attn_block=True),
                           (DENSE_KERNEL, PLAIN), (DENSE_KERNEL, PLAIN),
                           _counts(attn=2), _counts(attn=2)),
    "D_mlp_kernel_only": (dict(fused_mlp_block=True),
                          (PLAIN, DENSE_KERNEL), (PLAIN, DENSE_KERNEL),
                          _counts(mlp=2), _counts(mlp=2)),
    "D_both_subblock_kernels": (dict(fused_attn_block=True, fused_mlp_block=True),
                                (DENSE_KERNEL, DENSE_KERNEL), (DENSE_KERNEL, DENSE_KERNEL),
                                _counts(attn=2, mlp=2), _counts(attn=2, mlp=2)),
    "D_attn_kernel_with_pallas_attention": (
        dict(fused_attn_block=True, pallas_attention=True),
        (DENSE_KERNEL, PLAIN), (DENSE_KERNEL, PLAIN), _counts(attn=2), _counts(attn=2)),
    "layer_with_vision_seq_pad": (dict(fused_layer_block=True, vision_seq_pad=24),
                                  (PLAIN, DENSE_KERNEL), (DENSE_LAYER, DENSE_LAYER),
                                  _counts(mlp=2), _counts(layer=2)),
    "attn_kernel_with_vision_seq_pad": (dict(fused_attn_block=True, vision_seq_pad=24),
                                        (PLAIN, PLAIN), (DENSE_KERNEL, PLAIN),
                                        _counts(), _counts(attn=2)),
    "fused_attention": (dict(fused_attention=True), (PLAIN, PLAIN), (PLAIN, PLAIN),
                        _counts(), _counts()),
    "fused_attention_masked": (dict(fused_attention=True, vision_seq_pad=24),
                               (PLAIN, PLAIN), (PLAIN, PLAIN), _counts(), _counts()),
}


@pytest.mark.parametrize("name", sorted(ROUTINGS))
def test_routing_matches_jax(name, small_params, calls):
    flags, vis_mode, txt_mode, vis_calls, txt_calls = ROUTINGS[name]
    cfg = ModelConfig(**SMALL, **flags)
    padded = cfg.vision_seq_pad > 17
    assert layer_mode(cfg, cfg.vision_width, masked=padded) == vis_mode
    assert layer_mode(cfg, cfg.text_width, causal=True) == txt_mode
    image, text, vision, textc = _run_towers(cfg, small_params, calls)
    # both packages reached the same kernel entries, once per layer
    assert vision == {"jax": vis_calls, "torch": vis_calls}
    assert textc == {"jax": txt_calls, "torch": txt_calls}
    for got, want in (image, text):
        assert got.shape == want.shape and np.isfinite(got).all()
        if cfg.int8_matmuls:
            assert _row_cos(got, want).min() >= MIN_COS_INT8
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", ["A_fused_layer_block", "C_pallas_attention",
                                  "D_both_subblock_kernels"])
def test_bf16_towers_match_jax(name, small_params, calls):
    flags, _, _, vis_calls, txt_calls = ROUTINGS[name]
    cfg = ModelConfig(**{**SMALL, "dtype": "bfloat16"}, **flags)
    image, text, vision, textc = _run_towers(cfg, small_params, calls, "bfloat16")
    assert vision == {"jax": vis_calls, "torch": vis_calls}
    assert textc == {"jax": txt_calls, "torch": txt_calls}
    for got, want in (image, text):
        assert got.shape == want.shape and np.isfinite(got).all()
        assert _row_cos(got, want).min() >= MIN_COS_BF16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wide_towers_take_the_subblock_pair(dtype, wide_params, calls):
    """Configuration B's routing: under fused_layer_block a vision tower of
    width 1024 takes attention_block then mlp_block, the text tower (width
    512, causal) layer_block, in both packages."""
    cfg = ModelConfig(**{**WIDE, "dtype": dtype}, fused_layer_block=True)
    assert layer_mode(cfg, cfg.vision_width) == (DENSE_KERNEL, DENSE_KERNEL)
    assert layer_mode(cfg, cfg.text_width, causal=True) == (DENSE_LAYER, DENSE_LAYER)
    image, text, vision, textc = _run_towers(cfg, wide_params, calls, dtype)
    assert vision == {"jax": _counts(attn=2, mlp=2), "torch": _counts(attn=2, mlp=2)}
    assert textc == {"jax": _counts(layer=2), "torch": _counts(layer=2)}
    for got, want in (image, text):
        assert got.shape == want.shape == (4, 64) and np.isfinite(got).all()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        else:
            assert _row_cos(got, want).min() >= MIN_COS_BF16


def test_where_the_routing_parts_from_the_jax_table(calls, monkeypatch, tmp_path):
    """A text tower of width 768 under fused_layer_block: the port takes
    layer_block up to width 768; the JAX package, without a table entry for
    the shape, keeps its whole-layer kernel to width 512 (TPU memory) and
    takes the pair. Both compute the same function."""
    monkeypatch.setenv("IR_MOSAIC_SHAPES", str(tmp_path / "no_table.json"))
    base = {**SMALL, "text_width": 768, "text_heads": 12, "text_layers": 1}
    cfg = ModelConfig(**base, fused_layer_block=True)
    assert layer_mode(cfg, 768, causal=True) == (DENSE_LAYER, DENSE_LAYER)
    assert layer_mode(cfg, 1024, causal=True) == (DENSE_KERNEL, DENSE_KERNEL)
    _, text, _, textc = _run_towers(cfg, _params(base), calls)
    assert textc["torch"] == _counts(layer=1)
    assert textc["jax"] == _counts(attn=1, mlp=1)
    np.testing.assert_allclose(text[0], text[1], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("flag", ["fused_layer_block", "fused_attn_block", "fused_mlp_block",
                                  "pallas_attention", "fused_attention"])
def test_the_fused_parameter_tree_is_the_unfused_one(flag, small_params):
    """The fused routes read the parameters of the unfused modules, so
    params_from_jax carries over as is and the state dict loads strictly."""
    cfg = ModelConfig(**SMALL, **{flag: True})
    state = params_from_jax(small_params, cfg)
    plain = params_from_jax(small_params, ModelConfig(**SMALL))
    assert state.keys() == plain.keys()
    assert all(torch.equal(torch.as_tensor(state[k]), torch.as_tensor(plain[k])) for k in state)
    model = CLIP(cfg, torch.float32)
    assert model.state_dict().keys() == state.keys()
    model.load_state_dict(state, strict=True)


def test_dense_weights_cached_until_a_parameter_changes(small_params):
    """Cast once per compute dtype; a new state dict or a move casts again;
    while gradients are recorded the weights are part of the graph."""
    cfg = ModelConfig(**SMALL, fused_layer_block=True)
    model = CLIP(cfg, torch.bfloat16)
    state = params_from_jax(small_params, cfg)
    model.load_state_dict(state)
    model.requires_grad_(False)
    blk = model.vision.blocks[0]
    first = blk.dense_weights(torch.bfloat16)
    px, _ = _inputs(cfg, n=1)
    with torch.no_grad():
        model.encode_image(torch.from_numpy(px))
    assert blk.dense_weights(torch.bfloat16) is first
    assert first.wqkv_t.dtype == torch.bfloat16 and first.wqkv_t.shape == (144, 48)
    assert first.attn.wo_t is first.wo_t and not first.w1_t.requires_grad
    assert blk.dense_weights(torch.float32) is not first
    model.load_state_dict(state)
    second = blk.dense_weights(torch.bfloat16)
    assert second is not first and torch.equal(second.w1_t, first.w1_t)
    model.to("cpu")
    assert blk.dense_weights(torch.bfloat16) is not second
    model.requires_grad_(True)
    live = blk.dense_weights(torch.bfloat16)
    assert live.w1_t.requires_grad and blk.dense_weights(torch.bfloat16) is not live
    with torch.no_grad():
        assert not blk.dense_weights(torch.bfloat16).w1_t.requires_grad


def test_tower_gradients_match_jax(small_params):
    """d mean(encode_image(px)^2) / d parameters through layer_block on both
    sides (each backward recomputes through plain operations), at the
    tolerance the JAX package holds its fused towers' gradients to."""
    cfg = ModelConfig(**SMALL, fused_layer_block=True)
    px, _ = _inputs(cfg)
    jm = JaxCLIP(cfg, dtype=jnp.float32)
    grads = jax.grad(lambda p: jnp.mean(
        jm.apply(p, jnp.asarray(px), method=JaxCLIP.encode_image) ** 2))(small_params)
    want = params_from_jax(jax.tree.map(np.asarray, grads), cfg)
    model = CLIP(cfg, torch.float32)
    model.load_state_dict(params_from_jax(small_params, cfg))
    model.encode_image(torch.from_numpy(px)).square().mean().backward()
    checked = 0
    for name, p in model.named_parameters():
        if name.startswith("vision."):
            assert p.grad is not None, name
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(want[name]), rtol=2e-3,
                                       atol=2e-4, err_msg=name)
            checked += 1
    assert checked == 2 * 16 + 8  # two blocks; patch, class and position embeddings, two LayerNorms, the projection


# ---------------------------------------------------------------------------
# The slice as a whole under configuration A
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slice_under_fused_layer_block_matches_jax(dtype):
    """CLIPEncoder (fused_layer_block, no int8) -> ShardedVectorIndex ->
    SearchServer in both packages, the same pixels, texts and gallery rows.
    f32: embeddings to summation order, the served ranking identical. bf16
    (the default compute dtype): embeddings by cosine, and scores within
    5e-3 over rows planted at separated cosines (query embeddings a cosine
    of 0.99995 apart can move the score of a row at cosine 0.7 by 7e-3 at
    worst; readings are below 2e-3)."""
    from image_retrieval_tpu.app.server import SearchServer as JaxServer
    from image_retrieval_tpu.index.vector_index import ShardedVectorIndex as JaxIndex
    from image_retrieval_tpu.models.encoder import CLIPEncoder as JaxEncoder
    from image_retrieval_tpu_torch.app.server import SearchServer
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    model = ModelConfig(**{**SMALL, "vocab_size": get_tokenizer().vocab_size,
                           "context_length": 77, "dtype": dtype}, fused_layer_block=True)
    cfg = Config(model=model, index=IndexConfig(embedding_dim=24, capacity_step=64))
    _, params = jax_init_params(model, seed=0)
    params = jax.tree.map(np.asarray, params)
    jax_enc = JaxEncoder(cfg, params=params)
    enc = CLIPEncoder(cfg, params=params_from_jax(params, model), device="cpu")
    assert enc.model.vision.blocks[0].mode == (DENSE_LAYER, DENSE_LAYER)
    rng = np.random.default_rng(0)
    pixels = rng.integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8)
    img_j, img_t = jax_enc.encode_pixels(pixels), enc.encode_pixels(pixels)
    txt_j, txt_t = jax_enc.encode_texts(QUERIES), enc.encode_texts(QUERIES)
    assert img_t.shape == (6, 24) and img_t.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(img_t, img_j, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(txt_t, txt_j, rtol=RTOL, atol=ATOL)
    else:
        assert _row_cos(img_t, img_j).min() >= MIN_COS_BF16
        assert _row_cos(txt_t, txt_j).min() >= MIN_COS_BF16
    unit = txt_t / np.linalg.norm(txt_t, axis=1, keepdims=True)
    rows, paths = [], []
    for i, u in enumerate(unit):
        for c in (1.0, 0.95, 0.85, 0.7, 0.5):
            n = rng.normal(size=u.shape)
            n -= (n @ u) * u
            rows.append(c * u + np.sqrt(1 - c * c) * n / np.linalg.norm(n))
            paths.append(f"planted/{i}/{c}")
    rows = np.asarray(rows, np.float32)

    def build(index):
        index.insert([f"img/{i}.png" for i in range(6)], img_t)
        index.insert(paths, rows)
        return index

    got = _serve(SearchServer, enc,
                 build(ShardedVectorIndex(dim=24, config=cfg.index, device="cpu")))
    want = _serve(JaxServer, jax_enc, build(JaxIndex(dim=24, config=cfg.index)))
    atol = 1e-4 if dtype == "float32" else 5e-3
    for i, (g, w) in enumerate(zip(got, want)):
        assert g[0]["path"] == w[0]["path"] == f"planted/{i}/1.0"
        np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in w],
                                   rtol=0, atol=atol)
        # seeded random towers embed the queries close to each other, so rows
        # planted for another query can tie: ranks may swap only within atol
        for a, b in zip(g, w):
            assert a["path"] == b["path"] or abs(a["score"] - b["score"]) <= atol
