"""The ViT-L/14 serving path of the port held against the JAX package's:
every routing of a transformer layer that ``layer_mode`` knows (the Flax
``Block.__call__`` case by case), an L/14-shaped pair of towers under
``serving_config``, and the slice as a whole (ingest + search at embedding
width 768).

The L/14 shape is cut only where the routing does not need it: the vision
tower keeps width 1024 and 16 heads (wider than the whole-layer kernel
serves, so it must take the sub-block pair), the text tower width 768 and
12 heads (the whole-layer kernel), the embedding 768; depth is 2 + 2 layers
and the image 56 x 56 at patch 14 (17 tokens). The same weights go to both
packages through params_from_jax, the same inputs from a numpy seed; the JAX
Pallas kernels run in interpret mode. Which kernel entry each block took is
shown by counting the calls on both sides, with no launch: on the CPU the
port's wrappers run their plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.config import Config, IndexConfig, ModelConfig, serving_config
from image_retrieval_tpu.models.clip import CLIP as JaxCLIP
from image_retrieval_tpu.models.clip import init_params as jax_init_params
from image_retrieval_tpu.ops import flash_attention as jfa
from image_retrieval_tpu_torch import config as tcfg
from image_retrieval_tpu_torch.models import clip as tclip
from image_retrieval_tpu_torch.models.clip import CLIP, KERNEL, LAYER, PLAIN, QUANT, layer_mode
from image_retrieval_tpu_torch.models.tokenizer import get_tokenizer
from image_retrieval_tpu_torch.models.weights import init_params, params_from_jax

KERNELS = ("layer_block_int8", "attention_block_int8", "mlp_block_int8")

L14 = dict(image_size=56, patch_size=14, vision_width=1024, vision_layers=2,
           vision_heads=16, text_width=768, text_layers=2, text_heads=12,
           vocab_size=1000, context_length=16, embed_dim=768, dtype="float32")
# the small widths of tests/test_torch_clip.py
SMALL = dict(image_size=32, patch_size=8, vision_width=48, vision_layers=2,
             vision_heads=4, text_width=32, text_layers=2, text_heads=2,
             vocab_size=1000, context_length=16, embed_dim=24, dtype="float32")

# Int8 routes: both packages quantize the same values by the same rules and
# differ only where an f32 sum taken in another order flips an int8 level
# (tests/test_torch_layer_block.py); over a tower that is bounded per row by
# the cosine of tests/test_torch_clip.py. Plain routes: f32 summation order.
MIN_COS = 0.9999


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
def l14_params():
    return _params(L14)


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


def _counts(layer=0, attn=0, mlp=0):
    return dict(zip(KERNELS, (layer, attn, mlp)))


# flags -> (vision routes, text routes, kernel calls of a 2-layer vision tower, of the text tower)
ROUTINGS = {
    "attn_kernel_only": (dict(fused_attn_block=True, int8_matmuls=True),
                         (KERNEL, QUANT), (KERNEL, QUANT), _counts(attn=2), _counts(attn=2)),
    "mlp_kernel_only": (dict(fused_mlp_block=True, int8_matmuls=True),
                        (QUANT, KERNEL), (QUANT, KERNEL), _counts(mlp=2), _counts(mlp=2)),
    "both_subblock_kernels": (dict(fused_attn_block=True, fused_mlp_block=True,
                                   int8_matmuls=True),
                              (KERNEL, KERNEL), (KERNEL, KERNEL),
                              _counts(attn=2, mlp=2), _counts(attn=2, mlp=2)),
    "int8_matmuls_alone": (dict(int8_matmuls=True), (QUANT, QUANT), (QUANT, QUANT),
                           _counts(), _counts()),
    "serving_with_vision_seq_pad": (dict(fused_layer_block=True, int8_matmuls=True,
                                         vision_seq_pad=24),
                                    (QUANT, KERNEL), (LAYER, LAYER),
                                    _counts(mlp=2), _counts(layer=2)),
    "plain_with_vision_seq_pad": (dict(vision_seq_pad=24), (PLAIN, PLAIN), (PLAIN, PLAIN),
                                  _counts(), _counts()),
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
        if vis_mode == (PLAIN, PLAIN):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert _row_cos(got, want).min() >= MIN_COS


def test_vision_seq_pad_leaves_the_real_tokens_alone(small_params):
    """Zero tokens whose keys get a -inf bias: the plain tower's embeddings
    are those of the unpadded tower (f32 softmax over more, zero-weight,
    keys: summation order only)."""
    px, _ = _inputs(ModelConfig(**SMALL))
    out = []
    for pad in (0, 24):
        cfg = ModelConfig(**SMALL, vision_seq_pad=pad)
        model = CLIP(cfg, torch.float32)
        model.load_state_dict(params_from_jax(small_params, cfg))
        assert model.vision.seq_pad == (7 if pad else 0)
        with torch.no_grad():
            out.append(model.encode_image(torch.from_numpy(px)).numpy())
    np.testing.assert_allclose(out[1], out[0], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_l14_shaped_serving_towers_match_jax(dtype, l14_params, calls):
    """serving_config at the L/14 widths: the vision blocks (width 1024) take
    attention_block_int8 then mlp_block_int8, the text blocks (width 768,
    causal) layer_block_int8, in both packages. In bf16 the two frameworks
    also round at other places (embedding sums, the LayerNorm input), which
    the int8 levels amplify: cosine >= 0.999, the bound the JAX package's
    own tests hold its int8 towers to against f32."""
    cfg = serving_config(ModelConfig(**{**L14, "dtype": dtype}))
    assert layer_mode(cfg, cfg.vision_width) == (KERNEL, KERNEL)
    assert layer_mode(cfg, cfg.text_width, causal=True) == (LAYER, LAYER)
    image, text, vision, textc = _run_towers(cfg, l14_params, calls, dtype)
    assert vision == {"jax": _counts(attn=2, mlp=2), "torch": _counts(attn=2, mlp=2)}
    assert textc == {"jax": _counts(layer=2), "torch": _counts(layer=2)}
    for got, want in (image, text):
        assert got.shape == want.shape == (4, 768) and np.isfinite(got).all()
        assert _row_cos(got, want).min() >= (MIN_COS if dtype == "float32" else 0.999)


def test_int8_cache_covers_the_split_weights(l14_params):
    """One quantization per block, whatever route reads it; the halves are
    views of it, and loading new weights drops it."""
    cfg = serving_config(ModelConfig(**L14))
    model = CLIP(cfg, torch.float32)
    state = params_from_jax(l14_params, cfg)
    model.load_state_dict(state)
    blk = model.vision.blocks[0]
    first = blk.int8_weights()
    px, _ = _inputs(cfg, n=1)
    with torch.no_grad():
        model.encode_image(torch.from_numpy(px))
    assert blk.int8_weights() is first
    assert first.attn.wo_t is first.wo_t and first.mlp.w1_t is first.w1_t
    assert first.wqkv_t.shape == (3 * 1024, 1024) and first.w1_t.shape == (4096, 1024)
    model.load_state_dict(state)
    assert blk.int8_weights() is not first


@pytest.mark.parametrize("arch", ["vit_b32", "vit_b16", "vit_l14"])
def test_preset_routes_shapes_and_encode(arch):
    """The three presets under serving_config: which kernels their towers
    take, init_params at their shapes, and CLIPEncoder at full width on the
    CPU (depth cut to one layer: nothing in the parameter shapes or the
    routing depends on it)."""
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    full = tcfg.serving_config(getattr(tcfg, arch)())
    wide = full.vision_width > 768
    assert layer_mode(full, full.vision_width) == ((KERNEL, KERNEL) if wide else (LAYER, LAYER))
    assert layer_mode(full, full.text_width, causal=True) == (LAYER, LAYER)
    cfg = dataclasses.replace(full, vision_layers=1, text_layers=1,
                              vocab_size=get_tokenizer().vocab_size)
    params = init_params(cfg, seed=0)
    n = (cfg.image_size // cfg.patch_size) ** 2
    assert params["vision.position_embedding"].shape == (n + 1, cfg.vision_width)
    assert params["vision.patch_embed.kernel"].shape == (
        cfg.patch_size, cfg.patch_size, 3, cfg.vision_width)
    assert params["vision.proj"].shape == (cfg.vision_width, cfg.embed_dim)
    assert params["text.proj"].shape == (cfg.text_width, cfg.embed_dim)
    enc = CLIPEncoder(tcfg.Config(model=cfg), params=params, device="cpu")
    px = np.random.default_rng(0).integers(
        0, 256, size=(2, cfg.image_size, cfg.image_size, 3), dtype=np.uint8)
    img, txt = enc.encode_pixels(px), enc.encode_texts(["a red car"])
    assert img.shape == (2, cfg.embed_dim) and txt.shape == (1, cfg.embed_dim)
    assert np.isfinite(img).all() and np.isfinite(txt).all()
    assert np.abs(img[0] - img[1]).max() > 0


def test_entry_points_default_to_the_card():
    """No device= means the card; without one the entry point raises
    instead of running on the CPU."""
    from image_retrieval_tpu_torch.app.embed import ImageEmbeddingSystem
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder, FakeEncoder

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised in tests/test_torch_gpu.py")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedVectorIndex(dim=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        ImageEmbeddingSystem(FakeEncoder(dim=8))
    with pytest.raises(RuntimeError, match="CUDA"):
        CLIPEncoder(tcfg.Config(model=tcfg.ModelConfig(**SMALL)))


# ---------------------------------------------------------------------------
# The slice as a whole: ingest + search at embedding width 768
# ---------------------------------------------------------------------------

QUERIES = ["a red car", "a blue boat", "a small dog"]
TOP_K = 5


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("l14_imgs")
    rng = np.random.default_rng(2)
    paths = []
    for i in range(5):
        p = d / f"{i}.png"
        Image.fromarray(rng.integers(0, 256, size=(60 + i, 64, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    return paths


def test_l14_shaped_slice_matches_jax(image_files):
    """Files -> ImageEmbeddingSystem -> 768-d index -> TextImageSearcher in
    both packages. The stored embeddings agree by cosine (int8 flips only);
    with the same gallery rows planted around each query in both indexes,
    the best hit is the query's own row and the ranked scores agree to 1e-3
    (a cosine of 0.9999 between the two packages' query embeddings could
    move a score by 1.4e-2 at worst; readings are below 1e-4)."""
    from image_retrieval_tpu.app.embed import ImageEmbeddingSystem as JaxEmbed
    from image_retrieval_tpu.app.search import TextImageSearcher as JaxSearcher
    from image_retrieval_tpu.models.encoder import CLIPEncoder as JaxEncoder
    from image_retrieval_tpu_torch.app.embed import ImageEmbeddingSystem
    from image_retrieval_tpu_torch.app.search import TextImageSearcher
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    model = serving_config(ModelConfig(**{
        **L14, "vocab_size": get_tokenizer().vocab_size, "context_length": 77}))
    cfg = Config(model=model, index=IndexConfig(embedding_dim=768, capacity_step=64))
    _, params = jax_init_params(model, seed=0)
    params = jax.tree.map(np.asarray, params)
    ref = JaxEmbed(JaxEncoder(cfg, params=params), config=cfg)
    mine = ImageEmbeddingSystem(
        CLIPEncoder(cfg, params=params_from_jax(params, model), device="cpu"),
        config=cfg, device="cpu")
    assert mine.encoder.dim == mine.index.dim == 768
    assert mine.process_and_store_images(image_files, batch_size=4) == (5, 0)
    assert ref.process_and_store_images(image_files, batch_size=4) == (5, 0)
    assert mine.index.paths == ref.index.paths
    got = mine.index.get_vectors(np.arange(5))
    want = ref.index.get_vectors(np.arange(5))
    assert got.shape == (5, 768)
    assert _row_cos(got, want).min() >= MIN_COS

    txt = mine.encoder.encode_texts(QUERIES)
    assert _row_cos(txt, ref.encoder.encode_texts(QUERIES)).min() >= MIN_COS
    rng = np.random.default_rng(3)
    unit = txt / np.linalg.norm(txt, axis=1, keepdims=True)
    rows, paths = [], []
    for i, u in enumerate(unit):
        for c in (1.0, 0.95, 0.85, 0.7, 0.5):
            n = rng.normal(size=u.shape)
            n -= (n @ u) * u
            rows.append(c * u + np.sqrt(1 - c * c) * n / np.linalg.norm(n))
            paths.append(f"planted/{i}/{c}")
    rows = np.asarray(rows, np.float32)
    mine.index.insert(paths, rows)
    ref.index.insert(paths, rows)
    s_mine = TextImageSearcher(mine.encoder, mine.index)
    s_ref = JaxSearcher(ref.encoder, ref.index)
    for i, q in enumerate(QUERIES):
        g = s_mine.search(q, top_k=TOP_K, score_threshold=-1.0)
        w = s_ref.search(q, top_k=TOP_K, score_threshold=-1.0)
        assert g[0]["path"] == w[0]["path"] == f"planted/{i}/1.0"
        assert g[0]["score"] == pytest.approx(1.0, abs=1e-3)
        np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in w],
                                   rtol=0, atol=1e-3)
        # seeded random towers embed the queries close to each other, so rows
        # planted for another query can tie: ranks may swap only within the
        # score tolerance
        for a, b in zip(g, w):
            assert a["path"] == b["path"] or abs(a["score"] - b["score"]) <= 1e-3
