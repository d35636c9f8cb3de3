"""Tests of the port that need a CUDA card; each skips without one.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(`--noconftest` skips tests/conftest.py, which configures JAX.)
"""

import math

import numpy as np
import pytest
import torch

from image_retrieval_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer_weights(rng, w, device):
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    hidden = 4 * w
    params = [
        1 + 0.1 * f(w), 0.1 * f(w),
        f(w, w) / math.sqrt(w), 0.02 * f(w), f(w, w) / math.sqrt(w), 0.02 * f(w),
        f(w, w) / math.sqrt(w), 0.02 * f(w), f(w, w) / math.sqrt(w), 0.02 * f(w),
        1 + 0.1 * f(w), 0.1 * f(w),
        f(w, hidden) / math.sqrt(w), 0.02 * f(hidden),
        f(hidden, w) / math.sqrt(hidden), 0.02 * f(w),
    ]
    return fa.quantize_layer(*[p.to(device) for p in params])


@pytest.mark.parametrize("b,t,w,heads,causal", [
    (8, 50, 768, 12, False),   # ViT-B/32 vision layer
    (8, 77, 512, 8, True),     # text layer
    (3, 13, 128, 2, True),     # ragged token rows (M % 64 != 0)
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_matches_plain(cuda, b, t, w, heads, causal, dtype):
    rng = np.random.default_rng(9)
    wts = _layer_weights(rng, w, cuda)
    x = torch.from_numpy(rng.normal(size=(b, t, w)).astype(np.float32)).to(
        cuda, getattr(torch, dtype))
    before = fa.layer_block_int8.launches
    got = fa.layer_block_int8(x, wts, heads, causal)
    want = fa.layer_block_int8_reference(x, wts, heads, causal)
    torch.cuda.synchronize()
    assert fa.layer_block_int8.launches == before + 1
    # the limits chip_smoke.py applies (set from int8 rounding flips)
    r = fa.kernel_agreement(got, want, x)
    assert r["ok"], r


def test_kernel_rejects_unsupported_width(cuda):
    wts = _layer_weights(np.random.default_rng(1), 96, cuda)
    with pytest.raises(ValueError, match="divisible by 64"):
        fa.layer_block_int8(torch.zeros(2, 5, 96, device=cuda), wts, 3)


def test_serving_towers_cuda_vs_cpu(cuda):
    from image_retrieval_tpu_torch.config import Config, ModelConfig, serving_config
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder
    from image_retrieval_tpu_torch.models.tokenizer import get_tokenizer

    cfg = Config(model=serving_config(ModelConfig(
        image_size=64, patch_size=32, vision_width=128, vision_layers=2,
        vision_heads=2, text_width=64, text_layers=2, text_heads=1,
        vocab_size=get_tokenizer().vocab_size, context_length=16, embed_dim=32,
        dtype="bfloat16")))
    gpu_enc = CLIPEncoder(cfg, seed=4, device=cuda)
    cpu_enc = CLIPEncoder(cfg, seed=4, device="cpu")
    px = np.random.default_rng(2).integers(0, 256, size=(5, 64, 64, 3), dtype=np.uint8)
    texts = ["a red car", "two dogs", "an empty street at night"]
    before = fa.layer_block_int8.launches
    got_i, got_t = gpu_enc.encode_pixels(px), gpu_enc.encode_texts(texts)
    assert fa.layer_block_int8.launches == before + 4  # 2 + 2 layers, one batch each
    for got, want in ((got_i, cpu_enc.encode_pixels(px)), (got_t, cpu_enc.encode_texts(texts))):
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.999


def test_index_cuda_matches_cpu(cuda):
    from image_retrieval_tpu_torch.config import IndexConfig
    from image_retrieval_tpu_torch.index import ShardedVectorIndex

    rng = np.random.default_rng(3)
    emb = rng.normal(size=(5000, 64)).astype(np.float32)
    emb[100] = emb[7]  # a tie
    q = np.concatenate([emb[7:8], rng.normal(size=(9, 64)).astype(np.float32)])
    out = []
    for dev in (cuda, "cpu"):
        ix = ShardedVectorIndex(dim=64, config=IndexConfig(embedding_dim=64), device=dev)
        ix.insert([str(i) for i in range(len(emb))], emb)
        ix.delete_rows([3, 4])
        out.append(ix.search(q, top_k=20))
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=0, atol=1e-5)
    assert list(out[0][1][0, :2]) == [7, 100]
