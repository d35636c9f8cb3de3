"""The port's text->image serving slice end to end against the JAX package's:
CLIPEncoder (small serving config, the same weights through
params_from_jax) + ShardedVectorIndex + SearchServer, fed the same pixels
and texts. Also the ingest and searcher facades over FakeEncoder, which
must be bit-identical between the packages."""

import threading

import jax
import numpy as np
import pytest

from image_retrieval_tpu.app.server import SearchServer as JaxServer
from image_retrieval_tpu.config import Config, IndexConfig, ModelConfig, serving_config
from image_retrieval_tpu.index.vector_index import ShardedVectorIndex as JaxIndex
from image_retrieval_tpu.models.clip import init_params as jax_init_params
from image_retrieval_tpu.models.encoder import CLIPEncoder as JaxEncoder
from image_retrieval_tpu.models.encoder import FakeEncoder as JaxFake
from image_retrieval_tpu_torch.app.server import SearchServer
from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.models.encoder import CLIPEncoder, FakeEncoder
from image_retrieval_tpu_torch.models.tokenizer import get_tokenizer
from image_retrieval_tpu_torch.models.weights import params_from_jax

QUERIES = ["a red car", "a blue boat", "a small dog", "an old house"]
TOP_K = 5


@pytest.fixture(scope="module")
def stacks():
    vocab = get_tokenizer().vocab_size  # the fixture vocab's ids must embed
    model = serving_config(ModelConfig(
        image_size=32, patch_size=8, vision_width=48, vision_layers=2,
        vision_heads=4, text_width=32, text_layers=2, text_heads=2,
        vocab_size=vocab, context_length=77, embed_dim=24, dtype="float32"))
    cfg = Config(model=model, index=IndexConfig(embedding_dim=24, capacity_step=64))
    _, params = jax_init_params(model, seed=0)
    params = jax.tree.map(np.asarray, params)
    jax_enc = JaxEncoder(cfg, params=params)
    enc = CLIPEncoder(cfg, params=params_from_jax(params, model), device="cpu")
    return cfg, jax_enc, enc


def _row_cos(a, b):
    a, b = a.astype(np.float64), b.astype(np.float64)
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def _gallery(text_emb, rng):
    """Rows whose cosine to each query is set by construction, so the top
    scores are separated far beyond the embedding tolerance: the query's
    own direction (cos 1), then decoys at cos 0.95 / 0.85 / 0.7 / 0.5. Row 3
    is duplicated at the end, so query 0's top two are an exact tie."""
    unit = text_emb / np.linalg.norm(text_emb, axis=1, keepdims=True)
    rows, paths = [], []
    for i, u in enumerate(unit):
        rows.append(u)
        paths.append(f"own/{i}")
        for c in (0.95, 0.85, 0.7, 0.5):
            n = rng.normal(size=u.shape)
            n -= (n @ u) * u
            n /= np.linalg.norm(n)
            rows.append(c * u + np.sqrt(1 - c * c) * n)
            paths.append(f"decoy/{i}/{c}")
    rows.append(unit[0])
    paths.append("dup/0")
    return np.asarray(rows, np.float32), paths


def _serve(server_cls, enc, index):
    server = server_cls(enc, index, max_batch=8, max_wait_ms=20.0)
    out = [None] * len(QUERIES)

    def client(i):
        out[i] = server.search(QUERIES[i], top_k=TOP_K, timeout=120)

    server.start()
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(QUERIES))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.stop()
    return out


def test_slice_matches_jax(stacks):
    cfg, jax_enc, enc = stacks
    rng = np.random.default_rng(0)
    pixels = rng.integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8)
    img_j, img_t = jax_enc.encode_pixels(pixels), enc.encode_pixels(pixels)
    assert img_t.shape == (6, 24) and img_t.dtype == np.float32
    assert _row_cos(img_t, img_j).min() >= 0.9999  # int8 flips only (test_torch_clip)
    txt_j, txt_t = jax_enc.encode_texts(QUERIES), enc.encode_texts(QUERIES)
    assert _row_cos(txt_t, txt_j).min() >= 0.9999
    rows, paths = _gallery(txt_t, rng)

    def build(index):
        index.insert([f"img/{i}.png" for i in range(6)], img_t)
        index.insert(paths, rows)
        return index

    got = _serve(SearchServer, enc,
                 build(ShardedVectorIndex(dim=24, config=cfg.index, device="cpu")))
    want = _serve(JaxServer, jax_enc, build(JaxIndex(dim=24, config=cfg.index)))
    for q, g, w in zip(QUERIES, got, want):
        assert [h["path"] for h in g] == [h["path"] for h in w], q
        np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in w],
                                   rtol=0, atol=1e-4)
    # the duplicate row ties query 0's own row: the lower row index first
    assert [h["path"] for h in got[0][:2]] == ["own/0", "dup/0"]
    assert got[0][0]["score"] == got[0][1]["score"]


def test_fake_encoder_bit_identical():
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, size=(3, 40, 48, 3), dtype=np.uint8)
    f32 = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    texts = ["a red car", "Red CAR  parked", ""]
    for dim in (24, 512):
        mine, ref = FakeEncoder(dim=dim), JaxFake(dim=dim)
        for px in (u8, f32):
            np.testing.assert_array_equal(mine.encode_pixels(px), ref.encode_pixels(px))
        np.testing.assert_array_equal(mine.encode_texts(texts), ref.encode_texts(texts))


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(2)
    paths = []
    for i in range(7):
        p = d / f"{i}.png"
        Image.fromarray(rng.integers(0, 256, size=(40 + i, 36, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    (d / "broken.png").write_bytes(b"not an image")
    return paths + [str(d / "broken.png")]


def test_ingest_and_searcher_match_jax(image_dir):
    from image_retrieval_tpu.app.embed import ImageEmbeddingSystem as JaxEmbed
    from image_retrieval_tpu.app.search import TextImageSearcher as JaxSearcher
    from image_retrieval_tpu_torch.app.embed import ImageEmbeddingSystem
    from image_retrieval_tpu_torch.app.search import TextImageSearcher

    cfg = Config(index=IndexConfig(capacity_step=64))
    mine = ImageEmbeddingSystem(FakeEncoder(), config=cfg, device="cpu")
    ref = JaxEmbed(JaxFake(), config=cfg)
    assert mine.process_and_store_images(image_dir, batch_size=3) == (7, 1)
    assert ref.process_and_store_images(image_dir, batch_size=3) == (7, 1)
    assert mine.index.paths == ref.index.paths
    for (p1, e1, m1), (p2, e2, m2) in zip(mine.get_embeddings_with_magnitude(),
                                          ref.get_embeddings_with_magnitude()):
        assert p1 == p2 and m1 == pytest.approx(m2, rel=1e-6)
        np.testing.assert_allclose(e1, e2, atol=1e-6)
    s_mine = TextImageSearcher(mine.encoder, mine.index)
    s_ref = JaxSearcher(ref.encoder, ref.index)
    for opt in (False, True):
        got = s_mine.search("a red car", top_k=3, score_threshold=-1.0,
                            use_optimized_similarity=opt)
        want = s_ref.search("a red car", top_k=3, score_threshold=-1.0,
                            use_optimized_similarity=opt)
        assert [h["path"] for h in got] == [h["path"] for h in want]
        np.testing.assert_allclose([h["score"] for h in got],
                                   [h["score"] for h in want], atol=1e-5)
    got = s_mine.search_batch(["a red car", "blue sky"], top_k=4)
    want = s_ref.search_batch(["a red car", "blue sky"], top_k=4)
    assert [[h["path"] for h in r] for r in got] == [[h["path"] for h in r] for r in want]
    with pytest.raises(ValueError, match="empty"):
        s_mine.search("   ")
