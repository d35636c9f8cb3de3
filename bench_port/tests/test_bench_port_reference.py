"""The reference against the program's CPU path at tiny sizes: the towers
(the program's plain versions on the CPU), the index's int8 rows, and the
sweeps of each tier."""

import numpy as np
import pytest
import torch

from bench_port import compare, harness, inputs
from bench_port.reference.search import Scorer, quantize_rows, reference_topk
from conftest import TINY_MODEL, tiny_config

W_REF = (1.0, 1.0, 1.0, 0.0, 0.5)


def _encoder(cfg, seed):
    from image_retrieval_tpu_torch.config import Config
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    weights = inputs.make_weights(cfg["model"], seed, "cpu")
    enc = CLIPEncoder(Config(model=harness.model_config(cfg["model"])), params=weights,
                      device="cpu")
    return enc, weights


@pytest.mark.parametrize("name", ["clip-vit-b32-serving", "clip-vit-l14-serving"])
def test_towers_agree_with_the_programs_cpu_path(name):
    cfg = tiny_config(name)
    enc, weights = _encoder(cfg, 21)
    tr = harness.data("traffic", "search-cosine-64x1")
    texts = [inputs.QueryTexts(tr["texts"], 21)(g) for g in range(40)]
    got = enc.encode_texts(texts)
    want = compare.text_embeddings(cfg["model"], weights, texts, "cpu")
    assert compare.rel_err(got, want).max() < 1e-5
    pixels = inputs.make_pixels(1, 12, TINY_MODEL["image_size"], 21, "cpu")[0]
    got = enc.encode_pixels(pixels)
    want = compare.image_embeddings(cfg["model"], weights, pixels, "cpu")
    assert compare.rel_err(got, want).max() < 1e-5


def test_int8_rows_are_the_indexs_bit_for_bit():
    from image_retrieval_tpu_torch.index.vector_index import quantize_int8

    rows, _ = inputs.make_gallery(5000, 768, 3, "cpu", 2048, (1.0, 2.0))
    q8, sc = quantize_int8(rows)
    g, s = quantize_rows(torch.from_numpy(rows))
    assert np.array_equal(g.numpy().astype(np.int8), q8)
    assert np.allclose(s.numpy(), sc, rtol=3e-7, atol=0)


@pytest.mark.parametrize("tier,metric,weights", [
    ("float32", "cosine_similarity", None),
    ("int8", "cosine_similarity", None),
    ("int8", "optimized_similarity", W_REF)])
def test_sweeps_agree_with_the_index(tier, metric, weights):
    from image_retrieval_tpu_torch.config import IndexConfig
    from image_retrieval_tpu_torch.index import ShardedVectorIndex

    n, d, k = 6000, 64, 10
    rows, mags = inputs.make_gallery(n, d, 5, "cpu", 4096, (4.0, 12.0))
    ix = ShardedVectorIndex(dim=d, config=IndexConfig(embedding_dim=d, dtype=tier),
                            device="cpu")
    ix.insert([inputs.row_path(i) for i in range(n)], rows, magnitudes=mags)
    emb = np.random.default_rng(5).standard_normal((6, d)).astype(np.float32) * 3
    params = dict(zip(("w_angle", "w_l1", "w_l2", "w_inf", "w_mag"), weights)) if weights else None
    q_in = emb if weights else emb / np.linalg.norm(emb, axis=1, keepdims=True)
    vals, idx = ix.search(q_in, top_k=k, metric=metric, params=params)
    scorer = Scorer(tier, metric, weights)
    ref_v, ref_i = reference_topk(scorer, torch.from_numpy(emb), rows, mags, k, "cpu")
    assert np.array_equal(idx, ref_i)
    assert np.abs(vals - ref_v).max() < 1e-5 * max(1.0, np.abs(ref_v).max())
    answers = [[{"path": inputs.row_path(int(i)), "score": float(v)} for v, i in zip(vr, ir)]
               for vr, ir in zip(vals, idx)]
    serr, gap = compare.answer_numbers(scorer, emb, answers, rows, mags, k, "cpu")
    assert serr < 1e-5 and gap <= 1e-6
