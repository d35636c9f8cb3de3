"""The inputs a run makes from its seed: the same seed gives the same inputs,
another seed others; the query texts are distinct short sentences."""

import numpy as np
import torch

from bench_port import harness, inputs
from conftest import TINY_MODEL, tiny_config


def test_derive_is_fixed_and_takes_any_whole_number():
    big = 2 ** 31 + 12345
    assert inputs.derive(big, "weights") == inputs.derive(big, "weights")
    assert inputs.derive(big, "weights") != inputs.derive(big + 1, "weights")
    assert inputs.derive(big, "weights") != inputs.derive(big, "gallery")
    for s in (0, -7, 2 ** 70):
        assert 0 <= inputs.derive(s, "x") < 2 ** 63


def test_query_texts_are_deterministic_distinct_and_5_to_12_words():
    tr = harness.data("traffic", "search-cosine-64x1")
    a, b = inputs.QueryTexts(tr["texts"], 4_000_000_123), inputs.QueryTexts(tr["texts"], 4_000_000_123)
    other = inputs.QueryTexts(tr["texts"], 4_000_000_124)
    ids = range(0, 20000)
    got = [a(g) for g in ids]
    assert got == [b(g) for g in ids]
    assert got != [other(g) for g in ids]
    assert len(set(got)) == len(got)
    lengths = {len(s.split()) for s in got}
    assert min(lengths) >= 5 and max(lengths) <= 12
    words = [w for s in got for w in s.split()]
    assert len(set(words)) < len(words) / 100  # words repeat; sentences do not


def test_the_whole_sentence_space_is_a_bijection():
    tr = harness.data("traffic", "search-mixed-64x1")
    t = inputs.QueryTexts(tr["texts"], 5)
    assert len(t) == 552_960
    sample = [t(g) for g in range(0, len(t), 7)]
    assert len(set(sample)) == len(sample)


def test_weights_gallery_and_pixels_follow_the_seed():
    w1 = inputs.make_weights(TINY_MODEL | {"vocab_size": 700}, 11, "cpu")
    w2 = inputs.make_weights(TINY_MODEL | {"vocab_size": 700}, 11, "cpu")
    w3 = inputs.make_weights(TINY_MODEL | {"vocab_size": 700}, 12, "cpu")
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert not torch.equal(w1["text.proj"], w3["text.proj"])
    r1, m1 = inputs.make_gallery(3000, 32, 11, "cpu", 1024, (1.0, 2.0))
    r2, m2 = inputs.make_gallery(3000, 32, 11, "cpu", 1024, (1.0, 2.0))
    assert np.array_equal(r1, r2) and np.array_equal(m1, m2)
    assert np.allclose(np.linalg.norm(r1, axis=1), 1.0, atol=1e-6)
    assert m1.min() >= 1.0 and m1.max() <= 2.0
    p1 = inputs.make_pixels(2, 3, 16, 11, "cpu")
    assert p1.dtype == np.uint8 and np.array_equal(p1, inputs.make_pixels(2, 3, 16, 11, "cpu"))


def test_weight_names_and_shapes_are_the_programs():
    from image_retrieval_tpu_torch.models.clip import CLIP

    for name in ("clip-vit-b32-serving", "clip-vit-l14-serving"):
        cfg = harness.data("configs", name)
        with torch.device("meta"):
            model = CLIP(harness.model_config(cfg["model"]))
        want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
        got = {n: tuple(s) for n, s, _, _ in inputs.weight_specs(cfg["model"])}
        assert got == want


def test_paths_map_back_to_rows():
    assert inputs.path_row(inputs.row_path(4_194_303)) == 4_194_303
    assert inputs.path_row("g/x.jpg") == -1 and inputs.path_row("other/3.jpg") == -1


def test_tiny_config_keeps_the_cells_tier():
    assert tiny_config("clip-vit-l14-serving")["index"]["dtype"] == "int8"
