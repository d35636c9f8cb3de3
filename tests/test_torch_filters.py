"""Attribute filters in the port: the copy of index/filters.py pinned to the
JAX module, filter masks and filtered searches held against the JAX index,
and the searcher's handling of the (-inf, -1) padding of a filtered search."""

import ast
import pathlib

import numpy as np
import pytest
import torch

from image_retrieval_tpu.app.search import TextImageSearcher as JaxSearcher
from image_retrieval_tpu.config import IndexConfig
from image_retrieval_tpu.index import filters as jfilters
from image_retrieval_tpu.index.vector_index import ShardedVectorIndex as JaxIndex
from image_retrieval_tpu.models.encoder import FakeEncoder as JaxFake
from image_retrieval_tpu_torch.app.search import TextImageSearcher
from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.index import filters
from image_retrieval_tpu_torch.models.encoder import FakeEncoder

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _body(path):
    """The module's code without its docstring, as an AST dump."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    return [ast.dump(node) for node in tree.body[1:]]


def test_filters_copy_is_the_jax_module():
    assert (_body(ROOT / "image_retrieval_tpu_torch/index/filters.py")
            == _body(ROOT / "image_retrieval_tpu/index/filters.py"))


ATTRS = {
    "color": ["red", "blue", "green", "red", "blue"] * 8,
    "views": list(range(0, 400, 10)),
    "score": np.linspace(-1, 1, 40),
    "flag": [True, False] * 20,
}
EXPRS = [
    "color == 'red'",
    "color != 'red' and views >= 100",
    "color in ['blue', 'green'] or score < -0.5",
    "not (views < 50 || flag == true)",
    "color not in ['red'] && score >= 0.25",
    "missing_field == 3",
]


@pytest.mark.parametrize("expr", EXPRS)
def test_filter_masks_equal_jax(expr):
    mine, ref = filters.AttributeStore(), jfilters.AttributeStore()
    for store in (mine, ref):
        store.append({k: v[:25] for k, v in ATTRS.items()}, 25)
        store.append({"views": ATTRS["views"][25:]}, 15)  # fields absent in a batch
    if expr.startswith("missing"):
        with pytest.raises(filters.FilterError):
            mine.evaluate(filters.parse_filter(expr), 40)
        with pytest.raises(jfilters.FilterError):
            ref.evaluate(jfilters.parse_filter(expr), 40)
        return
    got = mine.evaluate(filters.parse_filter(expr), 40)
    want = ref.evaluate(jfilters.parse_filter(expr), 40)
    assert got.dtype == bool and got.shape == (40,)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_index_filter_mask_delete_where_and_search(dtype):
    rng = np.random.default_rng(2)
    emb = rng.normal(size=(40, 16)).astype(np.float32)
    cfg = IndexConfig(embedding_dim=16, dtype=dtype, capacity_step=32)
    mine, ref = ShardedVectorIndex(dim=16, config=cfg, device="cpu"), JaxIndex(dim=16, config=cfg)
    for ix in (mine, ref):
        ix.insert([f"p{i}" for i in range(40)], emb, attrs=ATTRS)
        ix.delete_rows([1, 2, 3])
    for expr in EXPRS[:5]:
        np.testing.assert_array_equal(mine.filter_mask(expr), ref.filter_mask(expr))
    assert mine.delete_where("views >= 300") == ref.delete_where("views >= 300") == 10
    np.testing.assert_array_equal(mine.live_mask(), ref.live_mask())
    q = rng.normal(size=(3, 16)).astype(np.float32)
    for expr in EXPRS[:5] + [np.arange(40) % 4 == 0]:
        got_v, got_i = mine.search(q, top_k=12, flt=expr)
        want_v, want_i = ref.search(q, top_k=12, flt=expr)
        np.testing.assert_array_equal(got_i, want_i)
        fin = np.isfinite(want_v)
        np.testing.assert_allclose(got_v[fin], want_v[fin], rtol=0, atol=1e-6)
        assert (got_i[~fin] == -1).all()
    with pytest.raises(ValueError, match="filter mask shape"):
        mine.search(q, flt=np.ones(39, bool))


def test_filter_mask_cache_follows_generation():
    ix = ShardedVectorIndex(dim=4, config=IndexConfig(embedding_dim=4), device="cpu")
    ix.insert(["a", "b", "c"], np.eye(3, 4, dtype=np.float32), attrs={"g": [1, 2, 1]})
    first = ix._filtered_valid("g == 1")
    assert ix._filtered_valid("g == 1") is first  # reused while nothing changes
    ix.delete(["a"])
    # the mask is the index's row shards (one shard on one device)
    assert torch.cat(ix._filtered_valid("g == 1")).tolist() == [False, False, True]
    _, i = ix.search(np.ones(4, np.float32), top_k=3, flt="g == 1")
    assert list(i) == [2, -1]


def _searchers(dtype):
    """Port and JAX searchers over FakeEncoder and the same 40-row gallery;
    the filter `keep == 1` matches 4 rows, fewer than 3 * top_k."""
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(40, 64)).astype(np.float32)
    paths = [f"img/{i:02d}.jpg" for i in range(40)]
    keep = np.zeros(40, int)
    keep[[3, 11, 17, 26]] = 1
    cfg = IndexConfig(embedding_dim=64, dtype=dtype, capacity_step=64)
    mine = ShardedVectorIndex(dim=64, config=cfg, device="cpu")
    ref = JaxIndex(dim=64, config=cfg)
    for ix in (mine, ref):
        ix.insert(paths, emb, attrs={"keep": keep})
    return (TextImageSearcher(FakeEncoder(dim=64), mine),
            JaxSearcher(JaxFake(dim=64), ref), {paths[i] for i in (3, 11, 17, 26)})


@pytest.mark.parametrize("dtype", ["float32", "int4"])
@pytest.mark.parametrize("optimized", [False, True])
def test_searcher_drops_filter_padding(dtype, optimized):
    """A filtered search that matches fewer rows than the overfetch pads
    with (-inf, -1). The searcher must drop the padding: fed through, id -1
    picks the gallery's LAST path (outside the filter) and, reranked, its
    vector. The port's answers are the JAX searcher's."""
    mine, ref, allowed = _searchers(dtype)
    kw = dict(top_k=5, score_threshold=float("-inf"), use_optimized_similarity=optimized,
              filter_expr="keep == 1")
    got = mine.search("a red car", **kw)
    want = ref.search("a red car", **kw)
    assert {h["path"] for h in got} == allowed  # not img/39.jpg
    assert [h["path"] for h in got] == [h["path"] for h in want]
    np.testing.assert_allclose([h["score"] for h in got], [h["score"] for h in want],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_facade_attrs_fn_reaches_filtered_search(tmp_path, dtype):
    """Both facades ingest the same images with the same attrs_fn: a gallery
    built through ImageEmbeddingSystem answers a search with filter_expr, and
    the port's paths and scores are the JAX package's."""
    from PIL import Image

    from image_retrieval_tpu.app.embed import ImageEmbeddingSystem as JaxSystem
    from image_retrieval_tpu.config import Config
    from image_retrieval_tpu_torch.app.embed import ImageEmbeddingSystem

    rng = np.random.default_rng(9)
    paths = []
    for i in range(12):
        p = tmp_path / f"img_{i:02d}.png"
        Image.fromarray(rng.integers(0, 256, size=(40, 40, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))
    paths.append(str(tmp_path / "missing.png"))  # fails to decode: no attribute row for it

    def attrs_fn(ok_paths):
        nums = [int(pathlib.Path(p).stem.split("_")[1]) for p in ok_paths]
        return {"num": nums, "parity": ["even" if n % 2 == 0 else "odd" for n in nums]}

    cfg = Config(index=IndexConfig(embedding_dim=64, dtype=dtype, capacity_step=64),
                 batch_size=5)
    mine = ImageEmbeddingSystem(FakeEncoder(dim=64), config=cfg, attrs_fn=attrs_fn,
                                device="cpu")
    ref = JaxSystem(JaxFake(dim=64), config=cfg, attrs_fn=attrs_fn)
    assert mine.process_and_store_images(paths) == ref.process_and_store_images(paths) == (12, 1)
    np.testing.assert_array_equal(mine.index.filter_mask("parity == 'even' and num >= 4"),
                                  ref.index.filter_mask("parity == 'even' and num >= 4"))
    kw = dict(top_k=5, score_threshold=float("-inf"),
              filter_expr="parity == 'even' and num >= 4")
    got = TextImageSearcher(FakeEncoder(dim=64), mine.index).search("a red car", **kw)
    want = JaxSearcher(JaxFake(dim=64), ref.index).search("a red car", **kw)
    assert {h["path"] for h in got} == {paths[i] for i in (4, 6, 8, 10)}
    assert [h["path"] for h in got] == [h["path"] for h in want]
    np.testing.assert_allclose([h["score"] for h in got], [h["score"] for h in want],
                               rtol=0, atol=1e-5)
    # without attrs_fn the facade inserts no attributes, as before
    bare = ImageEmbeddingSystem(FakeEncoder(dim=64), config=cfg, device="cpu")
    bare.process_and_store_images(paths[:3])
    with pytest.raises(filters.FilterError):
        bare.index.filter_mask("num >= 4")
