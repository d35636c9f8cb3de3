"""The port's streamed beyond-HBM tier (index/streaming.py and the index's
streamed branch) held against the JAX engine and index on the same numpy
rows, against a float64 oracle, and against the port's resident int8 tier.

Scores within 1e-6; ids equal except among scores within 1e-6 of their
neighbours (ties the two packages may order differently). On the CPU the
engine sweeps host chunks in place; tests/test_torch_gpu.py holds the card's
double buffer and K3 on packed chunks.
"""

import numpy as np
import pytest

from image_retrieval_tpu.config import IndexConfig
from image_retrieval_tpu.index.streaming import StreamingGallerySearch as JaxEngine
from image_retrieval_tpu.index.streaming import quantize_rows_int8 as jax_quantize
from image_retrieval_tpu.index.vector_index import ShardedVectorIndex as JaxIndex
from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.index.streaming import (
    StreamingGallerySearch,
    quantize_rows_int8,
)
from image_retrieval_tpu_torch.ops.int4 import quantize_pack_int4

ATOL = 1e-6


@pytest.fixture(scope="module")
def gallery():
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(5000, 64)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def _unit(rng, n, d=64):
    q = rng.normal(size=(n, d)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def assert_same_topk(got_v, got_i, want_v, want_i, atol=ATOL):
    """Scores within atol; ids equal wherever the wanted score at a rank is
    more than atol from its neighbours' (a tie may be ordered either way)."""
    got_v, got_i = np.atleast_2d(got_v), np.atleast_2d(got_i)
    want_v, want_i = np.atleast_2d(np.asarray(want_v)), np.atleast_2d(np.asarray(want_i))
    assert got_v.shape == want_v.shape and got_i.shape == want_i.shape
    fin = np.isfinite(want_v)
    np.testing.assert_array_equal(np.isfinite(got_v), fin)
    np.testing.assert_allclose(got_v[fin], want_v[fin], rtol=0, atol=atol)
    np.testing.assert_array_equal(got_i[~fin], want_i[~fin])
    for r, c in zip(*np.nonzero(got_i != want_i)):
        gaps = [abs(want_v[r, c] - want_v[r, o]) for o in (c - 1, c + 1)
                if 0 <= o < want_v.shape[1]]
        assert min(gaps) <= atol, (r, c, got_i[r], want_i[r])


def _oracle(q8, scales, queries, k):
    """float64 cosine of the bf16-rounded queries over the int8 rows."""
    import torch

    qb = torch.from_numpy(queries).to(torch.bfloat16).double().numpy()
    s = qb @ (q8.astype(np.float64) * scales[:, None].astype(np.float64)).T
    idx = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, idx, axis=1), idx


def test_quantize_rows_int8_bitwise_equal_jax(gallery):
    q8, sc = quantize_rows_int8(gallery[:300] * 3.0)
    jq8, jsc = jax_quantize(gallery[:300] * 3.0)
    np.testing.assert_array_equal(q8, jq8)
    np.testing.assert_array_equal(sc.view(np.uint32), jsc.view(np.uint32))


@pytest.mark.parametrize("chunk", [5000, 1250, 999, 4096, 8192])
def test_streamed_matches_jax_and_oracle_across_chunk_sizes(gallery, chunk):
    """One chunk, an even split, a ragged tail, and a chunk larger than N."""
    q = _unit(np.random.default_rng(1), 7)
    q8, sc = quantize_rows_int8(gallery)
    eng = StreamingGallerySearch(q8, sc, chunk_rows=chunk, device="cpu")
    vals, idx = eng.search(q, top_k=10)
    assert vals.shape == idx.shape == (7, 10) and idx.dtype == np.int32
    assert_same_topk(vals, idx, *JaxEngine(q8, sc, chunk_rows=chunk).search(q, top_k=10))
    assert_same_topk(vals, idx, *_oracle(q8, sc, q, 10))


def test_padded_rows_never_surface(gallery):
    """chunk_rows > N: one short chunk; nothing past row N ever appears."""
    q8, sc = quantize_rows_int8(gallery[:100])
    eng = StreamingGallerySearch(q8, sc, chunk_rows=4096, device="cpu")
    vals, idx = eng.search(-gallery[:3], top_k=50)  # every cosine negative
    assert (idx >= 0).all() and (idx < 100).all() and np.isfinite(vals).all()
    assert_same_topk(vals, idx, *JaxEngine(q8, sc, chunk_rows=4096).search(-gallery[:3],
                                                                           top_k=50))


def test_top_k_larger_than_a_chunk_and_capped_at_n():
    rng = np.random.default_rng(2)
    rows = rng.normal(size=(8, 32)).astype(np.float32)
    q8, sc = quantize_rows_int8(rows)
    q = rows[:2] / np.linalg.norm(rows[:2], axis=1, keepdims=True)
    vals, idx = StreamingGallerySearch(q8, sc, chunk_rows=3, device="cpu").search(q, top_k=20)
    assert vals.shape == (2, 8) and sorted(idx[0].tolist()) == list(range(8))
    assert_same_topk(vals, idx, *JaxEngine(q8, sc, chunk_rows=3).search(q, top_k=20))


def test_single_query_vector_accepted(gallery):
    q8, sc = quantize_rows_int8(gallery)
    v1, i1 = StreamingGallerySearch(q8, sc, chunk_rows=2000, device="cpu").search(
        gallery[0], top_k=5)
    assert v1.shape == (1, 5) and i1[0, 0] == 0
    assert_same_topk(v1, i1, *JaxEngine(q8, sc, chunk_rows=2000).search(gallery[0], top_k=5))


def test_ties_go_to_the_lower_row_across_chunks():
    """Duplicate rows in different chunks: equal scores rank by row."""
    rng = np.random.default_rng(5)
    rows = _unit(rng, 40, 32)
    rows = np.concatenate([rows, rows, rows])  # row r, r + 40, r + 80 equal
    q8, sc = quantize_rows_int8(rows)
    vals, idx = StreamingGallerySearch(q8, sc, chunk_rows=7, device="cpu").search(
        rows[[3, 17]], top_k=6)
    assert list(idx[0, :3]) == [3, 43, 83] and list(idx[1, :3]) == [17, 57, 97]
    np.testing.assert_array_equal(idx, JaxEngine(q8, sc, chunk_rows=7).search(
        rows[[3, 17]], top_k=6)[1])


@pytest.mark.parametrize("chunk", [5000, 777])
def test_filter_mask_matches_jax(gallery, chunk):
    rng = np.random.default_rng(6)
    q8, sc = quantize_rows_int8(gallery)
    q = _unit(rng, 4)
    for mask in (rng.random(5000) < 0.3, np.isin(np.arange(5000), [10, 2000, 4999])):
        got = StreamingGallerySearch(q8, sc, chunk_rows=chunk, device="cpu").search(
            q, top_k=10, mask=mask)
        want = JaxEngine(q8, sc, chunk_rows=chunk).search(q, top_k=10, mask=mask)
        assert_same_topk(*got, *want)
        assert mask[got[1][got[1] >= 0]].all()
    # three matching rows: the tail pads with (-inf, -1)
    assert (got[1][:, 3:] == -1).all() and np.isneginf(got[0][:, 3:]).all()
    assert sorted(got[1][0, :3].tolist()) == [10, 2000, 4999]


@pytest.mark.parametrize("rerank", ["none", "array", "memmap"])
def test_packed4_matches_jax(gallery, rerank, tmp_path):
    """int4 chunks: the raw screen, and the exact rerank from int8 rows held
    in an array or an np.memmap."""
    rng = np.random.default_rng(7)
    pk, sc4 = quantize_pack_int4(gallery)
    q8, sc8 = quantize_rows_int8(gallery)
    kw = {}
    if rerank != "none":
        rows = q8
        if rerank == "memmap":
            rows = np.memmap(tmp_path / "rows.i8", np.int8, "w+", shape=q8.shape)
            rows[:] = q8
            rows.flush()
            rows = np.memmap(tmp_path / "rows.i8", np.int8, "r", shape=q8.shape)
        kw = dict(rerank_rows=rows, rerank_scales=sc8, rerank_c=64)
    q = np.concatenate([gallery[[11, 4321]], _unit(rng, 3)])
    mask = rng.random(5000) < 0.5
    for m in (None, mask):
        got = StreamingGallerySearch(pk, sc4, chunk_rows=1500, device="cpu", packed4=True,
                                     **kw).search(q, top_k=10, mask=m)
        want = JaxEngine(pk, sc4, chunk_rows=1500, packed4=True, **kw).search(q, top_k=10,
                                                                               mask=m)
        assert_same_topk(*got, *want)
        if m is not None:
            assert m[got[1][got[1] >= 0]].all()
    if rerank != "none":  # exact int8 scores after the rerank: the oracle's
        got = StreamingGallerySearch(pk, sc4, chunk_rows=1500, device="cpu", packed4=True,
                                     **kw).search(q, top_k=10)
        ov, oi = _oracle(q8, sc8, q, 10)
        np.testing.assert_allclose(got[0], ov, rtol=0, atol=ATOL)
        assert got[1][0, 0] == 11 and got[1][1, 0] == 4321


def test_sweep_model_matches_jax(gallery):
    q8, sc = quantize_rows_int8(gallery)
    pk, sc4 = quantize_pack_int4(gallery)
    for args, kw in (((q8, sc), {}), ((pk, sc4), {"packed4": True})):
        mine = StreamingGallerySearch(*args, chunk_rows=999, device="cpu", **kw)
        ref = JaxEngine(*args, chunk_rows=999, **kw)
        assert mine.bytes_per_sweep == ref.bytes_per_sweep
        assert mine.expected_sweep_seconds(12.5, 3e-3) == pytest.approx(
            ref.expected_sweep_seconds(12.5, 3e-3), rel=1e-12)
        assert mine.expected_sweep_seconds(1000.0, 3e-3) == pytest.approx(6 * 3e-3)


def test_engine_rejects_bad_operands(gallery):
    q8, sc = quantize_rows_int8(gallery[:10])
    with pytest.raises(ValueError, match="int8"):
        StreamingGallerySearch(q8.astype(np.uint8), sc, device="cpu")
    with pytest.raises(ValueError, match="scales"):
        StreamingGallerySearch(q8, sc[:5], device="cpu")
    with pytest.raises(ValueError, match="mask"):
        StreamingGallerySearch(q8, sc, device="cpu").search(gallery[0], mask=np.ones(3, bool))


# -- the index's streamed tier -------------------------------------------------


def _pair(rows, dtype="int8", n_paths=None, **cfg):
    """The port's and the JAX package's index over the same rows."""
    config = IndexConfig(embedding_dim=rows.shape[1], capacity_step=1024, dtype=dtype, **cfg)
    out = []
    for ix in (ShardedVectorIndex(dim=rows.shape[1], config=config, device="cpu"),
               JaxIndex(dim=rows.shape[1], config=config)):
        ix.insert([f"p{i}" for i in range(len(rows))], rows,
                  attrs={"bucket": np.arange(len(rows)) % 4})
        out.append(ix)
    return out


def test_index_streamed_tier_matches_resident_and_jax(gallery):
    """Past stream_threshold_bytes the index streams: the same answers as
    the resident int8 tier over the same rows, and as the JAX index."""
    q = np.random.default_rng(3).normal(size=(5, 64)).astype(np.float32)
    resident = ShardedVectorIndex(dim=64, config=IndexConfig(capacity_step=1024,
                                                             dtype="int8"), device="cpu")
    resident.insert([f"p{i}" for i in range(len(gallery))], gallery)
    mine, ref = _pair(gallery, stream_threshold_bytes=1)
    got = mine.search(q, top_k=5)
    assert mine._stream is not None and mine._gallery is None  # the tier engaged
    assert_same_topk(*got, *resident.search(q, top_k=5))
    assert_same_topk(*got, *ref.search(q, top_k=5))
    v1, i1 = mine.search(q[0], top_k=5)  # 1-D in, 1-D out
    assert v1.shape == i1.shape == (5,) and i1.dtype == np.int32
    # a filter rides the engine's mask
    got = mine.search(q, top_k=8, flt="bucket == 2")
    assert_same_topk(*got, *ref.search(q, top_k=8, flt="bucket == 2"))
    assert (got[1] % 4 == 2).all()


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_index_streamed_tier_respects_tombstones(gallery, dtype):
    mine, ref = _pair(gallery, dtype, stream_threshold_bytes=1, rerank_c=64)
    target = gallery[7] * 3.0
    assert int(mine.search(target, top_k=3)[1][0]) == 7
    for ix in (mine, ref):
        ix.delete(["p7", "p8"])
        ix.delete_rows(np.arange(100, 4000, 3))
    got = mine.search(target, top_k=3)
    # the engine keeps every row and masks the tombstones: no copy of the rows
    assert 7 not in got[1].tolist() and mine._stream.n == len(gallery)
    assert_same_topk(*got, *ref.search(target, top_k=3))
    q = np.concatenate([gallery[[9, 100, 101]], -gallery[[5]]])
    for flt in (None, "bucket == 1"):
        got = mine.search(q, top_k=10, flt=flt)
        assert not np.isin(got[1], [7, 8] + list(range(100, 4000, 3))).any()
        assert_same_topk(*got, *ref.search(q, top_k=10, flt=flt))


def test_index_streamed_int4_tier_matches_jax(gallery):
    """The int4 tier streamed: packed chunks screened, the exact rerank from
    the host int8 rows; and its threshold counts the packed bytes."""
    mine, ref = _pair(gallery, "int4", stream_threshold_bytes=5000 * 32 - 1, rerank_c=64)
    q = np.concatenate([gallery[[1, 2]], np.random.default_rng(9).normal(
        size=(3, 64)).astype(np.float32)])
    for flt in (None, "bucket == 0"):
        got = mine.search(q, top_k=10, flt=flt)
        assert mine._stream is not None and mine._stream.packed4
        assert_same_topk(*got, *ref.search(q, top_k=10, flt=flt))
    below, _ = _pair(gallery, "int4", stream_threshold_bytes=5000 * 32, rerank_c=64)
    below.search(q, top_k=1)
    assert below._stream is None and below._packed is not None  # resident int4


def test_index_streams_in_chunk_rows_chunks(gallery, monkeypatch):
    """The index builds its engine with streaming.CHUNK_ROWS rows a chunk."""
    from image_retrieval_tpu_torch.index import streaming

    monkeypatch.setattr(streaming, "CHUNK_ROWS", 1200)
    mine, ref = _pair(gallery, stream_threshold_bytes=1)
    q = gallery[[0, 4999]] * 2.0
    got = mine.search(q, top_k=6)
    assert [nv for _, nv in mine._stream._chunks] == [1200] * 4 + [200]
    assert_same_topk(*got, *ref.search(q, top_k=6))


def test_index_streamed_tier_guards_unsupported(gallery):
    mine, _ = _pair(gallery, stream_threshold_bytes=1)
    q = gallery[0]
    with pytest.raises(ValueError, match="streamed"):
        mine.search(q, top_k=3, metric="l2_distance")
    with pytest.raises(ValueError, match="streamed"):
        mine.search(q, top_k=3, metric="optimized_similarity", params={"w_l1": 1.0})
    with pytest.raises(ValueError, match="streamed"):
        mine.multi_metric_topk(q, top_k=3)
    with pytest.raises(ValueError, match="streamed"):
        mine.scores(q)
    # the streamed tier ignores approx, as the JAX index does
    assert_same_topk(*mine.search(q, top_k=4, approx=True), *mine.search(q, top_k=4))
    # f32 past the threshold is a configuration error, told loudly
    for cls, kw in ((ShardedVectorIndex, {"device": "cpu"}), (JaxIndex, {})):
        f32 = cls(dim=64, config=IndexConfig(capacity_step=1024, stream_threshold_bytes=1),
                  **kw)
        f32.insert(["a"], gallery[:1])
        with pytest.raises(ValueError, match="int8"):
            f32.search(gallery[0], top_k=1)


def test_index_streamed_tier_disengages_after_compact(gallery):
    """Deletes and a compact that bring the rows under the threshold return
    the index to the resident tier."""
    mine, ref = _pair(gallery[:64], stream_threshold_bytes=2048)  # 4096 B > 2048
    mine.search(gallery[0], top_k=1)
    assert mine._stream is not None
    for ix in (mine, ref):
        ix.delete([f"p{i}" for i in range(48)])
        assert ix.compact() == 48  # 16 rows = 1024 B
    vals, ids = mine.search(gallery[50] * 2.0, top_k=1)
    assert mine._stream is None and mine._gallery is not None
    assert mine.paths[int(ids[0])] == "p50"
    assert_same_topk(*mine.search(gallery[40:60], top_k=5), *ref.search(gallery[40:60],
                                                                          top_k=5))
