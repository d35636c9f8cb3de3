"""The port's projection screen (index/screen.py) and the `ann="screen"`
wiring of the searcher, server and app, held against the JAX package on
the same numpy rows and against the port's exact tiers.

The JAX screen runs over the tests' 8-device CPU mesh (a candidate pool per
shard), the port's on one device, and the two second moments sum in other
orders, which can rotate a projection whose eigenvalues nearly tie. So the
answers are held equal where the pool covers every row, by recall where it
does not; `_fit_projection` is held bit for bit on the same second moment.
"""

import numpy as np
import pytest
import torch

from image_retrieval_tpu.config import IndexConfig
from image_retrieval_tpu.index import screen as jscreen
from image_retrieval_tpu.index.vector_index import ShardedVectorIndex as JaxIndex
from image_retrieval_tpu_torch.config import Config
from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.index import screen as scr_mod
from image_retrieval_tpu_torch.index.screen import ScreenedSearch
from image_retrieval_tpu_torch.models.encoder import FakeEncoder

ATOL = 1e-6


def clustered_rows(rng, n=512, dim=64, ncenters=16, noise=0.25):
    """Unit rows around unit centers: the clustered regime of CLIP corpora."""
    centers = rng.normal(size=(ncenters, dim))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, ncenters, size=n)
    rows = centers[assign] + noise * rng.normal(size=(n, dim)) / np.sqrt(dim)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    return rows.astype(np.float32)


def build(rows, dtype="int8", jax=False, **cfg):
    config = IndexConfig(embedding_dim=rows.shape[1], dtype=dtype, capacity_step=64, **cfg)
    idx = (JaxIndex(dim=rows.shape[1], config=config) if jax
           else ShardedVectorIndex(dim=rows.shape[1], config=config, device="cpu"))
    idx.insert([f"img_{i}.jpg" for i in range(len(rows))], rows,
               attrs={"x": np.arange(len(rows)) % 2})
    return idx


def recall(got, want, k=10):
    return np.mean([len(set(a[:k].tolist()) & set(b[:k].tolist())) / k
                    for a, b in zip(got, want)])


def assert_same_topk(got_v, got_i, want_v, want_i, atol=ATOL):
    """Scores within atol; ids equal except where neighbouring wanted scores
    are within atol (a tie)."""
    got_v, got_i = np.atleast_2d(got_v), np.atleast_2d(got_i)
    want_v, want_i = np.atleast_2d(np.asarray(want_v)), np.atleast_2d(np.asarray(want_i))
    fin = np.isfinite(want_v)
    np.testing.assert_array_equal(np.isfinite(got_v), fin)
    np.testing.assert_allclose(got_v[fin], want_v[fin], rtol=0, atol=atol)
    np.testing.assert_array_equal(got_i[~fin], want_i[~fin])
    for r, c in zip(*np.nonzero(got_i != want_i)):
        gaps = [abs(want_v[r, c] - want_v[r, o]) for o in (c - 1, c + 1)
                if 0 <= o < want_v.shape[1]]
        assert min(gaps) <= atol, (r, c, got_i[r], want_i[r])


# -- the pieces ------------------------------------------------------------------


@pytest.mark.parametrize("method", ["pca", "random"])
@pytest.mark.parametrize("ds", [8, 64])
def test_fit_projection_bitwise_equal_jax(method, ds):
    rng = np.random.default_rng(ds)
    x = clustered_rows(rng, n=300)
    cov = (x.T @ x).astype(np.float32)
    got = scr_mod._fit_projection(64, ds, method, 3, cov if method == "pca" else None)
    want = jscreen._fit_projection(64, ds, method, 3, cov if method == "pca" else None)
    assert got.dtype == np.float32 and got.shape == (64, ds)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    with pytest.raises(ValueError, match="method"):
        scr_mod._fit_projection(64, ds, "pq", 0, None)


def test_quantizer_and_second_moment_match_jax():
    """The sketch quantizer on the same f32 rows: int8 bit for bit, scales
    within a few ulps (the norms sum in other orders); the second moment."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    x = (rng.normal(size=(257, 16)) * rng.uniform(0.1, 5, (257, 1))).astype(np.float32)
    x[3] = 0.0
    q, s = scr_mod._quantize_rows_int8(torch.from_numpy(x))
    jq, js = jscreen._quantize_rows_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=5e-7, atol=0)
    rows = clustered_rows(rng, n=200)
    idx = build(rows)
    idx.delete_rows([4, 5])
    idx.load()
    cov = scr_mod.second_moment(idx._gallery, idx._valid, idx._scales, block=64)
    deq = idx.get_vectors(np.arange(200)).astype(np.float64)
    deq[[4, 5]] = 0.0
    np.testing.assert_allclose(cov, deq.T @ deq, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,block,c", [(100, 32, 10), (129, 64, 24), (96, 48, 48),
                                       (300, 7, 5)])
def test_blocked_sketch_topc_equals_direct_and_jax(n, block, c):
    """Phase 1 blocked with a running merge = the direct full-width top-c,
    and = the JAX package's blocked phase 1 wherever its value is finite."""
    import jax.numpy as jnp

    rng = np.random.default_rng(n)
    sk = rng.integers(-3, 4, size=(n, 6)).astype(np.int8)  # many exact ties
    sks = rng.uniform(0.5, 2.0, n).astype(np.float32)
    valid = rng.random(n) < 0.7
    qs = rng.integers(-2, 3, size=(3, 6)).astype(np.float32)
    args = (torch.from_numpy(qs).to(torch.bfloat16), torch.from_numpy(sk),
            torch.from_numpy(sks), torch.from_numpy(valid), c)
    dv, di = scr_mod.sketch_topc(*args, block=1 << 30)
    bv, bi = scr_mod.sketch_topc(*args, block=block)
    np.testing.assert_array_equal(bv.numpy(), dv.numpy())
    np.testing.assert_array_equal(bi.numpy(), di.numpy())
    jv, ji = jscreen._phase1_local_topc(jnp.asarray(qs, jnp.bfloat16), jnp.asarray(sk),
                                        jnp.asarray(sks), jnp.asarray(valid), c, block)
    jv, ji = np.asarray(jv), np.asarray(ji)
    np.testing.assert_array_equal(bv.numpy(), jv)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(bi.numpy()[fin], ji[fin])


# -- the resident screen ---------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int8", "float32", "bfloat16"])
def test_full_coverage_matches_exact_and_jax(rng, dtype):
    """candidates >= N: the screen gives the exact engine's answers."""
    rows = clustered_rows(rng)
    idx = build(rows, dtype)
    scr = ScreenedSearch.from_index(idx, sketch_dims=16, candidates=512)
    q = rng.normal(size=(5, rows.shape[1])).astype(np.float32)
    got = scr.search(q, top_k=10)
    assert got[1].dtype == np.int32
    assert_same_topk(*got, *idx.search(q, top_k=10))
    jidx = build(rows, dtype, jax=True)
    want = jscreen.ScreenedSearch.from_index(jidx, sketch_dims=16, candidates=512).search(
        q, top_k=10)
    assert_same_topk(*got, *want, atol=1e-5 if dtype == "bfloat16" else ATOL)


@pytest.mark.parametrize("method", ["pca", "random"])
@pytest.mark.parametrize("candidates", [64, 256])
def test_recall_on_clustered_data(rng, method, candidates):
    """Recall on clustered rows: the JAX screen's on a one-device mesh (the
    port's pool; on the 8-device mesh the JAX pool is 8 x larger), and the
    JAX tests' floor of 0.9 for the PCA sketch."""
    from image_retrieval_tpu.config import MeshConfig
    from image_retrieval_tpu.parallel.mesh import make_mesh

    rows = clustered_rows(rng, n=1024)
    q = clustered_rows(rng, n=16)
    idx = build(rows)
    jidx = JaxIndex(dim=64, mesh=make_mesh(MeshConfig(data=1, model=1)),
                    config=IndexConfig(dtype="int8", capacity_step=64))
    jidx.insert([f"img_{i}.jpg" for i in range(len(rows))], rows)
    scr = ScreenedSearch.from_index(idx, sketch_dims=16, candidates=candidates, method=method)
    got = recall(scr.search(q, top_k=10)[1], idx.search(q, top_k=10)[1])
    want = recall(jscreen.ScreenedSearch.from_index(
        jidx, sketch_dims=16, candidates=candidates, method=method).search(q, top_k=10)[1],
        jidx.search(q, top_k=10)[1])
    assert abs(got - want) <= 0.05, (got, want)
    if method == "pca":
        assert got >= 0.9, got


def test_pca_beats_random_at_equal_width(rng):
    dim = 64
    scales = np.geomspace(1.0, 0.02, dim)
    rows = (rng.normal(size=(1024, dim)) * scales).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    idx = build(rows)
    q = (rng.normal(size=(16, dim)) * scales).astype(np.float32)
    _, ei = idx.search(q, top_k=10)

    def rec(method):
        scr = ScreenedSearch.from_index(idx, sketch_dims=8, candidates=32, method=method,
                                        seed=3)
        return recall(scr.search(q, top_k=10)[1], ei)

    assert rec("pca") >= rec("random")


def test_tombstones_never_surface(rng):
    rows = clustered_rows(rng, n=256)
    idx, jidx = build(rows), build(rows, jax=True)
    for ix in (idx, jidx):
        ix.delete([f"img_{i}.jpg" for i in range(0, 256, 3)])
    scr = ScreenedSearch.from_index(idx, sketch_dims=16, candidates=256)
    got = scr.search(rows[:4], top_k=20)
    assert not (set(got[1].ravel().tolist()) & set(range(0, 256, 3)))
    assert_same_topk(*got, *idx.search(rows[:4], top_k=20))
    assert_same_topk(*got, *jscreen.ScreenedSearch.from_index(
        jidx, sketch_dims=16, candidates=256).search(rows[:4], top_k=20))


def test_padding_when_pool_exhausted(rng):
    """top_k beyond the live rows pads with (-inf, -1)."""
    rows = clustered_rows(rng, n=24)
    scr = ScreenedSearch.from_index(build(rows), sketch_dims=16, candidates=64)
    v, i = scr.search(rows[0], top_k=32)
    assert v.shape == i.shape == (32,) and (i >= 0).sum() == 24
    assert np.all(i[24:] == -1) and np.all(np.isneginf(v[24:]))
    jv, ji = jscreen.ScreenedSearch.from_index(build(rows, jax=True), sketch_dims=16,
                                               candidates=64).search(rows[0], top_k=32)
    assert_same_topk(v, i, jv, ji)


def test_single_query_shape_and_batch_agree(rng):
    rows = clustered_rows(rng, n=256)
    scr = ScreenedSearch.from_index(build(rows), sketch_dims=32, candidates=128)
    v1, i1 = scr.search(rows[7], top_k=5)
    vb, ib = scr.search(rows[6:8], top_k=5)
    assert v1.shape == (5,) and i1.shape == (5,)
    np.testing.assert_array_equal(i1, ib[1])
    np.testing.assert_allclose(v1, vb[1], rtol=1e-6)


def test_stale_after_mutation_raises(rng):
    rows = clustered_rows(rng, n=128)
    idx = build(rows)
    scr = ScreenedSearch.from_index(idx, sketch_dims=16, candidates=64)
    assert not scr.stale
    idx.insert(["new.jpg"], rows[:1])
    assert scr.stale
    with pytest.raises(ValueError, match="generation"):
        scr.search(rows[0], top_k=5)


def test_zero_candidates_and_int4_rejected(rng):
    rows = clustered_rows(rng, n=64)
    with pytest.raises(ValueError, match="candidates"):
        ScreenedSearch.from_index(build(rows), sketch_dims=16, candidates=0)
    with pytest.raises(ValueError, match="int4"):
        ScreenedSearch.from_index(build(rows, "int4"), sketch_dims=16)
    with pytest.raises(ValueError, match="empty"):
        ScreenedSearch.from_index(ShardedVectorIndex(dim=64, device="cpu"))


def test_recall_at_contract(rng):
    rows = clustered_rows(rng, n=256)
    idx = build(rows)
    scr = ScreenedSearch.from_index(idx, sketch_dims=32, candidates=256)
    _, ei = idx.search(rows[:8], top_k=10)
    assert scr.recall_at(rows[:8], ei, k=10) == 1.0  # full coverage


def test_all_tombstoned_returns_padding(rng):
    rows = clustered_rows(rng, n=64)
    idx = build(rows)
    idx.delete([f"img_{i}.jpg" for i in range(64)])
    scr = ScreenedSearch.from_index(idx, sketch_dims=16, candidates=64)
    v, i = scr.search(rows[0], top_k=5)
    assert np.all(i == -1) and np.all(np.isneginf(v))


class TestBlockedPhase1:
    """The resident phase 1 blocked over p1_block rows with a running merge
    returns the direct sweep's answers, with fewer live rows than candidates
    too (no row twice) and with a tail block."""

    def test_blocked_matches_direct(self, rng):
        rows = clustered_rows(rng, n=1024)
        scr = ScreenedSearch.from_index(build(rows), sketch_dims=16, candidates=16)
        q = rng.normal(size=(7, rows.shape[1])).astype(np.float32)
        scr.p1_block = 1 << 30
        dv, di = scr.search(q, top_k=10)
        scr.p1_block = 32
        bv, bi = scr.search(q, top_k=10)
        np.testing.assert_array_equal(bi, di)
        np.testing.assert_array_equal(bv, dv)

    def test_blocked_no_duplicates_when_live_lt_candidates(self, rng):
        rows = clustered_rows(rng, n=1024)
        idx = build(rows)
        idx.delete([f"img_{i}.jpg" for i in range(1012)])  # 12 live < 16
        scr = ScreenedSearch.from_index(idx, sketch_dims=16, candidates=16)
        scr.p1_block = 32
        vals, ids = scr.search(rng.normal(size=(3, 64)).astype(np.float32), top_k=16)
        for row_ids, row_vals in zip(ids, vals):
            live = row_ids[row_ids >= 0]
            assert len(live) == 12 and len(set(live.tolist())) == 12
            assert all(i >= 1012 for i in live)
            assert np.all(np.isneginf(row_vals[row_ids < 0]))

    def test_blocked_tail_matches_direct(self, rng):
        rows = clustered_rows(rng, n=1536)
        scr = ScreenedSearch.from_index(build(rows), sketch_dims=16, candidates=24)
        q = rng.normal(size=(5, rows.shape[1])).astype(np.float32)
        scr.p1_block = 1 << 30
        dv, di = scr.search(q, top_k=10)
        scr.p1_block = 40  # 1536 = 38 x 40 + 16
        bv, bi = scr.search(q, top_k=10)
        np.testing.assert_array_equal(bi, di)
        np.testing.assert_array_equal(bv, dv)


# -- the streamed screen ---------------------------------------------------------


def test_streamed_screen_full_coverage_matches_streamed_exact(rng):
    rows = clustered_rows(rng, n=256)
    idx = build(rows, stream_threshold_bytes=1024)
    scr = ScreenedSearch.from_index(idx, sketch_dims=16, candidates=256)
    assert scr.streamed and idx._stream is not None
    q = rng.normal(size=(5, rows.shape[1])).astype(np.float32)
    got = scr.search(q, top_k=10)
    assert_same_topk(*got, *idx.search(q, top_k=10))
    jidx = build(rows, jax=True, stream_threshold_bytes=1024)
    assert_same_topk(*got, *jscreen.ScreenedSearch.from_index(
        jidx, sketch_dims=16, candidates=256).search(q, top_k=10))


def test_streamed_screen_with_tombstones(rng):
    rows = clustered_rows(rng, n=192)
    idx = build(rows, stream_threshold_bytes=1024)
    idx.delete([f"img_{i}.jpg" for i in range(0, 192, 5)])
    scr = ScreenedSearch.from_index(idx, sketch_dims=16, candidates=192)
    got = scr.search(rows[:3], top_k=20)
    assert not (set(got[1].ravel().tolist()) & set(range(0, 192, 5)))
    assert_same_topk(*got, *idx.search(rows[:3], top_k=20))


def test_streamed_screen_recall_thin_sketch(rng):
    rows = clustered_rows(rng, n=1024)
    idx = build(rows, stream_threshold_bytes=1024)
    scr = ScreenedSearch.from_index(idx, sketch_dims=16, candidates=64)
    q = clustered_rows(rng, n=16)
    assert recall(scr.search(q, top_k=10)[1], idx.search(q, top_k=10)[1]) >= 0.9


def test_streamed_screen_padding_and_single_query(rng):
    rows = clustered_rows(rng, n=24)
    scr = ScreenedSearch.from_index(build(rows, stream_threshold_bytes=64), sketch_dims=16,
                                    candidates=64)
    v, i = scr.search(rows[0], top_k=32)
    assert v.shape == (32,) and (i >= 0).sum() == 24
    assert np.all(i[24:] == -1) and np.all(np.isneginf(v[24:]))


def test_streamed_phase1_blocked_path(monkeypatch, rng):
    """The blocked streamed phase 1 against the streamed exact engine,
    with queries whose cosines are all negative."""
    monkeypatch.setattr(scr_mod, "_PHASE1_BLOCK", 64)
    monkeypatch.setattr(scr_mod, "_STREAM_FIT_CHUNK", 50)  # several build passes
    rows = clustered_rows(rng, n=200)  # not a multiple of the block
    idx = build(rows, stream_threshold_bytes=1024)
    scr = ScreenedSearch.from_index(idx, sketch_dims=16, candidates=256)
    assert scr.streamed and scr._sketch.shape[0] == 200
    q = np.concatenate([rows[:3], -rows[3:5]])
    assert_same_topk(*scr.search(q, top_k=10), *idx.search(q, top_k=10))


@pytest.mark.parametrize("n,block", [(100, 32), (129, 64), (96, 48)])
def test_blocked_phase1_equals_direct(monkeypatch, rng, n, block):
    rows = clustered_rows(rng, n=n)
    idx = build(rows, stream_threshold_bytes=64)
    q = rng.normal(size=(3, rows.shape[1])).astype(np.float32)
    monkeypatch.setattr(scr_mod, "_PHASE1_BLOCK", 1 << 30)
    dv, di = ScreenedSearch.from_index(idx, sketch_dims=16, candidates=32, method="random",
                                       seed=1).search(q, top_k=10)
    monkeypatch.setattr(scr_mod, "_PHASE1_BLOCK", block)
    bv, bi = ScreenedSearch.from_index(idx, sketch_dims=16, candidates=32, method="random",
                                       seed=1).search(q, top_k=10)
    np.testing.assert_array_equal(di, bi)
    np.testing.assert_array_equal(dv, bv)


# -- ann="screen" in the searcher, the server and the app -------------------------


def _jax_app(ann, rows, dim):
    from image_retrieval_tpu.app.pipeline import ImageSearchApp as JaxApp
    from image_retrieval_tpu.config import Config as JaxConfig
    from image_retrieval_tpu.models.encoder import FakeEncoder as JaxFake

    cfg = JaxConfig()
    cfg.search.ann = ann
    cfg.search.screen_candidates = 96
    app = JaxApp(config=cfg, encoder=JaxFake(dim=dim))
    app.embeddings = {f"img_{i}.jpg": rows[i] for i in range(len(rows))}
    app._index_dirty = True
    return app


def _app(ann, rows, dim, **search):
    from image_retrieval_tpu_torch.app.pipeline import ImageSearchApp

    cfg = Config()
    cfg.search.ann = ann
    cfg.search.screen_candidates = 96  # full coverage: the exact answers
    for k, v in search.items():
        setattr(cfg.search, k, v)
    app = ImageSearchApp(config=cfg, encoder=FakeEncoder(dim=dim), device="cpu")
    app.embeddings = {f"img_{i}.jpg": rows[i] for i in range(len(rows))}
    app._index_dirty = True
    return app


@pytest.mark.parametrize("optimized", [False, True])
def test_facade_ann_screen(rng, optimized):
    """SearchConfig.ann = 'screen' routes search_images through the screen;
    at full coverage its answers are the exact facade's and the JAX
    facade's."""
    dim = 64
    rows = clustered_rows(rng, n=96, dim=dim) * rng.uniform(0.5, 3, (96, 1)).astype(np.float32)
    got = _app("screen", rows, dim).search_images("a red square", top_k=8,
                                                  use_optimized_similarity=optimized)
    for want in (_app("exact", rows, dim).search_images(
                     "a red square", top_k=8, use_optimized_similarity=optimized),
                 _jax_app("screen", rows, dim).search_images(
                     "a red square", top_k=8, use_optimized_similarity=optimized)):
        assert [r["path"] for r in got] == [r["path"] for r in want]
        np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                                   rtol=0, atol=1e-5)
    app = _app("screen", rows, dim)
    filtered = app.search_images("a red square", top_k=8, filter_expr="dir != 'x'")
    assert len(filtered) == 8  # a filter rides the exact index


def test_facade_ann_config_flip_rebuilds(rng):
    """A change of SearchConfig.ann or its settings rebuilds the tier at an
    unchanged index generation: 'ivf' builds an IVFIndex, 'screen' then a
    ScreenedSearch."""
    from image_retrieval_tpu_torch.index.ivf import IVFIndex

    rows = clustered_rows(rng, n=64)
    app = _app("ivf", rows, rows.shape[1], screen_candidates=64, nlist=8, nprobe=4)
    index = app._ensure_index()
    ann1 = app._ensure_ann(index)
    assert isinstance(ann1, IVFIndex) and (ann1.nlist, ann1.nprobe) == (8, 4)
    assert app._ensure_ann(index) is ann1
    app.config.search.ann = "screen"
    ann2 = app._ensure_ann(index)
    assert isinstance(ann2, ScreenedSearch) and app._ensure_ann(index) is ann2
    app.config.search.screen_dims = 32
    ann3 = app._ensure_ann(index)
    assert ann3 is not ann2 and ann3.sketch_dims == 32
    index.delete(["img_0.jpg"])
    assert app._ensure_ann(index) is not ann3  # a new generation
    app.config.search.ann = "exact"
    assert app._ensure_ann(index) is None


def test_searcher_with_screen_ann_matches_jax(rng):
    from image_retrieval_tpu.app.search import TextImageSearcher as JaxSearcher
    from image_retrieval_tpu.models.encoder import FakeEncoder as JaxFake
    from image_retrieval_tpu_torch.app.search import TextImageSearcher, ann_valid_candidates

    rows = clustered_rows(rng, n=96)
    idx, jidx = build(rows), build(rows, jax=True)
    mine = TextImageSearcher(FakeEncoder(dim=64), idx,
                             ann=ScreenedSearch.from_index(idx, sketch_dims=16, candidates=96))
    ref = JaxSearcher(JaxFake(dim=64), jidx, ann=jscreen.ScreenedSearch.from_index(
        jidx, sketch_dims=16, candidates=96))
    exact = TextImageSearcher(FakeEncoder(dim=64), idx)
    for kw in ({}, {"use_optimized_similarity": True}, {"filter_expr": "x == 1"}):
        got = mine.search("a blue bird", top_k=5, score_threshold=-1.0, **kw)
        assert [r["path"] for r in got] == [r["path"] for r in ref.search(
            "a blue bird", top_k=5, score_threshold=-1.0, **kw)]
        assert [r["path"] for r in got] == [r["path"] for r in exact.search(
            "a blue bird", top_k=5, score_threshold=-1.0, **kw)]
    cos, ids = ann_valid_candidates(mine.ann, idx, rows[0], 200)
    assert len(ids) == 96 and (ids >= 0).all() and ids[0] == 0


def test_server_with_screen_ann_and_detach(rng, tmp_path):
    """SearchServer(ann=ScreenedSearch): at full coverage the answers of the
    exact server and of the JAX server with the JAX screen; an insert or a
    delete detaches the screen and serving goes on from the exact sweep."""
    from image_retrieval_tpu.app.server import SearchServer as JaxServer
    from image_retrieval_tpu.models.encoder import FakeEncoder as JaxFake
    from image_retrieval_tpu_torch.app.server import SearchServer
    from PIL import Image

    rows = clustered_rows(rng, n=96)
    idx, jidx = build(rows), build(rows, jax=True)
    ann = ScreenedSearch.from_index(idx, sketch_dims=16, candidates=96)
    janns = jscreen.ScreenedSearch.from_index(jidx, sketch_dims=16, candidates=96)
    enc = FakeEncoder(dim=64)
    w = {"w_angle": 1.0, "w_l1": 1.0, "w_mag": 0.5}
    with SearchServer(enc, idx) as exact_srv, SearchServer(enc, idx, ann=ann) as scr_srv, \
            JaxServer(JaxFake(dim=64), jidx, ann=janns) as jax_srv:
        for kw in ({}, {"metric": "optimized_similarity", "weights": w}):
            a = exact_srv.search("a blue bird", top_k=5, **kw)
            b = scr_srv.search("a blue bird", top_k=5, **kw)
            c = jax_srv.search("a blue bird", top_k=5, **kw)
            assert [r["path"] for r in a] == [r["path"] for r in b] == [r["path"] for r in c]
            # the ANN path reranks the optimized metric in float64 on the
            # host, as the JAX server does; the exact sweep by the int8
            # scorer's definition (bf16 differences)
            np.testing.assert_allclose([r["score"] for r in b], [r["score"] for r in c],
                                       rtol=0, atol=1e-5)
        many = scr_srv.search_many(["a blue bird", "a red car"], top_k=3, approx=True)
        assert [[r["path"] for r in m] for m in many] == [
            [r["path"] for r in exact_srv.search(t, top_k=3)] for t in ("a blue bird",
                                                                        "a red car")]
        assert scr_srv.remove_images(["img_0.jpg"]) == 1
        assert scr_srv.ann is None  # detached: the screen went stale
        after = scr_srv.search("a blue bird", top_k=5)
        assert "img_0.jpg" not in [r["path"] for r in after] and len(after) == 5
    with SearchServer(enc, idx, ann=ScreenedSearch.from_index(idx, sketch_dims=16,
                                                              candidates=96)) as srv:
        p = tmp_path / "new.png"
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(p)
        assert srv.add_images([str(p)]) == (1, 0)
        assert srv.ann is None  # detached on the insert
        assert len(srv.search("a blue bird", top_k=5)) == 5


@pytest.mark.parametrize("mutation", ["insert", "delete"])
def test_server_mutation_while_a_wave_is_served(rng, tmp_path, mutation):
    """A wave that took the screen just before an insert or a delete, and
    searches after it, is served by the exact sweep: no request fails on the
    stale screen, and the answers are the exact server's over the changed
    index."""
    import threading

    from image_retrieval_tpu_torch.app.server import SearchServer
    from PIL import Image

    rows = clustered_rows(rng, n=96)
    idx = build(rows)
    enc = FakeEncoder(dim=64)
    texts = [f"query {i}" for i in range(16)]
    with SearchServer(enc, idx, ann=ScreenedSearch.from_index(
            idx, sketch_dims=16, candidates=96)) as srv:
        entered, go = threading.Event(), threading.Event()
        serves = srv._ann_serves

        def held(ann, metric, flt):  # pause the wave after it read the tier
            entered.set()
            assert go.wait(30)
            return serves(ann, metric, flt)

        srv._ann_serves = held
        out = {}
        wave = threading.Thread(target=lambda: out.update(
            got=srv.search_many(texts, top_k=5, timeout=60)))
        wave.start()
        assert entered.wait(30)
        if mutation == "insert":
            p = tmp_path / "new.png"
            Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(p)
            assert srv.add_images([str(p)]) == (1, 0)
        else:
            assert srv.remove_images(["img_0.jpg", "img_1.jpg"]) == 2
        assert srv.ann is None
        go.set()
        wave.join(60)
        srv._ann_serves = serves
        assert srv.stats["batches"] >= 1 and "got" in out
    with SearchServer(enc, idx) as exact_srv:
        want = exact_srv.search_many(texts, top_k=5)
    assert [[r["path"] for r in m] for m in out["got"]] == [
        [r["path"] for r in m] for m in want]


# -- the screen over a mesh --------------------------------------------------------


def _mesh_pair(rows, dtype="int8"):
    """The port's index on eight CPU shards and the JAX index on its 8-device
    mesh, over the same rows with the same tombstones."""
    from image_retrieval_tpu_torch.parallel.mesh import make_mesh

    config = IndexConfig(embedding_dim=rows.shape[1], dtype=dtype, capacity_step=64)
    mine = ShardedVectorIndex(dim=rows.shape[1], config=config,
                              mesh=make_mesh(devices=["cpu"] * 8))
    ref = JaxIndex(dim=rows.shape[1], config=config)
    for ix in (mine, ref):
        ix.insert([f"img_{i}.jpg" for i in range(len(rows))], rows)
        ix.delete([f"img_{i}.jpg" for i in range(0, len(rows), 9)])
    return mine, ref


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_sharded_second_moment_matches_jax(rng, dtype):
    """Each shard's moment summed over the shards (float64) against the JAX
    package's psum of f32 shard moments on its mesh and against the port's
    one-device moment: within the one-device moment test's 1e-5."""
    import jax.numpy as jnp

    rows = clustered_rows(rng, n=600)
    mine, ref = _mesh_pair(rows, dtype)
    one = build(rows, dtype)
    one.delete([f"img_{i}.jpg" for i in range(0, 600, 9)])
    for ix in (mine, ref, one):
        ix.load()
    got = scr_mod.second_moment(mine._gallery, mine._valid, mine._scales)
    want = np.asarray(jscreen._sharded_second_moment(ref._gallery, ref._valid, ref._scales,
                                                     mesh=ref.mesh, axes=ref._row_axes))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, scr_mod.second_moment(one._gallery, one._valid,
                                                          one._scales), rtol=1e-5, atol=1e-5)
    assert len(mine._gallery) == 8 and jnp.asarray(want).shape == (64, 64)


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_sharded_screen_matches_jax_on_its_mesh(rng, dtype):
    """The random projection (seeded: the same matrix in both packages) over
    eight shards, a pool of C a shard on both sides: the JAX screen's answers
    at ATOL, ids equal but for ties. PCA: the projections come from moments
    summed in other orders, so its recall is held to the JAX screen's."""
    rows = clustered_rows(rng, n=1024)
    q = clustered_rows(rng, n=16)
    mine, ref = _mesh_pair(rows, dtype)
    for method in ("random", "pca"):
        a = ScreenedSearch.from_index(mine, sketch_dims=16, candidates=24, method=method, seed=5)
        b = jscreen.ScreenedSearch.from_index(ref, sketch_dims=16, candidates=24, method=method,
                                              seed=5)
        assert len(a._sketch) == 8 and sum(s.shape[0] for s in a._sketch) == 1024
        got, want = a.search(q, top_k=10), b.search(q, top_k=10)
        if method == "random":
            np.testing.assert_array_equal(a.proj, b.proj)
            assert_same_topk(*got, *want)
        else:
            exact = mine.search(q, top_k=10)[1]
            assert abs(recall(got[1], exact) - recall(want[1], exact)) <= 0.05
        assert not set(got[1].ravel().tolist()) & set(range(0, 1024, 9))


def test_sharded_screen_full_pool_is_exact(rng):
    """A pool of every row of a shard reranks every live row: the exact
    tier's answers, as on one device."""
    rows = clustered_rows(rng, n=400)
    mine, _ = _mesh_pair(rows)
    scr = ScreenedSearch.from_index(mine, sketch_dims=8, candidates=64)
    got = scr.search(rows[:6], top_k=12)
    assert_same_topk(*got, *mine.search(rows[:6], top_k=12))
    one = build(rows)
    one.delete([f"img_{i}.jpg" for i in range(0, 400, 9)])
    assert_same_topk(*got, *ScreenedSearch.from_index(one, sketch_dims=8, candidates=400)
                     .search(rows[:6], top_k=12))
