"""The port's top-k and f32 index held against the JAX package's and a
numpy oracle, on galleries with exact duplicate rows (ties)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.config import IndexConfig
from image_retrieval_tpu.index.vector_index import ShardedVectorIndex as JaxIndex
from image_retrieval_tpu.ops import topk as jtopk
from image_retrieval_tpu_torch.app.search import TextImageSearcher
from image_retrieval_tpu_torch.app.server import SearchServer
from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.models.encoder import FakeEncoder
from image_retrieval_tpu_torch.ops import topk


def _tied_scores(seed):
    """(4, 300) scores from a gallery with duplicated rows, plus some
    exact ties introduced by rounding to a coarse grid."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(100, 16)).astype(np.float32)
    g = np.concatenate([g, g[::-1], g[10:20].repeat(10, 0)])  # 300 rows, many duplicates
    q = rng.normal(size=(4, 16)).astype(np.float32)
    s = q @ g.T
    s[:, ::7] = np.round(s[:, ::7], 1)
    return s


def _oracle(s, k, descending):
    key = -s if descending else s
    order = np.argsort(key, axis=-1, kind="stable")[:, :k]
    return np.take_along_axis(s, order, -1), order


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("k", [1, 10, 299, 400])
def test_exact_topk_ties_match_jax_and_oracle(descending, k):
    s = _tied_scores(k)
    want_v, want_i = _oracle(s, min(k, s.shape[1]), descending)
    jv, ji = jtopk.exact_topk(jnp.asarray(s), k, descending=descending)
    tv, ti = topk.exact_topk(torch.from_numpy(s), k, descending=descending)
    np.testing.assert_array_equal(ti.numpy(), want_i)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), want_v)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("descending", [True, False])
def test_two_key_and_merge_topk_match_jax(descending):
    rng = np.random.default_rng(11)
    vals = np.round(rng.normal(size=(3, 40)), 1).astype(np.float32)  # many ties
    idx = np.stack([rng.permutation(1000)[:40] for _ in range(3)]).astype(np.int32)
    jv, ji = jtopk.two_key_topk(jnp.asarray(vals), jnp.asarray(idx), 12, descending)
    tv, ti = topk.two_key_topk(torch.from_numpy(vals), torch.from_numpy(idx), 12, descending)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    a, b = slice(0, 20), slice(20, 40)
    jv, ji = jtopk.merge_topk(jnp.asarray(vals[:, a]), jnp.asarray(idx[:, a]),
                              jnp.asarray(vals[:, b]), jnp.asarray(idx[:, b]), 12, descending)
    tv, ti = topk.merge_topk(*(torch.from_numpy(x) for x in
                               (vals[:, a], idx[:, a], vals[:, b], idx[:, b])), 12, descending)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def _gallery(rng, n=200, d=64):
    emb = (rng.normal(size=(n, d)) * rng.uniform(2, 9, size=(n, 1))).astype(np.float32)
    emb[7] = emb[3]  # exact duplicate rows: a tie, lowest index first
    emb[50] = emb[3] * 2.0  # same direction, other magnitude: an exact cosine tie too
    emb[11] = 0.0  # zero-norm row: unit 0, magnitude 0, scores 0
    return emb


def test_index_matches_jax_index():
    rng = np.random.default_rng(12)
    emb = _gallery(rng)
    paths = [f"img/{i:03d}.jpg" for i in range(len(emb))]
    cfg = IndexConfig(embedding_dim=64, capacity_step=128)
    mine = ShardedVectorIndex(dim=64, config=cfg, device="cpu")
    ref = JaxIndex(dim=64, config=cfg)
    for ix in (mine, ref):
        assert ix.insert(paths[:150], emb[:150]) == 150
        # the magnitudes= form stores rows as given (already unit)
        unit = emb[150:] / np.linalg.norm(emb[150:], axis=1, keepdims=True)
        ix.insert(paths[150:], unit, np.linalg.norm(emb[150:], axis=1))
        assert ix.delete(["img/020.jpg", "img/021.jpg", "missing"]) == 2
        assert ix.delete_rows([30, 30, 31, 999, -1]) == 2
    assert len(mine) == len(ref) == 200
    assert mine.live_count == ref.live_count == 196
    assert mine.paths == ref.paths
    q = np.concatenate([emb[3:4], rng.normal(size=(5, 64)).astype(np.float32),
                        np.zeros((1, 64), np.float32)])
    got_v, got_i = mine.search(q, top_k=12)
    want_v, want_i = ref.search(q, top_k=12)
    np.testing.assert_array_equal(got_i, want_i)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-6)
    assert list(got_i[0, :3]) == [3, 7, 50]  # ties in ascending row order
    assert not (np.isin(got_i, [20, 21, 30, 31])).any()  # tombstones never returned
    np.testing.assert_array_equal(got_v[-1], np.zeros(12, np.float32))  # zero query
    v1, i1 = mine.search(q[1], top_k=500)  # 1-D query, k capped at live rows
    assert v1.shape == i1.shape == (196,)
    np.testing.assert_array_equal(mine.get_vectors([3, 11, 160]), ref.get_vectors([3, 11, 160]))
    np.testing.assert_array_equal(mine.get_magnitudes([3, 11, 160]),
                                  ref.get_magnitudes([3, 11, 160]))
    got_q, want_q = mine.query(limit=5), ref.query(limit=5)
    assert [p for p, _ in got_q] == [p for p, _ in want_q]


def test_index_mutations_after_search_resync():
    rng = np.random.default_rng(13)
    ix = ShardedVectorIndex(dim=8, config=IndexConfig(embedding_dim=8, capacity_step=4),
                            device="cpu")
    with pytest.raises(ValueError, match="empty"):
        ix.search(np.ones(8, np.float32))
    ix.insert(["a", "b"], rng.normal(size=(2, 8)).astype(np.float32))
    _, i = ix.search(np.ones(8, np.float32), top_k=5)
    assert len(i) == 2
    new = np.full((1, 8), 3.0, np.float32)
    ix.insert(["c"], new)  # grows past capacity_step, marks the device copy stale
    v, i = ix.search(new[0], top_k=1)
    assert i[0] == 2 and v[0] == pytest.approx(1.0, abs=1e-6)
    ix.delete(["c"])
    _, i = ix.search(new[0], top_k=3)
    assert 2 not in i and len(i) == 2
    with pytest.raises(ValueError, match="paths for"):
        ix.insert(["x"], np.ones((2, 8), np.float32))


@pytest.mark.parametrize("kwargs", [
    dict(config=IndexConfig(embedding_dim=8, dtype="int8", l1_shadow=True)),
    dict(config=IndexConfig(embedding_dim=8, dtype="int8", stream_threshold_bytes=1 << 20)),
    dict(config=IndexConfig(embedding_dim=8, approx_select=True)),
])
def test_index_tier_options_match_jax(kwargs):
    """The tier options that raised before they were ported build and answer
    as the JAX index with the same configuration."""
    rng = np.random.default_rng(14)
    emb = rng.normal(size=(50, 8)).astype(np.float32)
    mine = ShardedVectorIndex(dim=8, device="cpu", **kwargs)
    ref = JaxIndex(dim=8, **kwargs)
    for ix in (mine, ref):
        ix.insert([f"r{i}" for i in range(50)], emb)
    q = rng.normal(size=(3, 8)).astype(np.float32)
    got, want = mine.search(q, top_k=5), ref.search(q, top_k=5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)


def test_journal_not_ported(tmp_path):
    """A journal directory the JAX package wrote with approx_select (a tier
    option the port once lacked) reopens in the port with that option and
    the JAX index's answers."""
    rng = np.random.default_rng(15)
    emb = rng.normal(size=(40, 8)).astype(np.float32)
    cfg = IndexConfig(embedding_dim=8, dtype="int8", approx_select=True)
    ref = JaxIndex.open(str(tmp_path / "journal"), config=cfg)
    ref.insert([f"r{i}" for i in range(40)], emb)
    ref.delete(["r3"])
    ref.flush()
    mine = ShardedVectorIndex.open(str(tmp_path / "journal"), device="cpu")
    assert mine.config.approx_select and mine.config.dtype == "int8"
    q = rng.normal(size=(4, 8)).astype(np.float32)
    got, want = mine.search(q, top_k=6), ref.search(q, top_k=6)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=2e-3)
    ShardedVectorIndex.open(str(tmp_path / "fresh"), device="cpu")  # a new directory opens


@pytest.mark.parametrize("kwargs", [dict(selector="approx"),
                                    dict(shadow=torch.ones(1, 8, dtype=torch.bfloat16))])
def test_collective_options(kwargs):
    """sharded_search_topk's approximate selector gives the exact answers;
    a shadow is read only by the int8 weighted score (an f32 gallery's
    cosine ignores it)."""
    from image_retrieval_tpu_torch.parallel.collectives import sharded_search_topk

    ix = ShardedVectorIndex(dim=8, config=IndexConfig(embedding_dim=8), device="cpu")
    ix.insert(["a", "b", "c"], np.eye(3, 8, dtype=np.float32))
    ix.load()
    args = (torch.ones(1, 8), ix._gallery, ix._valid, ix._mags, 2)
    got, want = sharded_search_topk(*args, **kwargs), sharded_search_topk(*args)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def test_searcher_and_server_take_an_ann_tier():
    """ann= is accepted: any object with search(q_unit, top_k) -> (cos,
    ids) serves the candidates; its -1 slots never reach a path."""

    class Pool:
        def search(self, q, top_k):
            v = np.array([0.9, 0.5, -np.inf], np.float32)[:top_k]
            i = np.array([2, 0, -1])[:top_k]
            if np.ndim(q) == 2:  # a batch: one row of candidates a query
                return np.tile(v, (len(q), 1)), np.tile(i, (len(q), 1))
            return v, i

    ix = ShardedVectorIndex(dim=8, config=IndexConfig(embedding_dim=8), device="cpu")
    ix.insert(["a", "b", "c"], np.eye(3, 8, dtype=np.float32))
    searcher = TextImageSearcher(FakeEncoder(dim=8), ix, ann=Pool())
    hits = searcher.search("x", top_k=3, score_threshold=-1.0)
    assert [h["path"] for h in hits] == ["c", "a"]
    with SearchServer(FakeEncoder(dim=8), ix, ann=Pool(), overfetch=1) as srv:
        assert [h["path"] for h in srv.search("x", top_k=3)] == ["c", "a"]


def test_tf32_is_refused_not_changed():
    """The f32 paths check the caller's TF32 setting instead of changing a
    process-wide flag: a CUDA device with TF32 on raises, the CPU ignores it."""
    from image_retrieval_tpu_torch.device import require_full_f32

    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32 = False"):
            require_full_f32(torch.device("cuda"))
        require_full_f32(torch.device("cpu"))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
