"""The port's weighted and multi-metric search path against the JAX
package's on the same rows: ShardedVectorIndex.search for every metric and
weight set on the f32, bf16 and int8 tiers, with and without a filter;
multi_metric_topk; scores; the server's mixed batches; the searcher's
multi-metric analysis.

Tolerances. f32/bf16 tiers: f32 sums in another order, 1e-5 on scores of
unit scale. int8 tier: the JAX int8 scorer on XLA's CPU backend may keep f32
precision across a bf16 round trip, so its scores are held at the 2e-3 the
JAX package's own tests use. Ranked ids must be equal wherever the JAX
scores of neighbouring ranks differ by more than the tolerance."""

import threading

import numpy as np
import pytest

from image_retrieval_tpu.app.search import TextImageSearcher as JaxSearcher
from image_retrieval_tpu.app.server import SearchServer as JaxServer
from image_retrieval_tpu.config import IndexConfig
from image_retrieval_tpu.index.vector_index import ShardedVectorIndex as JaxIndex
from image_retrieval_tpu.models.encoder import FakeEncoder as JaxFake
from image_retrieval_tpu_torch.app.search import TextImageSearcher
from image_retrieval_tpu_torch.app.server import SearchServer
from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.models.encoder import FakeEncoder
from image_retrieval_tpu_torch.ops.metrics import METRIC_NAMES
from image_retrieval_tpu_torch.ops.topk import DESCENDING_METRICS

D, N, K = 64, 200, 8
TIERS = ("float32", "bfloat16", "int8")
ATOL = {"float32": 1e-5, "bfloat16": 1e-5, "int8": 2e-3}
WEIGHTS = {
    "reference": dict(w_angle=1.0, w_l1=1.0, w_l2=1.0, w_inf=0.0, w_mag=0.5),
    "cosine-only": dict(w_angle=1.0),
    "all-live": dict(w_angle=0.3, w_l1=0.2, w_l2=0.5, w_inf=0.7, w_mag=0.1),
}
CASES = [(m, None) for m in METRIC_NAMES] + [("optimized_similarity", w) for w in WEIGHTS]
FILTER = "bucket == 1"

_built = {}


def _pair(dtype):
    """The same rows in the port's index (on the CPU) and in the JAX index:
    magnitudes in [0.5, 4], a duplicated row, a zero row, tombstones and a
    `bucket` attribute."""
    if dtype not in _built:
        rng = np.random.default_rng(21)
        emb = (rng.normal(size=(N, D)) / np.sqrt(D)
               * rng.uniform(0.5, 4.0, size=(N, 1))).astype(np.float32)
        emb[7] = emb[3]
        emb[11] = 0.0
        cfg = IndexConfig(embedding_dim=D, dtype=dtype, capacity_step=128)
        mine = ShardedVectorIndex(dim=D, config=cfg, device="cpu")
        ref = JaxIndex(dim=D, config=cfg)
        for ix in (mine, ref):
            ix.insert([f"img/{i:03d}" for i in range(N)], emb,
                      attrs={"bucket": np.arange(N) % 4})
            ix.delete_rows([20, 21])
        q = np.concatenate([(rng.normal(size=(3, D)) * 0.3).astype(np.float32),
                            emb[5:6], np.zeros((1, D), np.float32)])
        _built[dtype] = (mine, ref, q, emb)
    return _built[dtype]


def _assert_topk(got, want, atol, descending, live):
    """Scores within atol; ids equal wherever the JAX scores of the
    neighbouring ranks differ by more than atol; padding in the same
    places, (-inf or +inf, -1)."""
    (gv, gi), (wv, wi) = got, want
    assert gv.shape == wv.shape and gi.shape == wi.shape
    pad = wi < 0
    np.testing.assert_array_equal(gi < 0, pad)
    np.testing.assert_array_equal(gv[pad], wv[pad])
    assert (gv[pad] == (-np.inf if descending else np.inf)).all()
    np.testing.assert_allclose(gv[~pad], wv[~pad], rtol=0, atol=atol)
    for r in range(gv.shape[0]):
        order = np.diff(gv[r][~pad[r]])
        assert (order <= 0).all() if descending else (order >= 0).all()
        for c in np.flatnonzero((gi[r] != wi[r]) & ~pad[r]):
            near = [abs(wv[r, c] - wv[r, o]) for o in (c - 1, c + 1)
                    if 0 <= o < gv.shape[1] and not pad[r, o]]
            assert near and min(near) <= 2 * atol, (r, c, gi[r], wi[r], wv[r])
        assert set(gi[r][~pad[r]].tolist()) <= live


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("metric,weights", CASES)
@pytest.mark.parametrize("dtype", TIERS)
def test_search_matches_jax(dtype, metric, weights, filtered):
    mine, ref, q, _ = _pair(dtype)
    params = WEIGHTS[weights] if weights else None
    flt = FILTER if filtered else None
    live = set(range(N)) - {20, 21}
    if filtered:
        live = {i for i in live if i % 4 == 1}
    got = mine.search(q, K, metric, params, flt=flt)
    want = ref.search(q, K, metric, params, flt=flt)
    assert got[0].dtype == np.float32 and got[1].dtype == np.int32
    atol = ATOL[dtype]
    if metric == "angular_distance" or (metric == "l2_distance") or (
            weights and WEIGHTS[weights].get("w_l2")):
        # query 3 equals stored row 5: arccos at 1 and the Gram-form L2 at 0
        # turn one ulp into ~1e-3
        atol = max(atol, 2e-3)
    _assert_topk(got, want, atol, metric in DESCENDING_METRICS, live)
    assert np.isfinite(got[0][-1]).all()  # the zero query: no NaN
    if metric in ("cosine_similarity", "optimized_similarity") and not filtered:
        assert got[1][3][0] == 5  # the query equal to a stored row finds it


@pytest.mark.parametrize("metric", ["l1_distance", "cosine_similarity"])
def test_short_filter_pads_with_the_worst_score(metric):
    mine, ref, q, _ = _pair("float32")
    mask = np.zeros(N, bool)
    mask[[4, 9, 20]] = True  # row 20 is tombstoned: two matches
    gv, gi = mine.search(q[:2], 5, metric, flt=mask)
    wv, wi = ref.search(q[:2], 5, metric, flt=mask)
    np.testing.assert_array_equal(gi, wi)
    assert (gi[:, 2:] == -1).all() and set(gi[0, :2]) == {4, 9}
    worst = -np.inf if metric in DESCENDING_METRICS else np.inf
    assert (gv[:, 2:] == worst).all() and np.isfinite(gv[:, :2]).all()
    np.testing.assert_allclose(gv[:, :2], wv[:, :2], rtol=0, atol=1e-5)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("dtype", TIERS)
def test_multi_metric_topk_matches_jax(dtype, filtered):
    mine, ref, q, _ = _pair(dtype)
    flt = FILTER if filtered else None
    live = {i for i in range(N) if i not in (20, 21) and (not filtered or i % 4 == 1)}
    got = mine.multi_metric_topk(q, K, flt=flt)
    want = ref.multi_metric_topk(q, K, flt=flt)
    assert list(got) == list(want) and len(got) == 5
    for name in want:
        # direct L2 here: no cancellation, the f32 tolerance holds (the int8
        # tier dequantizes to f32 on both sides)
        _assert_topk(got[name], tuple(np.asarray(a) for a in want[name]), 1e-5,
                     name in DESCENDING_METRICS, live)
    one = mine.multi_metric_topk(q[0], 3, flt=flt)
    assert one["l1_distance"][0].shape == (3,)
    np.testing.assert_array_equal(one["l1_distance"][1], got["l1_distance"][1][0, :3])


@pytest.mark.parametrize("metric,weights", [("cosine_similarity", None), ("l2_distance", None),
                                            ("linf_distance", None),
                                            ("optimized_similarity", "reference"),
                                            ("optimized_similarity", "all-live")])
@pytest.mark.parametrize("dtype", TIERS)
def test_scores_match_jax(dtype, metric, weights):
    mine, ref, q, _ = _pair(dtype)
    params = WEIGHTS[weights] if weights else None
    got, want = mine.scores(q, metric, params), ref.scores(q, metric, params)
    assert got.shape == want.shape == (len(q), N) and got.dtype == np.float32
    # scores() dequantizes int8 rows and uses the f32 scorer on both sides
    # (direct L2 in the optimized score), so the f32 tolerance holds on every
    # tier; only l2_distance is Gram-form (query 3 equals row 5)
    atol = 2e-3 if metric == "l2_distance" else 1e-5
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(mine.scores(q[0], metric, params), got[0], rtol=0, atol=1e-6)


def test_int8_search_and_scores_disagree_by_design():
    """search() on the int8 tier scores with the int8 fast path (bf16 query,
    bf16 differences), scores() with the f32 scorer on dequantized rows: the
    two differ at the rounding level, in the port as in the JAX package."""
    mine, ref, q, _ = _pair("int8")
    params = WEIGHTS["reference"]
    for ix in (mine, ref):
        v, i = ix.search(q[:3], 5, "optimized_similarity", params)
        s = ix.scores(q[:3], "optimized_similarity", params)
        diff = np.abs(v - np.take_along_axis(s, i, 1))
        assert 1e-6 < diff.max() < 2e-2


def test_search_paths_and_weight_defaults():
    mine, ref, q, _ = _pair("float32")
    got = mine.search_paths(q[0], 4, "optimized_similarity", {"w_l1": 0.5})
    want = ref.search_paths(q[0], 4, "optimized_similarity", {"w_l1": 0.5})
    assert [h["path"] for h in got] == [h["path"] for h in want]
    np.testing.assert_allclose([h["score"] for h in got], [h["score"] for h in want], atol=1e-5)
    assert mine._weights_tuple(None) == ref._weights_tuple(None) == (1.0, 0.0, 0.0, 0.0, 0.0)
    assert mine._weights_tuple({"w_mag": 2}) == (1.0, 0.0, 0.0, 0.0, 2.0)
    with pytest.raises(ValueError, match="single query"):
        mine.search_paths(q[:2], 4)
    with pytest.raises(ValueError, match="unknown metric"):
        mine.search(q[0], 4, "manhattan")


def test_int4_tier_and_unported_options_still_raise():
    cfg = IndexConfig(embedding_dim=D, dtype="int4", capacity_step=128)
    ix = ShardedVectorIndex(dim=D, config=cfg, device="cpu")
    ix.insert(["a", "b"], np.eye(2, D, dtype=np.float32))
    q = np.ones(D, np.float32)
    for call in (lambda: ix.search(q, 1, "l1_distance"),
                 lambda: ix.search(q, 1, "optimized_similarity", {"w_l1": 1.0}),
                 lambda: ix.multi_metric_topk(q, 1), lambda: ix.scores(q)):
        with pytest.raises(ValueError, match="int4 capacity tier"):
            call()
    # the int4 tier ignores approx, as the JAX index does; approximate
    # selection and the shadow are ported (test_approx_selection_matches_jax,
    # test_l1_shadow_matches_the_int8_scorer_and_jax)
    np.testing.assert_array_equal(ix.search(q, 2, approx=True)[1], ix.search(q, 2)[1])
    f32 = _pair("float32")[0]
    np.testing.assert_array_equal(f32.search(q, 3, "l1_distance", approx=True)[1],
                                  f32.search(q, 3, "l1_distance")[1])
    assert ShardedVectorIndex(dim=D, device="cpu", config=IndexConfig(
        embedding_dim=D, dtype="int8", l1_shadow=True)).config.l1_shadow
    empty = ShardedVectorIndex(dim=D, device="cpu")
    for call in (lambda: empty.multi_metric_topk(q), lambda: empty.scores(q)):
        with pytest.raises(ValueError, match="empty"):
            call()


# ---- approximate selection and the l1_shadow gallery --------------------------


_approx_built = {}


def _approx_pair(dtype):
    """The rows of _pair in an index with approx_select=True on each side."""
    if dtype not in _approx_built:
        _, _, q, emb = _pair(dtype)
        cfg = IndexConfig(embedding_dim=D, dtype=dtype, capacity_step=128,
                          approx_select=True)
        mine = ShardedVectorIndex(dim=D, config=cfg, device="cpu")
        ref = JaxIndex(dim=D, config=cfg)
        for ix in (mine, ref):
            ix.insert([f"img/{i:03d}" for i in range(N)], emb,
                      attrs={"bucket": np.arange(N) % 4})
            ix.delete_rows([20, 21])
        _approx_built[dtype] = (mine, ref)
    return _approx_built[dtype]


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("metric,weights", [("cosine_similarity", None), ("l2_distance", None),
                                            ("optimized_similarity", "reference")])
@pytest.mark.parametrize("dtype", TIERS)
def test_approx_selection_matches_jax(dtype, metric, weights, filtered):
    """IndexConfig(approx_select=True): the JAX index's answers (its
    approx_max_k is exact off the TPU) and, bit for bit, the port's exact
    selector's, also at k past the candidate set's 128 rows."""
    exact, _, q, _ = _pair(dtype)
    mine, ref = _approx_pair(dtype)
    params = WEIGHTS[weights] if weights else None
    flt = FILTER if filtered else None
    live = set(range(N)) - {20, 21}
    if filtered:
        live = {i for i in live if i % 4 == 1}
    for k in (K, 150):
        got = mine.search(q, k, metric, params, flt=flt)
        want = exact.search(q, k, metric, params, flt=flt)
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[0], want[0])
        atol = max(ATOL[dtype], 2e-3) if metric != "cosine_similarity" else ATOL[dtype]
        _assert_topk(got, ref.search(q, k, metric, params, flt=flt), atol,
                     metric in DESCENDING_METRICS, live)
    # the per-call override, both ways
    np.testing.assert_array_equal(exact.search(q, K, metric, params, approx=True)[1],
                                  mine.search(q, K, metric, params, approx=False)[1])


@pytest.mark.parametrize("descending", [True, False])
def test_approx_collective_on_ties(descending):
    """selector="approx" over a plane of exact ties at the candidate set's
    boundary keeps the lowest rows, as the exact selector does."""
    import torch

    from image_retrieval_tpu_torch.parallel.collectives import sharded_search_topk

    rng = np.random.default_rng(4)
    g = np.round(rng.normal(size=(600, 8)), 0).astype(np.float32)  # many equal rows
    g /= np.maximum(np.linalg.norm(g, axis=1, keepdims=True), 1e-6)
    q = torch.from_numpy(np.round(rng.normal(size=(3, 8)), 0).astype(np.float32))
    metric = "cosine_similarity" if descending else "l1_distance"
    args = (q, torch.from_numpy(g), torch.ones(600, dtype=torch.bool), torch.ones(600), 40,
            metric)
    av, ai = sharded_search_topk(*args, selector="approx")
    ev, ei = sharded_search_topk(*args)
    np.testing.assert_array_equal(ai.numpy(), ei.numpy())
    np.testing.assert_array_equal(av.numpy(), ev.numpy())
    with pytest.raises(ValueError, match="selector"):
        sharded_search_topk(*args, selector="hnsw")


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("weights", list(WEIGHTS))
def test_l1_shadow_matches_the_int8_scorer_and_jax(weights, filtered):
    """IndexConfig(l1_shadow=True) is accepted and builds no bf16 copy: the
    weighted answers are bit for bit those of the index without it (the
    int8 scorer) and the JAX index's with its shadow, also after a resync
    and on the streamed tier."""
    plain, _, q, emb = _pair("int8")
    cfg = IndexConfig(embedding_dim=D, dtype="int8", capacity_step=128, l1_shadow=True)
    mine = ShardedVectorIndex(dim=D, config=cfg, device="cpu")
    ref = JaxIndex(dim=D, config=cfg)
    for ix in (mine, ref):
        ix.insert([f"img/{i:03d}" for i in range(N)], emb, attrs={"bucket": np.arange(N) % 4})
        ix.delete_rows([20, 21])
    flt = FILTER if filtered else None
    got = mine.search(q, K, "optimized_similarity", WEIGHTS[weights], flt=flt)
    assert mine.config.l1_shadow and not hasattr(mine, "_shadow")
    want = plain.search(q, K, "optimized_similarity", WEIGHTS[weights], flt=flt)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))
    live = {i for i in set(range(N)) - {20, 21} if not filtered or i % 4 == 1}
    _assert_topk(got, ref.search(q, K, "optimized_similarity", WEIGHTS[weights], flt=flt),
                 ATOL["int8"], True, live)
    np.testing.assert_array_equal(mine.search(q, K, "l1_distance")[1],
                                  plain.search(q, K, "l1_distance")[1])
    for ix in (mine, ref):
        ix.insert(["late"], emb[:1])  # a resync
    _assert_topk(mine.search(q, K, "optimized_similarity", WEIGHTS[weights]),
                 ref.search(q, K, "optimized_similarity", WEIGHTS[weights]),
                 ATOL["int8"], True, set(range(N + 1)) - {20, 21})
    streamed = ShardedVectorIndex(dim=D, device="cpu", config=IndexConfig(
        embedding_dim=D, dtype="int8", l1_shadow=True, stream_threshold_bytes=1))
    streamed.insert(["a", "b"], emb[:2])
    assert streamed.search(emb[0], 1)[1][0] == 0 and streamed._stream is not None


# ---- the server and the searcher, FakeEncoder on both sides ------------------

TEXTS = ["a red car", "a blue boat", "a small dog", "an old house", "green tree", "wet cat"]


def _fake_stack(dtype):
    mine, ref, _, _ = _pair(dtype)
    return (FakeEncoder(dim=D), mine), (JaxFake(dim=D), ref)


def _mixed_batch(server):
    """Six requests enqueued together: two weight sets, a filter, plain
    cosine, an ascending metric and an unknown metric."""
    requests = [
        dict(query=TEXTS[0], metric="optimized_similarity", weights=WEIGHTS["reference"]),
        dict(query=TEXTS[1], metric="optimized_similarity", weights=WEIGHTS["all-live"]),
        dict(query=TEXTS[2], metric="optimized_similarity", weights=WEIGHTS["reference"],
             flt=FILTER),
        dict(query=TEXTS[3]),
        dict(query=TEXTS[4], metric="l1_distance", top_k=3),
        dict(query=TEXTS[5], metric="no_such_metric"),
    ]
    out = [None] * len(requests)

    def client(i):
        try:
            out[i] = server.search(timeout=120, **{"top_k": 5, **requests[i]})
        except Exception as e:
            out[i] = e

    server.start()
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        server.stop()
    return out


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_server_mixed_batch_matches_jax(dtype):
    (enc, mine), (jenc, ref) = _fake_stack(dtype)
    server = SearchServer(enc, mine, max_batch=8, max_wait_ms=200.0)
    got = _mixed_batch(server)
    # six distinct (metric, weights, filter) keys: one sweep each, the bad one counted too
    assert server.stats["groups"] == 6 and server.stats["requests"] == 6
    assert server.stats["batches"] < 6
    want = _mixed_batch(JaxServer(jenc, ref, max_batch=8, max_wait_ms=200.0))
    assert isinstance(got[5], Exception) and isinstance(want[5], Exception)  # only its group
    for g, w in zip(got[:5], want[:5]):
        assert isinstance(g, list), g
        assert [h["path"] for h in g] == [h["path"] for h in w]
        np.testing.assert_allclose([h["score"] for h in g], [h["score"] for h in w],
                                   rtol=0, atol=ATOL[dtype])
    assert len(got[4]) == 3 and got[4][0]["score"] <= got[4][1]["score"]  # ascending
    assert all(int(h["path"][4:]) % 4 == 1 for h in got[2])  # the filtered group
    # the two weight sets ranked differently scored requests
    assert [h["score"] for h in got[0]] != [h["score"] for h in got[1]]


def test_server_search_many_groups_and_short_filters():
    (enc, mine), (jenc, ref) = _fake_stack("float32")
    mask_expr = "bucket == 1 and bucket == 2"  # matches nothing
    with SearchServer(enc, mine, max_batch=8, max_wait_ms=50.0) as server, \
            JaxServer(jenc, ref, max_batch=8, max_wait_ms=50.0) as jserver:
        got = server.search_many(TEXTS[:4], top_k=4, metric="optimized_similarity",
                                 weights={"w_angle": 1.0, "w_mag": 0.25}, flt=FILTER)
        want = jserver.search_many(TEXTS[:4], top_k=4, metric="optimized_similarity",
                                   weights={"w_angle": 1.0, "w_mag": 0.25}, flt=FILTER)
        assert [[h["path"] for h in r] for r in got] == [[h["path"] for h in r] for r in want]
        assert server.search(TEXTS[0], flt=mask_expr) == []
        assert jserver.search(TEXTS[0], flt=mask_expr) == []
        assert server.stats["requests"] == 5
        assert server.stats["groups"] == server.stats["batches"]  # one key per batch


def test_optimized_requests_get_the_unnormalized_embedding():
    seen = []

    class Recording(ShardedVectorIndex):
        def search(self, queries, *args, **kwargs):
            seen.append((kwargs.get("metric"), np.linalg.norm(queries, axis=1)))
            return super().search(queries, *args, **kwargs)

    ix = Recording(dim=D, device="cpu")
    ix.insert(["a", "b", "c"], np.eye(3, D, dtype=np.float32) * 3.0)
    enc = FakeEncoder(dim=D)
    raw = np.linalg.norm(enc.encode_texts([TEXTS[0]]), axis=1)
    with SearchServer(enc, ix, max_wait_ms=1.0) as server:
        server.search(TEXTS[0], top_k=2)
        server.search(TEXTS[0], top_k=2, metric="optimized_similarity", weights={"w_mag": 1.0})
    assert seen[0][0] == "cosine_similarity" and seen[0][1] == pytest.approx(1.0, abs=1e-6)
    assert seen[1][0] == "optimized_similarity" and seen[1][1] == pytest.approx(raw, rel=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_searcher_multi_metric_analysis_matches_jax(dtype):
    (enc, mine), (jenc, ref) = _fake_stack(dtype)
    s_mine, s_ref = TextImageSearcher(enc, mine), JaxSearcher(jenc, ref)
    for s in (s_mine, s_ref):
        s.set_similarity_params(dict(WEIGHTS["reference"]))
    got = s_mine.search_with_multiple_metrics(TEXTS[0], top_k=4)
    want = s_ref.search_with_multiple_metrics(TEXTS[0], top_k=4)
    assert list(got) == list(want)
    for name in want:
        if name == "analysis":
            continue
        assert [h["path"] for h in got[name]] == [h["path"] for h in want[name]], name
        for g, w in zip(got[name], want[name]):
            assert g.keys() == w.keys()
            np.testing.assert_allclose([g[k] for k in g if k != "path"],
                                       [w[k] for k in w if k != "path"], rtol=0, atol=1e-6)
    for part in ("intersections", "unique_contributions"):
        assert got["analysis"][part].keys() == want["analysis"][part].keys()
        for key, w in want["analysis"][part].items():
            g = got["analysis"][part][key]
            assert {k: (sorted(v) if isinstance(v, list) else v) for k, v in g.items()} == \
                {k: (sorted(v) if isinstance(v, list) else v) for k, v in w.items()}
    cmp_got = s_mine.compare_search_methods(TEXTS[1], top_k=3)
    cmp_want = s_ref.compare_search_methods(TEXTS[1], top_k=3)
    for key in ("standard_results", "optimized_results"):
        assert [h["path"] for h in cmp_got[key]] == [h["path"] for h in cmp_want[key]]
    assert cmp_got["metrics"]["intersection_size"] == cmp_want["metrics"]["intersection_size"]
