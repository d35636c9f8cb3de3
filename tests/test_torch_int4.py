"""The port's quantized tiers (bf16, int8, int4 two-phase) and the int4
screen held against the JAX package on the same numpy inputs.

The JAX screen kernel runs as the JAX package's own tests run it on the
CPU: ``int4_screen_scores_pallas`` in interpret mode at D = 512 with N a
multiple of 256, ``unpack2_dots * scales`` elsewhere. On the CPU the port's
``int4_screen_scores`` takes its plain version, so these tests hold the
semantics; tests/test_torch_gpu.py holds the Hopper kernel to the plain
version on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.config import IndexConfig
from image_retrieval_tpu.index.vector_index import ShardedVectorIndex as JaxIndex
from image_retrieval_tpu.ops import int4 as jint4
from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.ops import int4
from image_retrieval_tpu_torch.ops import int4_screen as k3
from image_retrieval_tpu_torch.ops.topk import exact_topk, exact_topk_wide


def _unit_rows(rng, n, d):
    rows = rng.normal(size=(n, d)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def _bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)


# -- host quantization: bitwise ----------------------------------------------


@pytest.mark.parametrize("n,d", [(33, 64), (20, 512), (9, 30)])
def test_quantize_pack_unpack_bitwise_equal_jax(n, d):
    rng = np.random.default_rng(d)
    rows = rng.normal(size=(n, d)).astype(np.float32) * rng.uniform(0.1, 3, size=(n, 1))
    rows[0] = 0.0  # zero row: scale 0, nibbles +8
    pk, sc = int4.quantize_pack_int4(rows)
    jpk, jsc = jint4.quantize_pack_int4(rows)
    assert pk.dtype == np.uint8 and pk.shape == (n, d // 2)
    np.testing.assert_array_equal(pk, jpk)
    np.testing.assert_array_equal(sc.view(np.uint32), jsc.view(np.uint32))
    q4 = rng.integers(-8, 8, size=(n, d)).astype(np.int8)
    np.testing.assert_array_equal(int4.pack_nibbles(q4), jint4.pack_nibbles(q4))
    np.testing.assert_array_equal(int4.unpack_nibbles(pk), jint4.unpack_nibbles(pk))
    assert (int4.unpack_nibbles(int4.pack_nibbles(q4)) == q4).all()
    # nibble order: lo = even dim, hi = odd dim, +8 bias
    assert int4.pack_nibbles(np.array([[-8, 7]], np.int8))[0, 0] == 0xF0


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "int4"])
def test_insert_quantization_bitwise_equal_jax(dtype):
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(70, 64)).astype(np.float32) * 4.0
    emb[5] = 0.0
    cfg = IndexConfig(embedding_dim=64, dtype=dtype, capacity_step=64)
    mine, ref = ShardedVectorIndex(dim=64, config=cfg, device="cpu"), JaxIndex(dim=64, config=cfg)
    for ix in (mine, ref):
        ix.insert([str(i) for i in range(50)], emb[:50])
        ix.insert([str(i) for i in range(50, 70)], emb[50:] / np.linalg.norm(
            emb[50:], axis=1, keepdims=True), np.linalg.norm(emb[50:], axis=1))
    n = 70
    if dtype == "bfloat16":
        np.testing.assert_array_equal(mine._host_gallery[:n],
                                      ref._host_gallery[:n].view(np.uint16))
    else:
        np.testing.assert_array_equal(mine._host_gallery[:n], ref._host_gallery[:n])
        np.testing.assert_array_equal(mine._host_scales[:n].view(np.uint32),
                                      ref._host_scales[:n].view(np.uint32))
    if dtype == "int4":
        np.testing.assert_array_equal(mine._host_packed[:n], ref._host_packed[:n])
        np.testing.assert_array_equal(mine._host_scales4[:n], ref._host_scales4[:n])
    idx = [0, 5, 49, 50, 69]
    np.testing.assert_array_equal(mine.get_vectors(idx), ref.get_vectors(idx))
    got, want = mine.query(limit=7), ref.query(limit=7)
    assert [p for p, _ in got] == [p for p, _ in want]
    np.testing.assert_array_equal(np.stack([e for _, e in got]), np.stack([e for _, e in want]))


def test_threaded_insert_quantization_bitwise_equal_jax():
    """An insert larger than QUANT_ROWS is quantized in row blocks on
    several threads: the bits equal the JAX index's whole-batch numpy."""
    from image_retrieval_tpu_torch.index.vector_index import QUANT_ROWS

    rng = np.random.default_rng(6)
    n, d = 2 * QUANT_ROWS + 5, 6
    emb = rng.normal(size=(n, d)).astype(np.float32)
    cfg = IndexConfig(embedding_dim=d, dtype="int4", capacity_step=1 << 18)
    mine, ref = ShardedVectorIndex(dim=d, config=cfg, device="cpu"), JaxIndex(dim=d, config=cfg)
    for ix in (mine, ref):
        ix.insert(["x"] * 3, emb[:3])  # the threaded batch starts mid-buffer
        ix.insert(["p"] * (n - 3), emb[3:])
    for name in ("_host_gallery", "_host_scales", "_host_packed", "_host_scales4"):
        np.testing.assert_array_equal(getattr(mine, name), getattr(ref, name))


# -- the screen's plain version vs the JAX screen ----------------------------


@pytest.mark.parametrize("n,d", [(512, 512), (300, 64), (257, 40), (100, 768)])
def test_plain_screen_scores_match_jax(n, d):
    rng = np.random.default_rng(n + d)
    pk, sc = int4.quantize_pack_int4(_unit_rows(rng, n, d))
    q = _unit_rows(rng, 5, d)
    q[2] = 0.0
    qb = _bf16(q)
    qj = jnp.asarray(q, jnp.bfloat16)
    if d == 512 and n % 256 == 0:
        from image_retrieval_tpu.ops.pallas_kernels import (
            int4_screen_scores_pallas,
            pack_words_paired,
        )

        want = np.asarray(int4_screen_scores_pallas(
            qj, jnp.asarray(pack_words_paired(pk)), jnp.asarray(sc), block_n=128))
    else:
        want = np.asarray(jint4.unpack2_dots(qj, jnp.asarray(pk))) * sc
    valid = torch.ones(n, dtype=torch.bool)
    got = k3.int4_screen_scores(qb, torch.from_numpy(pk), torch.from_numpy(sc), valid)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[2].numpy(), np.zeros(n, np.float32))
    raw = int4.unpack2_dots(qb, torch.from_numpy(pk)).numpy()
    np.testing.assert_allclose(raw, np.asarray(jint4.unpack2_dots(qj, jnp.asarray(pk))),
                               rtol=0, atol=1e-5)


def test_screen_segments_and_mask():
    """A segment of the plain screen equals the matching columns of the
    whole plane, and invalid rows score -inf."""
    rng = np.random.default_rng(1)
    pk, sc = int4.quantize_pack_int4(_unit_rows(rng, 200, 64))
    valid = torch.from_numpy(rng.random(200) > 0.3)
    qb = _bf16(_unit_rows(rng, 3, 64))
    full = k3.int4_screen_scores(qb, torch.from_numpy(pk), torch.from_numpy(sc), valid)
    part = k3.int4_screen_scores(qb, torch.from_numpy(pk), torch.from_numpy(sc), valid, 37, 101)
    assert torch.equal(part, full[:, 37:138])
    assert torch.equal(torch.isinf(full[0]), ~valid)
    with pytest.raises(ValueError, match="outside"):
        k3.int4_screen_scores(qb, torch.from_numpy(pk), torch.from_numpy(sc), valid, 150, 51)


@pytest.mark.parametrize("block", [64, 1 << 21])
def test_screen_topc_matches_jax(block):
    rng = np.random.default_rng(block % 97)
    n, d, c = 450, 64, 40
    pk, sc = int4.quantize_pack_int4(_unit_rows(rng, n, d))
    valid = rng.random(n) > 0.2
    q = _unit_rows(rng, 4, d)
    jv, ji = jint4.screen_int4_topc(jnp.asarray(q, jnp.bfloat16), jnp.asarray(pk),
                                    jnp.asarray(sc), jnp.asarray(valid), c, block=block)
    args = (_bf16(q), torch.from_numpy(pk), torch.from_numpy(sc), torch.from_numpy(valid), c)
    for tv, ti in (int4.screen_int4_topc(*args, block=block),
                   k3.int4_screen_topc(*args, seg_rows=block)):
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-5)


def test_rerank_int8_topk_matches_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(3, 32)).astype(np.float32)
    q[1] = 0.0
    rows = rng.integers(-127, 128, size=(3, 20, 32)).astype(np.int8)
    rows[0, 7] = rows[0, 2]  # an exact tie: the lower position first
    scales = rng.uniform(0.005, 0.01, size=(3, 20)).astype(np.float32)
    scales[0, 7] = scales[0, 2]
    ok = rng.random((3, 20)) > 0.2
    ok[0, [2, 7]] = True
    jv, jp = jint4.rerank_int8_topk(jnp.asarray(q), jnp.asarray(rows), jnp.asarray(scales),
                                    jnp.asarray(ok), 8)
    tv, tp = int4.rerank_int8_topk(torch.from_numpy(q), torch.from_numpy(rows),
                                   torch.from_numpy(scales), torch.from_numpy(ok), 8)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)


def _broken_screen(qu, packed, scales, valid, *, swap=False, drop_scale=False):
    """The plain screen with one fault planted."""
    q = qu.to(torch.float32)
    lo = ((packed & 0xF).to(torch.int16) - 8).to(torch.float32)
    hi = ((packed >> 4).to(torch.int16) - 8).to(torch.float32)
    if swap:
        lo, hi = hi, lo
    s = q[:, 0::2] @ lo.t() + q[:, 1::2] @ hi.t()
    if not drop_scale:
        s = s * scales
    return s.masked_fill(~valid, float("-inf"))


@pytest.mark.parametrize("fault", ["swap", "drop_scale"])
def test_screen_agreement_catches_planted_faults(fault):
    """The kernel-vs-plain limit (SCREEN_MAX_ABS) and the top-c comparison
    chip_smoke.py applies reject a screen with the nibble order swapped or
    the row scale dropped, at D = 64."""
    rng = np.random.default_rng(8)
    n, d, c = 2000, 64, 128
    pk, sc = (torch.from_numpy(a) for a in int4.quantize_pack_int4(_unit_rows(rng, n, d)))
    valid = torch.from_numpy(rng.random(n) > 0.01)
    qu = _bf16(_unit_rows(rng, 8, d))
    want = k3.int4_screen_scores_reference(qu, pk, sc, valid)
    bad = _broken_screen(qu, pk, sc, valid, swap=fault == "swap",
                         drop_scale=fault == "drop_scale")
    fin = torch.isfinite(want)
    assert float((bad[fin] - want[fin]).abs().max()) > 100 * k3.SCREEN_MAX_ABS
    _, want_i = exact_topk_wide(want, c)
    _, bad_i = exact_topk_wide(bad, c)
    for w, b in zip(want_i.tolist(), bad_i.tolist()):
        assert set(w) != set(b)
    # the planted faults are not an artifact of the plain version itself
    again = _broken_screen(qu, pk, sc, valid)
    assert float((again[fin] - want[fin]).abs().max()) <= k3.SCREEN_MAX_ABS


# -- the wide-plane selection ------------------------------------------------


@pytest.mark.parametrize("k", [1, 7, 50, 128])
@pytest.mark.parametrize("descending", [True, False])
def test_exact_topk_wide_equals_exact_topk_on_ties(k, descending):
    rng = np.random.default_rng(k)
    s = np.round(rng.normal(size=(6, 3000)), 1).astype(np.float32)  # ~60 values: ties everywhere
    s[1] = 0.5  # one value across the whole row
    s[2, ::3] = -np.inf if descending else np.inf  # masked rows
    s[3, 10:] = -np.inf if descending else np.inf  # fewer finite scores than k
    s[4, 2000:] = s[4, :1000]  # duplicated columns
    st = torch.from_numpy(s)
    wv, wi = exact_topk(st, k, descending)
    gv, gi = exact_topk_wide(st, k, descending)
    assert torch.equal(gi, wi) and torch.equal(gv, wv)


# -- the index tiers vs the JAX index ----------------------------------------


@pytest.mark.parametrize("d", [64, 512])
@pytest.mark.parametrize("tier", ["float32", "bfloat16", "int8", "int4", "int4_device"])
def test_index_tiers_match_jax(tier, d):
    """Tombstones, a filter that matches fewer rows than top_k, a 1-D and a
    zero query: identical ids and scores within 1e-6. rerank_c covers every
    live row, so the int4 screen keeps them all and the ranking is exact.
    At D = 512 the JAX int4 tier runs its Pallas kernel (interpret mode)."""
    rng = np.random.default_rng(d)
    n = 300
    emb = rng.normal(size=(n, d)).astype(np.float32) * rng.uniform(0.5, 4, size=(n, 1))
    emb[9] = emb[4] * 2.0  # an exact tie with row 4
    paths = [f"p{i}" for i in range(n)]
    attrs = {"grp": ["hi" if i >= 260 else "lo" for i in range(n)], "views": np.arange(n)}
    dtype, dev_rerank = tier.split("_")[0], tier.endswith("_device")
    cfg = IndexConfig(embedding_dim=d, dtype=dtype, rerank_c=512, capacity_step=2048,
                      rerank_device=dev_rerank)
    mine, ref = ShardedVectorIndex(dim=d, config=cfg, device="cpu"), JaxIndex(dim=d, config=cfg)
    for ix in (mine, ref):
        ix.insert(paths, emb, attrs=attrs)
        ix.delete(paths[::7])
        ix.delete_where("views >= 290")
    q = np.concatenate([emb[4:5], rng.normal(size=(3, d)).astype(np.float32),
                        np.zeros((1, d), np.float32)])
    for args in ((q, 12, None), (q[1], 12, None), (q, 30, "grp == 'hi' and views < 280"),
                 (q[2], 5, "grp == 'lo'")):
        got_v, got_i = mine.search(args[0], top_k=args[1], flt=args[2])
        want_v, want_i = ref.search(args[0], top_k=args[1], flt=args[2])
        if dev_rerank and args[0].ndim == 2:
            # The zero query ties every row at 0. JAX's latency mode keeps
            # its per-shard screen order among ties, and approx_max_k inside
            # that jit does not give the lowest index first; the index's
            # contract (ties by ascending row) is what the port keeps.
            live = np.flatnonzero(mine.filter_mask(args[2]) if args[2] else mine.live_mask())
            want_i[-1] = np.pad(live[: args[1]], (0, max(args[1] - len(live), 0)),
                                constant_values=-1)
        assert got_i.shape == want_i.shape and got_i.dtype == np.int32
        np.testing.assert_array_equal(got_i, want_i)
        fin = np.isfinite(want_v)
        np.testing.assert_array_equal(np.isfinite(got_v), fin)
        np.testing.assert_allclose(got_v[fin], want_v[fin], rtol=0, atol=1e-6)
    v, i = mine.search(q, top_k=12)
    assert list(i[0, :2]) == [4, 9]  # the tie, lower row first
    np.testing.assert_array_equal(v[-1], np.zeros(12, np.float32))  # zero query
    v, i = mine.search(q[0], top_k=30, flt="grp == 'hi' and views < 280")
    live_hi = [r for r in range(260, 280) if r % 7]
    assert sorted(i[i >= 0]) == live_hi and (i[len(live_hi):] == -1).all()


@pytest.fixture
def trio():
    """int4 / int8 / f32 port indexes over the same 4096 rows."""
    rng = np.random.default_rng(7)
    n, d = 4096, 64
    emb = rng.normal(size=(n, d)).astype(np.float32)
    paths = [f"p{i}.jpg" for i in range(n)]
    mk = lambda dt: ShardedVectorIndex(
        dim=d, config=IndexConfig(embedding_dim=d, dtype=dt, rerank_c=64), device="cpu")
    i4, i8, f32 = mk("int4"), mk("int8"), mk("float32")
    for ix in (i4, i8, f32):
        ix.insert(paths, emb)
    return i4, i8, f32, emb


def test_int4_two_phase_recall_and_score_parity(trio):
    i4, i8, f32, emb = trio
    rng = np.random.default_rng(17)
    q = rng.normal(size=(4, emb.shape[1])).astype(np.float32)
    v4, idx4 = i4.search(q, top_k=10)
    v8, idx8 = i8.search(q, top_k=10)
    _, idxf = f32.search(q, top_k=10)
    for ref in (idx8, idxf):
        assert np.mean([len(set(a) & set(b)) / 10 for a, b in zip(idx4, ref)]) >= 0.9
    # phase 2 is the resident int8 sweep's math: equal scores for shared rows
    for r in range(len(q)):
        m8 = {int(i): float(v) for i, v in zip(idx8[r], v8[r])}
        for i, v in zip(idx4[r], v4[r]):
            if int(i) in m8:
                assert abs(m8[int(i)] - float(v)) < 1e-6
    # the same two-phase search as the JAX tier, screen of 64 out of 4096
    ref = JaxIndex(dim=64, config=IndexConfig(embedding_dim=64, dtype="int4", rerank_c=64))
    ref.insert(i4.paths, emb)
    jv, ji = ref.search(q, top_k=10)
    np.testing.assert_array_equal(idx4, ji)
    np.testing.assert_allclose(v4, jv, rtol=0, atol=1e-6)


def test_int4_single_query_and_filters(trio):
    i4, _, _, emb = trio
    d = emb.shape[1]
    q = np.random.default_rng(18).normal(size=d).astype(np.float32)
    v, i = i4.search(q, top_k=5)
    assert v.shape == (5,) and i.shape == (5,)
    for dev_rerank in (False, True):
        idx = ShardedVectorIndex(dim=d, config=IndexConfig(
            embedding_dim=d, dtype="int4", rerank_device=dev_rerank), device="cpu")
        idx.insert([f"x{i}" for i in range(100)], emb[:100],
                   attrs={"grp": ["a"] * 50 + ["b"] * 50})
        vv, ii = idx.search(q, top_k=60, flt="grp == 'a'")
        ok = np.isfinite(vv)
        assert ok.sum() == 50
        assert (ii[ok] < 50).all() and (ii[~ok] == -1).all()
        mask = np.arange(100) % 10 == 0  # a precomputed mask works too
        vv, ii = idx.search(q, top_k=20, flt=mask)
        assert sorted(ii[ii >= 0]) == list(range(0, 100, 10)) and (ii[10:] == -1).all()


def test_int4_fully_tombstoned():
    rng = np.random.default_rng(19)
    idx = ShardedVectorIndex(dim=32, config=IndexConfig(embedding_dim=32, dtype="int4"),
                             device="cpu")
    idx.insert(["a", "b"], _unit_rows(rng, 2, 32))
    idx.delete(["a", "b"])
    v, i = idx.search(rng.normal(size=32).astype(np.float32), top_k=3)
    assert v.shape == (0,) and i.shape == (0,)


def test_int4_rejects_non_cosine_and_matrix_apis(trio):
    i4, _, _, emb = trio
    q = np.random.default_rng(20).normal(size=emb.shape[1]).astype(np.float32)
    with pytest.raises(ValueError, match="cosine"):
        i4.search(q, top_k=5, metric="l2_distance")
    with pytest.raises(ValueError, match="int4"):
        i4.multi_metric_topk(q, top_k=5)
    with pytest.raises(ValueError, match="int4"):
        i4.scores(q)
    v, i = i4.search(q, top_k=5, metric="cosine")  # the alias every tier takes
    assert i.shape == (5,)


@pytest.mark.parametrize("dtype", ["int4", "int8", "bfloat16"])
def test_compact_keeps_paths_and_matches_jax(dtype):
    rng = np.random.default_rng(21)
    n, d = 400, 64
    emb = rng.normal(size=(n, d)).astype(np.float32)
    paths = [f"p{i}.jpg" for i in range(n)]
    cfg = IndexConfig(embedding_dim=d, dtype=dtype, rerank_c=512, capacity_step=256)
    mine, ref = ShardedVectorIndex(dim=d, config=cfg, device="cpu"), JaxIndex(dim=d, config=cfg)
    attrs = {"grp": [i % 3 for i in range(n)]}
    for ix in (mine, ref):
        ix.insert(paths, emb, attrs=attrs)
        ix.delete(paths[:100])
    q = rng.normal(size=(2, d)).astype(np.float32)
    before = mine.search(q, top_k=10)
    gen = mine.generation
    assert mine.live_count == ref.live_count == 300 and len(mine) == 400
    assert mine.compact() == ref.compact() == 100
    assert mine.generation > gen and mine.live_mask().all() and len(mine) == 300
    assert mine.live_count == 300
    after = mine.search(q, top_k=10)
    for r in range(2):  # compaction renumbers rows; the paths stay
        assert ([mine.paths[int(i)] for i in after[1][r]]
                == [f"p{int(i)}.jpg" for i in before[1][r]])
        np.testing.assert_allclose(after[0][r], before[0][r], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(after[1], ref.search(q, top_k=10)[1])
    np.testing.assert_array_equal(mine.filter_mask("grp == 1"), ref.filter_mask("grp == 1"))
    assert mine.delete_where("grp == 0") == 100 and mine.live_count == 200
