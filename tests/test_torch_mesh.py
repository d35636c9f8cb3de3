"""The port's device mesh and its row-sharded search, on an 8-shard CPU mesh.

Every collective of ``parallel/collectives.py`` over a mesh of eight virtual
CPU devices is held against the JAX function on the conftest's 8-device
virtual mesh with the same numpy inputs, at the tolerance of that function's
one-device parity test (``tests/test_torch_multimetric.py``'s ATOL: 1e-5 for
f32 and bf16 rows, 2e-3 where the int8 weighted score or the Gram-form L2
meets a self-match; the int4 screen 1e-6 as in ``tests/test_torch_int4.py``),
ids identical wherever the JAX scores of neighbouring ranks differ by more;
and against the port's own one-device answer within 1e-6 (ONE_DEVICE_ATOL:
the CPU's BLAS may order a dot product's sum by the shape of the block it is
given, so eight blocks of rows are not always bitwise one block), ids
identical in the same sense. Then the index on
a mesh against the JAX index on its mesh and against itself on one device,
a save reopened on other meshes, the make_mesh rules and the app on a mesh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from image_retrieval_tpu.config import IndexConfig
from image_retrieval_tpu.config import MeshConfig as JaxMeshConfig
from image_retrieval_tpu.index.vector_index import ShardedVectorIndex as JaxIndex
from image_retrieval_tpu.parallel import collectives as jcol
from image_retrieval_tpu.parallel.mesh import make_mesh as jax_make_mesh
from image_retrieval_tpu.parallel.mesh import shard_rows as jax_shard_rows
from image_retrieval_tpu_torch.config import MeshConfig
from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.ops.int4 import quantize_pack_int4
from image_retrieval_tpu_torch.ops.topk import DESCENDING_METRICS
from image_retrieval_tpu_torch.parallel import collectives as col
from image_retrieval_tpu_torch.parallel.mesh import (
    Mesh,
    entry_mesh,
    make_mesh,
    replicate,
    shard_devices,
    shard_rows,
)

N, D, K = 512, 32, 10
REF = (1.0, 1.0, 1.0, 0.0, 0.5)
ATOL = {"float32": 1e-5, "bfloat16": 1e-5, "int8": 1e-5}
WEIGHTED_INT8_ATOL = 2e-3  # bf16 differences of the int8 weighted score
ONE_DEVICE_ATOL = 1e-6  # eight shards against one device (module docstring)


def cpu_mesh(n=8):
    return make_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def m8():
    return cpu_mesh()


@pytest.fixture(scope="module")
def jm8():
    return jax_make_mesh(JaxMeshConfig(data=8, model=1))


def quantize_int8(unit):
    grid = np.maximum(np.abs(unit).max(1), 1e-12) / 127.0
    rows = np.clip(np.rint(unit / grid[:, None]), -127, 127).astype(np.int8)
    scales = (np.linalg.norm(unit, axis=1)
              / np.linalg.norm(rows.astype(np.float32), axis=1)).astype(np.float32)
    return rows, scales


@pytest.fixture(scope="module")
def data():
    """Unit rows with magnitudes in [0.5, 4], an exact tie (row 9 = row 4),
    tombstones (every 7th row), queries with one equal to a row."""
    rng = np.random.default_rng(3)
    emb = rng.normal(size=(N, D)).astype(np.float32) * rng.uniform(0.5, 4, (N, 1)).astype(
        np.float32)
    emb[9] = emb[4]
    mags = np.linalg.norm(emb, axis=1).astype(np.float32)
    unit = (emb / mags[:, None]).astype(np.float32)
    valid = np.ones(N, bool)
    valid[::7] = False
    q = np.concatenate([emb[4:5], rng.normal(size=(3, D)).astype(np.float32)])
    return unit, mags, valid, q


def assert_topk(got, want, atol, descending):
    """Scores within atol; ids equal wherever the reference's neighbouring
    ranks differ by more than 2 atol; padding (+-inf) in the same places."""
    gv, gi = (np.asarray(a) for a in got)
    wv, wi = (np.asarray(a) for a in want)
    assert gv.shape == wv.shape
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    np.testing.assert_array_equal(gv[~fin], wv[~fin])
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=0, atol=atol)
    for r in range(gv.shape[0]):
        for c in np.flatnonzero((gi[r] != wi[r]) & fin[r]):
            near = [abs(wv[r, c] - wv[r, o]) for o in (c - 1, c + 1)
                    if 0 <= o < gv.shape[1] and fin[r, o]]
            assert near and min(near) <= 2 * atol, (r, c, gi[r], wi[r])
        order = np.diff(gv[r][fin[r]])
        assert (order <= 0).all() if descending else (order >= 0).all()


def assert_same(got, want, descending=True):
    """The sharded answer against the one-device answer."""
    assert_topk(got, want, ONE_DEVICE_ATOL, descending)


def tier_rows(data, tier):
    """(port rows, port scales, JAX rows, JAX scales) of a tier."""
    unit = data[0]
    if tier == "int8":
        rows, sc = quantize_int8(unit)
        return torch.from_numpy(rows), torch.from_numpy(sc), jnp.asarray(rows), jnp.asarray(sc)
    if tier == "bfloat16":
        t = torch.from_numpy(unit).to(torch.bfloat16)
        return t, None, jnp.asarray(unit).astype(jnp.bfloat16), None
    return torch.from_numpy(unit), None, jnp.asarray(unit), None


# -- make_mesh and the helpers ---------------------------------------------------


def test_make_mesh_rules():
    m = make_mesh(MeshConfig(data=-1, model=2), devices=["cpu"] * 8)
    assert m.axis_names == ("data", "model") and m.shape == {"data": 4, "model": 2}
    assert m.devices.size == 8 and m.first == torch.device("cpu") and m.distinct() == [m.first]
    assert make_mesh(MeshConfig(data=3), devices=["cpu"] * 8).shape == {"data": 3, "model": 1}
    with pytest.raises(ValueError, match="needs"):  # JAX tests/test_index.py:345
        make_mesh(MeshConfig(data=-1, model=1024), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="needs 16 devices, have 8"):
        make_mesh(MeshConfig(data=16), devices=["cpu"] * 8)
    with pytest.raises(ValueError, match="unsupported device"):
        make_mesh(devices=["meta"])


def test_no_card_raises_instead_of_the_cpu():
    """The entry points span every visible card by default and never fall
    back to the CPU."""
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for make in (make_mesh, lambda: ShardedVectorIndex(dim=8), lambda: CLIPEncoder(),
                 lambda: entry_mesh(None, None)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    with pytest.raises(ValueError, match="not both"):
        ShardedVectorIndex(dim=8, device="cpu", mesh=cpu_mesh())


def test_shard_helpers_order_and_devices():
    grid = np.empty((2, 4), dtype=object)
    grid[:] = "cpu"
    sliced = Mesh(grid, ("slice", "data"))
    assert sliced.shape == {"slice": 2, "data": 4}
    assert len(shard_devices(sliced, ("slice", "data"))) == 8
    assert len(shard_devices(sliced, "data")) == 4
    x = np.arange(16 * 3).reshape(16, 3)
    parts = shard_rows(x, sliced, ("slice", "data"))
    assert [p[0, 0].item() for p in parts] == list(range(0, 48, 6))
    assert torch.equal(torch.cat(parts), torch.from_numpy(x))
    with pytest.raises(ValueError, match="do not split"):
        shard_rows(x[:15], sliced, ("slice", "data"))
    copies = replicate(x, sliced)
    assert list(copies) == [torch.device("cpu")]
    assert entry_mesh("cpu", None).shape == {"data": 1, "model": 1}


# -- the collectives against JAX and against one device -------------------------

SEARCH_CASES = [
    ("float32", "cosine_similarity", None),
    ("float32", "l2_distance", None),
    ("float32", "optimized_similarity", REF),
    ("bfloat16", "cosine_similarity", None),
    ("bfloat16", "l1_distance", None),
    ("int8", "cosine_similarity", None),
    ("int8", "optimized_similarity", REF),
]


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("tier,metric,weights", SEARCH_CASES)
def test_sharded_search_topk(data, m8, jm8, tier, metric, weights, filtered):
    unit, mags, valid, q = data
    if filtered:  # 4 live rows for k = 10: (+-inf, any index) padding
        valid = np.zeros(N, bool)
        valid[[5, 200, 201, 480]] = True
    g, sc, jg, jsc = tier_rows(data, tier)
    got = col.sharded_search_topk(torch.from_numpy(q), g, torch.from_numpy(valid),
                                  torch.from_numpy(mags), K, metric, weights, sc, mesh=m8)
    one = col.sharded_search_topk(torch.from_numpy(q), g, torch.from_numpy(valid),
                                  torch.from_numpy(mags), K, metric, weights, sc)
    descending = metric in DESCENDING_METRICS
    if filtered:  # the padding's index is arbitrary on both sides
        gv, gi, ov, oi = (t.numpy() for t in (*got, *one))
        assert_same((gv, np.where(np.isfinite(gv), gi, -1)),
                    (ov, np.where(np.isfinite(ov), oi, -1)), descending)
    else:
        assert_same(got, one, descending)
    want = jcol.sharded_search_topk(
        jnp.asarray(q), jax_shard_rows(jg, jm8), jax_shard_rows(jnp.asarray(valid), jm8),
        jax_shard_rows(jnp.asarray(mags), jm8), K, metric, weights,
        None if jsc is None else jax_shard_rows(jsc, jm8), mesh=jm8)
    atol = ATOL[tier]
    if (tier == "int8" and weights) or metric == "l2_distance" or weights:
        atol = WEIGHTED_INT8_ATOL  # query 0 equals row 4: the Gram-form L2 at 0
    if filtered:  # the padding's index is arbitrary: compare the live part
        live = np.isfinite(np.asarray(want[0]))
        assert live.sum(1).tolist() == [4] * len(q)
        got = (got[0].numpy(), np.where(live, got[1].numpy(), -1))
        want = (np.asarray(want[0]), np.where(live, np.asarray(want[1]), -1))
    assert_topk(got, want, atol, descending)
    if not filtered and descending:
        assert got[1][0, :2].tolist() == [4, 9]  # the tie, the lower global row first


@pytest.mark.parametrize("tier", ["float32", "int8"])
def test_sharded_multimetric_topk(data, m8, jm8, tier):
    unit, mags, valid, q = data
    g, sc, jg, jsc = tier_rows(data, tier)
    args = (torch.from_numpy(q), g, torch.from_numpy(valid), torch.from_numpy(mags), K, sc)
    got = col.sharded_multimetric_topk(*args, mesh=m8)
    one = col.sharded_multimetric_topk(*args)
    want = jcol.sharded_multimetric_topk(
        jnp.asarray(q), jax_shard_rows(jg, jm8), jax_shard_rows(jnp.asarray(valid), jm8),
        jax_shard_rows(jnp.asarray(mags), jm8), K,
        None if jsc is None else jax_shard_rows(jsc, jm8), mesh=jm8)
    assert set(got) == set(want)
    for name in got:
        assert_same(got[name], one[name], name in DESCENDING_METRICS)
        atol = 2e-3 if name == "l2_distance" else 1e-5
        assert_topk(got[name], want[name], atol, name in DESCENDING_METRICS)


@pytest.mark.parametrize("tier,metric,weights", [
    ("float32", "cosine_similarity", None), ("float32", "linf_distance", None),
    ("float32", "optimized_similarity", REF), ("int8", "l1_distance", None)])
def test_sharded_scores(data, m8, jm8, tier, metric, weights):
    unit, mags, valid, q = data
    g, sc, jg, jsc = tier_rows(data, tier)
    got = col.sharded_scores(torch.from_numpy(q), g, torch.from_numpy(mags), metric, weights,
                             sc, mesh=m8)
    assert got.shape == (len(q), N)
    np.testing.assert_allclose(
        got.numpy(),
        col.sharded_scores(torch.from_numpy(q), g, torch.from_numpy(mags), metric, weights,
                           sc).numpy(), rtol=0, atol=ONE_DEVICE_ATOL)
    want = jcol.sharded_scores(jnp.asarray(q), jax_shard_rows(jg, jm8),
                               jax_shard_rows(jnp.asarray(mags), jm8), metric, weights,
                               None if jsc is None else jax_shard_rows(jsc, jm8), mesh=jm8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_sharded_int4_screen_and_two_phase(data, m8, jm8):
    """The screen (K3's plain version on each shard) against the JAX XLA
    screen on its mesh; the two-phase search against one device when the
    pool covers every row (c a shard is then every row of it)."""
    unit, _, valid, q = data
    packed, sc4 = quantize_pack_int4(unit)
    rows8, sc8 = quantize_int8(unit)
    t = torch.from_numpy
    got = col.sharded_int4_screen_topk(t(q), t(packed), t(valid), t(sc4), 24, mesh=m8)
    want = jcol.sharded_int4_screen_topk(
        jnp.asarray(q), jax_shard_rows(jnp.asarray(packed), jm8),
        jax_shard_rows(jnp.asarray(valid), jm8), jax_shard_rows(jnp.asarray(sc4), jm8), 24,
        mesh=jm8)
    assert_topk(got, want, 1e-6, True)
    one = col.sharded_int4_screen_topk(t(q), t(packed), t(valid), t(sc4), 24)
    assert_same(got, one)
    args = (t(q), t(packed), t(valid), t(sc4), t(rows8), t(sc8), N, K)
    assert_same(col.sharded_int4_two_phase_topk(*args, mesh=m8),
                col.sharded_int4_two_phase_topk(*args))
    # a pool of 8 a shard: 64 candidates in all, each shard's exact top-8
    v, i = col.sharded_int4_two_phase_topk(*args[:6], 8, K, mesh=m8)
    assert i.shape == (len(q), K) and (np.diff(v.numpy(), axis=1) <= 0).all()


def test_merge_rows_of_lists_without_a_mesh(data, m8):
    """Shards as lists: without a mesh the merge is flat over the list."""
    unit, mags, valid, q = data
    shards = shard_rows(unit, m8)
    got = col.sharded_search_topk(torch.from_numpy(q), shards, shard_rows(valid, m8),
                                  shard_rows(mags, m8), K)
    assert_same(got, col.sharded_search_topk(torch.from_numpy(q), torch.from_numpy(unit),
                                             torch.from_numpy(valid), torch.from_numpy(mags), K))
    with pytest.raises(ValueError, match="3 shards for 8 devices"):
        col.sharded_search_topk(torch.from_numpy(q), shards, shard_rows(valid, m8)[:3], None, K)


# -- the index ----------------------------------------------------------------------

TIERS = ("float32", "bfloat16", "int8", "int4", "int4_device")
WEIGHT_PARAMS = {"w_angle": 1.0, "w_l1": 1.0, "w_l2": 1.0, "w_inf": 0.0, "w_mag": 0.5}


def _cfg(tier, d=D):
    dtype = tier.split("_")[0]
    return IndexConfig(embedding_dim=d, dtype=dtype, capacity_step=64, rerank_c=1024,
                       rerank_device=tier.endswith("_device"))


_indexes = {}


def _trio(tier, data):
    """The same rows, tombstones and attributes in the port's index on eight
    CPU shards, on one CPU device, and in the JAX index on its 8-device
    mesh. 203 rows: the last shard is part padding."""
    if tier not in _indexes:
        unit, mags, _, _ = data
        emb = unit[:203] * mags[:203, None]
        paths = [f"p{i}" for i in range(203)]
        ix8 = ShardedVectorIndex(dim=D, config=_cfg(tier), mesh=cpu_mesh())
        ix1 = ShardedVectorIndex(dim=D, config=_cfg(tier), device="cpu")
        ref = JaxIndex(dim=D, config=_cfg(tier))
        for ix in (ix8, ix1, ref):
            ix.insert(paths, emb, attrs={"b": np.arange(203) % 4})
            ix.delete(paths[::11])
        _indexes[tier] = ix8, ix1, ref
    return _indexes[tier]


@pytest.mark.parametrize("tier", TIERS)
def test_index_on_a_mesh(tier, data):
    ix8, ix1, ref = _trio(tier, data)
    assert ix8._nshards == 8 and ix8.capacity % 8 == 0
    q = data[3]
    cases = [("cosine_similarity", None, None), ("cosine_similarity", None, "b == 1"),
             ("cosine_similarity", None, np.arange(203) < 3)]
    if not tier.startswith("int4"):
        cases += [("optimized_similarity", WEIGHT_PARAMS, None), ("l2_distance", None, "b == 2")]
    for metric, params, flt in cases:
        got = ix8.search(q, K, metric, params, flt=flt)
        assert_same(got, ix1.search(q, K, metric, params, flt=flt),
                    metric in DESCENDING_METRICS)
        want = ref.search(q, K, metric, params, flt=flt)
        atol = 2e-3 if params or metric == "l2_distance" else 1e-5
        if flt is not None:  # the padding's index is -1 on both sides
            np.testing.assert_array_equal(got[1] < 0, np.asarray(want[1]) < 0)
        assert_topk(got, want, atol, metric in DESCENDING_METRICS)
    if tier.startswith("int4"):
        return
    mm8, mm1, mmj = ix8.multi_metric_topk(q, 6), ix1.multi_metric_topk(q, 6), \
        ref.multi_metric_topk(q, 6)
    for name in mm8:
        assert_same(mm8[name], mm1[name], name in DESCENDING_METRICS)
        assert_topk(mm8[name], mmj[name], 2e-3 if name == "l2_distance" else 1e-5,
                    name in DESCENDING_METRICS)
    np.testing.assert_allclose(ix8.scores(q), ix1.scores(q), rtol=0, atol=ONE_DEVICE_ATOL)
    np.testing.assert_allclose(ix8.scores(q), ref.scores(q), rtol=0, atol=1e-5)


def test_saved_index_reopens_on_another_mesh(data, tmp_path):
    """Save files and journals do not depend on the mesh."""
    unit, mags, _, q = data
    paths = [f"p{i}" for i in range(300)]
    cfg = IndexConfig(embedding_dim=D, dtype="int8", capacity_step=64)
    ix = ShardedVectorIndex(dim=D, config=cfg, mesh=cpu_mesh())
    ix.insert(paths, unit[:300] * mags[:300, None])
    ix.delete(paths[:5])
    want = ix.search(q, K)
    ix.save(str(tmp_path / "g"))
    grid = np.empty((2, 4), dtype=object)
    grid[:] = "cpu"
    for kw in ({"device": "cpu"}, {"mesh": cpu_mesh(2)},
               {"mesh": Mesh(grid, ("slice", "data"))}):
        back = ShardedVectorIndex.load_from(str(tmp_path / "g"), **kw)
        v, i = back.search(q, K)
        # the save compacts the 5 deleted rows away: ids move down by 5
        assert_same((v, i), (want[0], want[1] - 5))
    j = ShardedVectorIndex.open(str(tmp_path / "j"), config=cfg, mesh=cpu_mesh(4))
    j.insert(paths, unit[:300] * mags[:300, None])
    j.flush()
    del j
    again = ShardedVectorIndex.open(str(tmp_path / "j"), mesh=cpu_mesh())
    assert again._nshards == 8 and len(again) == 300
    ref = ShardedVectorIndex(dim=D, config=cfg, device="cpu")
    ref.insert(paths, unit[:300] * mags[:300, None])
    assert_same(again.search(q, K), ref.search(q, K))


def test_image_search_app_on_a_mesh(tmp_path, monkeypatch):
    """ImageSearchApp on an 8-shard mesh answers as on one device."""
    from image_retrieval_tpu_torch.app.pipeline import ImageSearchApp
    from image_retrieval_tpu_torch.models.encoder import FakeEncoder

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    for sub in ("red", "blue"):
        (tmp_path / "imgs" / sub).mkdir(parents=True)
        for i in range(6):
            Image.fromarray((rng.random((32, 32, 3)) * 255).astype(np.uint8)).save(
                tmp_path / "imgs" / sub / f"{i}.png")
    apps = [ImageSearchApp(encoder=FakeEncoder(dim=64), mesh=cpu_mesh()),
            ImageSearchApp(encoder=FakeEncoder(dim=64), device="cpu")]
    for app in apps:
        app.process_images(app.scan_folders(str(tmp_path / "imgs")))
    assert apps[0]._ensure_index()._nshards == 8
    for call in (lambda a: a.search_images("a red square", top_k=5),
                 lambda a: a.search_images("x", top_k=4, use_optimized_similarity=True),
                 lambda a: a.search_images("x", top_k=4, filter_expr="dir == 'blue'")):
        got, want = call(apps[0]), call(apps[1])
        assert [r["path"] for r in got] == [r["path"] for r in want]
        np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                                   rtol=0, atol=ONE_DEVICE_ATOL)
    got = apps[0].search_with_multiple_metrics("x", top_k=3)
    want = apps[1].search_with_multiple_metrics("x", top_k=3)
    assert got["analysis"] == want["analysis"]
