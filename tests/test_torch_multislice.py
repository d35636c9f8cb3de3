"""Multi-slice hierarchical top-k in the port: a (slice=2, data=4) mesh of
virtual CPU devices against the flat 8-shard mesh, a numpy oracle and the
JAX package's multislice_search_topk on its (2, 4) virtual mesh. Mirrors the
JAX package's tests/test_multislice.py: each slice merges its shards' k-lists
first, then the slices merge theirs, and the answers are the flat merge's,
tie order included. Port against port is exact; against JAX the tolerance
of the one-device parity tests (1e-5 f32, 2e-3 for the int8 weighted
score)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from image_retrieval_tpu.config import IndexConfig
from image_retrieval_tpu.parallel.collectives import multislice_search_topk as jax_multislice
from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.index.screen import ScreenedSearch
from image_retrieval_tpu_torch.parallel.collectives import (
    multislice_search_topk,
    sharded_int4_screen_topk,
    sharded_search_topk,
)
from image_retrieval_tpu_torch.parallel.mesh import Mesh, make_mesh


@pytest.fixture(scope="module")
def meshes():
    grid = np.empty((2, 4), dtype=object)
    grid[:] = "cpu"
    return make_mesh(devices=["cpu"] * 8), Mesh(grid, ("slice", "data"))


def _run_pair(meshes, emb, mags, q, k, metric, weights=None, scales=None):
    flat, sliced = meshes
    valid = torch.ones(emb.shape[0], dtype=torch.bool)
    t = lambda a: None if a is None else torch.from_numpy(a)
    flat_out = sharded_search_topk(t(q), t(emb), valid, t(mags), k, metric, weights, t(scales),
                                   mesh=flat)
    ms_out = multislice_search_topk(t(q), t(emb), valid, t(mags), k, metric, weights,
                                    t(scales), mesh=sliced)
    return [a.numpy() for a in flat_out], [a.numpy() for a in ms_out]


def _jax_multislice(emb, mags, q, k, metric, weights=None, scales=None):
    devs = np.array(jax.devices()[:8])
    mesh = JaxMesh(devs.reshape(2, 4), ("slice", "data"))

    def place(x):
        spec = P(("slice", "data"), *([None] * (x.ndim - 1)))
        return jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))

    out = jax_multislice(jnp.asarray(q), place(emb), place(np.ones(emb.shape[0], bool)),
                         None if mags is None else place(mags), k, metric, weights,
                         None if scales is None else place(scales), mesh=mesh)
    return [np.asarray(a) for a in out]


def _int8(unit):
    grid = np.maximum(np.abs(unit).max(1), 1e-12) / 127.0
    rows = np.clip(np.rint(unit / grid[:, None]), -127, 127).astype(np.int8)
    scales = (np.linalg.norm(unit, axis=1)
              / np.linalg.norm(rows.astype(np.float32), axis=1)).astype(np.float32)
    return rows, scales


def test_cosine_hierarchical_matches_flat_oracle_and_jax(meshes, rng):
    n, d, k = 256, 32, 10
    emb = rng.normal(size=(n, d)).astype(np.float32)
    unit = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    q = rng.normal(size=(2, d)).astype(np.float32)
    (fv, fi), (mv, mi) = _run_pair(meshes, unit, None, q, k, "cosine_similarity")
    np.testing.assert_array_equal(mi, fi)
    np.testing.assert_array_equal(mv, fv)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    oracle = np.argsort(-(qn @ unit.T), axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(mi, oracle)
    jv, ji = _jax_multislice(unit, None, q, k, "cosine_similarity")
    np.testing.assert_array_equal(mi, ji)
    np.testing.assert_allclose(mv, jv, rtol=0, atol=1e-5)


def test_ascending_metric_hierarchical(meshes, rng):
    n, d, k = 128, 16, 7
    emb = rng.normal(size=(n, d)).astype(np.float32)
    mags = np.linalg.norm(emb, axis=1).astype(np.float32)
    unit = emb / mags[:, None]
    q = rng.normal(size=(1, d)).astype(np.float32)
    (fv, fi), (mv, mi) = _run_pair(meshes, unit, mags, q, k, "l2_distance")
    np.testing.assert_array_equal(mi, fi)
    np.testing.assert_array_equal(mv, fv)
    diff = emb[None] - q[:, None]
    oracle = np.argsort(np.sqrt((diff ** 2).sum(-1)) / np.sqrt(d), axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(mi, oracle)


def test_optimized_metric_hierarchical(meshes, rng):
    n, d, k = 128, 16, 5
    emb = rng.normal(size=(n, d)).astype(np.float32) * rng.uniform(0.5, 2.0, (n, 1)).astype(
        np.float32)
    mags = np.linalg.norm(emb, axis=1).astype(np.float32)
    unit = emb / mags[:, None]
    q = rng.normal(size=(1, d)).astype(np.float32)
    weights = (1.0, 1.0, 1.0, 0.0, 0.5)
    (fv, fi), (mv, mi) = _run_pair(meshes, unit, mags, q, k, "optimized_similarity", weights)
    np.testing.assert_array_equal(mi, fi)
    np.testing.assert_array_equal(mv, fv)
    jv, ji = _jax_multislice(unit, mags, q, k, "optimized_similarity", weights)
    np.testing.assert_array_equal(mi, ji)
    np.testing.assert_allclose(mv, jv, rtol=0, atol=1e-5)


def test_int8_hierarchical(meshes, rng):
    """int8 cosine and the int8 weighted score (K5's plain version on each
    shard)."""
    n, d, k = 128, 16, 5
    emb = rng.normal(size=(n, d)).astype(np.float32)
    unit = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    rows, scales = _int8(unit)
    mags = np.ones((n,), np.float32)
    q = rng.normal(size=(1, d)).astype(np.float32)
    for metric, w, atol in (("cosine_similarity", None, 1e-5),
                            ("optimized_similarity", (1.0, 1.0, 1.0, 0.0, 0.5), 2e-3)):
        (fv, fi), (mv, mi) = _run_pair(meshes, rows, mags, q, k, metric, w, scales)
        np.testing.assert_array_equal(mi, fi)
        np.testing.assert_array_equal(mv, fv)
        jv, ji = _jax_multislice(rows, mags, q, k, metric, w, scales)
        np.testing.assert_array_equal(mi, ji)
        np.testing.assert_allclose(mv, jv, rtol=0, atol=atol)


def test_int4_screen_merges_data_before_slice(meshes, rng):
    """The int4 screen over the tuple axis ('slice', 'data') against the flat
    8-shard screen: identical candidates."""
    from image_retrieval_tpu_torch.ops.int4 import quantize_pack_int4

    flat, sliced = meshes
    unit = rng.normal(size=(512, 64)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    packed, sc = (torch.from_numpy(a) for a in quantize_pack_int4(unit))
    q = torch.from_numpy(rng.normal(size=(3, 64)).astype(np.float32))
    valid = torch.ones(512, dtype=torch.bool)
    a = sharded_int4_screen_topk(q, packed, valid, sc, 20, mesh=flat)
    b = sharded_int4_screen_topk(q, packed, valid, sc, 20, mesh=sliced, axis=("slice", "data"))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("dtype", ["float32", "int8", "int4"])
def test_sharded_index_on_multislice_mesh(meshes, rng, dtype):
    """ShardedVectorIndex shards rows over (slice, data) and searches through
    the hierarchical merge: the same answers as the same index on the flat
    8-shard mesh, for every metric, the multi-metric pass and scores()."""
    flat_mesh, sliced_mesh = meshes
    emb = rng.normal(size=(200, 32)).astype(np.float32) * rng.uniform(
        0.5, 2.0, (200, 1)).astype(np.float32)
    paths = [f"p{i}" for i in range(200)]
    q = rng.normal(size=(32,)).astype(np.float32)
    cfg = IndexConfig(capacity_step=32, dtype=dtype, embedding_dim=32, rerank_c=256)
    flat = ShardedVectorIndex(dim=32, mesh=flat_mesh, config=cfg)
    ms = ShardedVectorIndex(dim=32, mesh=sliced_mesh, config=cfg)
    assert ms._multislice and not flat._multislice
    assert ms._row_axes == ("slice", "data") and ms._nshards == 8
    flat.insert(paths, emb)
    ms.insert(paths, emb)
    cases = [("cosine_similarity", None)]
    if dtype != "int4":
        cases += [("l2_distance", None),
                  ("optimized_similarity",
                   {"w_angle": 1.0, "w_l1": 1.0, "w_l2": 1.0, "w_inf": 0.0, "w_mag": 0.5})]
    for metric, params in cases:
        fv, fi = flat.search(q, top_k=7, metric=metric, params=params)
        mv, mi = ms.search(q, top_k=7, metric=metric, params=params)
        np.testing.assert_array_equal(mi, fi)
        np.testing.assert_array_equal(mv, fv)
    if dtype == "int4":
        return
    mm_flat = flat.multi_metric_topk(q, top_k=5)
    mm_ms = ms.multi_metric_topk(q, top_k=5)
    for name in mm_flat:
        np.testing.assert_array_equal(mm_ms[name][1], mm_flat[name][1])
    np.testing.assert_array_equal(ms.scores(q), flat.scores(q))


def test_screen_on_multislice_mesh(meshes, rng):
    """The resident screen on a (slice, data) index: the same projection
    (the same shards' moments in the same order) and the same answers as on
    the flat mesh."""
    flat_mesh, sliced_mesh = meshes
    emb = rng.normal(size=(400, 32)).astype(np.float32)
    paths = [f"p{i}" for i in range(400)]
    cfg = IndexConfig(capacity_step=32, dtype="int8", embedding_dim=32)
    out = []
    for mesh in (flat_mesh, sliced_mesh):
        ix = ShardedVectorIndex(dim=32, mesh=mesh, config=cfg)
        ix.insert(paths, emb)
        scr = ScreenedSearch.from_index(ix, sketch_dims=8, candidates=16)
        out.append((scr.proj, scr.search(emb[:5], top_k=6)))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        np.testing.assert_array_equal(a, b)
