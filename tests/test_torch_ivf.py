"""The port's IVF tier (index/ivf.py) and `ann="ivf"` through the searcher,
server, app, CLI and web UI, held against the JAX package on the same numpy
rows (device="cpu").

The `train_size` build makes the JAX package's numpy draws in the same
order, so both packages start k-means from the same init: centroids agree
to f32 rounding, and packing, row ids, int8 slabs and answers agree. The
full-set build draws its init differently by design; its parity is held
through `save` / `load` in both directions.

Regenerate the JAX-written fixture (tests/data/jax_ivf_int8.npz and the JAX
answers beside it) with `JAX_PLATFORMS=cpu PYTHONPATH=. python
tests/test_torch_ivf.py`.
"""

import os

import numpy as np
import pytest
import torch

from image_retrieval_tpu.config import IndexConfig as JaxIndexConfig
from image_retrieval_tpu.index import ivf as jivf
from image_retrieval_tpu.index.vector_index import ShardedVectorIndex as JaxIndex
from image_retrieval_tpu_torch.config import Config, IndexConfig
from image_retrieval_tpu_torch.index import ShardedVectorIndex
from image_retrieval_tpu_torch.index import ivf as pivf
from image_retrieval_tpu_torch.index.ivf import IVFIndex
from image_retrieval_tpu_torch.models.encoder import FakeEncoder

ATOL = 1e-6  # scores: the same f32 products summed in another order
CENTROID_ATOL = 1e-5
DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURE = os.path.join(DATA, "jax_ivf_int8.npz")
FIXTURE_ANSWERS = os.path.join(DATA, "jax_ivf_int8_answers.npz")


def clustered(seed=5, n=2000, d=64, centers=32, noise=0.5, nq=8):
    """Rows around seeded centres (unnormalized, as the JAX tests' data) and
    queries near the first centres."""
    rng = np.random.default_rng(seed)
    c = rng.normal(size=(centers, d)) * 3
    rows = (c[np.arange(n) % centers] + rng.normal(size=(n, d)) * noise).astype(np.float32)
    q = (c[np.arange(nq) % centers] + rng.normal(size=(nq, d)) * 0.3).astype(np.float32)
    return rows, q


@pytest.fixture(scope="module")
def data():
    return clustered()


def pair(rows, nlist=32, nprobe=8, seed=3, dtype="float32", **build):
    """The JAX and the port's IVF built from the same rows and settings."""
    j = jivf.IVFIndex(nlist=nlist, nprobe=nprobe, seed=seed, dtype=dtype).build(rows, **build)
    p = IVFIndex(nlist=nlist, nprobe=nprobe, seed=seed, dtype=dtype,
                 device="cpu").build(rows, **build)
    return j, p


def assert_same_answers(got, want, atol=ATOL):
    gv, gi = (np.atleast_2d(np.asarray(a)) for a in got)
    wv, wi = (np.atleast_2d(np.asarray(a)) for a in want)
    np.testing.assert_array_equal(gi, wi)
    fin = np.isfinite(wv)
    np.testing.assert_array_equal(np.isfinite(gv), fin)
    np.testing.assert_allclose(gv[fin], wv[fin], rtol=0, atol=atol)


def assert_same_build(j, p, int8):
    np.testing.assert_allclose(p._centroids.numpy(), np.asarray(j._centroids), rtol=0,
                               atol=CENTROID_ATOL)
    assert (p._lmax, p._replicas, p.nlist, p.count) == (j._lmax, j._replicas, j.nlist, j.count)
    np.testing.assert_array_equal(p._row_ids.numpy(), np.asarray(j._row_ids))
    if int8:
        np.testing.assert_array_equal(p._packed.numpy(), np.asarray(j._packed))
        np.testing.assert_array_equal(p._scales.numpy().view(np.uint32),
                                      np.asarray(j._scales).view(np.uint32))
    else:
        np.testing.assert_allclose(p._packed.numpy(), np.asarray(j._packed), rtol=0, atol=0)


# -- k-means ---------------------------------------------------------------------


@pytest.mark.parametrize("iters", [1, 4])
def test_kmeans_chunked_matches_jax(iters):
    """The chunked Lloyd steps from one init: the same unit centroids."""
    rng = np.random.default_rng(iters)
    rows, _ = clustered(seed=iters, n=1024, d=32, centers=8)
    unit = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    rows3 = unit.reshape(4, 256, 32)
    init = unit[rng.choice(1024, 16, replace=False)]
    got = pivf._kmeans_chunked(torch.from_numpy(rows3), torch.from_numpy(init), iters)
    want = np.asarray(jivf._kmeans_chunked(rows3, init, iters))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CENTROID_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=1), 1.0, atol=1e-5)


def test_kmeans_keeps_an_empty_clusters_centroid():
    """A centroid no row picks keeps its value (the norms > 1e-9 guard)."""
    unit = np.eye(4, 8, dtype=np.float32)
    init = np.concatenate([unit[:2], np.full((1, 8), -8 ** -0.5, np.float32)])
    got = pivf._kmeans_chunked(torch.from_numpy(unit[None]), torch.from_numpy(init), 2)
    want = np.asarray(jivf._kmeans_chunked(unit[None], init, 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-7)
    np.testing.assert_array_equal(got.numpy()[2], init[2])


@pytest.mark.parametrize("r", [1, 3])
def test_top_r_centroids_ties_match_jax(r):
    """Duplicate centroids tie exactly: the lowest ids come first."""
    rng = np.random.default_rng(r)
    c = rng.normal(size=(6, 16)).astype(np.float32)
    c = np.concatenate([c, c[:3]])  # ids 6-8 tie with 0-2
    c /= np.linalg.norm(c, axis=1, keepdims=True)
    rows = np.concatenate([c, rng.normal(size=(20, 16)).astype(np.float32)])
    got = pivf._top_r_centroids(torch.from_numpy(rows), torch.from_numpy(c), r).numpy()
    want = np.asarray(jivf._top_r_centroids(rows, c, r))
    np.testing.assert_array_equal(got, want)


def test_full_set_build_init_and_quality(data):
    """The full-set build draws its init with numpy from the seed: the same
    seed gives the same index, and probing every cluster is the exact
    search."""
    rows, q = data
    a = IVFIndex(nlist=32, seed=7, device="cpu").build(rows)
    b = IVFIndex(nlist=32, seed=7, device="cpu").build(rows)
    assert_same_answers(a.search(q, 5), b.search(q, 5), atol=0)
    unit = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    qu = q / np.linalg.norm(q, axis=1, keepdims=True)
    exact = np.argsort(-(qu @ unit.T), axis=1, kind="stable")[:, :10]
    assert a.recall_at(q, exact, k=10, nprobe=32) == pytest.approx(1.0)
    assert a.recall_at(q, exact, k=10, nprobe=8) > 0.9


# -- the train_size build and its search --------------------------------------


@pytest.mark.parametrize("dtype,replicas,balance", [
    ("float32", 1, 1.5), ("int8", 1, 1.5), ("int8", 2, 1.5), ("float32", 2, None),
    ("int8", 1, None)])
def test_train_size_build_and_search_match_jax(data, dtype, replicas, balance):
    rows, q = data
    j, p = pair(rows, dtype=dtype, replicas=replicas, balance=balance, train_size=1500)
    assert_same_build(j, p, dtype == "int8")
    for nprobe, k in ((1, 10), (8, 1), (8, 10), (8, 40), (32, 10)):
        assert_same_answers(p.search(q, top_k=k, nprobe=nprobe),
                            j.search(q, top_k=k, nprobe=nprobe))
    assert_same_answers(p.search(q[3], top_k=10), j.search(q[3], top_k=10))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_tail_after_add_matches_jax(data, dtype):
    """add() appends to the exactly swept tail; the tail merges into the
    probed candidates as in the JAX package, on both of its sides of
    needs_rebuild."""
    rows, q = data
    j, p = pair(rows, dtype=dtype, replicas=2, train_size=1500)
    new = np.concatenate([q[:4] * 2.0, rows[:3]])  # twins of queries and of packed rows
    assert p.add(new, paths=[f"t{i}" for i in range(7)]) == j.add(
        new, paths=[f"t{i}" for i in range(7)]) == len(rows)
    assert p.tail_count == j.tail_count == 7 and p.needs_rebuild == j.needs_rebuild
    np.testing.assert_array_equal(p._tail_rows, j._tail_rows)
    np.testing.assert_array_equal(p._tail_scales, j._tail_scales)
    for k in (1, 10):
        assert_same_answers(p.search(q, top_k=k), j.search(q, top_k=k))
    _, ids = p.search(q[0], top_k=3)
    assert len(rows) in ids.tolist()  # the tail twin of query 0
    more = np.random.default_rng(0).normal(size=(1100, rows.shape[1])).astype(np.float32)
    p.add(more)
    j.add(more)
    assert p.needs_rebuild and j.needs_rebuild and p.paths[-1] == j.paths[-1]
    assert_same_answers(p.search(q, top_k=10), j.search(q, top_k=10))


def test_slab_score_ties_resolve_to_the_jax_order():
    """Rows duplicated within and across clusters (replicas) tie exactly:
    the (probe rank, slot) order decides, as lax.top_k does."""
    rng = np.random.default_rng(11)
    base = rng.normal(size=(40, 32)).astype(np.float32)
    rows = np.concatenate([base, base, base[:20]])  # equal rows
    q = base[:6] + 0.01
    for replicas in (1, 2):
        j, p = pair(rows, nlist=8, nprobe=4, replicas=replicas, train_size=90)
        for k in (5, 20):
            assert_same_answers(p.search(q, top_k=k), j.search(q, top_k=k))


def test_small_gallery_k_never_exceeds_the_probed_slots(rng):
    unit = rng.normal(size=(100, 32)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    j, p = pair(unit, nlist=90, nprobe=10, seed=0, train_size=99)
    q = rng.normal(size=(3, 32)).astype(np.float32)
    got = p.search(q, top_k=30)
    assert got[1].shape[1] <= 30 and (got[1][np.isfinite(got[0])] >= 0).all()
    assert_same_answers(got, j.search(q, top_k=30))


@pytest.mark.parametrize("n", [0, 1, 4 << 20, (4 << 20) - 1, 5_000_000, 8 << 20, 1 << 25,
                               1 << 27, 1 << 30, 10**12])
def test_recommended_ivf_matches_jax(n):
    assert pivf.recommended_ivf(n) == jivf.recommended_ivf(n)


# -- offload, save / load -------------------------------------------------------


@pytest.mark.parametrize("threads", [False, True])
@pytest.mark.parametrize("dtype,replicas", [("int8", 2), ("float32", 1)])
def test_offloaded_matches_resident_bit_for_bit(data, dtype, replicas, threads, monkeypatch):
    """The host gather of the probed slabs, on the calling thread or split
    over the host's threads: the resident answers, bit for bit."""
    if threads:
        monkeypatch.setattr(pivf, "GATHER_THREADS_BYTES", 0)
        monkeypatch.setattr(pivf, "HOST_WORKERS", 3)
    rows, q = data
    res = IVFIndex(nlist=32, seed=0, dtype=dtype, device="cpu").build(rows, replicas=replicas)
    off = IVFIndex(nlist=32, seed=0, dtype=dtype, device="cpu").build(
        rows, replicas=replicas, offload=True)
    assert off._packed is None and off._host_packed is not None
    again = IVFIndex(nlist=32, seed=0, dtype=dtype, device="cpu").build(
        rows, replicas=replicas).offload()
    for npb in (4, 16):
        want = res.search(q, top_k=10, nprobe=npb)
        for o in (off, again):
            got = o.search(q, top_k=10, nprobe=npb)
            np.testing.assert_array_equal(got[1], want[1])
            np.testing.assert_array_equal(got[0].view(np.uint32), want[0].view(np.uint32))
    itemsize = 1 if dtype == "int8" else 4
    off.search(q[0], top_k=5, nprobe=4)
    per_slab = off._lmax * (rows.shape[1] * itemsize + 4 + (4 if dtype == "int8" else 0))
    assert off.last_upload_bytes == 4 * per_slab  # the 4 probed slabs, nothing more


@pytest.mark.parametrize("offloaded", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_jax_saved_index_loads_in_the_port(data, tmp_path, dtype, offloaded):
    """A full-set JAX build (its init drawn by jax.random) saved, loaded by
    the port: the same answers, tail and paths included."""
    rows, q = data
    j = jivf.IVFIndex(nlist=32, nprobe=8, seed=1, dtype=dtype).build(
        rows, paths=[f"img/{i}.jpg" for i in range(len(rows))], replicas=2)
    j.add(q[:2] * 3.0, paths=["tail/0", "tail/1"])
    if offloaded:
        j.offload()
    path = str(tmp_path / "jax.npz")
    j.save(path)
    p = IVFIndex.load(path, device="cpu")
    assert p._offloaded == offloaded and p.dtype == dtype and p.paths == j.paths
    assert (p._lmax, p._replicas, p.count, p.tail_count) == (j._lmax, j._replicas, j.count,
                                                            j.tail_count)
    for npb in (2, 8):
        assert_same_answers(p.search(q, top_k=10, nprobe=npb), j.search(q, top_k=10, nprobe=npb))


@pytest.mark.parametrize("offloaded", [False, True])
@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_port_saved_index_loads_in_jax(data, tmp_path, dtype, offloaded):
    rows, q = data
    p = IVFIndex(nlist=32, nprobe=8, seed=2, dtype=dtype, device="cpu").build(rows, replicas=2)
    p.add(q[:3] * 2.0, paths=["a", "b", "c"])
    if offloaded:
        p.offload()
    path = str(tmp_path / "port.npz")
    p.save(path)
    with np.load(path) as z:
        want = {"centroids", "dtype", "meta", "packed", "paths", "row_ids", "scales",
                "tail_rows", "tail_scales"}
        assert set(z.files) == (want if dtype == "int8" else want - {"scales"})
        assert z["meta"].dtype == np.int64 and len(z["meta"]) == 8 and str(z["dtype"]) == dtype
        assert z["meta"][7] == int(offloaded)
    j = jivf.IVFIndex.load(path)
    assert j._offloaded == offloaded and j.paths == p.paths
    assert_same_answers(j.search(q, top_k=10), p.search(q, top_k=10))
    back = IVFIndex.load(path, device="cpu")
    assert_same_answers(back.search(q, top_k=10), p.search(q, top_k=10), atol=0)


def test_default_paths_are_not_saved(data, tmp_path):
    rows, q = data
    p = IVFIndex(nlist=16, device="cpu").build(rows)
    p.save(str(tmp_path / "a.npz"))
    with np.load(str(tmp_path / "a.npz")) as z:
        assert "paths" not in z.files and "scales" not in z.files
    back = jivf.IVFIndex.load(str(tmp_path / "a.npz"))
    assert back.paths == [str(i) for i in range(len(rows))] and not back._custom_paths


def test_jax_written_fixture_answers_as_jax_did():
    """tests/data/jax_ivf_int8.npz: written by the JAX package (int8,
    replicas 2, a tail, custom paths); the port, resident and offloaded,
    and the JAX package give the answers stored beside it."""
    with np.load(FIXTURE_ANSWERS) as z:
        q, want = z["queries"], (z["scores"], z["ids"])
    with np.load(FIXTURE) as z:
        assert str(z["dtype"]) == "int8" and z["meta"][4] == 2 and z["meta"][6] > 0
        assert "paths" in z.files
    assert os.path.getsize(FIXTURE) < 1 << 20
    p = IVFIndex.load(FIXTURE, device="cpu")
    assert_same_answers(p.search(q, top_k=want[1].shape[1]), want)
    assert_same_answers(p.offload().search(q, top_k=want[1].shape[1]), want)
    assert_same_answers(jivf.IVFIndex.load(FIXTURE).search(q, top_k=want[1].shape[1]), want,
                        atol=0)


# -- the cluster-sharded search ------------------------------------------------


def cpu_mesh(n=8):
    from image_retrieval_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=["cpu"] * n)


@pytest.mark.parametrize("dtype,nlist,replicas", [
    ("float32", 32, 1), ("int8", 32, 1), ("int8", 32, 2), ("float32", 20, 1), ("int8", 12, 1)])
def test_sharded_matches_jax_and_one_device(data, dtype, nlist, replicas):
    """The slabs over eight CPU shards (nlist 20 and 12 pad to 24 and 16
    with empty clusters) against the JAX package's sharded() on its 8-device
    mesh and against the port's one-device search, at ATOL with ids
    identical."""
    from image_retrieval_tpu.config import MeshConfig as JaxMeshConfig
    from image_retrieval_tpu.parallel.mesh import make_mesh as jax_make_mesh

    rows, q = data
    j, p = pair(rows, nlist=nlist, dtype=dtype, replicas=replicas, train_size=1500)
    jfn = j.sharded(jax_make_mesh(JaxMeshConfig(data=8, model=1)))
    pfn = p.sharded(cpu_mesh())
    for nprobe, k in ((1, 10), (8, 10), (8, 40), (nlist, 10)):
        got = pfn(q, top_k=k, nprobe=nprobe)
        assert_same_answers(got, jfn(q, top_k=k, nprobe=nprobe))
        assert_same_answers(got, p.search(q, top_k=k, nprobe=nprobe))
    assert_same_answers(pfn(q[3], top_k=10), p.search(q[3], top_k=10))
    # search() delegates once a mesh is attached; a tail merges on the host
    p.attach_mesh(cpu_mesh())
    p.add(q[:2] * 3.0)
    j.add(q[:2] * 3.0)
    assert_same_answers(p.search(q, top_k=10), j.sharded(
        jax_make_mesh(JaxMeshConfig(data=8, model=1)))(q, top_k=10))


def test_sharded_search_guards_and_padding(data):
    rows, q = data
    p = IVFIndex(nlist=12, nprobe=12, seed=3, device="cpu").build(rows[:600], train_size=500)
    with pytest.raises(ValueError, match="divisible"):
        pivf.sharded_ivf_search(torch.from_numpy(q), p._centroids, p._packed, p._row_ids,
                                p._lmax, 4, 10, mesh=cpu_mesh())
    # nprobe = nlist probes every real cluster and no padding one: every row
    # is reachable, nothing is -1
    v, i = p.sharded(cpu_mesh())(q, top_k=600)
    assert (i >= 0).all() and np.isfinite(v).all()
    assert sorted(i[0].tolist()) == list(range(600))
    off = IVFIndex(nlist=8, device="cpu").build(rows[:100]).offload()
    with pytest.raises(ValueError, match="device-resident"):
        off.sharded(cpu_mesh())
    off.attach_mesh(cpu_mesh())  # offloaded: the host gather serves, on one device
    assert off.search(q, top_k=5)[1].shape == (len(q), 5)
    assert p.attach_mesh(None) is p and p.search(q, top_k=5)[1].shape == (len(q), 5)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_from_index_on_a_mesh_attaches_it(data, dtype):
    """An index on eight CPU shards: from_index builds on its first device
    and attaches the mesh; the answers are the JAX from_index's on its
    8-device mesh (which attaches its mesh the same way)."""
    rows, q = data
    d = rows.shape[1]
    p_ix = ShardedVectorIndex(dim=d, config=IndexConfig(embedding_dim=d, dtype=dtype,
                                                        capacity_step=64), mesh=cpu_mesh())
    _, j_ix = indexes(rows[:600], dtype)
    p_ix.insert([f"p{i}" for i in range(600)], rows[:600])
    dead = [f"p{i}" for i in range(0, 600, 7)]
    p_ix.delete(dead)
    j_ix.delete(dead)
    p = IVFIndex.from_index(p_ix, nlist=16, nprobe=4, train_size=500)
    j = jivf.IVFIndex.from_index(j_ix, nlist=16, nprobe=4, train_size=500)
    assert p._mesh is p_ix.mesh and j._mesh is not None
    got = p.search(q, top_k=10)
    assert p._sharded_fn is not None
    assert_same_answers(got, j.search(q, top_k=10))
    assert not set(got[1].ravel().tolist()) & {int(x[1:]) for x in dead}


def test_jax_written_fixture_sharded():
    """tests/data/jax_ivf_int8.npz (int8, replicas 2, a tail) over eight CPU
    shards gives the answers the JAX package stored."""
    with np.load(FIXTURE_ANSWERS) as z:
        q, want = z["queries"], (z["scores"], z["ids"])
    p = IVFIndex.load(FIXTURE, device="cpu").attach_mesh(cpu_mesh())
    assert_same_answers(p.search(q, top_k=want[1].shape[1]), want)
    assert p._sharded_fn is not None


# -- from_index --------------------------------------------------------------


def indexes(rows, dtype="float32", **cfg):
    """The port's and the JAX package's exact index over the same rows."""
    d = rows.shape[1]
    p = ShardedVectorIndex(dim=d, config=IndexConfig(embedding_dim=d, dtype=dtype,
                                                     capacity_step=64, **cfg), device="cpu")
    j = JaxIndex(dim=d, config=JaxIndexConfig(embedding_dim=d, dtype=dtype, capacity_step=64,
                                              **cfg))
    for ix in (p, j):
        ix.insert([f"p{i}" for i in range(len(rows))], rows)
    return p, j


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_from_index_tombstones_and_ids_match_jax(data, dtype):
    rows, q = data
    p_ix, j_ix = indexes(rows[:600], dtype)
    dead = [f"p{i}" for i in range(0, 600, 7)]
    p_ix.delete(dead)
    j_ix.delete(dead)
    p = IVFIndex.from_index(p_ix, nlist=16, nprobe=4, train_size=500)
    j = jivf.IVFIndex.from_index(j_ix, nlist=16, nprobe=4, train_size=500)
    assert p.dtype == j.dtype == dtype and p.count == j.count == 600
    np.testing.assert_array_equal(p._row_ids.numpy(), np.asarray(j._row_ids))
    got = p.search(q, top_k=10)
    assert_same_answers(got, j.search(q, top_k=10))
    assert not set(got[1].ravel().tolist()) & {int(d[1:]) for d in dead}
    assert p.paths == p_ix.paths
    # ids are index rows: a new row's id never collides with a packed one
    first = p.add(q[:1] * 5.0)
    assert first == 600 == j.add(q[:1] * 5.0)
    _, ids = p.search(q[0], top_k=1)
    assert ids[0] == 600


@pytest.mark.parametrize("base,want", [("float32", "float32"), ("bfloat16", "float32"),
                                       ("int8", "int8"), ("int4", "int8")])
def test_from_index_dtype_follows_the_base_tier(base, want):
    rows, q = clustered(n=256, d=32, centers=8)
    p_ix, j_ix = indexes(rows, base)
    p = IVFIndex.from_index(p_ix, nlist=8, nprobe=8, train_size=200)
    j = jivf.IVFIndex.from_index(j_ix, nlist=8, nprobe=8, train_size=200)
    assert p.dtype == j.dtype == want
    assert_same_answers(p.search(q, top_k=5), j.search(q, top_k=5))


def test_from_index_offloads_past_stream_threshold(data):
    rows, q = data
    big, _ = indexes(rows[:512], "int8", stream_threshold_bytes=1 << 40)
    small, j_small = indexes(rows[:512], "int8", stream_threshold_bytes=1)
    resident = IVFIndex.from_index(big, nlist=16, nprobe=16)
    off = IVFIndex.from_index(small, nlist=16, nprobe=16)
    assert not resident._offloaded and off._offloaded
    assert j_small is not None and jivf.IVFIndex.from_index(j_small, nlist=16)._offloaded
    assert_same_answers(off.search(q, top_k=10), resident.search(q, top_k=10), atol=0)
    # past the threshold only on the padded slabs' bytes: offloaded after the build
    rows_bytes = 512 * rows.shape[1]
    padded, _ = indexes(rows[:512], "int8", stream_threshold_bytes=rows_bytes)
    late = IVFIndex.from_index(padded, nlist=16, nprobe=16)
    assert late._offloaded and late._host_packed.nbytes > rows_bytes


# -- entry points ---------------------------------------------------------------


def test_entry_points_default_to_the_card(data, tmp_path):
    """No device= means the card: without one they raise, never fall back."""
    rows, _ = data
    p = IVFIndex(nlist=8, device="cpu").build(rows[:100])
    p.save(str(tmp_path / "x.npz"))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        IVFIndex()
    with pytest.raises(RuntimeError, match="CUDA"):
        IVFIndex.load(str(tmp_path / "x.npz"))


def test_guards():
    p = IVFIndex(nlist=4, device="cpu")
    with pytest.raises(ValueError, match="before build"):
        p.add(np.ones((1, 8), np.float32))
    with pytest.raises(ValueError, match="before build"):
        p.save("unused.npz")
    with pytest.raises(ValueError, match="before build"):
        p.offload()
    with pytest.raises(ValueError, match="empty"):
        p.search(np.ones(8, np.float32))
    with pytest.raises(ValueError, match="dtype"):
        IVFIndex(dtype="int4", device="cpu")


# -- serving ----------------------------------------------------------------------


def _apps(rows, dim, nlist=4, nprobe=4):
    """The port's and the JAX facade with ann='ivf' over the same rows."""
    from image_retrieval_tpu.app.pipeline import ImageSearchApp as JaxApp
    from image_retrieval_tpu.config import Config as JaxConfig
    from image_retrieval_tpu.models.encoder import FakeEncoder as JaxFake
    from image_retrieval_tpu_torch.app.pipeline import ImageSearchApp

    out = []
    for App, cfg, enc, kw in ((ImageSearchApp, Config(), FakeEncoder(dim=dim), {"device": "cpu"}),
                              (JaxApp, JaxConfig(), JaxFake(dim=dim), {})):
        cfg.search.ann, cfg.search.nlist, cfg.search.nprobe = "ivf", nlist, nprobe
        app = App(config=cfg, encoder=enc, **kw)
        app.embeddings = {f"img_{i}.jpg": rows[i] for i in range(len(rows))}
        app._index_dirty = True
        out.append(app)
    return out


@pytest.mark.parametrize("optimized", [False, True])
@pytest.mark.parametrize("nlist,nprobe", [(4, 4), (8, 8)])
def test_facade_ann_ivf_matches_jax(rng, optimized, nlist, nprobe):
    """Every cluster probed (the facade builds the full-set IVF, whose init
    differs by design): the JAX facade's answers, no padding surfacing."""
    rows, _ = clustered(seed=9, n=96, d=64, centers=6)
    rows *= rng.uniform(0.5, 3, (96, 1)).astype(np.float32)
    mine, ref = _apps(rows, 64, nlist, nprobe)
    for query in ("a red square", "a dog"):
        got = mine.search_images(query, top_k=8, use_optimized_similarity=optimized)
        want = ref.search_images(query, top_k=8, use_optimized_similarity=optimized)
        assert [r["path"] for r in got] == [r["path"] for r in want]
        np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                                   rtol=0, atol=1e-5)
        assert all(np.isfinite(r["score"]) for r in got)  # no padding surfaces
    assert isinstance(mine._ann, IVFIndex) and mine._ann.nlist == min(nlist, 96)


def test_facade_ann_rebuilds_and_fully_deleted_gallery(rng):
    """The IVF is rebuilt on a new generation or new nlist / nprobe; a
    gallery with no live row returns None (the exact path answers [])."""
    rows, _ = clustered(seed=4, n=64, d=32, centers=4)
    app, _ = _apps(rows, 32)
    index = app._ensure_index()
    a = app._ensure_ann(index)
    assert isinstance(a, IVFIndex) and app._ensure_ann(index) is a
    app.config.search.nprobe = 2
    b = app._ensure_ann(index)
    assert b is not a and b.nprobe == 2
    index.delete(["img_0.jpg"])
    c = app._ensure_ann(index)
    assert c is not b and c.count == 64
    index.delete([f"img_{i}.jpg" for i in range(64)])
    assert app._ensure_ann(index) is None
    assert app.search_images("anything", top_k=5) == []


def test_facade_auto_stays_exact_below_the_crossover(rng, monkeypatch):
    """nlist or nprobe 0 = recommended_ivf's operating point: None (exact)
    below 4 x 2^20 rows; where it names one, that IVF is built."""
    rows, _ = clustered(seed=6, n=64, d=32, centers=4)
    app, _ = _apps(rows, 32, nlist=0, nprobe=0)
    index = app._ensure_index()
    assert app._ensure_ann(index) is None
    assert len(app.search_images("x", top_k=3)) == 3
    monkeypatch.setattr(pivf, "recommended_ivf", lambda n: (8, 3))
    app.config.search.nlist = 0
    ann = app._ensure_ann(index)
    assert isinstance(ann, IVFIndex) and (ann.nlist, ann.nprobe) == (8, 3)
    app.config.search.nlist = 5
    assert app._ensure_ann(index).nlist == 5  # nprobe alone auto


def test_searcher_with_ivf_matches_jax():
    from image_retrieval_tpu.app.search import TextImageSearcher as JaxSearcher
    from image_retrieval_tpu.models.encoder import FakeEncoder as JaxFake
    from image_retrieval_tpu_torch.app.search import TextImageSearcher

    rows, _ = clustered(seed=8, n=128, d=64, centers=8)
    p_ix, j_ix = indexes(rows, "int8")
    p_ix.delete(["p3", "p4"])
    j_ix.delete(["p3", "p4"])
    mine = TextImageSearcher(FakeEncoder(dim=64), p_ix,
                             ann=IVFIndex.from_index(p_ix, nlist=8, nprobe=3, train_size=120))
    ref = JaxSearcher(JaxFake(dim=64), j_ix,
                      ann=jivf.IVFIndex.from_index(j_ix, nlist=8, nprobe=3, train_size=120))
    for kw in ({}, {"use_optimized_similarity": True}):
        for text in ("a blue bird", "query 7"):
            got = mine.search(text, top_k=6, score_threshold=-1.0, **kw)
            want = ref.search(text, top_k=6, score_threshold=-1.0, **kw)
            assert [r["path"] for r in got] == [r["path"] for r in want]
            np.testing.assert_allclose([r["score"] for r in got],
                                       [r["score"] for r in want], rtol=0, atol=1e-5)


def test_server_keeps_the_ivf_across_inserts_and_deletes(rng, tmp_path):
    """SearchServer(ann=IVFIndex) against the JAX server with the JAX IVF:
    the same answers; an insert reaches the IVF's tail (the new image is
    found first through it), a delete leaves it attached and the deleted
    rows never come back."""
    from image_retrieval_tpu.app.server import SearchServer as JaxServer
    from image_retrieval_tpu.models.encoder import FakeEncoder as JaxFake
    from image_retrieval_tpu_torch.app.server import SearchServer
    from PIL import Image

    rows, _ = clustered(seed=10, n=96, d=64, centers=6)
    p_ix, j_ix = indexes(rows, "float32")
    ann = IVFIndex.from_index(p_ix, nlist=6, nprobe=3, train_size=90)
    jann = jivf.IVFIndex.from_index(j_ix, nlist=6, nprobe=3, train_size=90)
    w = {"w_angle": 1.0, "w_l1": 1.0, "w_mag": 0.5}
    paths = []
    for i in range(3):
        p = tmp_path / f"new{i}.png"
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(p)
        paths.append(str(p))

    def answers(srv):
        return [[(r["path"], r["score"]) for r in srv.search(t, top_k=5, **kw)]
                for t in ("a blue bird", "a red car")
                for kw in ({}, {"metric": "optimized_similarity", "weights": w})]

    def same(a, b):
        assert [[p for p, _ in x] for x in a] == [[p for p, _ in x] for x in b]
        np.testing.assert_allclose([s for x in a for _, s in x], [s for x in b for _, s in x],
                                   rtol=0, atol=1e-5)

    with SearchServer(FakeEncoder(dim=64), p_ix, ann=ann) as srv, \
            JaxServer(JaxFake(dim=64), j_ix, ann=jann) as jsrv:
        same(answers(srv), answers(jsrv))
        assert srv.add_images(paths) == jsrv.add_images(paths) == (3, 0)
        assert srv.ann is ann and ann.tail_count == 3 and ann.count == len(p_ix) == 99
        for p in paths:
            hit = srv.search_similar(p, top_k=3, exclude_self=False)[0]
            assert hit["path"] == p and hit["score"] > 0.999
        same(answers(srv), answers(jsrv))
        gone = [r["path"] for r in srv.search("a blue bird", top_k=4)]
        assert srv.remove_images(gone) == jsrv.remove_images(gone) == 4
        assert srv.ann is ann
        after = answers(srv)
        assert not {p for x in after for p, _ in x} & set(gone)
        same(after, answers(jsrv))


def test_cli_and_webui_take_ann_ivf(rng, tmp_path, monkeypatch, capsys):
    """--ann ivf with --nlist / --nprobe through the CLI's search and the
    web UI's HTTP /search: the answers of --ann exact at a full probe."""
    import json
    import threading
    import urllib.request

    from image_retrieval_tpu_torch.app import cli, webui
    from PIL import Image

    folder = tmp_path / "imgs"
    folder.mkdir()
    for i in range(12):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
            folder / f"im{i}.png")
    monkeypatch.chdir(tmp_path)
    base = ["search", "--folder", str(folder), "--fake-encoder", "--device", "cpu"]
    assert cli.main(base + ["a query"]) == 0
    exact = capsys.readouterr().out
    assert cli.main(base + ["--ann", "ivf", "--nlist", "3", "--nprobe", "3", "a query"]) == 0
    assert capsys.readouterr().out == exact

    served, real_serve = {}, webui.serve

    def fake_serve(srv, paths, host="127.0.0.1", port=8008):
        httpd = real_serve(srv, paths, host, 0)
        served["ann"] = srv.ann
        t = threading.Thread(target=httpd.serve_forever, daemon=True)
        t.start()
        url = f"http://{host}:{httpd.server_address[1]}/search?q=a+query&k=4"
        served["hits"] = json.loads(urllib.request.urlopen(url, timeout=30).read())
        httpd.shutdown()
        return _Stopped(httpd)

    class _Stopped:
        def __init__(self, httpd):
            self.httpd = httpd

        def serve_forever(self):
            pass

        def server_close(self):
            self.httpd.server_close()

    monkeypatch.setattr(webui, "serve", fake_serve)
    webui.main(["--folder", str(folder), "--fake-encoder", "--device", "cpu", "--ann", "ivf",
                "--nlist", "3", "--nprobe", "3"])
    assert isinstance(served["ann"], IVFIndex) and served["ann"].nprobe == 3
    assert len(served["hits"]) == 4


# -- the fixture ------------------------------------------------------------------


def write_jax_fixture(path=FIXTURE, answers=FIXTURE_ANSWERS):
    """The JAX package's IVFIndex.save of an int8, replicas=2 index with a
    tail and custom paths, and its answers to 8 seeded queries."""
    rows, q = clustered(seed=19, n=2048, d=64, centers=24)
    j = jivf.IVFIndex(nlist=32, nprobe=8, seed=0, dtype="int8").build(
        rows, paths=[f"img/{i:04d}.jpg" for i in range(len(rows))], replicas=2, train_size=1536)
    j.add(q[:4] * 2.0 + 0.1, paths=[f"tail/{i}.jpg" for i in range(4)])
    j.save(path)
    scores, ids = j.search(q, top_k=10)
    np.savez(answers, queries=q, scores=scores, ids=ids)


if __name__ == "__main__":
    write_jax_fixture()
    print(f"wrote {FIXTURE} and {FIXTURE_ANSWERS}")
