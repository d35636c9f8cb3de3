"""Durability of the port's index: the copies of index/journal.py and
index/evaluation.py pinned to the originals, the port-side forms of
tests/test_journal.py (every test drops the index without save() and
reopens the directory: a crash), the order of the fsyncs, and journal
directories and save files written by either package reopened by the other
on the f32, int8 and int4 tiers with attributes and meta: the same answers
(scores within 1e-5, identical ids). Also the committed fixture
tests/data/jax_journal_int8/, a journal directory written by the JAX package
that chip_smoke.py reopens on the card: it is regenerated here and held to
its expected answers. Regenerate it with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_journal.py
"""

import ast
import json
import os
import pathlib
import shutil

import numpy as np
import pytest

from image_retrieval_tpu.config import IndexConfig as JaxIndexConfig
from image_retrieval_tpu.index.evaluation import mean_recall as jax_mean_recall
from image_retrieval_tpu.index.vector_index import ShardedVectorIndex as JaxIndex
from image_retrieval_tpu_torch.config import IndexConfig
from image_retrieval_tpu_torch.index import journal as journal_mod
from image_retrieval_tpu_torch.index.evaluation import mean_recall
from image_retrieval_tpu_torch.index.vector_index import ShardedVectorIndex

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "data" / "jax_journal_int8"
SCORE_ATOL = 1e-5  # the same rows and queries through the two packages


def _code(path):
    """The module's code without its docstring, as an AST dump."""
    tree = ast.parse(path.read_text(encoding="utf-8"))
    return [ast.dump(node) for node in tree.body[1:]]


@pytest.mark.parametrize("module", ["index/journal.py", "index/evaluation.py"])
def test_copies_pinned_to_the_originals(module):
    assert _code(ROOT / "image_retrieval_tpu_torch" / module) == \
        _code(ROOT / "image_retrieval_tpu" / module)


def test_mean_recall_copy():
    got, exact = np.array([[1, 2, 3], [4, 5, 9]]), np.array([[3, 2, 1], [4, 5, 6]])
    assert mean_recall(got, exact) == jax_mean_recall(got, exact) == pytest.approx(5 / 6)
    with pytest.raises(ValueError):
        mean_recall(got[:1], exact)


def _mk(journal_dir, dtype="float32", dim=32):
    return ShardedVectorIndex.open(
        str(journal_dir), config=IndexConfig(embedding_dim=dim, dtype=dtype), device="cpu")


def _rows(n, dim=32, seed=0):
    return np.random.default_rng(seed).normal(size=(n, dim)).astype(np.float32)


# -- the port-side forms of tests/test_journal.py --------------------------


def test_unflushed_save_free_inserts_survive_reopen(tmp_path):
    idx = _mk(tmp_path / "j")
    idx.insert([f"p{i}" for i in range(8)], _rows(8))
    idx.flush()
    del idx
    re = _mk(tmp_path / "j")
    assert re.paths == [f"p{i}" for i in range(8)]
    assert re.live_count == 8


@pytest.mark.parametrize("dtype", ["float32", "int8", "int4"])
def test_replay_preserves_search_results_exactly(tmp_path, dtype):
    emb = _rows(40, seed=3)
    idx = _mk(tmp_path / "j", dtype)
    idx.insert([f"p{i}" for i in range(40)], emb)
    q = _rows(1, seed=9)[0]
    want = idx.search(q, top_k=5)
    del idx
    got = _mk(tmp_path / "j", dtype).search(q, top_k=5)
    np.testing.assert_array_equal(want[1], got[1])
    np.testing.assert_array_equal(want[0], got[0])


def test_deletes_and_compact_replay(tmp_path):
    idx = _mk(tmp_path / "j")
    idx.insert([f"p{i}" for i in range(10)], _rows(10))
    idx.delete(["p1", "p3"])
    idx.compact()
    idx.insert(["q0", "q1"], _rows(2, seed=5))
    idx.delete_rows([0])  # p0, in the numbering after the compact
    del idx
    re = _mk(tmp_path / "j")
    assert re.live_count == 9
    live = {re.paths[i] for i in np.flatnonzero(re.live_mask())}
    assert live == {"p2", "p4", "p5", "p6", "p7", "p8", "p9", "q0", "q1"}


def test_checkpoint_truncates_and_reopens_fast_path(tmp_path):
    jd = tmp_path / "j"
    idx = _mk(jd)
    idx.insert([f"p{i}" for i in range(6)], _rows(6))
    idx.checkpoint()
    assert (jd / "CURRENT").exists()
    assert os.path.getsize(jd / "ops.jsonl") == 0
    assert not [f for f in os.listdir(jd) if f.startswith("seg-")]
    idx.insert(["late"], _rows(1, seed=7))
    idx.delete(["p0"])
    del idx
    re = _mk(jd)
    assert re.live_count == 6
    assert "late" in re.paths
    assert not re.live_mask()[re.paths.index("p0")]


def test_second_checkpoint_gcs_the_first(tmp_path):
    jd = tmp_path / "j"
    idx = _mk(jd)
    idx.insert(["a", "b"], _rows(2))
    idx.checkpoint()
    first = (jd / "CURRENT").read_text()
    idx.insert(["c"], _rows(1, seed=1))
    idx.checkpoint()
    second = (jd / "CURRENT").read_text()
    assert first != second
    assert not (jd / first).exists()
    del idx
    assert sorted(_mk(jd).paths) == ["a", "b", "c"]


def test_torn_tail_is_ignored(tmp_path):
    jd = tmp_path / "j"
    idx = _mk(jd)
    idx.insert(["a", "b", "c"], _rows(3))
    idx.flush()
    del idx
    with open(jd / "ops.jsonl", "a") as f:  # a crash mid-append
        f.write('{"op": "ins')
    re = _mk(jd)
    assert re.paths == ["a", "b", "c"]
    re.insert(["d"], _rows(1, seed=2))
    del re
    assert "d" in _mk(jd).paths


def test_torn_segment_drops_unflushed_tail(tmp_path):
    """A logged insert whose segment is torn (no flush() since): recovery
    keeps everything up to the last flush and drops the torn record and
    every record after it."""
    jd = tmp_path / "j"
    idx = _mk(jd)
    idx.insert(["a", "b"], _rows(2))
    idx.flush()
    idx.insert(["c"], _rows(1, seed=1))
    idx.insert(["d"], _rows(1, seed=2))
    seqs = sorted(int(f[4:-4]) for f in os.listdir(jd) if f.startswith("seg-"))
    with open(jd / f"seg-{seqs[-2]}.npz", "r+b") as f:
        f.truncate(8)
    re = _mk(jd)
    assert re.paths == ["a", "b"]
    re.insert(["e"], _rows(1, seed=3))
    re.flush()
    del re
    assert _mk(jd).paths == ["a", "b", "e"]


def test_flush_fsyncs_pending_segments(tmp_path):
    idx = _mk(tmp_path / "j")
    idx.insert(["a"], _rows(1))
    idx.insert(["b"], _rows(1, seed=1))
    assert len(idx._journal._pending_segs) == 2
    idx.flush()
    assert idx._journal._pending_segs == []


def test_fsync_order(tmp_path, monkeypatch):
    """flush(): the segments, then their directory, then the op log.
    checkpoint(): the snapshot's files and directory before CURRENT is
    published by rename, and the journal directory after it."""
    jd = tmp_path / "j"
    idx = _mk(jd)
    names = {}
    events = []
    real_open, real_fsync, real_replace = os.open, os.fsync, os.replace

    def rec_open(path, *a, **k):
        fd = real_open(path, *a, **k)
        names[fd] = os.path.relpath(path, jd)
        return fd

    def rec_fsync(fd):
        events.append(("fsync", names.get(fd, "ops.jsonl" if fd == idx._journal._fh.fileno()
                                          else "other")))
        return real_fsync(fd)

    def rec_replace(a, b):
        events.append(("replace", os.path.relpath(b, jd)))
        return real_replace(a, b)

    monkeypatch.setattr(journal_mod.os, "open", rec_open)
    monkeypatch.setattr(journal_mod.os, "fsync", rec_fsync)
    monkeypatch.setattr(journal_mod.os, "replace", rec_replace)
    idx.insert(["a"], _rows(1))
    idx.insert(["b"], _rows(1, seed=1))
    events.clear()
    idx.flush()
    segs = [e for e in events if e[1].startswith("seg-")]
    assert [e[0] for e in segs] == ["fsync", "fsync"]
    assert events.index(("fsync", ".")) > events.index(segs[-1])
    assert events[-1] == ("fsync", "ops.jsonl")
    events.clear()
    idx.checkpoint()
    publish = events.index(("replace", "CURRENT"))
    snap = (jd / "CURRENT").read_text()
    before = {name for kind, name in events[:publish] if kind == "fsync"}
    assert {f"{snap}/{f}" for f in os.listdir(jd / snap)} | {snap} <= before
    assert ("fsync", ".") in events[publish:]


def test_int8_tier_replay_requantizes_identically(tmp_path):
    idx = _mk(tmp_path / "j", dtype="int8")
    idx.insert([f"p{i}" for i in range(30)], _rows(30, seed=4))
    q = _rows(1, seed=8)[0]
    want = idx.search(q, top_k=5)
    del idx
    got = _mk(tmp_path / "j", dtype="int8").search(q, top_k=5)
    np.testing.assert_array_equal(want[1], got[1])
    np.testing.assert_array_equal(want[0], got[0])


def test_attrs_and_filtered_delete_replay(tmp_path):
    idx = _mk(tmp_path / "j")
    idx.insert(["a", "b", "c"], _rows(3), attrs={"color": ["red", "blue", "red"]})
    idx.delete_where("color == 'blue'")
    del idx
    re = _mk(tmp_path / "j")
    assert re.live_count == 2
    assert int(re.filter_mask("color == 'red'").sum()) == 2


def test_journal_records_are_json_clean(tmp_path):
    idx = _mk(tmp_path / "j")
    idx.insert(["a"], _rows(1), attrs={"n": [np.int64(3)]})
    with open(tmp_path / "j" / "ops.jsonl") as f:
        assert json.loads(f.readline())["attrs"]["n"] == [3]


def test_unjournaled_index_checkpoint_raises():
    idx = ShardedVectorIndex(dim=16, config=IndexConfig(embedding_dim=16), device="cpu")
    with pytest.raises(ValueError, match="journaled"):
        idx.checkpoint()
    idx.flush()  # a no-op without a journal


def test_reopen_without_config_recovers_tier(tmp_path):
    idx = _mk(tmp_path / "j", dtype="int8", dim=64)
    idx.insert(["a"], _rows(1, dim=64))
    del idx
    re = ShardedVectorIndex.open(str(tmp_path / "j"), device="cpu")
    assert re.dim == 64 and re.config.dtype == "int8" and re.paths == ["a"]


def test_meta_survives_crash_and_checkpoint(tmp_path):
    idx = _mk(tmp_path / "j")
    idx.insert(["a"], _rows(1))
    idx.set_meta("partitions", ["cats"])
    idx.flush()
    del idx
    re = _mk(tmp_path / "j")
    assert re.meta == {"partitions": ["cats"]}
    re.checkpoint()
    re.set_meta("owner", "x")
    del re
    assert _mk(tmp_path / "j").meta == {"partitions": ["cats"], "owner": "x"}


def test_magnitudes_roundtrip_through_journal(tmp_path):
    emb = _rows(5, seed=6) * 3.7
    idx = _mk(tmp_path / "j")
    idx.insert([f"p{i}" for i in range(5)], emb)
    want = idx.get_magnitudes(range(5))
    del idx
    re = _mk(tmp_path / "j")
    np.testing.assert_array_equal(re.get_magnitudes(range(5)), want)
    np.testing.assert_allclose(dict(re.reconstruct_original_embeddings(limit=5))["p0"],
                               emb[0], rtol=1e-5)


def test_idle_checkpoint_is_noop_and_preserves_snapshot(tmp_path):
    """A second checkpoint with nothing logged since must not touch the
    live snapshot: removing it as a leftover and saving again would lose
    the whole index to a crash in between."""
    jd = tmp_path / "j"
    idx = _mk(jd)
    idx.insert(["a", "b", "c"], _rows(3))
    idx.checkpoint()
    snap = (jd / "CURRENT").read_text()
    snap_dir = jd / snap
    mtimes = {f: os.path.getmtime(snap_dir / f) for f in os.listdir(snap_dir)}
    idx.checkpoint()
    assert (jd / "CURRENT").read_text() == snap
    assert {f: os.path.getmtime(snap_dir / f) for f in os.listdir(snap_dir)} == mtimes
    del idx
    assert _mk(jd).live_count == 3


def test_idle_checkpoint_after_reopen(tmp_path):
    jd = tmp_path / "j"
    idx = _mk(jd)
    idx.insert(["a", "b"], _rows(2))
    idx.checkpoint()
    del idx
    re = _mk(jd)
    re.checkpoint()
    del re
    assert _mk(jd).live_count == 2


def test_recovery_after_a_second_crash_keeps_unterminated_record(tmp_path):
    """A final log line that lost its newline is terminated at recovery, so
    a record appended after it survives a second crash."""
    jd = tmp_path / "j"
    idx = _mk(jd)
    idx.insert(["a", "b"], _rows(2))
    idx.flush()
    del idx
    ops = jd / "ops.jsonl"
    raw = ops.read_bytes()
    assert raw.endswith(b"\n")
    ops.write_bytes(raw[:-1])
    re1 = _mk(jd)
    assert re1.live_count == 2
    re1.insert(["c"], _rows(1, seed=2))
    re1.flush()
    del re1
    re2 = _mk(jd)
    assert re2.live_count == 3 and "c" in re2.paths


def test_save_load_from_roundtrip(tmp_path):
    idx = ShardedVectorIndex(dim=32, config=IndexConfig(embedding_dim=32, dtype="int8"),
                             device="cpu")
    idx.insert([f"p{i}" for i in range(20)], _rows(20), attrs={"k": list(range(20))})
    idx.delete(["p4"])
    idx.set_meta("m", 1)
    idx.save(str(tmp_path / "g"))  # np.savez adds .npz; the sidecars follow it
    assert (tmp_path / "g.npz.config.json").exists()
    re = ShardedVectorIndex.load_from(str(tmp_path / "g"), device="cpu")
    assert re.config.dtype == "int8" and re.meta == {"m": 1} and len(re) == 19
    assert idx.paths == re.paths  # save() compacted the index itself
    q = _rows(3, seed=1)
    np.testing.assert_array_equal(re.search(q, top_k=4, flt="k >= 10")[1],
                                  idx.search(q, top_k=4, flt="k >= 10")[1])
    f32 = ShardedVectorIndex.load_from(str(tmp_path / "g.npz"),
                                       config=IndexConfig(embedding_dim=32), device="cpu")
    assert f32.config.dtype == "float32"


# -- journals and save files across the two packages ------------------------


def _write(pkg, where, dtype, form):
    """An index of `pkg` ("jax" or "torch") with inserts, deletes, attrs and
    meta, left as a journal directory (crashed after flush()) or a save
    file. Returns the path to reopen."""
    cfg = (JaxIndexConfig if pkg == "jax" else IndexConfig)(embedding_dim=64, dtype=dtype)
    kw = {} if pkg == "jax" else {"device": "cpu"}
    cls = JaxIndex if pkg == "jax" else ShardedVectorIndex
    path = str(where / ("j" if form == "journal" else "saved"))
    idx = cls.open(path, config=cfg, **kw) if form == "journal" else cls(64, config=cfg, **kw)
    emb = _rows(120, dim=64, seed=2) * np.linspace(0.5, 3, 120, dtype=np.float32)[:, None]
    idx.insert([f"img/{i:03d}.jpg" for i in range(100)], emb[:100],
               attrs={"color": [("red", "blue", "green")[i % 3] for i in range(100)],
                      "n": list(range(100))})
    idx.delete(["img/005.jpg", "img/017.jpg"])
    unit = emb[100:] / np.linalg.norm(emb[100:], axis=1, keepdims=True)
    idx.insert([f"new/{i}.jpg" for i in range(20)], unit, np.linalg.norm(emb[100:], axis=1),
               attrs={"color": ["red"] * 20, "n": list(range(100, 120))})
    idx.delete_rows([40])
    idx.set_meta("partitions", ["a", "b"])
    if form == "journal":
        idx.flush()
    else:
        idx.save(path)
    return path


def _reopen(pkg, path, form):
    kw = {} if pkg == "jax" else {"device": "cpu"}
    cls = JaxIndex if pkg == "jax" else ShardedVectorIndex
    return cls.open(path, **kw) if form == "journal" else cls.load_from(path, **kw)


@pytest.mark.parametrize("form", ["journal", "save"])
@pytest.mark.parametrize("dtype", ["float32", "int8", "int4"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_written_by_one_package_reopens_in_the_other(tmp_path, writer, dtype, form):
    reader = "torch" if writer == "jax" else "jax"
    path = _write(writer, tmp_path, dtype, form)
    mine, theirs = _reopen(reader, path, form), _reopen(writer, path, form)
    assert mine.config.dtype == dtype and mine.dim == 64
    assert mine.paths == theirs.paths and mine.live_count == theirs.live_count == 117
    np.testing.assert_array_equal(mine.live_mask(), theirs.live_mask())
    assert mine.meta == theirs.meta == {"partitions": ["a", "b"]}
    np.testing.assert_array_equal(mine.filter_mask("color == 'red' and n > 50"),
                                  theirs.filter_mask("color == 'red' and n > 50"))
    q = _rows(6, dim=64, seed=11)
    for flt in (None, "color in ['red', 'green']"):
        mv, mi = mine.search(q, top_k=8, flt=flt)
        tv, ti = theirs.search(q, top_k=8, flt=flt)
        np.testing.assert_array_equal(mi, ti)
        np.testing.assert_allclose(mv, tv, rtol=0, atol=SCORE_ATOL)
    if form == "journal":  # the reader goes on writing the directory
        mine.insert(["late.jpg"], _rows(1, dim=64, seed=4))
        mine.flush()
        assert _reopen(writer, path, form).paths[-1] == "late.jpg"


# -- the committed JAX-written journal ---------------------------------------

FIXTURE_FILTER = "color == 'red'"


def write_jax_fixture(where):
    """A journal directory written by the JAX package into `where`: the int8
    tier at dim 64, 200 rows with attributes and meta sealed in a snapshot,
    then 40 more rows, a delete by path, a delete by row and a meta record in
    the op log; and expected.json: 8 queries and the JAX index's top-10
    (ids and scores), unfiltered and under FIXTURE_FILTER."""
    where = pathlib.Path(where)
    shutil.rmtree(where, ignore_errors=True)
    rng = np.random.default_rng(2024)
    emb = (rng.normal(size=(240, 64)) * rng.uniform(0.5, 4, size=(240, 1))).astype(np.float32)
    colors = [("red", "green", "blue")[i % 3] for i in range(240)]
    idx = JaxIndex.open(str(where), config=JaxIndexConfig(embedding_dim=64, dtype="int8"))
    idx.insert([f"img/{i:03d}.jpg" for i in range(200)], emb[:200],
               attrs={"color": colors[:200], "n": list(range(200))})
    idx.set_meta("partitions", ["red"])
    idx.delete(["img/007.jpg"])
    idx.checkpoint()
    idx.insert([f"new/{i:03d}.jpg" for i in range(40)], emb[200:],
               attrs={"color": colors[200:], "n": list(range(200, 240))})
    idx.delete(["img/011.jpg", "new/003.jpg"])
    idx.delete_rows([150])
    idx.set_meta("owner", "fixture")
    idx.flush()
    queries = rng.normal(size=(8, 64)).astype(np.float32)
    expected = {"queries": queries.tolist(), "count": len(idx), "live": idx.live_count,
                "paths": idx.paths, "meta": idx.meta, "filter": FIXTURE_FILTER}
    for key, flt in (("unfiltered", None), ("filtered", FIXTURE_FILTER)):
        vals, ids = idx.search(queries, top_k=10, flt=flt)
        expected[key] = {"scores": np.asarray(vals).tolist(), "ids": np.asarray(ids).tolist()}
    with open(where / "expected.json", "w") as f:
        json.dump(expected, f)
    return expected


def _check_fixture_answers(idx, expected):
    assert len(idx) == expected["count"] and idx.live_count == expected["live"]
    assert idx.paths == expected["paths"] and idx.meta == expected["meta"]
    q = np.asarray(expected["queries"], np.float32)
    for key, flt in (("unfiltered", None), ("filtered", expected["filter"])):
        vals, ids = idx.search(q, top_k=10, flt=flt)
        np.testing.assert_array_equal(ids, expected[key]["ids"])
        np.testing.assert_allclose(vals, expected[key]["scores"], rtol=0, atol=SCORE_ATOL)


def test_committed_jax_fixture_is_what_the_jax_package_writes(tmp_path):
    fresh = write_jax_fixture(tmp_path / "fresh")
    with open(FIXTURE / "expected.json") as f:
        committed = json.load(f)
    assert {k: v for k, v in committed.items() if k not in ("unfiltered", "filtered")} == \
        {k: v for k, v in fresh.items() if k not in ("unfiltered", "filtered")}
    for key in ("unfiltered", "filtered"):
        assert committed[key]["ids"] == fresh[key]["ids"]
        np.testing.assert_allclose(committed[key]["scores"], fresh[key]["scores"],
                                   rtol=0, atol=1e-6)
    shutil.copytree(FIXTURE, tmp_path / "committed")
    _check_fixture_answers(JaxIndex.open(str(tmp_path / "committed")), committed)


def test_committed_jax_fixture_reopens_in_the_port(tmp_path):
    shutil.copytree(FIXTURE, tmp_path / "j")  # opening rewrites config.json
    with open(FIXTURE / "expected.json") as f:
        expected = json.load(f)
    assert (tmp_path / "j" / "CURRENT").exists()
    idx = ShardedVectorIndex.open(str(tmp_path / "j"), device="cpu")
    assert idx.config.dtype == "int8" and idx.dim == 64
    _check_fixture_answers(idx, expected)


if __name__ == "__main__":
    write_jax_fixture(FIXTURE)
    print(f"wrote {FIXTURE}")
