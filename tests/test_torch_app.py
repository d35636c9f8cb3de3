"""The port's app layer on the CPU, held against the JAX package's with the
deterministic FakeEncoder (bit-identical embeddings in both packages): live
ingest and image queries through SearchServer (the counterparts of the first
four tests of tests/test_server_ingest.py), durable serving
(tests/test_durable_serving.py), search_by_image with its self-exclusion,
ImageSearchApp, the CLI's search and compare against the JAX CLI's printed
answers, the web UI's JSON against the JAX web UI's, and the pymilvus shim
(tests/test_compat.py)."""

import json
import os
import re
import threading
import urllib.error
import urllib.parse
import urllib.request

import numpy as np
import pytest
from PIL import Image

from image_retrieval_tpu.app import cli as jax_cli
from image_retrieval_tpu.app.pipeline import ImageSearchApp as JaxApp
from image_retrieval_tpu.app.search import TextImageSearcher as JaxSearcher
from image_retrieval_tpu.app.server import SearchServer as JaxServer
from image_retrieval_tpu.app.webui import serve as jax_serve
from image_retrieval_tpu.config import IndexConfig as JaxIndexConfig
from image_retrieval_tpu.index.vector_index import ShardedVectorIndex as JaxIndex
from image_retrieval_tpu.models.encoder import FakeEncoder as JaxFake
from image_retrieval_tpu_torch.app import cli
from image_retrieval_tpu_torch.app.pipeline import ImageSearchApp
from image_retrieval_tpu_torch.app.search import TextImageSearcher
from image_retrieval_tpu_torch.app.server import SearchServer
from image_retrieval_tpu_torch.app.webui import serve
from image_retrieval_tpu_torch.config import IndexConfig
from image_retrieval_tpu_torch.index.compat import Collection, drop_collection, has_collection
from image_retrieval_tpu_torch.index.vector_index import ShardedVectorIndex
from image_retrieval_tpu_torch.models.encoder import FakeEncoder

SCORE_ATOL = 1e-4  # the CLI prints four decimals; the answers themselves agree to 1e-6


def _write_images(folder, names, seed=0, size=64):
    rng = np.random.default_rng(seed)
    paths = []
    for n in names:
        p = str(folder / f"{n}.png")
        Image.fromarray((rng.random((size, size, 3)) * 255).astype(np.uint8)).save(p)
        paths.append(p)
    return paths


def _index(dim=512, **cfg):
    return ShardedVectorIndex(dim=dim, config=IndexConfig(embedding_dim=dim, capacity_step=64,
                                                          **cfg), device="cpu")


# -- live ingest: tests/test_server_ingest.py ------------------------------


@pytest.fixture()
def stack(tmp_path):
    enc = FakeEncoder(dim=512)
    idx = _index()
    base = _write_images(tmp_path, [f"base{i}" for i in range(6)])
    idx.insert(base, enc.encode_images(base))
    return enc, idx, tmp_path


def test_add_images_visible_to_searches(stack):
    enc, idx, tmp = stack
    new = _write_images(tmp, ["new0", "new1"], seed=7)
    with SearchServer(enc, idx) as server:
        assert server.add_images(new) == (2, 0)
        hits = server.search_similar(new[0], top_k=1, exclude_self=False)
        assert hits[0]["path"] == new[0]
        assert server.stats["ingested"] == 2
    assert idx.live_count == 8


def test_add_images_skips_undecodable(stack):
    enc, idx, tmp = stack
    bad = tmp / "broken.png"
    bad.write_bytes(b"not an image")
    good = _write_images(tmp, ["ok0"], seed=9)
    with SearchServer(enc, idx) as server:
        assert server.add_images([str(bad)] + good) == (1, 1)
    assert good[0] in idx.paths


def test_remove_images_disappear_from_results(stack):
    enc, idx, tmp = stack
    victim = idx.paths[0]
    with SearchServer(enc, idx) as server:
        assert server.search_similar(victim, top_k=3, exclude_self=False)[0]["path"] == victim
        assert server.remove_images([victim]) == 1
        after = server.search_similar(victim, top_k=3, exclude_self=False)
        assert all(h["path"] != victim for h in after)
        assert server.stats["removed"] == 1
    assert idx.live_count == 5


def test_concurrent_search_during_ingest(stack):
    enc, idx, tmp = stack
    new = _write_images(tmp, [f"burst{i}" for i in range(8)], seed=3)
    errors = []
    with SearchServer(enc, idx, max_wait_ms=1) as server:
        stop = threading.Event()

        def searcher():
            try:
                while not stop.is_set():
                    assert len(server.search("some object", top_k=3)) == 3
                    assert len(server.search_similar(idx.paths[1], top_k=2)) == 2
            except Exception as e:  # reported after the join
                errors.append(e)

        t = threading.Thread(target=searcher)
        t.start()
        try:
            for p in new:
                server.add_images([p])
            server.remove_images(new[:2])
        finally:
            stop.set()
            t.join(timeout=30)
    assert not errors, errors[:1]
    assert idx.live_count == 6 + 8 - 2


def test_server_answers_match_the_jax_server(stack):
    """Text and image requests in one wave, the image's own path excluded
    (also when spelled another way), against the JAX server."""
    enc, idx, tmp = stack
    jidx = JaxIndex(dim=512, config=JaxIndexConfig(capacity_step=64))
    jidx.insert(idx.paths, JaxFake(dim=512).encode_images(idx.paths))
    other_spelling = os.path.join(str(tmp), ".", os.path.basename(idx.paths[2]))
    with SearchServer(enc, idx) as mine, JaxServer(JaxFake(dim=512), jidx) as ref:
        for call in (lambda s: s.search("a red square", top_k=4),
                     lambda s: s.search_similar(idx.paths[2], top_k=4),
                     lambda s: s.search_similar(other_spelling, top_k=4),
                     lambda s: s.search_similar(idx.paths[2], top_k=3, metric="optimized_similarity",
                                                weights={"w_l1": 1.0, "w_mag": 0.5}),
                     lambda s: s.search_similar(
                         np.asarray(Image.open(idx.paths[3]).convert("RGB")), top_k=3)):
            got, want = call(mine), call(ref)
            assert [h["path"] for h in got] == [h["path"] for h in want]
            np.testing.assert_allclose([h["score"] for h in got], [h["score"] for h in want],
                                       atol=1e-5)
        assert idx.paths[2] not in [h["path"] for h in mine.search_similar(other_spelling)]


# -- durable serving: tests/test_durable_serving.py ------------------------


class CountingEncoder(FakeEncoder):
    """FakeEncoder that counts the images it encodes."""

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        self.images_encoded = 0

    def encode_images(self, paths, batch_size=256):
        self.images_encoded += len(paths)
        return super().encode_images(paths)

    def encode_pixels(self, pixels):
        self.images_encoded += len(pixels)
        return super().encode_pixels(pixels)


def _open(jdir):
    return ShardedVectorIndex.open(jdir, config=IndexConfig(embedding_dim=512, capacity_step=64),
                                   device="cpu")


def test_server_restart_keeps_acknowledged_inserts(tmp_path):
    enc = FakeEncoder(dim=512)
    jdir = str(tmp_path / "j")
    idx = _open(jdir)
    base = _write_images(tmp_path, [f"base{i}" for i in range(4)], size=48)
    new = _write_images(tmp_path, ["live0", "live1", "live2"], seed=7, size=48)
    server = SearchServer(enc, idx)
    server.start()
    idx.insert(base, enc.encode_images(base))
    idx.flush()
    assert server.add_images(new) == (3, 0)  # acknowledged: durable
    server.stop()
    del server, idx  # a crash: no save(), no checkpoint()
    re_idx = _open(jdir)
    assert re_idx.live_count == 7
    with SearchServer(enc, re_idx) as server2:
        assert server2.search_similar(new[1], top_k=1, exclude_self=False)[0]["path"] == new[1]


def test_server_restart_keeps_acknowledged_deletes(tmp_path):
    enc = FakeEncoder(dim=512)
    jdir = str(tmp_path / "j")
    idx = _open(jdir)
    paths = _write_images(tmp_path, [f"im{i}" for i in range(6)], size=48)
    idx.insert(paths, enc.encode_images(paths))
    idx.flush()
    with SearchServer(enc, idx) as server:
        assert server.remove_images([paths[0], paths[3]]) == 2
    del idx
    re_idx = _open(jdir)
    assert re_idx.live_count == 4
    alive = {p for p, a in zip(re_idx.paths, re_idx.live_mask()) if a}
    assert paths[0] not in alive and paths[3] not in alive


def _app(enc, jdir):
    app = ImageSearchApp(encoder=enc, journal_dir=jdir, device="cpu")
    app.config.index = IndexConfig(embedding_dim=512, capacity_step=64)
    return app


def test_facade_restart_recovers_without_reencoding(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # new_embeddings.npz lands here
    imgs = _write_images(tmp_path, [f"a{i}" for i in range(5)], size=48)
    jdir = str(tmp_path / "j")
    enc1 = CountingEncoder(dim=512)
    app1 = _app(enc1, jdir)
    app1.process_images(imgs)
    res1 = app1.search_images("a red thing", top_k=3)
    assert enc1.images_encoded == 5 and len(res1) == 3
    del app1
    enc2 = CountingEncoder(dim=512)
    app2 = _app(enc2, jdir)
    app2.process_images(imgs)
    assert enc2.images_encoded == 0
    assert [r["path"] for r in app2.search_images("a red thing", top_k=3)] == \
        [r["path"] for r in res1]


def test_facade_restart_delta_inserts_only_new(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    old = _write_images(tmp_path, ["o0", "o1", "o2"], size=48)
    jdir = str(tmp_path / "j")
    app = _app(CountingEncoder(dim=512), jdir)
    app.process_images(old)
    assert app._ensure_index().live_count == 3
    del app
    new = _write_images(tmp_path, ["n0", "n1"], seed=5, size=48)
    enc2 = CountingEncoder(dim=512)
    app2 = _app(enc2, jdir)
    app2.process_images(old + new)
    idx = app2._ensure_index()
    assert enc2.images_encoded == 2
    assert idx.live_count == 5
    assert sorted(idx.paths) == sorted(old + new)


def test_facade_checkpoint_bounds_replay(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    imgs = _write_images(tmp_path, [f"c{i}" for i in range(4)], size=48)
    jdir = str(tmp_path / "j")
    app = _app(FakeEncoder(dim=512), jdir)
    app.process_images(imgs)
    app.checkpoint()
    del app
    assert (tmp_path / "j" / "CURRENT").exists()
    app2 = _app(CountingEncoder(dim=512), jdir)
    app2.process_images(imgs)
    assert app2._ensure_index().live_count == 4


def test_empty_partition_survives_restart(tmp_path):
    jdir = str(tmp_path / "j")
    drop_collection("imgs")
    coll = Collection("imgs", dim=32, journal_dir=jdir, device="cpu")
    coll.create_partition("humans")
    coll.create_partition("cats")
    rng = np.random.default_rng(0)
    coll.insert([["p0", "p1"], rng.normal(size=(2, 32)).astype(np.float32)],
                partition_name="cats")
    coll.flush()
    drop_collection("imgs")  # a restart: the process's registry is gone
    re_coll = Collection("imgs", dim=32, journal_dir=jdir, device="cpu")
    assert re_coll.has_partition("humans") and re_coll.has_partition("cats")
    re_coll.drop_partition("humans")
    drop_collection("imgs")
    re2 = Collection("imgs", dim=32, journal_dir=jdir, device="cpu")
    assert not re2.has_partition("humans") and re2.has_partition("cats")
    drop_collection("imgs")


# -- search_by_image ---------------------------------------------------------


@pytest.fixture()
def gallery(tmp_path):
    folder = tmp_path / "g"
    (folder / "red").mkdir(parents=True)
    (folder / "blue").mkdir()
    paths = (_write_images(folder / "red", [f"r{i}" for i in range(7)], seed=1, size=40)
             + _write_images(folder / "blue", [f"b{i}" for i in range(6)], seed=2, size=40))
    return folder, paths


@pytest.mark.parametrize("optimized", [False, True])
def test_search_by_image_excludes_itself_and_matches_jax(gallery, optimized):
    folder, paths = gallery
    enc = FakeEncoder(dim=512)
    idx, jidx = _index(), JaxIndex(dim=512, config=JaxIndexConfig(capacity_step=64))
    emb = enc.encode_images(paths)
    dirs = {"dir": [os.path.basename(os.path.dirname(p)) for p in paths]}
    idx.insert(paths, emb, attrs=dirs)
    jidx.insert(paths, emb, attrs=dirs)
    mine, ref = TextImageSearcher(enc, idx), JaxSearcher(JaxFake(dim=512), jidx)
    kw = dict(top_k=4, score_threshold=0.0 if optimized else -1.0,
              use_optimized_similarity=optimized)
    for query in (paths[3], os.path.join(str(folder), "red", ".", "r3.png")):
        got = mine.search_by_image(query, **kw)
        assert [r["path"] for r in got] == [r["path"] for r in ref.search_by_image(query, **kw)]
        assert paths[3] not in [r["path"] for r in got]  # itself, in any spelling
        assert len(got) == 4
    kept = mine.search_by_image(paths[3], exclude_self=False, **kw)
    assert paths[3] in [r["path"] for r in kept]
    got = mine.search_by_image(paths[3], filter_expr="dir == 'blue'", **kw)
    assert [r["path"] for r in got] == \
        [r["path"] for r in ref.search_by_image(paths[3], filter_expr="dir == 'blue'", **kw)]
    assert got and all("/blue/" in r["path"] for r in got)
    pixels = np.asarray(Image.open(paths[5]).convert("RGB"))
    for px in (pixels, pixels.astype(np.float32) / 255.0):
        got = mine.search_by_image(px, **kw)
        want = ref.search_by_image(px, **kw)
        assert [r["path"] for r in got] == [r["path"] for r in want]
        np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                                   atol=1e-5)
    with pytest.raises(ValueError, match="pixels"):
        mine.search_by_image(np.zeros((4, 4)))


# -- ImageSearchApp -----------------------------------------------------------


def test_image_search_app_matches_jax(gallery, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    folder, paths = gallery
    mine = ImageSearchApp(encoder=FakeEncoder(dim=512), device="cpu")
    ref = JaxApp(encoder=JaxFake(dim=512))
    for app in (mine, ref):
        app.process_images(app.scan_folders(str(folder)))
    assert list(mine.embeddings) == list(ref.embeddings)
    for a, b in zip(mine.embeddings.values(), ref.embeddings.values()):
        np.testing.assert_array_equal(a, b)
    calls = [
        lambda a: a.search_images("a red square", top_k=5),
        lambda a: a.search_images("a red square", top_k=5, use_optimized_similarity=True),
        lambda a: a.search_images("a blue thing", top_k=5, filter_expr="dir == 'blue'"),
        lambda a: a.find_similar_images(paths[2], top_k=4),
        lambda a: a.find_similar_images(np.asarray(Image.open(paths[8]).convert("RGB")), top_k=3),
    ]
    for call in calls:
        got, want = call(mine), call(ref)
        assert [r["path"] for r in got] == [r["path"] for r in want]
        np.testing.assert_allclose([r["score"] for r in got], [r["score"] for r in want],
                                   atol=1e-5)
    assert all("/blue/" in r["path"] for r in calls[2](mine))
    assert paths[2] not in [r["path"] for r in calls[3](mine)]
    got = mine.search_with_multiple_metrics("a red square", top_k=4)
    want = ref.search_with_multiple_metrics("a red square", top_k=4)
    for key in ("cosine_similarity", "l1_distance", "l2_distance"):
        assert [r["path"] for r in got[key]] == [r["path"] for r in want[key]]
        np.testing.assert_allclose([r["score"] for r in got[key]],
                                   [r["score"] for r in want[key]], atol=1e-5)
    assert got["analysis"] == want["analysis"]


# -- the CLI --------------------------------------------------------------------

HIT = re.compile(r"^\s*\d+\. ([+-]?\d+\.\d+)\s+(\S.*)$")


def _hits(out):
    return [(float(m.group(1)), m.group(2)) for m in map(HIT.match, out.splitlines()) if m]


def _run_both(argv, capsys):
    """The port's CLI on the CPU and the JAX CLI on the same argv:
    (port stdout, JAX stdout)."""
    assert cli.main(argv + ["--device", "cpu"]) == 0
    mine = capsys.readouterr().out
    args = jax_cli.make_parser().parse_args(argv)
    assert args.fn(args) == 0
    return mine, capsys.readouterr().out


@pytest.mark.parametrize("extra", [
    ["a red square"],
    ["a red square", "--optimized", "--top-k", "4"],
    ["a blue thing", "--filter", "dir == 'blue'"],
    ["--image", "IMAGE"],
])
def test_cli_search_matches_the_jax_cli(gallery, tmp_path, monkeypatch, capsys, extra):
    monkeypatch.chdir(tmp_path)
    folder, paths = gallery
    extra = [paths[4] if a == "IMAGE" else a for a in extra]
    mine, ref = _run_both(["search", "--folder", str(folder), "--fake-encoder"] + extra, capsys)
    got, want = _hits(mine), _hits(ref)
    assert got and [p for _, p in got] == [p for _, p in want]
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want], atol=SCORE_ATOL)
    if "--image" in extra:
        assert paths[4] not in [p for _, p in got]


def test_cli_compare_matches_the_jax_cli(gallery, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    folder, _ = gallery
    mine, ref = _run_both(["compare", "--folder", str(folder), "--fake-encoder",
                           "a red square", "--top-k", "4"], capsys)
    got, want = _hits(mine), _hits(ref)
    assert len(got) == 12 and [p for _, p in got] == [p for _, p in want]
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want], atol=SCORE_ATOL)
    tail = lambda out: out[out.index("== intersections =="):]
    assert tail(mine) == tail(ref)


@pytest.mark.parametrize("cmd,extra", [
    ("search", ["a red square", "--ann", "screen", "--screen-candidates", "16"]),
    ("search", ["a red square", "--ann", "screen", "--screen-dims", "8", "--optimized"]),
    ("search", ["--approx-select", "a red square"]),
    ("compare", ["--approx-select", "a red square", "--top-k", "4"]),
])
def test_cli_ann_screen_and_approx_select_match_the_jax_cli(gallery, tmp_path, monkeypatch,
                                                            capsys, cmd, extra):
    """--ann screen (candidates from the projection screen, reranked) and
    --approx-select: the JAX CLI's answers on the same folder."""
    monkeypatch.chdir(tmp_path)
    folder, _ = gallery
    mine, ref = _run_both([cmd, "--folder", str(folder), "--fake-encoder"] + extra, capsys)
    got, want = _hits(mine), _hits(ref)
    assert got and [p for _, p in got] == [p for _, p in want]
    np.testing.assert_allclose([s for s, _ in got], [s for s, _ in want], atol=SCORE_ATOL)


def test_cli_serve_with_ann_screen(gallery, tmp_path, monkeypatch, capsys):
    """serve --ann screen: the server takes its candidates from the screen;
    over 13 rows the pool covers them all, so the exact server's answers."""
    monkeypatch.chdir(tmp_path)
    folder, _ = gallery
    out = []
    for ann in ("screen", "exact"):
        lines = iter(["a red square", ""])
        monkeypatch.setattr("builtins.input", lambda prompt: next(lines))
        assert cli.main(["serve", "--folder", str(folder), "--fake-encoder", "--device",
                         "cpu", "--ann", ann, "--top-k", "3"]) == 0
        out.append(_hits(capsys.readouterr().out))
    assert len(out[0]) == 3 and [p for _, p in out[0]] == [p for _, p in out[1]]
    np.testing.assert_allclose([s for s, _ in out[0]], [s for s, _ in out[1]], atol=1e-5)


def test_cli_journal_dir_grid_and_serve(gallery, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    folder, _ = gallery
    jdir = str(tmp_path / "j")
    argv = ["search", "--folder", str(folder), "--fake-encoder", "--journal_dir", jdir,
            "a query", "--top-k", "2", "--device", "cpu", "--save-grid",
            str(tmp_path / "grid.png")]
    assert cli.main(argv) == 0
    first = _hits(capsys.readouterr().out)
    assert (tmp_path / "j" / "ops.jsonl").exists() and (tmp_path / "grid.png").exists()
    assert cli.main(argv) == 0  # served from the recovered index
    assert _hits(capsys.readouterr().out) == first
    lines = iter(["a red square", ""])
    monkeypatch.setattr("builtins.input", lambda prompt: next(lines))
    assert cli.main(["serve", "--folder", str(folder), "--fake-encoder", "--journal-dir",
                     jdir, "--device", "cpu", "--top-k", "3"]) == 0
    out = capsys.readouterr().out
    assert "Serving 13 vectors" in out and len(_hits(out)) == 3
    assert cli.main(["search", "--folder", str(folder), "--fake-encoder", "--device",
                     "cpu"]) == 2  # neither a query nor --image


# -- the web UI -----------------------------------------------------------------


@pytest.fixture(scope="module")
def web_pair(tmp_path_factory):
    """The port's and the JAX package's web UIs over the same images."""
    folder = tmp_path_factory.mktemp("web_imgs")
    paths = _write_images(folder, [f"i{i}" for i in range(8)], seed=4, size=40)
    bases, stops = [], []
    for srv_cls, idx, enc, serve_fn in (
            (SearchServer, _index(), FakeEncoder(dim=512), serve),
            (JaxServer, JaxIndex(dim=512, config=JaxIndexConfig(capacity_step=64)),
             JaxFake(dim=512), jax_serve)):
        idx.insert(paths, enc.encode_images(paths))
        srv = srv_cls(enc, idx)
        srv.start()
        httpd = serve_fn(srv, idx.paths, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        bases.append(f"http://127.0.0.1:{httpd.server_address[1]}")
        stops.append((httpd, srv))
    yield bases, paths
    for httpd, srv in stops:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()


def _get(url):
    return json.loads(urllib.request.urlopen(url).read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"}, method="POST")
    return json.loads(urllib.request.urlopen(req).read())


def test_webui_json_matches_the_jax_webui(web_pair):
    (mine, ref), paths = web_pair
    q = urllib.parse.quote(paths[2])
    for tail in ("/search?q=brown%20shape&k=3",
                 "/search?q=brown&k=4&metric=optimized&w_angle=1&w_l1=1&w_mag=0.5",
                 f"/similar?path={q}&k=3",
                 f"/similar?path={q}&k=3&metric=optimized&w_l1=1&w_l2=1&w_mag=0.5",
                 "/search?q=brown&k=3&approx=0"):
        got, want = _get(mine + tail), _get(ref + tail)
        assert [h["path"] for h in got] == [h["path"] for h in want]
        np.testing.assert_allclose([h["score"] for h in got], [h["score"] for h in want],
                                   atol=1e-5)
    assert paths[2] not in [h["path"] for h in _get(mine + f"/similar?path={q}&k=3")]
    body = {"queries": ["brown", "shape"], "k": 2}
    got, want = _post(mine + "/batch_search", body), _post(ref + "/batch_search", body)
    assert [[h["path"] for h in r] for r in got] == [[h["path"] for h in r] for r in want]
    stats = _get(mine + "/stats")
    assert set(_get(ref + "/stats")) <= set(stats) | {"ingested", "removed"}
    assert stats["indexed_images"] == len(paths) and stats["requests"] >= 1
    page = urllib.request.urlopen(mine + "/").read().decode()
    assert "<form" in page
    ok = urllib.request.urlopen(mine + "/image?path=" + urllib.parse.quote(paths[0]))
    assert ok.status == 200 and ok.headers["Content-Type"] == "image/png"
    for bad in ("/image?path=/etc/passwd", "/similar?path=/etc/passwd&k=3", "/nothing"):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(mine + bad)
        assert e.value.code == 404


def test_webui_client_errors_and_approx(web_pair):
    """Malformed requests answer 400; approx=1 (the approximate selector)
    answers as the JAX web UI does."""
    (mine, ref), paths = web_pair
    for tail in ("/search?q=brown&k=3&approx=exact", "/search?q=brown&k=3&approx=maybe",
                 "/search?q=brown&k=3&filter=nope%20%3D%3D", "/search?q=%20&k=3"):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(mine + tail)
        assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(mine + "/batch_search", {"queries": ["a"], "approx": "yes"})
    assert e.value.code == 400
    q = urllib.parse.quote(paths[1])
    for tail in ("/search?q=brown&k=3&approx=1", f"/similar?path={q}&k=3&approx=1",
                 "/search?q=brown&k=4&metric=optimized&w_l1=1&approx=true"):
        got, want = _get(mine + tail), _get(ref + tail)
        assert [h["path"] for h in got] == [h["path"] for h in want]
        np.testing.assert_allclose([h["score"] for h in got], [h["score"] for h in want],
                                   atol=1e-5)
    body = {"queries": ["brown", "shape"], "k": 2, "approx": True}
    got, want = _post(mine + "/batch_search", body), _post(ref + "/batch_search", body)
    assert [[h["path"] for h in r] for r in got] == [[h["path"] for h in r] for r in want]


def test_webui_live_add_and_remove(tmp_path):
    enc = FakeEncoder(dim=512)
    idx = _index()
    paths = _write_images(tmp_path, [f"w{i}" for i in range(4)], size=40)
    idx.insert(paths, enc.encode_images(paths))
    new = _write_images(tmp_path, ["fresh"], seed=8, size=40)
    with SearchServer(enc, idx) as srv:
        httpd = serve(srv, idx.paths, port=0)
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{httpd.server_address[1]}"
        try:
            assert _post(base + "/add", {"paths": new}) == {"inserted": 1, "failed": 0}
            hits = _get(base + "/similar?path=" + urllib.parse.quote(new[0]) + "&k=5")
            assert len(hits) == 4 and new[0] not in [h["path"] for h in hits]
            assert _post(base + "/remove", {"paths": [paths[0]]}) == {"removed": 1}
            assert paths[0] not in [h["path"] for h in _get(base + "/search?q=x&k=5")]
        finally:
            httpd.shutdown()
            httpd.server_close()


# -- the pymilvus shim: tests/test_compat.py --------------------------------------


def _unit_rows(rng, n, d):
    emb = rng.normal(size=(n, d)).astype(np.float32)
    mags = np.linalg.norm(emb, axis=1)
    return emb, emb / mags[:, None], mags


def test_milvus_style_usage(rng):
    drop_collection("image_embeddings")
    collection = Collection("image_embeddings", dim=64, device="cpu")
    _, unit, mags = _unit_rows(rng, 50, 64)
    collection.insert([[f"p{i}.jpg" for i in range(50)], unit, mags])
    collection.flush()
    assert collection.num_entities == 50 and has_collection("image_embeddings")
    collection.create_index("embedding", {"metric_type": "COSINE"})
    collection.load()
    results = collection.search(data=[unit[3]], anns_field="embedding",
                                param={"metric_type": "COSINE", "params": {"nprobe": 10}},
                                limit=5, output_fields=["image_path", "embedding", "magnitude"])
    hit = results[0][0]
    assert hit.entity.get("image_path") == "p3.jpg"
    assert hit.score == pytest.approx(1.0, abs=1e-5)
    np.testing.assert_allclose(hit.entity.get("embedding"), unit[3], atol=1e-5)
    assert hit.entity.get("magnitude") == pytest.approx(float(mags[3]))
    rows = collection.query(expr="id >= 0", output_fields=["image_path", "magnitude"], limit=10)
    assert len(rows) == 10 and rows[0]["image_path"] == "p0.jpg"
    collection.release()
    assert Collection("image_embeddings").num_entities == 50
    drop_collection("image_embeddings")


def test_collection_l2_metric_and_drop(rng):
    drop_collection("tmp_l2")
    col = Collection("tmp_l2", dim=32, device="cpu")
    emb, unit, mags = _unit_rows(rng, 20, 32)
    col.insert([[f"x{i}" for i in range(20)], unit, mags])
    res = col.search(data=[emb[5]], param={"metric_type": "L2"}, limit=3,
                     output_fields=["image_path"])
    assert res[0][0].entity.get("image_path") == "x5"
    drop_collection("tmp_l2")
    assert not has_collection("tmp_l2")


def test_collection_schema_and_metric_validation(rng):
    drop_collection("val_test")
    c = Collection("val_test", dim=32, device="cpu")
    assert c.search([rng.normal(size=32).astype(np.float32)], limit=3) == [[]]
    assert Collection("val_test")._impl.dim == 32
    with pytest.raises(ValueError, match="dim"):
        Collection("val_test", dim=128)
    c.insert([["a"], rng.normal(size=(1, 32)).astype(np.float32)])
    with pytest.raises(ValueError, match="metric_type"):
        c.search([rng.normal(size=32).astype(np.float32)], param={"metric_type": "IP"}, limit=1)
    drop_collection("val_test")


def test_partitions_lifecycle_and_scoped_ops(rng):
    drop_collection("parts")
    c = Collection("parts", dim=32, device="cpu")
    c.create_partition("summer")
    c.create_partition("winter")
    assert c.has_partition("summer") and not c.has_partition("autumn")
    assert c.partitions == ["_default", "summer", "winter"]

    def rows(n, tag):
        _, unit, mags = _unit_rows(rng, n, 32)
        return [[f"{tag}{i}.jpg" for i in range(n)], unit, mags]

    c.insert(rows(6, "s"), partition_name="summer")
    c.insert(rows(6, "w"), partition_name="winter")
    c.insert(rows(4, "d"))
    assert c.num_entities == 16
    with pytest.raises(ValueError, match="does not exist"):
        c.insert(rows(1, "x"), partition_name="autumn")
    q = rng.normal(size=32).astype(np.float32)
    hits = c.search([q], limit=16, partition_names=["summer"])[0]
    assert len(hits) == 6 and all(h.entity.get("image_path").startswith("s") for h in hits)
    assert len(c.search([q], limit=16, partition_names=["summer", "winter"])[0]) == 12
    assert len(c.search([q], limit=16, expr="image_path != 's0.jpg'",
                        partition_names=["summer"])[0]) == 5
    with pytest.raises(ValueError, match="does not exist"):
        c.search([q], limit=3, partition_names=["autumn"])
    rows_q = c.query(expr="id >= 0", partition_names=["winter"], output_fields=["image_path"])
    assert len(rows_q) == 6 and all(r["image_path"].startswith("w") for r in rows_q)
    assert c.drop_partition("winter") == 6
    assert not c.has_partition("winter")
    assert len(c.search([q], limit=16)[0]) == 10
    with pytest.raises(ValueError, match="_default"):
        c.drop_partition("_default")
    assert Collection("parts").partitions == ["_default", "summer"]
    assert c.delete("image_path == 'd0.jpg'") == 1
    drop_collection("parts")


def test_partitions_default_when_column_absent(rng):
    drop_collection("parts_raw")
    idx = _index(dim=16)
    _, unit, _ = _unit_rows(rng, 5, 16)
    idx.insert([f"r{i}.jpg" for i in range(5)], unit)
    c = Collection("parts_raw", index=idx)
    q = rng.normal(size=16).astype(np.float32)
    assert len(c.search([q], limit=9, partition_names=["_default"])[0]) == 5
    c.create_partition("p1")
    assert c.search([q], limit=9, partition_names=["p1"])[0] == []
    drop_collection("parts_raw")


def test_search_batches_query_list(rng):
    drop_collection("batched_search")
    c = Collection("batched_search", dim=32, device="cpu")
    _, unit, mags = _unit_rows(rng, 40, 32)
    c.insert([[f"b{i}.jpg" for i in range(40)], unit, mags])
    queries = [unit[5], unit[17], unit[33]]
    batched = c.search(data=queries, limit=4, output_fields=["image_path"])
    assert len(batched) == 3
    for qi, q in enumerate(queries):
        single = c.search(data=[q], limit=4, output_fields=["image_path"])
        assert [h.entity.get("image_path") for h in batched[qi]] == \
            [h.entity.get("image_path") for h in single[0]]
        np.testing.assert_allclose([h.score for h in batched[qi]],
                                   [h.score for h in single[0]], rtol=1e-6)
    assert c.search(data=[], limit=5) == []
    drop_collection("batched_search")


def test_journaled_collection_double_open_is_safe(tmp_path):
    jd = str(tmp_path / "j")
    drop_collection("dbl")
    c1 = Collection("dbl", dim=16, journal_dir=jd, device="cpu")
    c1.insert([[f"x{i}" for i in range(3)], np.eye(16, dtype=np.float32)[:3],
               np.ones(3, np.float32)])
    assert Collection("dbl", journal_dir=jd)._impl is c1._impl
    assert Collection("dbl")._impl is c1._impl
    with pytest.raises(ValueError, match="already open"):
        Collection("dbl", journal_dir=str(tmp_path / "other"))
    drop_collection("dbl")


def test_non_ascii_partition_names(rng):
    drop_collection("uni")
    c = Collection("uni", dim=16, device="cpu")
    c.create_partition("café")
    _, unit, _ = _unit_rows(rng, 4, 16)
    mags = np.ones(4, np.float32)
    c.insert([[f"c{i}" for i in range(2)], unit[:2], mags[:2]], partition_name="café")
    c.insert([[f"d{i}" for i in range(2)], unit[2:], mags[2:]])
    hits = c.search(data=[unit[0]], limit=4, partition_names=["café"],
                    output_fields=["image_path"])
    assert {h.entity.get("image_path") for h in hits[0]} == {"c0", "c1"}
    assert c.drop_partition("café") == 2
    drop_collection("uni")


def test_shim_matches_the_jax_shim_and_survives_restart(rng, tmp_path):
    from image_retrieval_tpu.index import compat as jax_compat

    emb, unit, mags = _unit_rows(rng, 30, 32)
    jd = str(tmp_path / "milvus")
    drop_collection("jtest")
    mine = Collection("jtest", dim=32, journal_dir=jd, device="cpu")
    mine.create_partition("red")
    mine.insert([[f"a{i}" for i in range(10)], unit[:10], mags[:10]], partition_name="red")
    mine.insert([[f"c{i}" for i in range(20)], unit[10:], mags[10:]], attrs={"n": list(range(20))})
    mine.delete("n >= 15")
    mine.flush()
    drop_collection("jtest")
    jax_compat._REGISTRY.pop("jtest_ref", None)
    ref = jax_compat.Collection("jtest_ref", journal_dir=jd)  # the JAX shim reopens it
    again = Collection("jtest_again", journal_dir=jd, device="cpu")
    assert again.num_entities == ref.num_entities == 30 and again.has_partition("red")
    q = [emb[3], emb[12]]
    for kw in ({"param": {"metric_type": "COSINE"}}, {"param": {"metric_type": "L2"}},
               {"partition_names": ["red"]}, {"expr": "n < 10"}):
        got = again.search(q, limit=6, output_fields=["image_path"], **kw)
        want = ref.search(q, limit=6, output_fields=["image_path"], **kw)
        for g, w in zip(got, want):
            assert [h.entity.get("image_path") for h in g] == \
                [h.entity.get("image_path") for h in w]
            np.testing.assert_allclose([h.score for h in g], [h.score for h in w], atol=1e-5)
    assert again.query(expr="n >= 10", output_fields=["image_path"]) == \
        ref.query(expr="n >= 10", output_fields=["image_path"])
    drop_collection("jtest_again")
    jax_compat._REGISTRY.pop("jtest_ref", None)
