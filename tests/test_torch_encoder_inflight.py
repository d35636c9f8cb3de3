"""The port's CLIPEncoder keeps up to four chunks in flight: encode_stream,
encode_pixels and encode_images held against the synchronous form (a window
of one chunk) bit for bit and against the JAX encoder on the same weights
(params_from_jax), on a two-layer model at small widths; the order of the
outputs, the window counted through a monkeypatched dispatch, the rule for a
batch larger than the window, and empty batches."""

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from image_retrieval_tpu.config import Config as JaxConfig
from image_retrieval_tpu.config import ModelConfig as JaxModelConfig
from image_retrieval_tpu.models.clip import init_params as jax_init_params
from image_retrieval_tpu.models.encoder import CLIPEncoder as JaxEncoder
from image_retrieval_tpu.parallel.mesh import make_mesh
from image_retrieval_tpu_torch.config import Config, ModelConfig
from image_retrieval_tpu_torch.models import encoder as enc_mod
from image_retrieval_tpu_torch.models.encoder import CLIPEncoder, FakeEncoder, get_encoder
from image_retrieval_tpu_torch.models.weights import params_from_jax

SMALL = dict(image_size=32, patch_size=8, vision_width=48, vision_layers=2,
             vision_heads=4, text_width=32, text_layers=2, text_heads=2,
             vocab_size=49408, context_length=16, embed_dim=24, dtype="float32")
TOL = dict(rtol=1e-4, atol=1e-4)  # the port's towers vs the JAX towers, f32


@pytest.fixture(scope="module")
def jax_params():
    _, params = jax_init_params(JaxModelConfig(**SMALL), seed=0)
    return jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def enc(jax_params):
    cfg = ModelConfig(**SMALL)
    return CLIPEncoder(Config(model=cfg), params=params_from_jax(jax_params, cfg),
                       device="cpu")


@pytest.fixture(scope="module")
def jax_enc(jax_params):
    return JaxEncoder(JaxConfig(model=JaxModelConfig(**SMALL)), params=jax_params,
                      mesh=make_mesh(devices=jax.devices()[:1]))


class Window:
    """Counts chunks in flight through CLIPEncoder._launch / _fetch."""

    def __init__(self, monkeypatch, enc):
        self.now = self.most = self.launches = 0
        launch, fetch = enc._launch, enc._fetch

        def counted_launch(*a):
            self.now += 1
            self.launches += 1
            self.most = max(self.most, self.now)
            return launch(*a)

        def counted_fetch(p):
            self.now -= 1
            return fetch(p)

        monkeypatch.setattr(enc, "_launch", counted_launch)
        monkeypatch.setattr(enc, "_fetch", counted_fetch)


def _synchronous(enc, monkeypatch):
    monkeypatch.setattr(enc, "_MAX_IN_FLIGHT", 1)


def _pixels(n, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, size=(n, 32, 32, 3), dtype=np.uint8)
    return rng.normal(size=(n, 32, 32, 3)).astype(np.float32)


def _batches():
    """Ragged stream: bucket-sized, ragged, empty, and several chunks."""
    sizes = [8, 5, 0, 40, 1, 300, 33]
    return [(f"b{i}", _pixels(n, i)) for i, n in enumerate(sizes)]


def test_encode_stream_equals_synchronous_and_keeps_order(enc, monkeypatch):
    got = list(enc.encode_stream(iter(_batches())))
    with monkeypatch.context() as m:
        _synchronous(enc, m)
        want = list(enc.encode_stream(iter(_batches())))
    assert [meta for meta, _ in got] == [f"b{i}" for i in range(7)]
    assert [meta for meta, _ in want] == [meta for meta, _ in got]
    for (_, a), (_, b), (_, px) in zip(got, want, _batches()):
        assert a.shape == (px.shape[0], 24) and a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    # each batch alone through encode_pixels: the same rows
    for (_, a), (_, px) in zip(got, _batches()):
        np.testing.assert_array_equal(a, enc.encode_pixels(px))


def test_encode_stream_window_never_above_four(enc, monkeypatch):
    w = Window(monkeypatch, enc)
    out = list(enc.encode_stream(iter(_batches())))
    assert len(out) == 7
    assert w.most == 4 and w.now == 0
    # 8 -> 1, 5 -> 1, 0 -> 0, 40 -> 1 (bucket 128), 1 -> 1, 300 -> 2, 33 -> 1
    assert w.launches == 7


def test_encode_stream_oversized_batch_drains_window(enc, monkeypatch):
    """A batch above 4 x 256 rows drains the window, then runs through
    encode_pixels, whose own window stays at 4."""
    w = Window(monkeypatch, enc)
    seen = []
    big = _pixels(1100, 9)  # 5 chunks of 256, 256, 256, 256, 76
    feed = [("small", _pixels(3, 1)), ("big", big), ("after", _pixels(2, 2))]
    for meta, emb in enc.encode_stream(iter(feed)):
        seen.append((meta, w.now))
        assert emb.shape[0] == {"small": 3, "big": 1100, "after": 2}[meta]
    # "small" was fetched before the big batch launched anything
    assert seen[0] == ("small", 0) and seen[1][0] == "big"
    assert w.most == 4 and w.launches == 1 + 5 + 1


def test_encode_pixels_windowed_equals_synchronous(enc, monkeypatch):
    px = _pixels(1030, 4)  # 5 chunks: more than the window
    w = Window(monkeypatch, enc)
    got = enc.encode_pixels(px)
    assert w.most == 4 and w.launches == 5
    with monkeypatch.context() as m:
        _synchronous(enc, m)
        np.testing.assert_array_equal(got, enc.encode_pixels(px))
    assert enc.encode_pixels(px[:0]).shape == (0, 24)


def test_encode_images_and_texts_windowed_equal_synchronous(enc, monkeypatch, tmp_path):
    paths = []
    for i, px in enumerate(_pixels(37, 5)):
        paths.append(str(tmp_path / f"{i}.png"))
        Image.fromarray(px).resize((40, 36)).save(paths[-1])
    texts = [f"a photo of thing {i}" for i in range(40)]
    w = Window(monkeypatch, enc)
    got_i = enc.encode_images(paths, batch_size=4)  # 4 snaps to 8: 5 chunks
    got_t = enc.encode_texts(texts)
    assert w.most == 4 and w.launches == 5 + 1
    with monkeypatch.context() as m:
        _synchronous(enc, m)
        np.testing.assert_array_equal(got_i, enc.encode_images(paths, batch_size=4))
        np.testing.assert_array_equal(got_t, enc.encode_texts(texts))
    assert enc.encode_images([]).shape == (0, 24)
    assert enc.encode_texts([]).shape == (0, 24)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_encode_pixels_and_stream_match_the_jax_encoder(enc, jax_enc, dtype):
    px = _pixels(20, 6, dtype)  # one chunk, padded to the 32 bucket on both sides
    want = jax_enc.encode_pixels(px)
    np.testing.assert_allclose(enc.encode_pixels(px), want, **TOL)
    feed = [("a", px[:7]), ("b", px[7:])]
    jax_out = list(jax_enc.encode_stream(iter(feed)))
    for (m1, a), (m2, b) in zip(enc.encode_stream(iter(feed)), jax_out):
        assert m1 == m2
        np.testing.assert_allclose(a, b, **TOL)


def test_encode_images_and_texts_match_the_jax_encoder(enc, jax_enc, tmp_path):
    paths = []
    for i, px in enumerate(_pixels(5, 7)):
        paths.append(str(tmp_path / f"{i}.jpg"))
        Image.fromarray(px).resize((48, 40)).save(paths[-1])
    np.testing.assert_allclose(enc.encode_images(paths, batch_size=2),
                               jax_enc.encode_images(paths, batch_size=2), **TOL)
    texts = ["a red car", "two dogs on a beach", "x"]
    np.testing.assert_allclose(enc.encode_texts(texts), jax_enc.encode_texts(texts), **TOL)


def test_base_encoder_stream_and_get_encoder():
    fake = get_encoder(fake=True)
    assert isinstance(fake, FakeEncoder) and fake.dim == 512
    assert get_encoder(Config(model=ModelConfig(**SMALL)), fake=True).dim == 24
    feed = [("a", _pixels(3, 1)), ("b", _pixels(1, 2)), ("c", _pixels(2, 3))]
    out = list(fake.encode_stream(iter(feed)))
    assert [m for m, _ in out] == ["a", "b", "c"]
    for (_, e), (_, px) in zip(out, feed):
        np.testing.assert_array_equal(e, fake.encode_pixels(px))
    enc = get_encoder(Config(model=ModelConfig(**SMALL)), device="cpu", seed=1)
    assert isinstance(enc, CLIPEncoder) and enc._MAX_IN_FLIGHT == 4
    assert enc_mod.CLIPEncoder._MAX_IN_FLIGHT == 4


# -- data parallel over a mesh ------------------------------------------------------

# The sharded encoder against the one-device encoder on the CPU. Each part is
# the one-device forward of that part bit for bit (below); the whole batch
# agrees within 1e-5, because the CPU's BLAS may order a product's sums by
# the number of rows it is given, and a part has fewer rows than the batch.
# The card's kernels plan by width only, and chip_smoke.py --mesh holds the
# sharded vit_b32_serving() encoder to the one-device one bit for bit there.
SHARDED_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def enc8(jax_params):
    from image_retrieval_tpu_torch.parallel.mesh import make_mesh

    cfg = ModelConfig(**SMALL)
    return CLIPEncoder(Config(model=cfg), params=params_from_jax(jax_params, cfg),
                       mesh=make_mesh(devices=["cpu"] * 8))


def test_sharded_encoder_parts_are_the_one_device_forward(enc, enc8):
    """A 32-row chunk over eight shards: part i is the one-device encoder's
    forward of rows 4i..4i+3 alone, bit for bit, in mesh order."""
    px = _pixels(20, 11)
    got = enc8.encode_pixels(px)
    assert got.shape == (20, 24) and enc8._batch_sizes(20) == 32
    padded = np.concatenate([px, np.zeros((12,) + px.shape[1:], px.dtype)])
    with torch.inference_mode():
        parts = [enc._encode_image(enc.model, torch.from_numpy(padded[i: i + 4])).numpy()
                 for i in range(0, 32, 4)]
    np.testing.assert_array_equal(got, np.concatenate(parts)[:20])
    np.testing.assert_allclose(got, enc.encode_pixels(px), **SHARDED_TOL)
    texts = ["a red car", "two dogs on a beach", "x"]
    np.testing.assert_allclose(enc8.encode_texts(texts), enc.encode_texts(texts),
                               **SHARDED_TOL)


def test_sharded_encoder_matches_the_jax_encoder_on_its_mesh(enc8, jax_params):
    """The JAX encoder's shard_map over its 8-device mesh, the same weights."""
    jax8 = JaxEncoder(JaxConfig(model=JaxModelConfig(**SMALL)), params=jax_params,
                      mesh=make_mesh())
    px = _pixels(40, 12)  # one chunk, padded to 128: 16 rows a device
    np.testing.assert_allclose(enc8.encode_pixels(px), jax8.encode_pixels(px), **TOL)
    texts = ["a photo of a cat", "y"]
    np.testing.assert_allclose(enc8.encode_texts(texts), jax8.encode_texts(texts), **TOL)


def test_sharded_encoder_window_and_stream(enc8, monkeypatch):
    """A chunk of eight parts is one launch of the window; the stream keeps
    its order and equals encode_pixels batch by batch."""
    w = Window(monkeypatch, enc8)
    out = list(enc8.encode_stream(iter(_batches())))
    assert w.most == 4 and w.now == 0 and w.launches == 7
    for (meta, a), (m2, px) in zip(out, _batches()):
        assert meta == m2
        np.testing.assert_array_equal(a, enc8.encode_pixels(px))


@pytest.mark.parametrize("nd", [1, 2, 3, 8])
def test_batch_sizes_snap_like_jax(nd):
    """The padded batch is the first bucket the data axis divides, else the
    request rounded up to the axis: the JAX encoder's _batch_sizes."""
    from types import SimpleNamespace

    from image_retrieval_tpu.config import MeshConfig as JaxMeshConfig
    from image_retrieval_tpu_torch.parallel.mesh import make_mesh as port_mesh

    jmesh = make_mesh(JaxMeshConfig(data=nd, model=1))
    mine = SimpleNamespace(_part_devices=[torch.device("cpu")] * nd,
                           _BUCKETS=CLIPEncoder._BUCKETS)
    theirs = SimpleNamespace(mesh=jmesh, _BUCKETS=JaxEncoder._BUCKETS)
    for n in (1, 5, 8, 9, 33, 129, 200, 256, 300, 1000):
        assert CLIPEncoder._batch_sizes(mine, n) == JaxEncoder._batch_sizes(theirs, n)
    assert len(port_mesh(devices=["cpu"] * nd).devices.flat) == nd
