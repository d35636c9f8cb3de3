"""The port's color-histogram encoder (image_retrieval_tpu_torch/models/
histogram.py) held against the JAX package's (image_retrieval_tpu/models/
histogram.py) on the same numpy inputs. Exact: the bins are integer
truncations of products by a power of two, the counts integers, the
normalization one f32 division, and the CLIP normalization is undone on the
host in numpy by both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.config import IndexConfig
from image_retrieval_tpu.index import vector_index as jvi
from image_retrieval_tpu.models import histogram as jhist
from image_retrieval_tpu_torch.config import IndexConfig as TIndexConfig
from image_retrieval_tpu_torch.index import vector_index as tvi
from image_retrieval_tpu_torch.models import histogram as thist
from image_retrieval_tpu_torch.models.preprocess import CLIP_MEAN, CLIP_STD


def _pixels01(n, side, seed, edges=True):
    """[0, 1] pixels with values exactly on bin edges (k / 8 and k / 4) and
    at 0 and 1 mixed in."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, side, side, 3)).astype(np.float32)
    if edges:
        mask = rng.random(x.shape) < 0.3
        x[mask] = rng.integers(0, 9, size=int(mask.sum())).astype(np.float32) / 8.0
        x[:, 0, 0] = 0.0
        x[:, -1, -1] = 1.0
    return x


def _clip_normalized(n, side, seed):
    return ((_pixels01(n, side, seed) - CLIP_MEAN) / CLIP_STD).astype(np.float32)


@pytest.mark.parametrize("bins", [4, 8])
def test_batched_color_histogram_equals_jax(bins):
    x = _pixels01(5, 12, seed=bins)
    want = np.asarray(jhist.batched_color_histogram(jnp.asarray(x), bins))
    got = thist.batched_color_histogram(torch.from_numpy(x), bins)
    assert got.dtype == torch.float32 and got.shape == (5, bins ** 3)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(got.sum(1).numpy(), 1.0, rtol=1e-6)


def test_all_zero_batch_and_one_image():
    x = np.zeros((1, 4, 4, 3), np.float32)
    got = thist.batched_color_histogram(torch.from_numpy(x))
    want = np.asarray(jhist.batched_color_histogram(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0] == 1.0


@pytest.mark.parametrize("n", [0, 3, 300], ids=["none", "few", "chunked"])
def test_encode_pixels_equals_jax(n):
    """300 images cross the 256-image chunk (JAX pads the tail to a bucket,
    the port does not: the rows are the same)."""
    px = _clip_normalized(n, 8, seed=n) if n else np.zeros((0, 8, 8, 3), np.float32)
    want = jhist.HistogramEncoder().encode_pixels(px)
    got = thist.HistogramEncoder(device="cpu").encode_pixels(px)
    assert got.dtype == np.float32 and got.shape == (n, 512)
    np.testing.assert_array_equal(got, want)


def test_encode_texts_equals_jax():
    texts = ["a red car", "Blue sky and green grass", "a photo of a dog",
             "grey gray", "", "purple orange yellow"]
    want = jhist.HistogramEncoder(bins_per_channel=4).encode_texts(texts)
    got = thist.HistogramEncoder(bins_per_channel=4, device="cpu").encode_texts(texts)
    np.testing.assert_array_equal(got, want)
    # no colour word: uniform
    np.testing.assert_allclose(got[2], np.full(64, 1 / 64, np.float32))


def test_encode_images_equals_jax(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(5)
    paths = []
    for i in range(5):
        p = tmp_path / f"{i}.png"
        Image.fromarray(rng.integers(0, 256, size=(30 + 7 * i, 41, 3),
                                     dtype=np.uint8)).save(p)
        paths.append(str(p))
    want = jhist.HistogramEncoder().encode_images(paths, batch_size=2)
    got = thist.HistogramEncoder(device="cpu").encode_images(paths, batch_size=2)
    np.testing.assert_array_equal(got, want)
    assert thist.HistogramEncoder(device="cpu").encode_images([]).shape == (0, 512)


def test_l2_topk_equals_jax():
    """tests/test_histogram.py: the histograms into an index, queried by L2
    with colour-word texts; the port's index over the port's histograms gives
    the JAX index's answers over the JAX histograms."""
    px = _clip_normalized(64, 16, seed=9)
    queries = ["red", "blue car", "green", "white", "black dog", "brown", "a cat",
               "yellow orange"]
    jenc, tenc = jhist.HistogramEncoder(), thist.HistogramEncoder(device="cpu")
    paths = [f"img_{i}.png" for i in range(len(px))]
    jix = jvi.ShardedVectorIndex(dim=512, config=IndexConfig(capacity_step=64))
    jix.insert(paths, jenc.encode_pixels(px))
    tix = tvi.ShardedVectorIndex(dim=512, config=TIndexConfig(capacity_step=64),
                                 device="cpu")
    tix.insert(paths, tenc.encode_pixels(px))
    want = jix.search(jenc.encode_texts(queries), top_k=10, metric="l2_distance")
    got = tix.search(tenc.encode_texts(queries), top_k=10, metric="l2_distance")
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)


def test_no_device_means_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py phase 14 covers it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        thist.HistogramEncoder()
