"""The port's ops/binning.py and ops/mi.py against the JAX package's on the
same seeded inputs: the host float64 copies equal (==) bin for bin and MI
for MI, the adversarial cases of tests/test_binning_mi.py included; the
tensor forms discretize_uniform / mutual_info_uniform against
discretize_uniform_jax / mutual_info_uniform_jax (bins equal, MI within
1e-5), and against the port's host functions."""

import numpy as np
import pytest
import torch

from image_retrieval_tpu.ops import binning as jb
from image_retrieval_tpu.ops import mi as jm
from image_retrieval_tpu_torch.ops import binning as tb
from image_retrieval_tpu_torch.ops import mi as tm

ADVERSARIAL = [
    [0.0, 0.0, 0.0, 1e-300],                 # near-degenerate range
    [1.0, 1.0 + 2**-23, 2.0],                # one-ulp separation
    [-5.0, -5.0, -5.0, -5.0, 7.0],           # constant with one outlier
    list(np.linspace(0, 1, 21)),             # values exactly on edges
    [3.14] * 50,                             # fully constant
]


@pytest.mark.parametrize("values", ADVERSARIAL + [[0.0, 0.25, 0.5, 0.75, 1.0]])
@pytest.mark.parametrize("strategy", ["uniform", "quantile"])
def test_host_binning_equals_jax_on_adversarial_cases(values, strategy):
    x = np.array(values, np.float64)
    np.testing.assert_array_equal(tb.bin_edges(x, 5, strategy), jb.bin_edges(x, 5, strategy))
    np.testing.assert_array_equal(tb.discretize(x, 5, strategy), jb.discretize(x, 5, strategy))


@pytest.mark.parametrize("n_bins", [2, 5, 20, 33])
@pytest.mark.parametrize("strategy", ["uniform", "quantile"])
def test_host_binning_equals_jax(n_bins, strategy):
    x = np.random.default_rng(n_bins).normal(size=500)
    got, want = tb.discretize(x, n_bins, strategy), jb.discretize(x, n_bins, strategy)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_unknown_strategy_raises_like_jax():
    with pytest.raises(ValueError, match="Unsupported strategy"):
        tb.bin_edges(np.arange(3.0), 2, "kmeans")
    with pytest.raises(ValueError, match="Unsupported strategy"):
        jb.bin_edges(np.arange(3.0), 2, "kmeans")


@pytest.mark.parametrize("seed", range(4))
def test_host_mi_equals_jax(seed):
    rng = np.random.default_rng(seed)
    xb = rng.integers(0, 20, size=400)
    y = rng.integers(0, 4, size=400)
    assert tm.mutual_info_binned(xb, y) == jm.mutual_info_binned(xb, y)
    values = rng.normal(size=600)
    labels = rng.integers(-1, 3, size=600)  # -1: the related_category label
    values[::50] = np.nan  # filtered, as the reference does
    for strategy in ("uniform", "quantile"):
        assert (tm.mutual_info_from_labels(values, labels, 20, strategy)
                == jm.mutual_info_from_labels(values, labels, 20, strategy))


@pytest.mark.parametrize("values", ADVERSARIAL)
def test_host_mi_equals_jax_on_adversarial_cases(values):
    x = np.array(values, np.float64)
    labels = np.arange(len(x)) % 3
    assert (tm.mutual_info_from_labels(x, labels, 5)
            == jm.mutual_info_from_labels(x, labels, 5))


def test_host_mi_of_nothing_is_zero():
    assert tm.mutual_info_binned(np.array([]), np.array([])) == 0.0
    assert tm.mutual_info_from_labels(np.array([np.nan]), np.array([1]), 5) == 0.0


@pytest.mark.parametrize("n_bins", [5, 20])
def test_discretize_uniform_equals_jax_bin_for_bin(n_bins):
    x = np.random.default_rng(3).normal(size=(6, 1000)).astype(np.float32) * 3
    x[2] = 1.5  # a constant row: all in bin 0
    got = tb.discretize_uniform(torch.from_numpy(x), n_bins)
    want = np.asarray(jb.discretize_uniform_jax(x, n_bins))
    assert got.dtype == torch.int32 and got.shape == x.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[2] == 0).all()


def test_discretize_uniform_edges_and_leading_axes():
    """Values on an interior edge fall in the upper bin; the maximum in the
    last; leading axes are independent rows."""
    x = torch.tensor([[0.0, 0.25, 0.5, 0.75, 1.0]], dtype=torch.float32)
    assert tb.discretize_uniform(x, 4).tolist() == [[0, 1, 2, 3, 3]]
    y = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 3, 40)).astype(np.float32))
    flat = tb.discretize_uniform(y.reshape(6, 40), 7)
    np.testing.assert_array_equal(tb.discretize_uniform(y, 7).reshape(6, 40).numpy(),
                                  flat.numpy())
    want = np.asarray(jb.discretize_uniform_jax(y.numpy(), 7))
    np.testing.assert_array_equal(tb.discretize_uniform(y, 7).numpy(), want)


def test_discretize_uniform_tracks_host_f64():
    x = np.random.default_rng(9).normal(size=256).astype(np.float32)
    got = tb.discretize_uniform(torch.from_numpy(x), 20).numpy()
    assert (got == tb.discretize(x.astype(np.float64), 20)).mean() > 0.99


def test_mutual_info_uniform_within_1e5_of_jax():
    """A (7, 300) grid: seven combinations' scores against one label vector."""
    rng = np.random.default_rng(42)
    vals = rng.normal(size=(7, 300)).astype(np.float32)
    labels = rng.integers(0, 3, size=300).astype(np.int32)
    got = tm.mutual_info_uniform(torch.from_numpy(vals), torch.from_numpy(labels), 20, 3)
    want = np.asarray(jm.mutual_info_uniform_jax(vals, labels, 20, 3))
    assert got.shape == (7,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for i in range(7):  # and the host f64 pipeline on the same values
        assert float(got[i]) == pytest.approx(tm.mutual_info_from_labels(vals[i], labels, 20),
                                              abs=1e-4)


def test_mutual_info_uniform_leading_axes_and_labels():
    """(2, 3, P) values give (2, 3) MI, each row the MI of its own bins; a
    row whose bins copy the labels reaches the label entropy; a constant row
    is 0."""
    rng = np.random.default_rng(1)
    labels = rng.integers(0, 4, size=500)
    vals = rng.normal(size=(2, 3, 500)).astype(np.float32)
    vals[0, 1] = labels.astype(np.float32)  # perfectly informative
    vals[1, 2] = 2.0  # constant
    got = tm.mutual_info_uniform(torch.from_numpy(vals), torch.from_numpy(labels), 4, 4)
    want = np.asarray(jm.mutual_info_uniform_jax(vals, labels.astype(np.int32), 4, 4))
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    p = np.bincount(labels) / len(labels)
    assert float(got[0, 1]) == pytest.approx(-(p * np.log(p)).sum(), abs=1e-5)
    assert float(got[1, 2]) == 0.0
