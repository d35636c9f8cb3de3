"""The port's ``preprocess_device``
(image_retrieval_tpu_torch/models/preprocess.py) held against the JAX
package's (image_retrieval_tpu/models/preprocess.py:58-71) on the same
seeded uint8 batches: down (40 -> 24), up (16 -> 24) and equal sizes.

Tolerance 1e-4 after the CLIP normalization. The port resizes with
``F.interpolate(mode="bilinear", antialias=True)``, JAX with
``jax.image.resize(..., "bilinear", antialias=True)``: two filters written
apart, whose weights round apart (readings on [0, 1] inputs: 1.2e-6 at
40 -> 24, 4.6e-7 at 16 -> 24, 5.4e-5 at 320 -> 224 after the division by
CLIP's std). An equal size is not resized on either side (readings: within
2.4e-7, XLA's fused normalization against PyTorch's true divisions) and
equals the port's normalize-only path bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.models import preprocess as jpre
from image_retrieval_tpu_torch.models import preprocess as tpre

ATOL = 1e-4


def _batch(side, n=3, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(n, side, side, 3),
                                                dtype=np.uint8)


@pytest.mark.parametrize("side,size", [(40, 24), (16, 24), (24, 24), (33, 24)],
                         ids=["down", "up", "equal", "down_odd"])
def test_matches_jax(side, size):
    x = _batch(side)
    want = np.asarray(jpre.preprocess_device(jnp.asarray(x), size=size))
    got = tpre.preprocess_device(x, size, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (3, size, size, 3)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    if side == size:
        assert torch.equal(got, tpre.normalize_u8_device(torch.from_numpy(x)))


def test_numpy_lands_on_the_device_a_tensor_stays():
    x = _batch(40)
    got = tpre.preprocess_device(x, 24, device="cpu")
    assert got.device == torch.device("cpu")
    t = torch.from_numpy(x)
    # a tensor stays on its own device whatever device= says
    assert torch.equal(tpre.preprocess_device(t, 24, device="cuda"), got)


def test_refuses_a_batch_that_is_not_square():
    with pytest.raises(ValueError, match="square"):
        tpre.preprocess_device(np.zeros((2, 24, 20, 3), np.uint8), 24, device="cpu")


def test_no_device_means_the_card():
    """No device= means the card; without one a numpy batch raises rather
    than running on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py phase 14 covers it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpre.preprocess_device(_batch(40), 24)
