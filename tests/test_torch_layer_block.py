"""The port's int8 layer (image_retrieval_tpu_torch/ops/flash_attention.py)
held against the JAX package's layer_block_int8 family.

Inputs are made with numpy from a seed and given to both packages. On the
CPU the port's wrapper runs its plain PyTorch version; the JAX kernel runs
in Pallas interpret mode, as the JAX package's own tests run it. The Hopper
kernel itself is compared with the plain version in tests/test_torch_gpu.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.ops import flash_attention as jfa
from image_retrieval_tpu_torch.ops import flash_attention as tfa

# Agreement bounds for the whole layer, f32. Both sides quantize the same
# f32 values with the same rules, so they agree to f32 rounding (measured
# <= 1e-6 at these shapes) except where a sum taken in another order
# (LayerNorm moments, QK^T, PV) lands on the other side of an int8 rounding
# boundary. Such a flip moves one quantized activation by one level; after
# the next projection that is <= ~2.5e-2 on a few elements (the bound the
# JAX package's own kernel-vs-mirror test uses, test_flash_attention.py:644).
ATOL = 1e-4
FLIP_ATOL = 2.5e-2
FLIP_FRACTION = 0.005


def assert_close_modulo_flips(got, want):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert err.max() <= FLIP_ATOL, err.max()
    assert (err > ATOL).mean() <= FLIP_FRACTION, (err > ATOL).mean()


def layer_params(rng, w, hidden):
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return [
        1 + 0.1 * f(w), 0.1 * f(w),
        f(w, w) / math.sqrt(w), 0.02 * f(w), f(w, w) / math.sqrt(w), 0.02 * f(w),
        f(w, w) / math.sqrt(w), 0.02 * f(w), f(w, w) / math.sqrt(w), 0.02 * f(w),
        1 + 0.1 * f(w), 0.1 * f(w),
        f(w, hidden) / math.sqrt(w), 0.02 * f(hidden),
        f(hidden, w) / math.sqrt(hidden), 0.02 * f(w),
    ]


@pytest.mark.parametrize("shape", [(64, 256), (48, 192), (768, 3)])
def test_quantize_weight_bitwise(shape):
    w = np.random.default_rng(shape[0]).normal(size=shape).astype(np.float32)
    w[:, 0] = 0.0  # an all-zero channel takes the 1e-12 floor
    jq, js = jfa._quantize_weight(jnp.asarray(w))
    tq, ts = tfa.quantize_weight(torch.from_numpy(w))
    assert tq.dtype == torch.int8 and ts.shape == (1, shape[1])
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("scale", [1e-3, 1.0, 40.0])
def test_rowquant_bitwise(scale):
    rng = np.random.default_rng(3)
    h = (scale * rng.normal(size=(37, 96))).astype(np.float32)
    h[5] = 0.0
    h[6, :3] = [0.5, -0.5, 1.5]  # exact halves round to even
    jq, js = jfa._rowquant(jnp.asarray(h))
    tq, ts = tfa.rowquant(torch.from_numpy(h))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_fast_layernorm_f32():
    rng = np.random.default_rng(4)
    # roughly centered rows, like the residual stream entering CLIP's
    # LayerNorms: E[x^2] - mu^2 cancels, so a large offset would amplify
    # the summation-order difference of the two means instead
    x = (0.1 + 2 * rng.normal(size=(6, 10, 64))).astype(np.float32)
    s = (1 + 0.1 * rng.normal(size=(64,))).astype(np.float32)
    b = (0.1 * rng.normal(size=(64,))).astype(np.float32)
    want = np.asarray(jfa._fast_layernorm_f32(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b)))
    got = tfa.fast_layernorm_f32(*map(torch.from_numpy, (x, s, b))).numpy()
    # f32 means summed in another order: a few ulps of outputs of order 1
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_qkv_concatenated_quantization_equals_separate():
    rng = np.random.default_rng(5)
    p = [torch.from_numpy(a) for a in layer_params(rng, 32, 128)]
    wts = tfa.quantize_layer(*p)
    for j, w in enumerate((p[2], p[4], p[6])):
        q, s = tfa.quantize_weight(w)
        np.testing.assert_array_equal(wts.wqkv_t[j * 32:(j + 1) * 32].numpy(), q.t().numpy())
        np.testing.assert_array_equal(wts.wqkv_s[j * 32:(j + 1) * 32].numpy(), s[0].numpy())


@pytest.mark.parametrize("causal", [False, True])
def test_layer_matches_jax_kernel_interpret(causal):
    """Port (CPU: the plain version) vs the JAX Pallas kernel, interpreted."""
    rng = np.random.default_rng(6)
    p = layer_params(rng, 64, 256)
    x = rng.normal(size=(4, 11, 64)).astype(np.float32)
    want = jfa.layer_block_int8(jnp.asarray(x), *map(jnp.asarray, p), 4, causal)
    before = tfa.layer_block_int8.launches
    got = tfa.layer_block_int8(torch.from_numpy(x), tfa.quantize_layer(
        *map(torch.from_numpy, p)), 4, causal)
    assert tfa.layer_block_int8.launches == before  # the CPU path launches nothing
    assert got.dtype == torch.float32 and got.shape == x.shape
    assert_close_modulo_flips(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("t", [11, 50])
@pytest.mark.parametrize("causal", [False, True])
def test_layer_matches_xla_mirror(t, causal):
    rng = np.random.default_rng(7 + t)
    p = layer_params(rng, 64, 256)
    x = rng.normal(size=(3, t, 64)).astype(np.float32)
    want = jfa.xla_layer_block_int8(jnp.asarray(x), *map(jnp.asarray, p),
                                    heads=4, causal=causal)
    got = tfa.layer_block_int8_reference(
        torch.from_numpy(x), tfa.quantize_layer(*map(torch.from_numpy, p)), 4, causal)
    assert_close_modulo_flips(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bias", ["bqkv", "bo", "b1", "b2"])
def test_kernel_agreement_catches_a_dropped_bias(bias, dtype):
    """The kernel-vs-plain limits (kernel_agreement, used on the card by
    chip_smoke.py and tests/test_torch_gpu.py) reject a layer that skips a
    bias add of the CLIP-like scale 0.02, and accept flip-sized errors."""
    import dataclasses

    rng = np.random.default_rng(10)
    wts = tfa.quantize_layer(*map(torch.from_numpy, layer_params(rng, 64, 256)))
    x = torch.from_numpy(rng.normal(size=(4, 11, 64)).astype(np.float32)).to(
        getattr(torch, dtype))
    want = tfa.layer_block_int8_reference(x, wts, 4)
    bad = dataclasses.replace(wts, **{bias: torch.zeros_like(getattr(wts, bias))})
    assert not tfa.kernel_agreement(
        tfa.layer_block_int8_reference(x, bad, 4), want, x)["ok"]
    # one bf16 ulp (or 1e-3 in f32) on 1 % of the elements passes
    flip = want.clone().reshape(-1)
    idx = torch.from_numpy(rng.choice(flip.numel(), flip.numel() // 100, replace=False))
    step = flip[idx].float().abs() * 2.0 ** -7 if dtype == "bfloat16" else 1e-3
    flip[idx] = (flip[idx].float() + step).to(flip.dtype)
    assert tfa.kernel_agreement(flip.reshape(want.shape), want, x)["ok"]


def test_layer_rejects_unsupported_device():
    rng = np.random.default_rng(8)
    wts = tfa.quantize_layer(*map(torch.from_numpy, layer_params(rng, 64, 256)))
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.layer_block_int8(torch.zeros(1, 4, 64, device="meta"), wts, 4)
