"""The port's two int8 sub-blocks and its QuantDense
(image_retrieval_tpu_torch/ops/flash_attention.py) held against the JAX
package's attention_block_int8 / mlp_block_int8 family and _quant_matmul.

Inputs are made with numpy from a seed and given to both packages. On the
CPU the port's wrappers run their plain PyTorch versions; the JAX kernels
run in Pallas interpret mode, as the JAX package's own tests run them, and
their XLA mirrors as they are. The Hopper kernels themselves are compared
with the plain versions in tests/test_torch_gpu.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.models.clip import _quant_matmul
from image_retrieval_tpu.ops import flash_attention as jfa
from image_retrieval_tpu_torch.ops import flash_attention as tfa

from test_torch_layer_block import assert_close_modulo_flips, layer_params

W, HEADS, HIDDEN = 64, 4, 256

# f32: the bounds of tests/test_torch_layer_block.py for the whole layer hold
# for each half, for the same reason: both sides quantize the same f32 values
# by the same rules and agree to f32 rounding except where a sum taken in
# another order (LayerNorm moments, QK^T, PV) lands on the other side of an
# int8 rounding boundary, which moves one activation by one level
# (assert_close_modulo_flips). bf16: besides such a flip, an output that sits
# on a bf16 rounding boundary may round to its neighbour: at most 2 bf16 ulps
# of the largest output, on at most 2 % of the elements (readings at these
# shapes: 1 ulp on <= 0.9 %).
BF16_ULPS = 2
BF16_SHARE = 0.02


def assert_close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        assert_close_modulo_flips(got, want)
        return
    ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert err.max() <= BF16_ULPS * ulp, (err.max(), ulp)
    assert (err > 0).mean() <= BF16_SHARE, (err > 0).mean()


def _case(seed, t, dtype, b=3):
    rng = np.random.default_rng(seed)
    p = layer_params(rng, W, HIDDEN)
    x = rng.normal(size=(b, t, W)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    return p, jx, tx, tfa.quantize_layer(*map(torch.from_numpy, p))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [10, 17])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("against", ["kernel_interpret", "xla_mirror"])
def test_attention_block_matches_jax(against, causal, t, dtype):
    p, jx, tx, wts = _case(20 + t, t, dtype)
    attn = [jnp.asarray(a) for a in p[:10]]
    if against == "kernel_interpret":
        want = jfa.attention_block_int8(jx, *attn, HEADS, causal)
    else:
        want = jfa.xla_attention_block_int8(jx, *attn, heads=HEADS, causal=causal)
    before = tfa.attention_block_int8.launches
    got = tfa.attention_block_int8(tx, wts.attn, HEADS, causal)
    assert tfa.attention_block_int8.launches == before  # the CPU path launches nothing
    assert got.dtype == tx.dtype
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [10, 17])
@pytest.mark.parametrize("against", ["kernel_interpret", "xla_mirror"])
def test_mlp_block_matches_jax(against, t, dtype):
    p, jx, tx, wts = _case(40 + t, t, dtype)
    mlp = [jnp.asarray(a) for a in p[10:]]
    fn = jfa.mlp_block_int8 if against == "kernel_interpret" else jfa.xla_mlp_block_int8
    want = fn(jx, *mlp)
    before = tfa.mlp_block_int8.launches
    got = tfa.mlp_block_int8(tx, wts.mlp)
    assert tfa.mlp_block_int8.launches == before
    assert got.dtype == tx.dtype
    assert_close(got, want, dtype)


def _whole_layer_in_one(x, wt, heads, causal):
    """The whole int8 layer written out in one piece (the order of
    operations of the TPU kernel _layer_block_int8_kernel), independent of
    the two sub-block functions."""
    b, t, w = x.shape
    dt = x.dtype
    xb = x.reshape(b * t, w)
    hq, hs = tfa.rowquant(tfa.fast_layernorm_f32(xb.float(), wt.ln1_s, wt.ln1_b))
    qkv = tfa._int8_proj(hq, hs, wt.wqkv_t, wt.wqkv_s, wt.bqkv, dt)
    attn = tfa._attention_reference(qkv, b, t, w, heads, causal, dt)
    aq, as_ = tfa.rowquant(attn.float())
    x1 = xb + tfa._int8_proj(aq, as_, wt.wo_t, wt.wo_s, wt.bo, dt)
    h2q, h2s = tfa.rowquant(tfa.fast_layernorm_f32(x1.float(), wt.ln2_s, wt.ln2_b))
    g = tfa.quick_gelu(tfa._int8_proj(h2q, h2s, wt.w1_t, wt.w1_s, wt.b1, torch.float32))
    gq, gs = tfa.rowquant(g)
    return (x1 + tfa._int8_proj(gq, gs, wt.w2_t, wt.w2_s, wt.b2, dt)).reshape(b, t, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_subblocks_compose_to_the_layer_bitwise(causal, dtype):
    """The mid-layer activation passes in the compute dtype in the whole
    layer too, so attention_block_int8 then mlp_block_int8 is the whole
    layer bit for bit (which lets the card hold K2a then K2b against K1)."""
    _, _, tx, wts = _case(60, 17, dtype)
    two = tfa.mlp_block_int8(tfa.attention_block_int8(tx, wts.attn, HEADS, causal), wts.mlp)
    assert torch.equal(two, _whole_layer_in_one(tx, wts, HEADS, causal))
    assert torch.equal(two, tfa.layer_block_int8(tx, wts, HEADS, causal))


def test_halves_share_the_layers_tensors():
    _, _, _, wts = _case(61, 10, "float32")
    assert wts.attn.wqkv_t is wts.wqkv_t and wts.mlp.w2_t is wts.w2_t
    assert wts.attn.width == wts.mlp.width == wts.width == W
    assert wts.mlp.hidden == wts.hidden == HIDDEN
    assert len(wts.attn.tensors()) + len(wts.mlp.tensors()) == len(wts.tensors())


@pytest.mark.parametrize("in_dtype,out_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("shape,n", [((3, 10, 64), 192), ((37, 96), 64)])
def test_quant_dense_matches_quant_matmul(shape, n, in_dtype, out_dtype):
    """QuantDense: (_quant_matmul(x, kernel) + bias).astype(dtype). The int32
    sums are exact on both sides and the f32 rescale runs in the same order
    (acc * xscale * wscale + bias); XLA may contract the last multiply and the
    bias add into one fused multiply-add, an ulp of values of order 1 (1e-6
    in f32, which in bf16 can move a value on a rounding boundary to its
    neighbour: one bf16 ulp on a few elements)."""
    rng = np.random.default_rng(shape[0] + n)
    k = shape[-1]
    kernel = (rng.normal(size=(k, n)) / math.sqrt(k)).astype(np.float32)
    kernel[:, 1] = 0.0  # an all-zero channel takes the 1e-12 floor
    bias = (0.02 * rng.normal(size=n)).astype(np.float32)
    x = rng.normal(size=shape).astype(np.float32)
    x[0] = 0.0
    jx = jnp.asarray(x).astype(getattr(jnp, in_dtype))
    want = (_quant_matmul(jx, jnp.asarray(kernel)) + jnp.asarray(bias)).astype(
        getattr(jnp, out_dtype))
    w_q, w_s = tfa.quantize_weight(torch.from_numpy(kernel))
    before = tfa.quant_dense.launches
    got = tfa.quant_dense(torch.from_numpy(x).to(getattr(torch, in_dtype)),
                          w_q.t().contiguous(), w_s.reshape(-1), torch.from_numpy(bias),
                          getattr(torch, out_dtype))
    assert tfa.quant_dense.launches == before
    assert got.dtype == getattr(torch, out_dtype) and got.shape == (*shape[:-1], n)
    want = np.asarray(want.astype(jnp.float32))
    if out_dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    else:
        err = np.abs(got.float().numpy() - want)
        assert err.max() <= 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
        assert (err > 0).mean() <= 0.01


def test_tiled_attention_cpu_is_the_plain_version():
    rng = np.random.default_rng(62)
    qkv = torch.from_numpy(rng.normal(size=(2 * 10, 3 * W)).astype(np.float32))
    before = tfa.tiled_attention.launches
    got = tfa.tiled_attention(qkv, 2, HEADS, True)
    assert tfa.tiled_attention.launches == before
    assert torch.equal(got, tfa._attention_reference(qkv, 2, 10, W, HEADS, True, qkv.dtype))


@pytest.mark.parametrize("fn,args", [
    ("attention_block_int8", lambda w: (w.attn, HEADS)),
    ("mlp_block_int8", lambda w: (w.mlp,)),
    ("quant_dense", lambda w: (w.wo_t, w.wo_s, w.bo, torch.float32)),
    ("tiled_attention", lambda w: (1, HEADS)),
])
def test_wrappers_reject_unsupported_device(fn, args):
    _, _, _, wts = _case(63, 10, "float32")
    width = 3 * W if fn == "tiled_attention" else W
    x = torch.zeros(4, width, device="meta") if fn == "tiled_attention" else torch.zeros(
        1, 4, width, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(tfa, fn)(x, *args(wts))
