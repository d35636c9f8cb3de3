"""The port's kernels in the compute dtype
(image_retrieval_tpu_torch/ops/flash_attention.py: layer_block,
attention_block, mlp_block, multihead_attention) held against the JAX
package's entries of the same names.

Inputs are made with numpy from a seed and given to both packages. On the
CPU the port's wrappers run their plain PyTorch versions; the JAX kernels
run in Pallas interpret mode, as the JAX package's own tests run them, and
their XLA mirrors as they are. The Hopper kernels themselves are compared
with the plain versions in tests/test_torch_gpu.py.

Tolerances are the JAX package's own between its kernels and their mirrors
(tests/test_flash_attention.py): 2e-5 in f32 (f32 sums in another order; the
mirror also scales q before the dot where kernel and port scale the scores
after it), 1e-2 in bf16. A bf16 step is 1.6e-2 from 2.0 and 3.1e-2 from 4.0
on, so 1e-2 holds only while no output that large sits on a rounding
boundary: the bf16 bound here is that of tests/test_torch_subblocks.py, at
most two bf16 steps of the largest output, on at most 5 % of the elements
more than 1e-2. Readings at these shapes: no element beyond 1e-2 for a
sub-block or one attention against the JAX kernel; one step on <= 1.9 % for
the whole layer, where XLA on the CPU may keep the mid-layer activation x1 in
excess precision (its own note, test_flash_attention.py:582-586) while the
port rounds it to bf16 as the TPU kernel does, and on one element for
multihead_attention against the mirror that rounds q * scale to bf16 before
the dot.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.ops import flash_attention as jfa
from image_retrieval_tpu_torch.ops import flash_attention as tfa

from test_torch_layer_block import layer_params

ATOL = {"float32": 2e-5, "bfloat16": 1e-2}
ENTRIES = ("layer_block", "attention_block", "mlp_block", "multihead_attention")


def _case(seed, b, t, w, dtype):
    """Seeded layer parameters and input: the numpy parameters, x for JAX,
    x for the port, the port's LayerWeights."""
    rng = np.random.default_rng(seed)
    p = layer_params(rng, w, 4 * w)
    x = rng.normal(size=(b, t, w)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    wts = tfa.prepare_layer(*map(torch.from_numpy, p), dtype=tx.dtype)
    return p, jx, tx, wts


def _jax_want(entry, against, p, jx, heads, causal):
    """The JAX package's answer: its Pallas kernel interpreted, or its XLA
    mirror."""
    jp = [jnp.asarray(a) for a in p]
    kernel = against == "kernel_interpret"
    if entry == "attention_block":
        if kernel:
            return jfa.attention_block(jx, *jp[:10], heads, causal)
        return jfa.xla_attention_block(jx, *jp[:10], heads=heads, causal=causal)
    if entry == "mlp_block":
        return (jfa.mlp_block if kernel else jfa.xla_mlp_block)(jx, *jp[10:])
    if kernel:
        return jfa.layer_block(jx, *jp, heads, causal)
    x1 = jfa.xla_attention_block(jx, *jp[:10], heads=heads, causal=causal)
    return jfa.xla_mlp_block(x1, *jp[10:])


def _port_got(entry, tx, wts, heads, causal):
    if entry == "attention_block":
        return tfa.attention_block(tx, wts.attn, heads, causal)
    if entry == "mlp_block":
        return tfa.mlp_block(tx, wts.mlp)
    return tfa.layer_block(tx, wts, heads, causal)


BF16_ULPS = 2  # bf16 steps of the largest output
BF16_SHARE = 0.05  # of the elements off by more than ATOL


def _assert_close(got: torch.Tensor, want, dtype: str):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    if dtype == "bfloat16":
        err = np.abs(got.float().numpy() - want)
        ulp = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
        assert err.max() <= max(BF16_ULPS * ulp, ATOL[dtype]), (err.max(), ulp)
        assert (err > ATOL[dtype]).mean() <= BF16_SHARE, (err > ATOL[dtype]).mean()
        return
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=ATOL[dtype])


# the MLP sub-block has no mask
ENTRY_CASES = [("layer_block", False), ("layer_block", True), ("attention_block", False),
               ("attention_block", True), ("mlp_block", False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("against", ["kernel_interpret", "xla_mirror"])
@pytest.mark.parametrize("entry,causal", ENTRY_CASES)
def test_block_matches_jax(entry, causal, against, dtype):
    heads = 4
    p, jx, tx, wts = _case(11 + len(entry), 4, 11, 64, dtype)
    before = getattr(tfa, entry).launches
    got = _port_got(entry, tx, wts, heads, causal)
    assert getattr(tfa, entry).launches == before  # the CPU path launches nothing
    _assert_close(got, _jax_want(entry, against, p, jx, heads, causal), dtype)


# the geometries of tests/test_flash_attention.py::test_fused_kernels_shape_sweep
SWEEP = [
    (3, 50, 64, 4, False),    # odd batch
    (8, 197, 64, 4, False),   # ViT-B/16's token count
    (6, 77, 64, 4, True),     # text-like, causal
    (1, 5, 32, 2, True),      # a single short sequence
    (5, 13, 96, 12, False),   # odd everything
]


@pytest.mark.parametrize("b,t,w,heads,causal", SWEEP)
@pytest.mark.parametrize("entry", ["layer_block", "attention_block", "mlp_block"])
def test_block_shape_sweep_matches_jax_kernel(entry, b, t, w, heads, causal):
    p, jx, tx, wts = _case(b * t + w, b, t, w, "float32")
    got = _port_got(entry, tx, wts, heads, causal)
    _assert_close(got, _jax_want(entry, "kernel_interpret", p, jx, heads, causal), "float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,w,heads", [(4, 11, 64, 4), (3, 50, 64, 4), (5, 13, 96, 12),
                                          (2, 77, 128, 2)])
@pytest.mark.parametrize("against", ["kernel_interpret", "xla_mirror"])
def test_multihead_attention_matches_jax(against, b, t, w, heads, dtype):
    rng = np.random.default_rng(b * t + w)
    qkv = [rng.normal(size=(b, t, w)).astype(np.float32) for _ in range(3)]
    jq = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in qkv]
    tq = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in qkv]
    fn = jfa.multihead_attention if against == "kernel_interpret" else jfa.xla_attention
    before = tfa.multihead_attention.launches
    got = tfa.multihead_attention(*tq, heads)
    assert tfa.multihead_attention.launches == before
    _assert_close(got, fn(*jq, heads), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_subblocks_compose_to_the_layer_bitwise(causal, dtype):
    """The mid-layer activation passes in the compute dtype in the whole
    layer too, so plain attention_block then plain mlp_block is the plain
    layer_block bit for bit; the layer written out in one piece in the TPU
    kernel's order (_layer_block_kernel), independent of the halves, agrees to
    summation order."""
    _, _, x, wt = _case(60, 3, 17, 64, dtype)
    heads = 4
    two = tfa.mlp_block_reference(
        tfa.attention_block_reference(x, wt.attn, heads, causal), wt.mlp)
    assert torch.equal(two, tfa.layer_block_reference(x, wt, heads, causal))
    assert torch.equal(two, tfa.layer_block(x, wt, heads, causal))

    b, t, w = x.shape
    dt = x.dtype
    xb = x.reshape(b * t, w)
    proj = lambda h, w_t, bias: h.float() @ w_t.float().t() + bias
    h = tfa.fast_layernorm_f32(xb.float(), wt.ln1_s, wt.ln1_b).to(dt)
    q, k, v = (proj(h, wt.wqkv_t[i * w:(i + 1) * w], wt.bqkv[i * w:(i + 1) * w]).to(dt)
               .reshape(b, t, w) for i in range(3))
    attn = tfa.multihead_attention_reference(q, k, v, heads, causal).reshape(b * t, w)
    x1 = xb + proj(attn, wt.wo_t, wt.bo).to(dt)
    h2 = tfa.fast_layernorm_f32(x1.float(), wt.ln2_s, wt.ln2_b).to(dt)
    a = tfa.quick_gelu(proj(h2, wt.w1_t, wt.b1)).to(dt)
    one = (x1 + proj(a, wt.w2_t, wt.b2).to(dt)).reshape(b, t, w)
    # three products over a third of the channels each may sum in another
    # order than one product over all of them
    _assert_close(two, one.float().numpy(), dtype)


def test_prepare_layer_casts_once_and_shares_tensors():
    p, _, _, wts = _case(61, 1, 4, 64, "bfloat16")
    assert wts.attn.wqkv_t is wts.wqkv_t and wts.mlp.w2_t is wts.w2_t
    assert wts.attn.width == wts.mlp.width == wts.width == 64
    assert wts.mlp.hidden == wts.hidden == 256
    assert len(wts.attn.tensors()) + len(wts.mlp.tensors()) == len(wts.tensors())
    # [q | k | v] output channels, output-major, in the compute dtype; the
    # cast is JAX's wq.astype(dt)
    for j, i in enumerate((2, 4, 6)):
        want = np.asarray(jnp.asarray(p[i]).astype(jnp.bfloat16).astype(jnp.float32)).T
        np.testing.assert_array_equal(wts.wqkv_t[j * 64:(j + 1) * 64].float().numpy(), want)
        np.testing.assert_array_equal(wts.bqkv[j * 64:(j + 1) * 64].numpy(), p[i + 1])
    assert wts.wqkv_t.dtype == wts.w1_t.dtype == torch.bfloat16
    assert wts.b1.dtype == wts.ln2_s.dtype == torch.float32
    assert wts.w1_t.shape == (256, 64) and wts.w2_t.shape == (64, 256)
    assert all(a.is_contiguous() for a in wts.tensors())


def test_weights_of_another_dtype_are_refused():
    _, _, x, wts = _case(62, 1, 4, 64, "float32")
    with pytest.raises(ValueError, match="compute dtype"):
        tfa.layer_block(x.to(torch.bfloat16), wts, 4)
    with pytest.raises(ValueError, match="compute dtype"):
        tfa.mlp_block(x.to(torch.bfloat16), wts.mlp)


# ---------------------------------------------------------------------------
# The kernel-vs-plain limits (dense_agreement), shown on the CPU to reject
# wrong layers and to accept what separates a kernel from its plain version
# ---------------------------------------------------------------------------


def _gelu_after_cast(x, wt):
    """mlp_block with fc1 cast to the compute dtype BEFORE quick_gelu: the
    mistake the JAX package's tests lock out (test_flash_attention.py:554)."""
    b, t, w = x.shape
    dt = x.dtype
    xb = x.reshape(b * t, w)
    h = tfa.fast_layernorm_f32(xb.float(), wt.ln_s, wt.ln_b).to(dt)
    a = tfa.quick_gelu(tfa._dense_proj(h, wt.w1_t, wt.b1).to(dt)).to(dt)
    return (xb + tfa._dense_proj(a, wt.w2_t, wt.b2).to(dt)).reshape(b, t, w)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("bias", ["bqkv", "bo", "b1", "b2"])
def test_dense_agreement_catches_a_dropped_bias(bias, dtype):
    _, _, x, wts = _case(70, 4, 11, 64, dtype)
    want = tfa.layer_block_reference(x, wts, 4)
    bad = dataclasses.replace(wts, **{bias: torch.zeros_like(getattr(wts, bias))})
    assert not tfa.dense_agreement(tfa.layer_block_reference(x, bad, 4), want, x, "layer")["ok"]
    assert tfa.dense_agreement(want, want, x, "layer")["ok"]


@pytest.mark.parametrize("seed", [71, 72, 73])
def test_dense_agreement_catches_a_gelu_after_the_cast(seed):
    """In bf16 a cast before the gelu moves about a third of the MLP half's
    outputs to a neighbouring value; the half's limit on the share of
    differing outputs rejects it (in f32 the cast is the identity). The
    whole layer's own roundings move as many, so its limit cannot: on the
    card the layer kernel is also held bit for bit against the two half
    kernels in turn."""
    _, _, x, wts = _case(seed, 4, 11, 64, "bfloat16")
    x1 = tfa.attention_block_reference(x, wts.attn, 4)
    r = tfa.dense_agreement(_gelu_after_cast(x1, wts.mlp),
                            tfa.mlp_block_reference(x1, wts.mlp), x1, "mlp")
    assert not r["ok"] and r["diff_share"] > 5 * tfa.DENSE_BF16_DIFF_SHARE["mlp"], r


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_agreement_accepts_rounding_noise(dtype):
    """What separates a kernel from its plain version passes: one bf16 step
    on 0.5 % of the outputs, or f32 rounding noise on all of them."""
    rng = np.random.default_rng(74)
    _, _, x, wts = _case(74, 4, 11, 64, dtype)
    want = tfa.layer_block_reference(x, wts, 4)
    got = want.clone().reshape(-1)
    if dtype == "bfloat16":
        idx = torch.from_numpy(rng.choice(got.numel(), got.numel() // 200, replace=False))
        got[idx] = (got[idx].float() * (1 + 2.0 ** -7)).to(got.dtype)
    else:
        got = got * (1 + 1e-6 * torch.from_numpy(rng.normal(size=got.shape).astype(np.float32)))
    r = tfa.dense_agreement(got.reshape(want.shape), want, x, "layer")
    assert r["ok"] and r["max_abs_err"] > 0, r


# ---------------------------------------------------------------------------
# Gradients: the port differentiates its plain versions, the JAX entries
# their XLA mirrors
# ---------------------------------------------------------------------------

NAMES = ("ln1_s", "ln1_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
         "ln2_s", "ln2_b", "w1", "b1", "w2", "b2")
PARTS = {"layer_block": slice(0, 16), "attention_block": slice(0, 10),
         "mlp_block": slice(10, 16)}


@pytest.mark.parametrize("entry,causal", ENTRY_CASES)
def test_block_gradients_match_jax(entry, causal):
    """d mean(out * g) / d (x, every parameter) in f32. Both sides recompute
    the forward in plain operations for the backward; they differ by f32
    summation order and by where the attention scale is applied (readings:
    within 4e-6 of gradients of order 1-10)."""
    heads = 4
    rng = np.random.default_rng(80)
    p = layer_params(rng, 64, 256)
    x = rng.normal(size=(3, 11, 64)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    part = PARTS[entry]

    def jloss(jx, *jp):
        if entry == "mlp_block":
            out = jfa.mlp_block(jx, *jp)
        else:
            out = getattr(jfa, entry)(jx, *jp, heads, causal)
        return jnp.sum(out * jnp.asarray(g))

    jp = [jnp.asarray(a) for a in p[part]]
    want = jax.grad(jloss, argnums=tuple(range(1 + len(jp))))(jnp.asarray(x), *jp)

    tx = torch.from_numpy(x).requires_grad_(True)
    tp = [torch.from_numpy(a).requires_grad_(True) for a in p]
    wts = tfa.prepare_layer(*tp, dtype=torch.float32)
    out = _port_got(entry, tx, wts, heads, causal)
    (out * torch.from_numpy(g)).sum().backward()
    got = [tx.grad] + [t.grad for t in tp[part]]
    for name, a, b in zip(("x",) + NAMES[part], got, want):
        assert a is not None, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5,
                                   err_msg=name)
    # the other half's parameters got no gradient
    assert all(t.grad is None for i, t in enumerate(tp)
               if not part.start <= i < part.stop)


def test_multihead_attention_gradients_match_jax():
    rng = np.random.default_rng(81)
    qkv = [rng.normal(size=(3, 11, 64)).astype(np.float32) for _ in range(3)]
    g = rng.normal(size=(3, 11, 64)).astype(np.float32)
    want = jax.grad(lambda q, k, v: jnp.sum(jfa.multihead_attention(q, k, v, 4) * g),
                    argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
    tq = [torch.from_numpy(a).requires_grad_(True) for a in qkv]
    (tfa.multihead_attention(*tq, 4) * torch.from_numpy(g)).sum().backward()
    for a, b in zip(tq, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), rtol=2e-5, atol=2e-5)


def test_kernel_function_backward_differentiates_the_plain_version():
    """The autograd Function the wrappers use on a CUDA tensor, driven here
    with the plain version standing in for the launch: its backward equals
    autograd through the plain version, and leaves inputs that need no
    gradient alone."""
    _, _, x, wts = _case(82, 2, 7, 64, "float32")
    tensors = [t.clone().requires_grad_(i != 1) for i, t in enumerate(wts.attn.tensors())]
    plain = lambda x, *ts: tfa.attention_block_reference(x, tfa.AttnWeights(*ts), 4, True)
    launched = []

    def launch(x, *ts):
        launched.append(torch.is_grad_enabled())
        return plain(x, *ts)

    x1 = x.clone().requires_grad_(True)
    tfa._KernelFunction.apply(launch, plain, x1, *tensors).square().sum().backward()
    assert launched == [False]  # the forward records nothing
    x2 = x.clone().requires_grad_(True)
    ref = [t.detach().clone().requires_grad_(t.requires_grad) for t in tensors]
    plain(x2, *ref).square().sum().backward()
    assert torch.equal(x1.grad, x2.grad)
    for a, b in zip(tensors, ref):
        assert (a.grad is None and b.grad is None) or torch.equal(a.grad, b.grad)
    assert tensors[1].grad is None


@pytest.mark.parametrize("fn,args", [
    ("layer_block", lambda w: (w, 4)),
    ("attention_block", lambda w: (w.attn, 4)),
    ("mlp_block", lambda w: (w.mlp,)),
])
def test_wrappers_reject_unsupported_device(fn, args):
    _, _, _, wts = _case(83, 1, 4, 64, "float32")
    with pytest.raises(ValueError, match="unsupported device"):
        getattr(tfa, fn)(torch.zeros(1, 4, 64, device="meta"), *args(wts))


def test_multihead_attention_rejects_unsupported_device():
    q = torch.zeros(1, 4, 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.multihead_attention(q, q, q, 4)


def test_every_entry_has_a_plain_version_and_a_launch_counter():
    for name in ENTRIES:
        assert callable(getattr(tfa, name + "_reference"))
        assert isinstance(getattr(tfa, name).launches, int)
