"""The training form of the attention sub-block
(image_retrieval_tpu_torch/ops/flash_attention.py: attention_block_saved,
attention_block_saved_backward, attention_block_train) held against the JAX
package's (_pallas_attention_block_saved in Pallas interpret mode,
attention_block_train's custom VJP, xla_attention_block under jax.grad).

Inputs are made with numpy from a seed and given to both packages. On the
CPU the port runs its plain version of the saving forward; the Hopper kernel
is compared with that plain version in tests/test_torch_gpu.py.

Tolerances. Forward, the six outputs: those of tests/test_torch_dense_blocks.py
(2e-5 in f32; in bf16 two bf16 steps of the largest output, at most 5 % of
the elements beyond 1e-2); the probabilities lie in [0, 1] and take 5e-6 in
f32 (readings <= 4.2e-7). In bf16 a q or k value that rounds to its
neighbour in one framework moves a score by a bf16 step of |q| |k| / sqrt(hd)
and the probability with it: 2e-3 (readings <= 2.6e-4). Gradients in f32:
2e-5, the tolerance of
tests/test_flash_attention.py:648-680. In bf16 the JAX backward multiplies
by its f32 parameters where the port multiplies by the weights the forward
used (cast to bf16), and the port's weight gradients pass a bf16 cast on
their way to the f32 parameters: each gradient within 2^-6 of its largest
entry (four bf16 steps there; readings <= 2^-7.4).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.ops import flash_attention as jfa
from image_retrieval_tpu_torch.ops import flash_attention as tfa

from test_torch_dense_blocks import _assert_close
from test_torch_layer_block import layer_params

PROBS_ATOL = {"float32": 5e-6, "bfloat16": 2e-3}
GRAD_ATOL_F32 = 2e-5
GRAD_BF16_REL = 2.0 ** -6
NAMES = ("x", "ln_s", "ln_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo")

# (B, T, W, heads, causal): the two towers' forms, a ragged causal one, a
# single short sequence, odd everything
SHAPES = [(4, 11, 64, 4, False), (4, 11, 64, 4, True), (3, 50, 64, 4, False),
          (2, 77, 64, 4, True), (1, 5, 32, 2, True), (5, 13, 96, 12, False)]


def _case(seed, b, t, w, dtype):
    rng = np.random.default_rng(seed)
    p = layer_params(rng, w, 4 * w)
    x = rng.normal(size=(b, t, w)).astype(np.float32)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    wts = tfa.prepare_layer(*map(torch.from_numpy, p), dtype=tx.dtype).attn
    return p[:10], jx, tx, wts


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,t,w,heads,causal", SHAPES)
def test_saved_forward_matches_jax_kernel(b, t, w, heads, causal, dtype):
    """All six outputs against the Pallas kernel interpreted; under `causal`
    exact zeros above the diagonal, on both sides."""
    p, jx, tx, wts = _case(b * t + w, b, t, w, dtype)
    want = jfa._pallas_attention_block_saved(jx, *map(jnp.asarray, p), heads, causal=causal)
    before = tfa.attention_block_train.launches
    got = tfa.attention_block_saved(tx, wts, heads, causal)
    assert tfa.attention_block_train.launches == before  # the CPU path launches nothing
    for name, g, wn in zip(("o", "q", "k", "v", "attn"), got, want):
        assert g.shape == (b, t, w), name
        _assert_close(g, wn, dtype)
    probs, pwant = got[5], np.asarray(want[5])
    assert probs.dtype == torch.float32 and probs.shape == pwant.shape == (b, heads, t, t)
    np.testing.assert_allclose(probs.numpy(), pwant, rtol=0, atol=PROBS_ATOL[dtype])
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, rtol=0, atol=1e-5)
    if causal:
        above = np.triu(np.ones((t, t), bool), k=1)
        assert not probs.numpy()[..., above].any() and not pwant[..., above].any()
    # the forward of the sub-block itself, bit for bit
    assert torch.equal(got[0], tfa.attention_block_reference(tx, wts, heads, causal))
    # q, k, v are views of one packed tensor, as the kernel writes them
    assert got[1].untyped_storage().data_ptr() == got[3].untyped_storage().data_ptr()


def _port_grads(fn, p, x, g, heads, causal, dtype="float32"):
    dt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(dt).requires_grad_(True)
    tp = [torch.from_numpy(a).requires_grad_(True) for a in p]
    mlp = [torch.zeros(s) for s in ((1,), (1,), (1, 4), (4,), (4, 1), (1,))]
    wts = tfa.prepare_layer(*tp, *mlp, dtype=dt).attn
    out = fn(tx, wts, heads, causal)
    (out.float() * torch.from_numpy(g)).sum().backward()
    return [tx.grad.float().numpy()] + [t.grad.numpy() for t in tp]


def _grad_case(seed=90, w=32, heads=4):
    rng = np.random.default_rng(seed)
    p = layer_params(rng, w, 4 * w)[:10]
    x = rng.normal(size=(3, 7, w)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    return p, x, g, heads


@pytest.mark.parametrize("against", ["attention_block_train", "xla_attention_block"])
@pytest.mark.parametrize("causal", [False, True])
def test_train_gradients_match_jax(causal, against):
    """d sum(out * g) / d (x and all ten parameters), f32, against jax.grad
    of the JAX entry (its kernel interpreted, its hand-written backward) and
    of the XLA mirror."""
    p, x, g, heads = _grad_case()

    def jloss(jx, *jp):
        if against == "attention_block_train":
            out = jfa.attention_block_train(jx, *jp, heads, causal)
        else:
            out = jfa.xla_attention_block(jx, *jp, heads=heads, causal=causal)
        return jnp.sum(out * jnp.asarray(g))

    want = jax.grad(jloss, argnums=tuple(range(11)))(jnp.asarray(x), *map(jnp.asarray, p))
    got = _port_grads(tfa.attention_block_train, p, x, g, heads, causal)
    for name, a, b in zip(NAMES, got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=GRAD_ATOL_F32, err_msg=name)


@pytest.mark.parametrize("causal", [False, True])
def test_train_gradients_match_jax_bf16(causal):
    p, x, g, heads = _grad_case(91, 64, 4)
    g = np.array(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))

    def jloss(jx, *jp):
        out = jfa.attention_block_train(jx, *jp, heads, causal)
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(g))

    jx = jnp.asarray(x).astype(jnp.bfloat16)
    want = jax.grad(jloss, argnums=tuple(range(11)))(jx, *map(jnp.asarray, p))
    got = _port_grads(tfa.attention_block_train, p, x, g, heads, causal, "bfloat16")
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(jnp.asarray(b, jnp.float32))
        if name == "bk":
            # zero in exact arithmetic (a key bias shifts every score of a
            # row alike): both sides return rounding noise
            assert max(np.abs(a).max(), np.abs(b).max()) <= 1e-5
            continue
        assert np.abs(a - b).max() <= GRAD_BF16_REL * np.abs(b).max(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_handwritten_backward_matches_autograd(causal, dtype):
    """attention_block_saved_backward over the saved tensors against autograd
    through attention_block_reference (the recompute the other kernels'
    Function does). f32: the same derivative in another order of sums. bf16:
    autograd rounds the gradient at every cast it passes, the hand-written
    backward stays in f32 between them; where they part by more than four
    bf16 steps (the key bias, zero in exact arithmetic) the hand-written one
    is the closer to the f32 derivative."""
    p, x, g, heads = _grad_case(92, 64, 4)
    got = _port_grads(tfa.attention_block_train, p, x, g, heads, causal, dtype)
    plain = _port_grads(tfa.attention_block_reference, p, x, g, heads, causal, dtype)
    if dtype == "float32":
        for name, a, b in zip(NAMES, got, plain):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)
        return
    xr = torch.from_numpy(x).bfloat16().float().numpy()
    exact = _port_grads(tfa.attention_block_reference, p, xr, g, heads, causal, "float32")
    for name, a, b, e in zip(NAMES, got, plain, exact):
        near = np.abs(a - b).max() <= 4 * 2.0 ** -8 * np.abs(b).max()
        assert near or np.abs(a - e).max() <= np.abs(b - e).max(), name


def test_backward_recomputes_no_forward(monkeypatch):
    """The backward reads the saved tensors: it calls neither the saving
    forward nor any attention again, only the LayerNorm."""
    p, x, g, heads = _grad_case(93)
    tx = torch.from_numpy(x).requires_grad_(True)
    wts = tfa.prepare_layer(*(torch.from_numpy(a).requires_grad_(True) for a in p),
                            *(torch.zeros(s) for s in ((1,), (1,), (1, 4), (4,), (4, 1), (1,))),
                            dtype=torch.float32).attn
    out = tfa.attention_block_train(tx, wts, heads, True)
    assert type(out.grad_fn).__name__ == "_SavedAttentionFunctionBackward"
    saved = out.grad_fn.saved_tensors
    assert len(saved) == 1 + 6 + 5  # x, the weights, q, k, v, attn, probs
    assert saved[-1].shape == (3, heads, 7, 7) and saved[-1].dtype == torch.float32

    def forbidden(*a, **k):
        raise AssertionError("the backward recomputed the forward")

    lns = []
    real_ln = tfa.fast_layernorm_f32
    for name in ("attention_block_saved", "attention_block_saved_reference",
                 "attention_block_reference", "_attention_with_probs", "_dense_proj"):
        monkeypatch.setattr(tfa, name, forbidden)
    monkeypatch.setattr(tfa, "fast_layernorm_f32",
                        lambda *a: lns.append(1) or real_ln(*a))
    (out * torch.from_numpy(g)).sum().backward()
    assert lns == [1] and tx.grad is not None


def test_without_a_gradient_it_is_attention_block(monkeypatch):
    """As the JAX entry's primal: a call that records no gradient takes
    attention_block and saves nothing."""
    _, _, tx, wts = _case(94, 2, 9, 64, "bfloat16")
    calls = []
    real = tfa.attention_block
    monkeypatch.setattr(tfa, "attention_block", lambda *a: calls.append("plain") or real(*a))
    monkeypatch.setattr(tfa, "attention_block_saved",
                        lambda *a: calls.append("saved"))
    out = tfa.attention_block_train(tx, wts, 4, True)  # nothing requires a gradient
    with torch.no_grad():
        out2 = tfa.attention_block_train(tx.clone().requires_grad_(True), wts, 4, True)
    assert calls == ["plain", "plain"]
    assert out.grad_fn is None and out2.grad_fn is None and torch.equal(out, out2)
    assert torch.equal(out, tfa.attention_block_reference(tx, wts, 4, True))


def test_inputs_that_need_no_gradient_get_none():
    p, x, g, heads = _grad_case(95)
    tx = torch.from_numpy(x)  # no gradient for x
    tp = [torch.from_numpy(a).requires_grad_(i != 1) for i, a in enumerate(p)]
    mlp = [torch.zeros(s) for s in ((1,), (1,), (1, 4), (4,), (4, 1), (1,))]
    wts = tfa.prepare_layer(*tp, *mlp, dtype=torch.float32).attn
    (tfa.attention_block_train(tx, wts, heads, False) * torch.from_numpy(g)).sum().backward()
    assert tp[1].grad is None and all(t.grad is not None for i, t in enumerate(tp) if i != 1)


def test_saved_forward_rejects_other_dtypes_and_devices():
    _, _, tx, wts = _case(96, 1, 4, 64, "float32")
    with pytest.raises(ValueError, match="compute dtype"):
        tfa.attention_block_saved(tx.to(torch.bfloat16), wts, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        tfa.attention_block_saved(tx.to("meta"), wts, 4)


def test_ln_backward_matches_autograd():
    rng = np.random.default_rng(97)
    x = torch.from_numpy(rng.normal(size=(2, 5, 32)).astype(np.float32)).requires_grad_(True)
    s = torch.from_numpy(1 + 0.1 * rng.normal(size=32).astype(np.float32)).requires_grad_(True)
    b = torch.from_numpy(0.1 * rng.normal(size=32).astype(np.float32)).requires_grad_(True)
    dh = torch.from_numpy(rng.normal(size=(2, 5, 32)).astype(np.float32))
    want = torch.autograd.grad(tfa.fast_layernorm_f32(x, s, b), (x, s, b), dh)
    got = tfa._ln_bwd_f32(dh, x.detach(), s.detach())
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-5)
    assert math.isfinite(float(got[0].abs().max()))
