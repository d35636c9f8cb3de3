"""Training through the port's int8 kernels: the straight-through backward of
``quant_dense`` and of the int8 layer entries (image_retrieval_tpu_torch/
ops/flash_attention.py ``*_int8_train``, ``quant_dense_train``), the towers
that route to them while a gradient is recorded (models/clip.py), and
``CLIPTrainer`` under ``int8_matmuls`` — held against the JAX package's
custom VJPs (QuantDense's ``_quant_matmul``, ``_layer8_bwd``, ``_blk8_bwd``,
``_mlp8_bwd``) on the same numpy inputs, the JAX kernels in interpret mode.

On the CPU the port's forward is the int8 kernels' plain version and its
backward the dense plain version's, as on the card.

Tolerances. QuantDense: the JAX test's own (tests/test_models.py:230-256),
1e-4 on the kernel and the input, 1e-5 on the bias. One entry under a fixed
cotangent: both sides differentiate the same dense math at the same saved
inputs, so only f32 summation order differs: 2e-5, as
tests/test_torch_dense_blocks.py. Towers: each layer's output goes through
int8 roundings that both packages make by the same rules, but an f32 sum in
another order can land on the other side of a rounding boundary and move
one activation by one level (ops/flash_attention.py, kernel_agreement), so
the later layers may see slightly other inputs: rtol 1e-4, atol 1e-6 on
gradients up to 0.1 (readings: within 2.3e-8). Trainer: the first two
losses of three AdamW steps within rtol 1e-5 (readings 1.6e-6), the third
within 2e-3 (readings up to 4.9e-4). AdamW's first step is lr * g / |g|,
so a weight whose gradient is at noise level moves by lr either way, and
where that carries it across an int8 rounding boundary of its channel the
next forward quantizes it to another level on one side only. After two SGD
steps at lr 0.1 the parameters agree within 2e-4 (readings 6.8e-5), the
losses within rtol 1e-4 (readings 2.7e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.config import MeshConfig, ModelConfig
from image_retrieval_tpu.models.clip import CLIP as JaxCLIP
from image_retrieval_tpu.models.clip import QuantDense
from image_retrieval_tpu.models.clip import init_params as jax_init_params
from image_retrieval_tpu.ops import flash_attention as jfa
from image_retrieval_tpu.parallel.mesh import make_mesh
from image_retrieval_tpu.train import trainer as jtrainer
from image_retrieval_tpu_torch.models import clip as tclip
from image_retrieval_tpu_torch.models.clip import CLIP, KERNEL, LAYER, QUANT, layer_mode
from image_retrieval_tpu_torch.models.weights import params_from_jax
from image_retrieval_tpu_torch.ops import flash_attention as tfa
from image_retrieval_tpu_torch.train import CLIPTrainer

from test_torch_layer_block import layer_params

# the config of tests/test_flash_attention.py:307-337 (and test_torch_train.py)
SMALL = dict(image_size=32, patch_size=8, vision_width=48, vision_layers=2,
             vision_heads=4, text_width=32, text_layers=2, text_heads=2,
             vocab_size=1000, context_length=16, embed_dim=24, dtype="float32")
# the two int8 configurations the trainer routes through the kernels
INT8 = {
    "attn_mlp_kernels": dict(int8_matmuls=True, fused_attn_block=True, fused_mlp_block=True),
    "layer_kernel": dict(int8_matmuls=True, fused_layer_block=True),
}
ROUTES = {"attn_mlp_kernels": (KERNEL, KERNEL), "layer_kernel": (LAYER, LAYER)}
TOWER_RTOL, TOWER_ATOL = 1e-4, 1e-6
ENTRY_TOL = 2e-5
NAMES = ("ln1_s", "ln1_b", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo",
         "ln2_s", "ln2_b", "w1", "b1", "w2", "b2")
PARTS = {"layer_block_int8": slice(0, 16), "attention_block_int8": slice(0, 10),
         "mlp_block_int8": slice(10, 16)}
TRAIN_ENTRIES = ("layer_block_int8_train", "attention_block_int8_train",
                 "mlp_block_int8_train", "quant_dense_train")
SERVE_ENTRIES = ("layer_block_int8", "attention_block_int8", "mlp_block_int8", "quant_dense")


def _inputs(cfg, n=8, seed=0):
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    toks = rng.integers(1, cfg.vocab_size - 1, size=(n, cfg.context_length)).astype(np.int32)
    toks[:, 9] = cfg.vocab_size - 1  # EOT = max id: the pooled position
    return px, toks


@pytest.fixture(scope="module")
def small_params():
    _, params = jax_init_params(ModelConfig(**SMALL), seed=0)
    return jax.tree.map(np.asarray, params)


@pytest.fixture
def calls(monkeypatch):
    """Counts the entries the port's Block calls."""
    counts = dict.fromkeys(TRAIN_ENTRIES + SERVE_ENTRIES, 0)

    def counting(name, fn):
        def wrapped(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name in counts:
        monkeypatch.setattr(tclip, name, counting(name, getattr(tclip, name)))

    def take():
        got = {k: v for k, v in counts.items() if v}
        counts.update(dict.fromkeys(counts, 0))
        return got

    return take


# ---------------------------------------------------------------------------
# QuantDense
# ---------------------------------------------------------------------------


def test_quant_dense_straight_through_gradients_match_jax():
    """tests/test_models.py:230-256 on both packages: jax.grad of QuantDense
    against the port's quant_dense_train, and both against the f32 matmul's
    gradients. The forward is quant_dense on the quantized kernel, bit for
    bit."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    qd = QuantDense(8, jnp.float32)
    params = jax.tree.map(np.array, qd.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    params["params"]["bias"] = (0.1 * rng.normal(size=8)).astype(np.float32)
    wave = np.sin(np.arange(3 * 5 * 8, dtype=np.float32)).reshape(3, 5, 8)

    def jloss(p, x):
        return jnp.sum(qd.apply(p, x) * wave)

    jg = jax.grad(jloss, argnums=(0, 1))(params, jnp.asarray(x))
    want_k = np.asarray(jg[0]["params"]["kernel"])
    want_b = np.asarray(jg[0]["params"]["bias"])
    want_x = np.asarray(jg[1])

    tx = torch.from_numpy(x).requires_grad_(True)
    k = torch.from_numpy(params["params"]["kernel"]).requires_grad_(True)
    b = torch.from_numpy(params["params"]["bias"]).requires_grad_(True)
    out = tfa.quant_dense_train(tx, k, b, torch.float32)
    (out * torch.from_numpy(wave)).sum().backward()
    assert np.abs(k.grad.numpy()).max() > 0  # not frozen by the rounding
    np.testing.assert_allclose(k.grad.numpy(), want_k, rtol=0, atol=1e-4)
    np.testing.assert_allclose(b.grad.numpy(), want_b, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), want_x, rtol=0, atol=1e-4)

    # the forward: the same projection as quant_dense on the quantized kernel
    # and as the JAX QuantDense (whose sums XLA orders otherwise)
    with torch.no_grad():
        served = tfa.quant_dense(tx, *tfa.quantize_kernel(k), b, torch.float32)
    assert torch.equal(out.detach(), served)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(qd.apply(params, x)),
                               rtol=0, atol=1e-5)

    # against the plain f32 matmul (the JAX test's reference)
    k2 = k.detach().clone().requires_grad_(True)
    b2 = b.detach().clone().requires_grad_(True)
    x2 = tx.detach().clone().requires_grad_(True)
    ((x2 @ k2 + b2) * torch.from_numpy(wave)).sum().backward()
    torch.testing.assert_close(k.grad, k2.grad, rtol=0, atol=1e-4)
    torch.testing.assert_close(b.grad, b2.grad, rtol=0, atol=1e-5)
    torch.testing.assert_close(tx.grad, x2.grad, rtol=0, atol=1e-4)


def test_quant_dense_gradient_dtypes_follow_jax():
    """_quant_matmul_bwd: dx in x's dtype (bf16 here), dW and db in f32."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(6, 16)).astype(np.float32)
    kern = (rng.normal(size=(16, 8)) / 4).astype(np.float32)
    bias = (0.1 * rng.normal(size=8)).astype(np.float32)

    def jloss(x, k, b):
        return jnp.sum(QuantDense(8, jnp.bfloat16).apply(
            {"params": {"kernel": k, "bias": b}}, x).astype(jnp.float32))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x, jnp.bfloat16), kern, bias)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tk = torch.from_numpy(kern).requires_grad_(True)
    tb = torch.from_numpy(bias).requires_grad_(True)
    out = tfa.quant_dense_train(tx, tk, tb, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert (tx.grad.dtype, tk.grad.dtype, tb.grad.dtype) == (
        torch.bfloat16, torch.float32, torch.float32)
    assert [str(a.dtype) for a in jg] == ["bfloat16", "float32", "float32"]
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jg[1]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg[2]), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tx.grad.float().numpy(), np.asarray(jg[0], np.float32),
                               rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# The int8 layer entries
# ---------------------------------------------------------------------------


def _port_train(entry, x, p, heads, causal):
    if entry == "layer_block_int8":
        return tfa.layer_block_int8_train(x, p, heads, causal)
    if entry == "attention_block_int8":
        return tfa.attention_block_int8_train(x, p[:10], heads, causal)
    return tfa.mlp_block_int8_train(x, p[10:])


def _port_served(entry, x, p, heads, causal):
    w = tfa.quantize_layer(*p)
    if entry == "layer_block_int8":
        return tfa.layer_block_int8(x, w, heads, causal)
    if entry == "attention_block_int8":
        return tfa.attention_block_int8(x, w.attn, heads, causal)
    return tfa.mlp_block_int8(x, w.mlp)


ENTRY_CASES = [(e, c) for e in PARTS for c in (False, True) if e != "mlp_block_int8" or not c]


@pytest.mark.parametrize("entry,causal", ENTRY_CASES)
def test_int8_entry_gradients_match_jax(entry, causal):
    """d sum(out * g) / d (x, every parameter of the entry) in f32, a fixed
    cotangent g: the port's straight-through backward against jax.grad of
    the JAX entry (its custom VJP through the XLA mirrors), the forward
    against the serving entry bit for bit and the JAX kernel by
    kernel_agreement. The other half's parameters get no gradient."""
    heads = 4
    rng = np.random.default_rng(81)
    p = layer_params(rng, 64, 256)
    x = rng.normal(size=(3, 11, 64)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    part = PARTS[entry]
    jp_all = [jnp.asarray(a) for a in p]

    def jforward(jx, *jp):
        if entry == "mlp_block_int8":
            return jfa.mlp_block_int8(jx, *jp)
        return getattr(jfa, entry)(jx, *jp, heads, causal)

    jp = jp_all[part]
    want = jax.grad(lambda jx, *a: jnp.sum(jforward(jx, *a) * jnp.asarray(g)),
                    argnums=tuple(range(1 + len(jp))))(jnp.asarray(x), *jp)

    tx = torch.from_numpy(x).requires_grad_(True)
    tp = [torch.from_numpy(a).requires_grad_(True) for a in p]
    out = _port_train(entry, tx, tp, heads, causal)
    (out * torch.from_numpy(g)).sum().backward()
    got = [tx.grad] + [t.grad for t in tp[part]]
    for name, a, b in zip(("x",) + NAMES[part], got, want):
        assert a is not None, name
        assert a.dtype == torch.float32 and np.abs(a.numpy()).max() > 0, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=ENTRY_TOL, atol=ENTRY_TOL,
                                   err_msg=name)
    assert all(t.grad is None for i, t in enumerate(tp)
               if not part.start <= i < part.stop)

    with torch.no_grad():
        served = _port_served(entry, tx, [t.detach() for t in tp], heads, causal)
    assert torch.equal(out.detach(), served)
    jout = torch.from_numpy(np.array(jforward(jnp.asarray(x), *jp)))
    r = tfa.kernel_agreement(out.detach(), jout, tx.detach())
    assert r["ok"], r


@pytest.mark.parametrize("entry", ["layer_block_int8"])
def test_int8_entry_gradient_dtypes_in_bf16_follow_jax(entry):
    """In bf16 the cotangent of x comes back in bf16 and the parameters'
    in f32, as the JAX VJPs give them; the values within a bf16 step (2^-6
    here, a bf16 value's relative spacing at most) of the entry's largest
    gradient: k's bias has a gradient of zero in exact arithmetic (softmax
    does not see a shift of every key by one vector), so it holds only
    rounding noise of the bf16 probabilities."""
    heads = 4
    rng = np.random.default_rng(82)
    p = layer_params(rng, 32, 128)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    part = PARTS[entry]
    jp = [jnp.asarray(a) for a in p][part]

    def jloss(jx, *a):
        out = (jfa.mlp_block_int8(jx, *a) if entry == "mlp_block_int8"
               else getattr(jfa, entry)(jx, *a, heads, False))
        return jnp.sum(out.astype(jnp.float32))

    want = jax.grad(jloss, argnums=tuple(range(1 + len(jp))))(
        jnp.asarray(x, jnp.bfloat16), *jp)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tp = [torch.from_numpy(a).requires_grad_(True) for a in p]
    out = _port_train(entry, tx, tp, heads, False)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    got = [tx.grad] + [t.grad for t in tp[part]]
    assert [str(a.dtype).removeprefix("torch.") for a in got] == [str(w.dtype) for w in want]
    scale = max(float(np.abs(np.asarray(w, np.float32)).max()) for w in want)
    for name, a, b in zip(("x",) + NAMES[part], got, want):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32), rtol=0,
                                   atol=2 ** -6 * scale, err_msg=name)


def test_train_entry_without_gradient_launches_directly(monkeypatch):
    """A call that records no gradient runs the serving entry on the
    quantized parameters and builds no autograd node."""
    rng = np.random.default_rng(83)
    p = [torch.from_numpy(a) for a in layer_params(rng, 32, 128)]
    x = torch.from_numpy(rng.normal(size=(2, 5, 32)).astype(np.float32))
    applied = []
    real = tfa._KernelFunction.apply
    monkeypatch.setattr(tfa._KernelFunction, "apply",
                        lambda *a: applied.append(1) or real(*a))
    out = tfa.layer_block_int8_train(x, p, 4, True)
    assert not applied and not out.requires_grad
    assert torch.equal(out, tfa.layer_block_int8(x, tfa.quantize_layer(*p), 4, True))
    tfa.layer_block_int8_train(x, [a.clone().requires_grad_(True) for a in p], 4, True)
    assert applied == [1]


# ---------------------------------------------------------------------------
# The towers
# ---------------------------------------------------------------------------


def _tower_loss_grads(cfg, params, px, toks):
    jm = JaxCLIP(cfg, dtype=jnp.float32)

    def f(p):
        img = jm.apply(p, jnp.asarray(px), method=JaxCLIP.encode_image)
        txt = jm.apply(p, jnp.asarray(toks), method=JaxCLIP.encode_text)
        return jnp.mean(img ** 2) + jnp.mean(txt ** 2)

    return jax.tree.map(np.asarray, jax.grad(f)(params))


def _port_grads(cfg, params, px, toks):
    model = CLIP(cfg, torch.float32)
    model.load_state_dict(params_from_jax(params, cfg))
    img = model.encode_image(torch.from_numpy(px))
    txt = model.encode_text(torch.from_numpy(toks).long())
    loss = img.square().mean() + txt.square().mean()
    loss.backward()
    return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()
                                  if p.grad is not None}


@pytest.mark.parametrize("name", sorted(INT8))
def test_tower_gradients_under_int8_match_jax(name, small_params, calls):
    """d (mean(img^2) + mean(txt^2)) / d every parameter, both towers, under
    each int8 configuration the trainer accepts: against jax.grad of the JAX
    towers under the same flags (the int8 kernels interpreted forward, their
    custom VJPs backward). The port's blocks take the straight-through
    entries, one call per layer and half."""
    cfg = ModelConfig(**SMALL, **INT8[name])
    assert layer_mode(cfg, cfg.vision_width) == ROUTES[name]
    assert layer_mode(cfg, cfg.text_width, causal=True) == ROUTES[name]
    px, toks = _inputs(cfg, n=4)
    _, got = _port_grads(cfg, small_params, px, toks)
    layers = cfg.vision_layers + cfg.text_layers
    want_calls = {
        "attn_mlp_kernels": {"attention_block_int8_train": layers,
                             "mlp_block_int8_train": layers},
        "layer_kernel": {"layer_block_int8_train": layers},
    }[name]
    assert calls() == want_calls
    want = params_from_jax(_tower_loss_grads(cfg, small_params, px, toks), cfg)
    assert got.keys() == want.keys() - {"logit_scale"}
    for k, g in got.items():
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=TOWER_RTOL,
                                   atol=TOWER_ATOL, err_msg=k)


@pytest.mark.parametrize("flags,routes,per_layer", [
    (dict(int8_matmuls=True), (QUANT, QUANT), {"quant_dense_train": 4}),
    (dict(int8_matmuls=True, fused_attn_block=True), (KERNEL, QUANT),
     {"attention_block_int8_train": 1, "quant_dense_train": 2}),
], ids=["unfused", "attn_kernel_quant_mlp"])
def test_quant_dense_tower_gradients_match_jax(flags, routes, per_layer, small_params,
                                               calls):
    """The int8 routes through QuantDense: unfused everywhere (which the
    trainer refuses but direct gradients take, as jax.grad does in the JAX
    package) and the MLP half beside the attention kernel (which the
    trainer takes): one quant_dense_train per projection."""
    cfg = ModelConfig(**SMALL, **flags)
    assert layer_mode(cfg, cfg.vision_width) == routes
    px, toks = _inputs(cfg, n=4)
    _, got = _port_grads(cfg, small_params, px, toks)
    layers = cfg.vision_layers + cfg.text_layers
    assert calls() == {k: v * layers for k, v in per_layer.items()}
    want = params_from_jax(_tower_loss_grads(cfg, small_params, px, toks), cfg)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy(), want[k].numpy(), rtol=TOWER_RTOL,
                                   atol=TOWER_ATOL, err_msg=k)


@pytest.mark.parametrize("name", ["layer_kernel"])
def test_remat_under_int8_recomputes_the_same_quantization(name, small_params, calls):
    """remat runs every layer's straight-through entry again in the backward
    pass, on parameters quantized again: the same loss and gradients bit for
    bit, twice the calls."""
    px, toks = _inputs(ModelConfig(**SMALL), n=4)
    runs, losses, grads = [], [], []
    for remat in (False, True):
        cfg = ModelConfig(**SMALL, **INT8[name], remat=remat)
        loss, g = _port_grads(cfg, small_params, px, toks)
        runs.append(sum(calls().values()))
        losses.append(loss)
        grads.append(g)
    assert runs[1] == 2 * runs[0] > 0
    assert losses[0] == losses[1]
    assert grads[0].keys() == grads[1].keys()
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])


@pytest.mark.parametrize("name", sorted(INT8))
def test_serving_pass_reads_the_cached_int8_weights(name, small_params, calls):
    """Without gradients a Block quantizes once and keeps the result: two
    passes run the serving entries on one cache, the embeddings equal the
    pass that records gradients bit for bit."""
    cfg = ModelConfig(**SMALL, **INT8[name])
    model = CLIP(cfg, torch.float32)
    model.load_state_dict(params_from_jax(small_params, cfg))
    px, _ = _inputs(cfg, n=4)
    trained = model.encode_image(torch.from_numpy(px))
    assert trained.requires_grad and set(calls()) <= set(TRAIN_ENTRIES)
    with torch.no_grad():
        first = model.encode_image(torch.from_numpy(px))
        caches = [b._int8 for b in model.vision.blocks]
        second = model.encode_image(torch.from_numpy(px))
    served = calls()
    assert served and set(served) <= set(SERVE_ENTRIES)
    assert all(c is not None for c in caches)
    assert all(b._int8 is c for b, c in zip(model.vision.blocks, caches))
    assert torch.equal(first, second) and torch.equal(first, trained.detach())


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(INT8))
def test_int8_trainer_adamw_losses_match_the_jax_trainer(name, small_params):
    """Three AdamW steps from the same parameters on the same batch, the
    JAX CLIPTrainer on a one-device mesh: the losses, falling."""
    cfg = ModelConfig(**SMALL, **INT8[name])
    px, toks = _inputs(cfg)
    jt = jtrainer.CLIPTrainer(cfg=cfg, mesh=make_mesh(MeshConfig(data=1, model=1)),
                              params=jax.tree.map(jnp.array, small_params),
                              learning_rate=1e-3)
    tt = CLIPTrainer(cfg, learning_rate=1e-3, params=params_from_jax(small_params, cfg),
                     device="cpu")
    want = [jt.train_step(px, toks) for _ in range(3)]
    got = [tt.train_step(px, toks) for _ in range(3)]
    np.testing.assert_allclose(got[:2], want[:2], rtol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=2e-3)
    assert got[2] < got[0]


@pytest.mark.parametrize("name", ["layer_kernel"])
def test_int8_trainer_sgd_parameters_match_the_jax_trainer(name, small_params):
    """Two plain SGD steps on both sides: the losses and every parameter
    through params_from_jax."""
    import optax

    cfg = ModelConfig(**SMALL, **INT8[name])
    px, toks = _inputs(cfg)
    jt = jtrainer.CLIPTrainer(cfg=cfg, mesh=make_mesh(MeshConfig(data=1, model=1)),
                              params=jax.tree.map(jnp.array, small_params),
                              optimizer=optax.sgd(0.1))
    tt = CLIPTrainer(cfg, params=params_from_jax(small_params, cfg), device="cpu",
                     optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))
    for _ in range(2):
        np.testing.assert_allclose(tt.train_step(px, toks), jt.train_step(px, toks),
                                   rtol=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jt.params), cfg)
    assert tt.params.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(tt.params[k].numpy(), v.numpy(), rtol=0, atol=2e-4,
                                   err_msg=k)


def test_int8_trainer_moves_every_weight_and_drops_the_cache(small_params):
    """A step under int8 updates the f32 parameters (the straight-through
    gradient is not frozen by the rounding) and leaves no quantized weights
    cached from before the step."""
    cfg = ModelConfig(**SMALL, **INT8["layer_kernel"])
    px, toks = _inputs(cfg)
    tt = CLIPTrainer(cfg, learning_rate=1e-3, params=params_from_jax(small_params, cfg),
                     device="cpu")
    before = {k: v.clone() for k, v in tt.params.items()}
    with torch.no_grad():
        tt.model.encode_image(torch.from_numpy(px))
    assert all(b._int8 is not None for b in tt.model.vision.blocks)
    tt.train_step(px, toks)
    assert all(b._int8 is None for b in tt.model.vision.blocks)
    for k in ("vision.blocks.0.attn.q_proj.kernel", "vision.blocks.1.mlp.fc2.kernel",
              "text.blocks.0.mlp.fc1.kernel", "text.blocks.1.attn.out_proj.kernel"):
        assert not torch.equal(before[k], tt.params[k]), k
