"""The port's training path (image_retrieval_tpu_torch/train, the towers
under ModelConfig.fused_train_vjp and ModelConfig.remat, params_to_jax) held
against the JAX package's: the same parameters through params_from_jax, the
same batches from a numpy seed, the JAX Pallas kernels in interpret mode.

On the CPU the port's wrappers run their plain versions. Which entry each
block took is shown by counting the calls on both sides.

Tolerances. Tower outputs: 1e-4 (f32 sums in another order, as
tests/test_torch_dense_towers.py). Tower gradients under the training kernel
configuration: rtol 2e-4, atol 2e-5, what the JAX package holds its own fused
towers' gradients to against its unfused ones
(tests/test_flash_attention.py:683-716). Losses of three AdamW steps: rtol
1e-4. Parameters are compared after plain SGD, never after AdamW, whose first
step is lr * g / |g| and so turns a gradient at noise level into a step of
full size: two SGD steps at lr 0.1 move a parameter by 0.1 x its gradients, so
the gradient tolerance carries over a tenth as large, rtol 2e-4 and atol 4e-6
(readings <= 9.4e-7).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from image_retrieval_tpu.config import MeshConfig, ModelConfig
from image_retrieval_tpu.models.clip import CLIP as JaxCLIP
from image_retrieval_tpu.models.clip import init_params as jax_init_params
from image_retrieval_tpu.ops import flash_attention as jfa
from image_retrieval_tpu.parallel.mesh import make_mesh
from image_retrieval_tpu.train import data as jdata
from image_retrieval_tpu.train import trainer as jtrainer
from image_retrieval_tpu_torch.models import clip as tclip
from image_retrieval_tpu_torch.models.clip import (
    CLIP, DENSE_KERNEL, DENSE_LAYER, KERNEL, PLAIN, layer_mode)
from image_retrieval_tpu_torch.models.weights import params_from_jax, params_to_jax
from image_retrieval_tpu_torch.ops import flash_attention as tfa
from image_retrieval_tpu_torch.train import CLIPTrainer, clip_contrastive_loss
from image_retrieval_tpu_torch.train import data as tdata

KERNELS = ("layer_block", "attention_block", "attention_block_train",
           "attention_block_int8", "mlp_block")

# the small widths of tests/test_torch_clip.py: 17 vision tokens, 16 text
SMALL = dict(image_size=32, patch_size=8, vision_width=48, vision_layers=2,
             vision_heads=4, text_width=32, text_layers=2, text_heads=2,
             vocab_size=1000, context_length=16, embed_dim=24, dtype="float32")
TRAIN_FLAGS = dict(fused_attn_block=True, fused_mlp_block=True, fused_train_vjp=True)

RTOL = ATOL = 1e-4
MIN_COS_INT8 = 0.9999


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
    """Counts the kernel entries each package's Block calls."""
    counts = {"jax": {k: 0 for k in KERNELS}, "torch": {k: 0 for k in KERNELS}}

    def counting(side, name, fn):
        def wrapped(*args, **kwargs):
            counts[side][name] += 1
            return fn(*args, **kwargs)
        return wrapped

    for name in KERNELS:
        monkeypatch.setattr(jfa, name, counting("jax", name, getattr(jfa, name)))
        monkeypatch.setattr(tclip, name, counting("torch", name, getattr(tclip, name)))
    # a pass that records gradients takes the int8 kernel's straight-through
    # entry, the port's form of the JAX entry's custom VJP
    monkeypatch.setattr(tclip, "attention_block_int8_train",
                        counting("torch", "attention_block_int8",
                                 tclip.attention_block_int8_train))

    def take():
        got = {side: dict(c) for side, c in counts.items()}
        for c in counts.values():
            c.update(dict.fromkeys(KERNELS, 0))
        return got

    return take


def _counts(**kw):
    return {k: kw.get(k, 0) for k in KERNELS}


# flags -> (vision routes, text routes, entries a 2-layer vision tower calls, the text tower)
ROUTINGS = {
    "train_vjp_with_attn_kernel": (
        dict(fused_attn_block=True, fused_train_vjp=True),
        (DENSE_KERNEL, PLAIN), (DENSE_KERNEL, PLAIN),
        _counts(attention_block_train=2), _counts(attention_block_train=2)),
    "training_kernel_config": (
        TRAIN_FLAGS, (DENSE_KERNEL, DENSE_KERNEL), (DENSE_KERNEL, DENSE_KERNEL),
        _counts(attention_block_train=2, mlp_block=2),
        _counts(attention_block_train=2, mlp_block=2)),
    "int8_kernel_wins": (
        dict(fused_attn_block=True, fused_train_vjp=True, int8_matmuls=True),
        (KERNEL, "quant_dense"), (KERNEL, "quant_dense"),
        _counts(attention_block_int8=2), _counts(attention_block_int8=2)),
    "whole_layer_kernel_wins": (
        dict(fused_layer_block=True, fused_train_vjp=True),
        (DENSE_LAYER, DENSE_LAYER), (DENSE_LAYER, DENSE_LAYER),
        _counts(layer_block=2), _counts(layer_block=2)),
    "train_vjp_alone_changes_nothing": (
        dict(fused_train_vjp=True), (PLAIN, PLAIN), (PLAIN, PLAIN), _counts(), _counts()),
    "padded_vision_keeps_unfused_attention": (
        dict(fused_attn_block=True, fused_train_vjp=True, vision_seq_pad=24),
        (PLAIN, PLAIN), (DENSE_KERNEL, PLAIN),
        _counts(), _counts(attention_block_train=2)),
    "mlp_kernel_only": (
        dict(fused_mlp_block=True, fused_train_vjp=True),
        (PLAIN, DENSE_KERNEL), (PLAIN, DENSE_KERNEL),
        _counts(mlp_block=2), _counts(mlp_block=2)),
}


@pytest.mark.parametrize("name", sorted(ROUTINGS))
def test_train_vjp_routing_matches_jax(name, small_params, calls):
    """fused_train_vjp no longer raises; each block takes the entry the Flax
    Block takes (models/clip.py:287-335 of the JAX package)."""
    flags, vis_mode, txt_mode, vis_calls, txt_calls = ROUTINGS[name]
    cfg = ModelConfig(**SMALL, **flags)
    assert layer_mode(cfg, cfg.vision_width, masked=cfg.vision_seq_pad > 17) == vis_mode
    assert layer_mode(cfg, cfg.text_width, causal=True) == txt_mode
    px, toks = _inputs(cfg, n=4)
    jm = JaxCLIP(cfg, dtype=jnp.float32)
    model = CLIP(cfg, torch.float32)
    model.load_state_dict(params_from_jax(small_params, cfg))
    assert all(b.train_vjp for b in (*model.vision.blocks, *model.text.blocks))
    want_i = np.asarray(jm.apply(small_params, jnp.asarray(px), method=JaxCLIP.encode_image))
    got_i = model.encode_image(torch.from_numpy(px)).detach().numpy()
    vision = calls()
    want_t = np.asarray(jm.apply(small_params, jnp.asarray(toks), method=JaxCLIP.encode_text))
    got_t = model.encode_text(torch.from_numpy(toks).long()).detach().numpy()
    textc = calls()
    assert vision == {"jax": vis_calls, "torch": vis_calls}
    assert textc == {"jax": txt_calls, "torch": txt_calls}
    for got, want in ((got_i, want_i), (got_t, want_t)):
        assert got.shape == want.shape and np.isfinite(got).all()
        if cfg.int8_matmuls:
            cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1)
                                          * np.linalg.norm(want, axis=-1))
            assert cos.min() >= MIN_COS_INT8
        else:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_saving_forward_runs_only_while_a_gradient_is_recorded(small_params, monkeypatch):
    """Under the training kernel configuration a pass that records gradients
    takes the saving forward once per layer; under no_grad the same model
    takes attention_block and keeps nothing."""
    cfg = ModelConfig(**SMALL, **TRAIN_FLAGS)
    model = CLIP(cfg, torch.float32)
    model.load_state_dict(params_from_jax(small_params, cfg))
    saved = []
    real = tfa.attention_block_saved
    monkeypatch.setattr(tfa, "attention_block_saved",
                        lambda *a: saved.append(1) or real(*a))
    px, toks = _inputs(cfg, n=2)
    out = model.encode_image(torch.from_numpy(px))
    assert len(saved) == 2 and out.requires_grad
    with torch.no_grad():
        out2 = model.encode_image(torch.from_numpy(px))
    assert len(saved) == 2 and torch.equal(out.detach(), out2)


def _tower_loss_grads(cfg, params, px, toks):
    jm = JaxCLIP(cfg, dtype=jnp.float32)

    def f(p):
        img = jm.apply(p, jnp.asarray(px), method=JaxCLIP.encode_image)
        txt = jm.apply(p, jnp.asarray(toks), method=JaxCLIP.encode_text)
        return jnp.mean(img ** 2) + jnp.mean(txt ** 2)

    return jax.tree.map(np.asarray, jax.grad(f)(params))


@pytest.mark.parametrize("remat", [False, True])
def test_tower_gradients_under_the_training_kernel_config_match_jax(small_params, remat):
    """d (mean(img^2) + mean(txt^2)) / d every parameter, both towers, the
    loss of tests/test_flash_attention.py:683-716: against the JAX towers
    under the same flags (kernels interpreted, the hand-written backward) and
    against the JAX unfused towers."""
    cfg = ModelConfig(**SMALL, **TRAIN_FLAGS, remat=remat)
    px, toks = _inputs(cfg, n=4)
    model = CLIP(cfg, torch.float32)
    model.load_state_dict(params_from_jax(small_params, cfg))
    img = model.encode_image(torch.from_numpy(px))
    txt = model.encode_text(torch.from_numpy(toks).long())
    (img.square().mean() + txt.square().mean()).backward()
    got = {k: p.grad.numpy() for k, p in model.named_parameters() if p.grad is not None}
    for jcfg in (cfg, ModelConfig(**SMALL)):
        want = params_from_jax(_tower_loss_grads(jcfg, small_params, px, toks), cfg)
        assert got.keys() == want.keys() - {"logit_scale"}
        for k, g in got.items():
            np.testing.assert_allclose(g, want[k].numpy(), rtol=2e-4, atol=2e-5, err_msg=k)


def test_remat_equals_no_remat(small_params, monkeypatch):
    """ModelConfig.remat recomputes each layer in the backward pass: the
    same loss and gradients bit for bit, the saving forward run twice per
    layer, and nothing recomputed when no gradient is recorded."""
    px, toks = _inputs(ModelConfig(**SMALL), n=4)
    saved = []
    real = tfa.attention_block_saved
    monkeypatch.setattr(tfa, "attention_block_saved",
                        lambda *a: saved.append(1) or real(*a))
    grads, losses, runs = [], [], []
    for remat in (False, True):
        cfg = ModelConfig(**SMALL, **TRAIN_FLAGS, remat=remat)
        tr = CLIPTrainer(cfg, params=params_from_jax(small_params, cfg), device="cpu")
        del saved[:]
        loss = tr.loss(torch.from_numpy(px), torch.from_numpy(toks).long())
        loss.backward()
        runs.append(len(saved))
        losses.append(float(loss.detach()))
        grads.append({k: p.grad.clone() for k, p in tr.model.named_parameters()})
    assert runs == [4, 8]
    assert losses[0] == losses[1]
    assert all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])
    # the unfused towers too
    cfg = ModelConfig(**SMALL, remat=True)
    a = CLIPTrainer(cfg, params=params_from_jax(small_params, cfg), device="cpu")
    b = CLIPTrainer(ModelConfig(**SMALL), params=params_from_jax(small_params, cfg),
                    device="cpu")
    assert a.train_step(px, toks) == b.train_step(px, toks)
    assert a.train_step(px, toks) == b.train_step(px, toks)


def test_contrastive_loss_matches_jax():
    rng = np.random.default_rng(1)
    for logits in (np.eye(4, dtype=np.float32) * 10.0,
                   np.roll(np.eye(4, dtype=np.float32) * 10.0, 1, axis=1),
                   (5 * rng.normal(size=(9, 9))).astype(np.float32)):
        want = float(jtrainer.clip_contrastive_loss(jnp.asarray(logits)))
        got = float(clip_contrastive_loss(torch.from_numpy(logits)))
        # a difference of log-sum-exps near 10, each rounded at 1e-6
        assert got == pytest.approx(want, rel=1e-6, abs=2e-6)
    assert float(clip_contrastive_loss(torch.eye(4) * 10.0)) < 0.01


def _jax_trainer(cfg, params, **kw):
    return jtrainer.CLIPTrainer(cfg=cfg, mesh=make_mesh(MeshConfig(data=8, model=1)),
                                params=jax.tree.map(jnp.array, params), **kw)


@pytest.mark.parametrize("flags", [{}, TRAIN_FLAGS], ids=["default", "train_kernels"])
def test_adamw_losses_match_the_jax_trainer(flags, small_params):
    """Three AdamW steps from the same parameters on the same batch: the
    losses. (Parameters are compared after SGD, below.)"""
    cfg = ModelConfig(**SMALL, **flags)
    px, toks = _inputs(cfg)
    jt = _jax_trainer(cfg, small_params, learning_rate=1e-3)
    tt = CLIPTrainer(cfg, learning_rate=1e-3, params=params_from_jax(small_params, cfg),
                     device="cpu")
    want = [jt.train_step(px, toks) for _ in range(3)]
    got = [tt.train_step(px, toks) for _ in range(3)]
    assert all(isinstance(v, float) for v in got)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]


@pytest.mark.parametrize("flags", [{}, TRAIN_FLAGS], ids=["default", "train_kernels"])
def test_sgd_parameters_match_the_jax_trainer(flags, small_params):
    """Two plain SGD steps on both sides (optimizer=, as
    tests/test_pipelined.py:53): every parameter, leaf by leaf, through
    params_to_jax."""
    cfg = ModelConfig(**SMALL, **flags)
    px, toks = _inputs(cfg)
    jt = _jax_trainer(cfg, small_params, optimizer=optax.sgd(0.1))
    tt = CLIPTrainer(cfg, params=params_from_jax(small_params, cfg), device="cpu",
                     optimizer=lambda ps: torch.optim.SGD(ps, lr=0.1))
    for _ in range(2):
        np.testing.assert_allclose(tt.train_step(px, toks), jt.train_step(px, toks), rtol=1e-4)
    want = jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, jt.params))[0]
    got = jax.tree_util.tree_flatten_with_path(params_to_jax(tt.params, cfg))[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    moved = 0
    start = jax.tree_util.tree_leaves(small_params)
    for (path, g), (_, w), s in zip(got, want, start):
        np.testing.assert_allclose(g, w, rtol=2e-4, atol=4e-6, err_msg=str(path))
        moved += bool(np.abs(w - s).max() > 1e-5)
    assert moved >= len(want) - 4  # all but a few biases whose gradient is zero or tiny


def test_default_optimizer_is_optax_adamw_term_for_term(small_params):
    cfg = ModelConfig(**SMALL)
    tt = CLIPTrainer(cfg, learning_rate=3e-4, weight_decay=0.02,
                     params=params_from_jax(small_params, cfg), device="cpu")
    opt = tt.optimizer
    assert isinstance(opt, torch.optim.AdamW) and len(opt.param_groups) == 1
    g = opt.param_groups[0]
    assert (g["lr"], g["betas"], g["eps"], g["weight_decay"]) == (3e-4, (0.9, 0.999), 1e-8, 0.02)
    assert not g["amsgrad"] and len(g["params"]) == len(list(tt.model.parameters()))
    # one step on a parameter by hand, optax.adamw's rule
    p = torch.nn.Parameter(torch.tensor([1.0, -2.0]))
    grad = torch.tensor([0.5, 0.25])
    o = torch.optim.AdamW([p], lr=0.1, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    p.grad = grad.clone()
    o.step()
    tx = optax.adamw(0.1, weight_decay=0.01)
    jp = jnp.asarray([1.0, -2.0])
    upd, _ = tx.update(jnp.asarray(grad.numpy()), tx.init(jp), jp)
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp + upd), rtol=1e-6)


def test_checkpoint_round_trip(tmp_path, small_params):
    """As tests/test_train.py:65-82: a trainer from another seed, restored,
    takes the next step to the same loss; the optimizer's moments too."""
    cfg = ModelConfig(**SMALL, **TRAIN_FLAGS)
    px, toks = _inputs(cfg)
    tr = CLIPTrainer(cfg, seed=0, device="cpu")
    tr.train_step(px, toks)
    path = str(tmp_path / "ckpt.pt")
    tr.save_checkpoint(path)
    loss_before = tr.train_step(px, toks)
    tr2 = CLIPTrainer(cfg, seed=1, device="cpu")
    assert tr2.train_step(px, toks) != loss_before
    tr2.restore_checkpoint(path)
    assert tr2.train_step(px, toks) == pytest.approx(loss_before, abs=1e-6)
    assert tr2.train_step(px, toks) == pytest.approx(tr.train_step(px, toks), abs=1e-6)
    for k, v in tr.params.items():
        torch.testing.assert_close(tr2.params[k], v, rtol=0, atol=1e-6)


def test_config_errors():
    base = ModelConfig(**SMALL)
    with pytest.raises(ValueError, match="int8_matmuls without fused kernels"):
        CLIPTrainer(dataclasses.replace(base, int8_matmuls=True), device="cpu")
    with pytest.raises(ValueError, match="int8_matmuls without fused kernels"):
        jtrainer.CLIPTrainer(cfg=dataclasses.replace(base, int8_matmuls=True))
    # int8 through the fused kernels trains (tests/test_torch_train_int8.py)
    for flag in ("fused_attn_block", "fused_layer_block"):
        tr = CLIPTrainer(dataclasses.replace(base, int8_matmuls=True, **{flag: True}),
                         device="cpu")
        assert tr.cfg.int8_matmuls and getattr(tr.cfg, flag)


def test_trainer_defaults_to_the_card():
    """No device= means the card; without one the trainer raises rather than
    training on the host."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_gpu.py covers the default")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CLIPTrainer(ModelConfig(**SMALL))


def test_fit_returns_one_float_per_step_and_learns():
    cfg = ModelConfig(**SMALL, **TRAIN_FLAGS)
    px, toks = _inputs(cfg)
    tr = CLIPTrainer(cfg, learning_rate=1e-3, device="cpu")
    synced = []
    real = tr.train_step_async

    def step(p, t):
        loss = real(p, t)
        assert isinstance(loss, torch.Tensor) and loss.shape == () and not loss.requires_grad
        synced.append(loss)
        return loss

    tr.train_step_async = step
    losses = tr.fit(((px, toks) for _ in range(100)), steps=7, max_in_flight=3)
    assert len(losses) == len(synced) == 7 and all(isinstance(v, float) for v in losses)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert tr.fit(iter(()), steps=3) == []
    assert len(tr.fit([(px, toks)] * 2)) == 2  # no step limit: to the end of the batches


def test_a_step_is_seen_by_the_cached_kernel_weights(small_params):
    """The blocks cache their cast weights for passes that record no
    gradient; an optimizer step updates the parameters in place and the
    next such pass casts again."""
    cfg = ModelConfig(**SMALL, **TRAIN_FLAGS)
    px, toks = _inputs(cfg)
    tr = CLIPTrainer(cfg, learning_rate=1e-2, params=params_from_jax(small_params, cfg),
                     device="cpu")
    with torch.no_grad():
        before = tr.model.encode_image(torch.from_numpy(px))
    tr.train_step(px, toks)
    with torch.no_grad():
        after = tr.model.encode_image(torch.from_numpy(px))
    fresh = CLIP(cfg, torch.float32)
    fresh.load_state_dict(tr.params)
    with torch.no_grad():
        want = fresh.encode_image(torch.from_numpy(px))
    assert not torch.equal(before, after) and torch.equal(after, want)


@pytest.mark.parametrize("flags", [{}, TRAIN_FLAGS, dict(fused_layer_block=True)],
                         ids=["default", "train_kernels", "layer_kernel"])
def test_params_to_jax_inverts_params_from_jax(flags, small_params):
    cfg = ModelConfig(**SMALL, **flags)
    state = params_from_jax(small_params, cfg)
    back = params_to_jax(state, cfg)
    want = jax.tree_util.tree_flatten_with_path(small_params)[0]
    got = jax.tree_util.tree_flatten_with_path(back)[0]
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape and np.array_equal(g, w)
    again = params_from_jax(back, cfg)
    assert again.keys() == state.keys() and all(torch.equal(again[k], state[k]) for k in state)
    # the tree of the fused routes is the unfused one: it loads strictly,
    # and the JAX model takes what the port hands back
    CLIP(cfg, torch.float32).load_state_dict(state, strict=True)
    px, _ = _inputs(cfg, n=2)
    jm = JaxCLIP(cfg, dtype=jnp.float32)
    a = jm.apply(back, jnp.asarray(px), method=JaxCLIP.encode_image)
    b = jm.apply(small_params, jnp.asarray(px), method=JaxCLIP.encode_image)
    assert np.array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError, match="config says"):
        params_to_jax(state, dataclasses.replace(cfg, text_layers=3))


# ---------------------------------------------------------------------------
# train/data.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def color_dataset(tmp_path_factory):
    from image_retrieval_tpu.data.dataset import prepare_color_dataset

    base = str(tmp_path_factory.mktemp("ds"))
    _, metadata = prepare_color_dataset(base_dir=base, num_examples=2)
    return base, metadata


def test_read_metadata_matches_pandas(color_dataset):
    import pandas as pd

    base, _ = color_dataset
    want = pd.read_csv(f"{base}/metadata.csv").to_dict("records")
    got = tdata.read_metadata(base)
    assert len(got) == len(want) >= 16
    for g, w in zip(got, want):
        assert (g["path"], g["color"], g["category"]) == (w["path"], w["color"], w["category"])
        assert tdata.caption_for(g) == jdata.caption_for(w) == f"a {w['color']} {w['category']}"


@pytest.mark.parametrize("batch_size,seed,epochs", [(5, 0, 2), (16, 3, 1), (1000, 1, 1)])
def test_contrastive_batches_match_jax_bitwise(color_dataset, batch_size, seed, epochs):
    """The same metadata and seed: the same shuffling, the dropped ragged
    tail, the clamp of an oversized batch, the base_dir join."""
    base, _ = color_dataset
    rows = tdata.read_metadata(base)
    kw = dict(image_size=32, context_length=16, seed=seed, epochs=epochs, base_dir=base)
    want = list(jdata.contrastive_batches(rows, batch_size, **kw))
    got = list(tdata.contrastive_batches(rows, batch_size, **kw))
    n = min(batch_size, len(rows))
    assert len(got) == len(want) == epochs * (len(rows) // n)
    for (gp, gt), (wp, wt) in zip(got, want):
        assert gp.dtype == np.float32 and gt.dtype == np.int32
        assert gp.shape == (n, 32, 32, 3) and gt.shape == (n, 16)
        assert np.array_equal(gp, wp) and np.array_equal(gt, wt)
    assert list(tdata.contrastive_batches([], 4)) == []


def test_finetune_on_color_dataset_learns(color_dataset):
    """As tests/test_train.py:98-113, on a dataset written by the JAX
    package's prepare_color_dataset."""
    base, _ = color_dataset
    cfg = ModelConfig(**{**SMALL, "image_size": 224, "patch_size": 32, "vocab_size": 49408},
                      **TRAIN_FLAGS)
    tr = CLIPTrainer(cfg, learning_rate=3e-4, device="cpu")
    losses = tdata.finetune_on_color_dataset(tr, base, batch_size=16, steps=6)
    assert len(losses) == 6 and all(np.isfinite(v) for v in losses)
    assert losses[-1] < losses[0]
