"""CLIP towers in PyTorch — the port of models/clip.py (ViT-B/32, B/16 and
L/14 presets of config.py).

Same architecture and dtype contract as the Flax model: bf16 (or f32)
compute with f32 parameters; LayerNorms, softmax and the final projections
in f32. Parameter names follow the Flax tree (``vision.blocks.0.attn.q_proj
.kernel`` is Flax's ``vision/block_0/attn/q_proj/kernel``, kernels in
(in, out) layout), so ``models/weights.py`` maps either package's weights
one to one.

Each half of a transformer layer takes one of the routes that the Flax
``Block.__call__`` chooses from the same ``ModelConfig`` flags
(``layer_mode`` below):

- plain: unfused, compute-dtype projections (the default ``ModelConfig``);
- ``fused_layer_block``: the whole layer is one kernel call up to width 768
  (``layer_block_int8`` with ``int8_matmuls``, as in ``serving_config``, else
  ``layer_block`` in the compute dtype); wider towers (ViT-L/14 vision) take
  the pair ``attention_block[_int8]`` then ``mlp_block[_int8]``; a vision
  sequence padded by ``vision_seq_pad`` keeps its masked attention unfused
  and takes the MLP kernel;
- ``fused_attn_block`` / ``fused_mlp_block``: that half through its sub-block
  kernel, the other unfused;
- ``int8_matmuls``: every unfused projection is ``quant_dense``;
- ``pallas_attention``: the unfused attention of an input without a mask
  (the vision tower without ``vision_seq_pad``) runs ``multihead_attention``
  between its projections; the text tower's mask keeps the plain path;
- ``fused_attention``: the unfused attention in the order of XLA's
  ``jax.nn.dot_product_attention`` (f32 scores scaled after the dot), written
  out in tensor operations; no kernel, as in the JAX package.

- ``fused_train_vjp``: where the attention half takes ``attention_block``
  (no int8), it takes ``attention_block_train`` instead, whose forward keeps
  its intermediates for a hand-written backward; the whole-layer kernel and
  the int8 kernels win over it, as in the Flax ``Block``;
- ``remat``: each layer is recomputed in the backward pass
  (``torch.utils.checkpoint``) instead of keeping its activations.

A pass that records gradients through an int8 route (``LAYER``, ``KERNEL``,
``QUANT``) takes the straight-through entries (``layer_block_int8_train``,
``attention_block_int8_train``, ``mlp_block_int8_train``,
``quant_dense_train``): the same kernels forward on the layer's f32
parameters quantized on that call, the dense plain version's gradients
backward, as the JAX package's custom VJPs. A pass that records none reads
the quantized weights cached by ``Block.int8_weights``.

All nine kernels are hand-written Hopper kernels on a CUDA tensor
(``ops/flash_attention.py``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from image_retrieval_tpu_torch.config import ModelConfig
from image_retrieval_tpu_torch.ops.flash_attention import (
    attention_block,
    attention_block_int8,
    attention_block_int8_train,
    attention_block_train,
    fast_layernorm_f32,
    layer_block,
    layer_block_int8,
    layer_block_int8_train,
    mlp_block,
    mlp_block_int8,
    mlp_block_int8_train,
    multihead_attention,
    prepare_layer,
    quant_dense,
    quant_dense_train,
    quantize_layer,
    quick_gelu,
)

# the `int8` argument of Attention and MLP in a pass that records
# gradients: quantize the module's own f32 parameters on every call
STRAIGHT_THROUGH = "straight-through"

# widest tower the whole-layer kernels serve; above it the JAX package takes
# the sub-block pair on purpose (models/clip.py:268-286), and so does the port
_LAYER_KERNEL_MAX_WIDTH = 768

# routes of a layer's halves: the int8 kernels, the kernels in the compute
# dtype, and the two unfused forms
LAYER, KERNEL, QUANT, PLAIN = "int8_layer", "int8_block", "quant_dense", "plain"
DENSE_LAYER, DENSE_KERNEL = "layer", "block"


def layer_mode(cfg: ModelConfig, width: int, causal: bool = False,
               masked: bool = False) -> Tuple[str, str]:
    """(attention route, MLP route) of a layer of `width`, as the Flax
    Block.__call__ decides them (models/clip.py:266-354). `causal` marks the
    text tower, whose mask the kernels apply themselves; `masked` a vision
    sequence padded by vision_seq_pad, whose mask only the unfused
    attention honours. Routes with int8_matmuls: LAYER (both halves in one
    layer_block_int8 call), KERNEL (attention_block_int8 / mlp_block_int8),
    QUANT (unfused over quant_dense). Without: DENSE_LAYER (layer_block),
    DENSE_KERNEL (attention_block / mlp_block), PLAIN.

    The rule, for either family: fused_layer_block takes the whole-layer
    kernel up to width 768 where the kernel can apply the mask (none, or the
    causal one), else the sub-block pair; a padded vision sequence keeps
    unfused attention and takes the MLP kernel; fused_attn_block /
    fused_mlp_block ask for one half each. The JAX package decides the same
    way but also asks a table of shapes its TPU compiler accepted
    (ops/shape_support.py): without int8 it admits the whole-layer kernel
    only up to width 512, or at the (768, 50) it swept, and drops a
    sub-block kernel at a swept shape the compiler rejected. That is a
    question of TPU memory and lowering which this card does not pose, and
    the routes compute the same function, so the port carries no table: it
    parts from the JAX routing only at those shapes (e.g. layer_block at
    width 768 with 197 tokens, where JAX takes the pair).

    fused_train_vjp changes no route: a Block whose attention route is
    DENSE_KERNEL runs attention_block_train in place of attention_block."""
    layer, kernel, unfused = ((LAYER, KERNEL, QUANT) if cfg.int8_matmuls
                              else (DENSE_LAYER, DENSE_KERNEL, PLAIN))
    mask_ok = causal or not masked
    if cfg.fused_layer_block and width <= _LAYER_KERNEL_MAX_WIDTH and mask_ok:
        return layer, layer
    subblocks = cfg.fused_layer_block  # too wide, or a mask the kernel lacks
    attn = kernel if (cfg.fused_attn_block or subblocks) and mask_ok else unfused
    mlp = kernel if cfg.fused_mlp_block or subblocks else unfused
    return attn, mlp


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, dtype=torch.float32))


# Rows per product of the towers' f32 output projection. A GEMM library
# picks its algorithm by the shape, and on an H100 cuBLAS sums a row of a
# 256-row f32 product in another order than of a 128-row one; products of
# one fixed shape give a row the same bits whatever batch it came in, which
# the encoder's data-parallel parts need (models/encoder.py).
PRODUCT_ROWS = 64


def _f32_product(a: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """jnp.dot(a.astype(dt), w.astype(dt), preferred_element_type=f32):
    round both to the compute type, then multiply and sum in f32, in
    products of PRODUCT_ROWS rows (the last padded with zero rows)."""
    a, w = a.to(dt).float(), w.to(dt).float()
    m = a.shape[0]
    if m % PRODUCT_ROWS:
        a = torch.cat([a, a.new_zeros((PRODUCT_ROWS - m % PRODUCT_ROWS, a.shape[1]))])
    return torch.cat([blk @ w for blk in a.split(PRODUCT_ROWS)])[:m]


class LayerNorm(nn.Module):
    """flax nn.LayerNorm(dtype=f32): fast variance, f32 output."""

    def __init__(self, width: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(width))
        self.bias = _param(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fast_layernorm_f32(x.float(), self.scale, self.bias)


class Dense(nn.Module):
    """flax nn.Dense(dtype=dt): inputs, kernel and bias cast to dt."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = _param(in_features, features)
        self.bias = _param(features)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        return x.to(dt) @ self.kernel.to(dt) + self.bias.to(dt)


class Attention(nn.Module):
    """Unfused attention. `kernel` (ModelConfig.pallas_attention) sends an
    input without a mask through multihead_attention; `scale_scores`
    (ModelConfig.fused_attention) takes the order of XLA's
    jax.nn.dot_product_attention, f32 scores scaled after the dot, where the
    default scales q in the compute dtype first, as Flax does."""

    def __init__(self, width: int, heads: int, kernel: bool = False,
                 scale_scores: bool = False):
        super().__init__()
        self.width, self.heads = width, heads
        self.kernel, self.scale_scores = kernel, scale_scores
        self.q_proj = Dense(width, width)
        self.k_proj = Dense(width, width)
        self.v_proj = Dense(width, width)
        self.out_proj = Dense(width, width)

    def _qkv_params(self):
        return (torch.cat([self.q_proj.kernel, self.k_proj.kernel, self.v_proj.kernel], 1),
                torch.cat([self.q_proj.bias, self.k_proj.bias, self.v_proj.bias]))

    def attend(self, q, k, v, dt, mask: Optional[torch.Tensor], heads: Optional[int] = None):
        """The attention between the projections: (B, T, heads * hd) q, k, v
        in the compute dtype -> the heads' outputs, (B, T, heads * hd).
        `heads` defaults to the module's; a tensor-parallel shard passes its
        own share of them (train/trainer.py)."""
        heads = heads or self.heads
        b, t, w = q.shape
        hd = self.width // self.heads
        if self.kernel and mask is None:
            return multihead_attention(q.contiguous(), k.contiguous(), v.contiguous(), heads)
        split = lambda a: a.reshape(b, t, heads, hd).transpose(1, 2)
        if self.scale_scores:
            logits = (split(q).float() @ split(k).float().transpose(-1, -2)) * (hd ** -0.5)
        else:
            q = split(q) * (hd ** -0.5)  # scaled in dt, as Flax
            logits = q.float() @ split(k).float().transpose(-1, -2)
        if mask is not None:
            logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(dt)
        return (probs @ split(v)).transpose(1, 2).reshape(b, t, w)

    def forward(self, h, dt, mask: Optional[torch.Tensor], int8=None):
        """On the f32 LayerNorm output `h`. With `int8` the projections are
        QuantDense: q, k, v as one int8 product over the concatenated
        weights, which per-channel scales make bitwise equal to three.
        `int8` is the cached Int8AttnWeights, or STRAIGHT_THROUGH for
        quant_dense_train on this module's f32 parameters."""
        if int8 is None:
            q, k, v = self.q_proj(h, dt), self.k_proj(h, dt), self.v_proj(h, dt)
        elif int8 is STRAIGHT_THROUGH:
            q, k, v = quant_dense_train(h.contiguous(), *self._qkv_params(),
                                        dt).split(self.width, dim=-1)
        else:
            q, k, v = quant_dense(h.contiguous(), int8.wqkv_t, int8.wqkv_s, int8.bqkv,
                                  dt).split(self.width, dim=-1)
        out = self.attend(q, k, v, dt, mask)
        if int8 is None:
            return self.out_proj(out, dt)
        if int8 is STRAIGHT_THROUGH:
            return quant_dense_train(out.contiguous(), self.out_proj.kernel,
                                     self.out_proj.bias, dt)
        return quant_dense(out.contiguous(), int8.wo_t, int8.wo_s, int8.bo, dt)


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = Dense(width, 4 * width)
        self.fc2 = Dense(4 * width, width)

    def forward(self, h, dt, int8=None):
        """Unfused MLP on the f32 LayerNorm output `h`; with `int8` (the
        cached Int8MlpWeights, or STRAIGHT_THROUGH for quant_dense_train on
        this module's f32 parameters) both projections are QuantDense,
        quick_gelu between them in the compute dtype."""
        if int8 is None:
            return self.fc2(quick_gelu(self.fc1(h, dt)), dt)
        if int8 is STRAIGHT_THROUGH:
            g = quick_gelu(quant_dense_train(h.contiguous(), self.fc1.kernel,
                                             self.fc1.bias, dt))
            return quant_dense_train(g, self.fc2.kernel, self.fc2.bias, dt)
        g = quick_gelu(quant_dense(h.contiguous(), int8.w1_t, int8.w1_s, int8.b1, dt))
        return quant_dense(g, int8.w2_t, int8.w2_s, int8.b2, dt)


class Block(nn.Module):
    """Pre-LN transformer layer; `mode` is layer_mode()'s answer, the routes
    of its attention and MLP halves. `train_vjp` (ModelConfig.fused_train_vjp)
    sends a DENSE_KERNEL attention half through attention_block_train; every
    other route ignores it (models/clip.py:308-335 of the JAX package)."""

    def __init__(self, width: int, heads: int, causal: bool, mode: Tuple[str, str],
                 attention_kernel: bool = False, scale_scores: bool = False,
                 train_vjp: bool = False):
        super().__init__()
        self.heads, self.causal, self.mode = heads, causal, mode
        self.train_vjp = train_vjp
        self.ln1 = LayerNorm(width)
        self.attn = Attention(width, heads, attention_kernel, scale_scores)
        self.ln2 = LayerNorm(width)
        self.mlp = MLP(width)
        self._int8 = None  # None, or {device: the quantized layer}
        self._dense = {}  # by (compute dtype, device)

    def _layer_params(self):
        a, m = self.attn, self.mlp
        return [self.ln1.scale, self.ln1.bias,
                a.q_proj.kernel, a.q_proj.bias, a.k_proj.kernel, a.k_proj.bias,
                a.v_proj.kernel, a.v_proj.bias, a.out_proj.kernel, a.out_proj.bias,
                self.ln2.scale, self.ln2.bias,
                m.fc1.kernel, m.fc1.bias, m.fc2.kernel, m.fc2.bias]

    def _records_grad(self) -> bool:
        """Whether this call is recorded for a backward pass that reaches the
        layer's parameters."""
        return torch.is_grad_enabled() and any(p.requires_grad for p in self._layer_params())

    def int8_weights(self):
        """The layer quantized on first use (bitwise quantize_weight of the
        f32 parameters), then cached; every int8 route of a pass without
        gradients reads its half from it. Loading a state dict or moving or
        casting the module drops the cache; serving edits no parameter in
        place. The cache is kept per device of the parameters, so that a
        layer called on another device's tensors (torch.func.functional_call
        over a mesh) is never served weights made on the first."""
        params = self._layer_params()
        dev = params[0].device
        if self._int8 is None:
            self._int8 = {}
        if dev not in self._int8:
            with torch.no_grad():
                self._int8[dev] = quantize_layer(*params)
        return self._int8[dev]

    def dense_weights(self, dt: torch.dtype):
        """The layer's weights cast to the compute dtype `dt` for the kernels
        that keep it (prepare_layer), made on first use and cached like
        int8_weights. While gradients are being recorded they are made anew
        on every call instead, as part of the graph, so that a backward pass
        reaches the parameters. Kept per device, as int8_weights."""
        params = self._layer_params()
        if self._records_grad():
            return prepare_layer(*params, dtype=dt)
        key = (dt, params[0].device)
        if key not in self._dense:
            with torch.no_grad():
                self._dense[key] = prepare_layer(*params, dtype=dt)
        return self._dense[key]

    def _drop_caches(self):
        """Forget the cached weights: whoever edits a parameter in place (the
        trainer, after each optimizer step) calls this."""
        self._int8 = None
        self._dense = {}

    def _load_from_state_dict(self, *args, **kwargs):
        self._drop_caches()
        super()._load_from_state_dict(*args, **kwargs)

    def _apply(self, fn, *args, **kwargs):
        self._drop_caches()
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x, dt, mask=None):
        attn, mlp = self.mode
        if attn in (LAYER, KERNEL, QUANT) and self._records_grad():
            return self._int8_straight_through(x, dt, mask)
        if attn == LAYER:
            return layer_block_int8(x.to(dt).contiguous(), self.int8_weights(),
                                    self.heads, self.causal)
        if attn == DENSE_LAYER:
            return layer_block(x.to(dt).contiguous(), self.dense_weights(dt),
                               self.heads, self.causal)
        int8 = self.int8_weights() if QUANT in self.mode or KERNEL in self.mode else None
        dense = self.dense_weights(dt) if DENSE_KERNEL in self.mode else None
        if attn == KERNEL:
            x = attention_block_int8(x.to(dt).contiguous(), int8.attn, self.heads,
                                     self.causal)
        elif attn == DENSE_KERNEL:
            block_fn = attention_block_train if self.train_vjp else attention_block
            x = block_fn(x.to(dt).contiguous(), dense.attn, self.heads, self.causal)
        else:
            x = x + self.attn(self.ln1(x), dt, mask, int8.attn if attn == QUANT else None)
        if mlp == KERNEL:
            return mlp_block_int8(x.to(dt).contiguous(), int8.mlp)
        if mlp == DENSE_KERNEL:
            return mlp_block(x.to(dt).contiguous(), dense.mlp)
        return x + self.mlp(self.ln2(x), dt, int8.mlp if mlp == QUANT else None)

    def _int8_straight_through(self, x, dt, mask):
        """The int8 routes of a pass that records gradients: the
        straight-through entries on the layer's f32 parameters, quantized on
        this call (remat's recomputation quantizes them again, to the same
        bits)."""
        attn, mlp = self.mode
        params = self._layer_params()
        if attn == LAYER:
            return layer_block_int8_train(x.to(dt).contiguous(), params, self.heads,
                                          self.causal)
        if attn == KERNEL:
            x = attention_block_int8_train(x.to(dt).contiguous(), params[:10], self.heads,
                                           self.causal)
        else:
            x = x + self.attn(self.ln1(x), dt, mask, STRAIGHT_THROUGH)
        if mlp == KERNEL:
            return mlp_block_int8_train(x.to(dt).contiguous(), params[10:])
        return x + self.mlp(self.ln2(x), dt, STRAIGHT_THROUGH)


def _run_blocks(blocks, x, dt, mask, remat: bool):
    """The tower's layers in turn. With `remat` (ModelConfig.remat, nn.remat
    in the JAX package) a pass that records gradients keeps only each layer's
    input and runs the layer again in the backward pass."""
    if remat and torch.is_grad_enabled():
        for blk in blocks:
            x = checkpoint(blk, x, dt, mask, use_reentrant=False,
                           preserve_rng_state=False)  # the layers draw nothing
        return x
    for blk in blocks:
        x = blk(x, dt, mask)
    return x


class PatchEmbed(nn.Module):
    """Strided patch conv written as reshape + one matmul (the JAX
    package's as_matmul form, clip.py:377-386): no cuDNN convolution, so no
    TF32 on the path. Parameter (p, p, 3, width), the Flax conv layout."""

    def __init__(self, width: int, patch: int):
        super().__init__()
        self.patch = patch
        self.kernel = _param(patch, patch, 3, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        p = self.patch
        gh, gw = h // p, w // p
        x = (x.reshape(b, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5)
             .reshape(b, gh * gw, p * p * 3))
        return x @ self.kernel.to(x.dtype).reshape(p * p * 3, -1)


def vision_tokens(mod: nn.Module, pixels: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Patch conv + [CLS] + positions + pre-LN, in the compute dtype, on any
    module that holds the vision tower's patch_embed, class_embedding,
    position_embedding and pre_ln (CLIPVisionTower, the pipelined trainer's
    VisionEmbed)."""
    x = mod.patch_embed(pixels.to(dt))
    cls = mod.class_embedding.to(dt).expand(x.shape[0], 1, -1)
    x = torch.cat([cls, x], dim=1) + mod.position_embedding.to(dt)
    return mod.pre_ln(x).to(dt)


def vision_pool(mod: nn.Module, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """post-LN of the [CLS] token, then the f32 projection (post_ln, proj)."""
    return _f32_product(mod.post_ln(x[:, 0]), mod.proj, dt)


def text_tokens(mod: nn.Module, token_ids: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """Token + position embeddings (token_embedding, position_embedding), for
    the batch's own length."""
    t = token_ids.shape[1]
    return mod.token_embedding.to(dt)[token_ids] + mod.position_embedding.to(dt)[:t]


def causal_mask(t: int, device) -> torch.Tensor:
    """The text tower's (T, T) additive mask: -inf above the diagonal."""
    return torch.triu(torch.full((t, t), float("-inf"), device=device), diagonal=1)


def text_pool(mod: nn.Module, x: torch.Tensor, token_ids: torch.Tensor,
              dt: torch.dtype) -> torch.Tensor:
    """final LN, the row at argmax(id) (the EOT token has the largest id;
    argmax takes the first on ties), then the f32 projection (final_ln,
    proj)."""
    x = mod.final_ln(x)
    pooled = x[torch.arange(x.shape[0], device=x.device), token_ids.argmax(-1)]
    return _f32_product(pooled, mod.proj, dt)


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        n = (cfg.image_size // cfg.patch_size) ** 2
        # zero tokens appended up to vision_seq_pad, their keys masked
        self.seq_pad = max(cfg.vision_seq_pad - (n + 1), 0) if cfg.vision_seq_pad else 0
        mode = layer_mode(cfg, cfg.vision_width, masked=self.seq_pad > 0)
        self.patch_embed = PatchEmbed(cfg.vision_width, cfg.patch_size)
        self.class_embedding = _param(cfg.vision_width)
        self.position_embedding = _param(n + 1, cfg.vision_width)
        self.pre_ln = LayerNorm(cfg.vision_width)
        self.blocks = nn.ModuleList(
            Block(cfg.vision_width, cfg.vision_heads, False, mode,
                  cfg.pallas_attention, cfg.fused_attention, cfg.fused_train_vjp)
            for _ in range(cfg.vision_layers))
        self.post_ln = LayerNorm(cfg.vision_width)
        self.proj = _param(cfg.vision_width, cfg.embed_dim)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized pixels -> (B, embed_dim) f32, unnormalized."""
        x, mask = self.embed(pixels)
        return self.head(_run_blocks(self.blocks, x, self.dtype, mask, self.cfg.remat))

    def embed(self, pixels: torch.Tensor):
        """The layers' input and their mask: (B, T, width) in the compute
        dtype, and None or the padded keys' -inf bias."""
        x = vision_tokens(self, pixels, self.dtype)
        mask = None
        if self.seq_pad:
            # real tokens' outputs (and the CLS pooling) stay identical: the
            # padded keys get a -inf bias
            t = x.shape[1]
            x = torch.nn.functional.pad(x, (0, 0, 0, self.seq_pad))
            mask = torch.zeros(t + self.seq_pad, device=x.device)
            mask[t:] = float("-inf")
        return x, mask

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The last layer's output -> (B, embed_dim) f32."""
        return vision_pool(self, x, self.dtype)


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        mode = layer_mode(cfg, cfg.text_width, causal=True)
        self.token_embedding = _param(cfg.vocab_size, cfg.text_width)
        self.position_embedding = _param(cfg.context_length, cfg.text_width)
        self.blocks = nn.ModuleList(
            Block(cfg.text_width, cfg.text_heads, True, mode,
                  cfg.pallas_attention, cfg.fused_attention, cfg.fused_train_vjp)
            for _ in range(cfg.text_layers))
        self.final_ln = LayerNorm(cfg.text_width)
        self.proj = _param(cfg.text_width, cfg.embed_dim)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        """(B, T) token ids -> (B, embed_dim) f32, pooled at argmax(id) (the
        EOT token has the largest id; argmax takes the first on ties)."""
        x, mask = self.embed(token_ids)
        x = _run_blocks(self.blocks, x, self.dtype, mask, self.cfg.remat)
        return self.head(x, token_ids)

    def embed(self, token_ids: torch.Tensor):
        """The layers' input and the causal mask of the batch's length."""
        x = text_tokens(self, token_ids, self.dtype)
        return x, causal_mask(token_ids.shape[1], x.device)

    def head(self, x: torch.Tensor, token_ids: torch.Tensor) -> torch.Tensor:
        """The last layer's output -> (B, embed_dim) f32."""
        return text_pool(self, x, token_ids, self.dtype)


class CLIP(nn.Module):
    """Joint model; encode_image / encode_text return unnormalized f32
    embeddings."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg = cfg
        self.vision = CLIPVisionTower(cfg, dtype)
        self.text = CLIPTextTower(cfg, dtype)
        self.logit_scale = nn.Parameter(torch.tensor(2.6592))

    def encode_image(self, pixels: torch.Tensor) -> torch.Tensor:
        return self.vision(pixels)

    def encode_text(self, token_ids: torch.Tensor) -> torch.Tensor:
        return self.text(token_ids)
