"""CLIP ViT-B/32 towers in PyTorch — the port of models/clip.py.

Same architecture and dtype contract as the Flax model: bf16 (or f32)
compute with f32 parameters; LayerNorms, softmax and the final projections
in f32. Parameter names follow the Flax tree (``vision.blocks.0.attn.q_proj
.kernel`` is Flax's ``vision/block_0/attn/q_proj/kernel``, kernels in
(in, out) layout), so ``models/weights.py`` maps either package's weights
one to one.

Two execution paths per transformer layer:

- the plain path of the default ``ModelConfig`` (unfused, compute-dtype
  projections);
- ``fused_layer_block and int8_matmuls`` (``serving_config``, the
  ``vit_b32_serving`` preset): every layer of both towers is one call to
  ``ops.flash_attention.layer_block_int8``, the hand-written Hopper kernel
  on a CUDA tensor.

Every other flag combination of ``ModelConfig`` raises NotImplementedError
rather than silently taking the plain path; ROADMAP.md lists them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from image_retrieval_tpu_torch.config import ModelConfig
from image_retrieval_tpu_torch.ops.flash_attention import (
    fast_layernorm_f32,
    layer_block_int8,
    quantize_layer,
    quick_gelu,
)

# widest tower the whole-layer kernel serves; the JAX package takes its
# sub-block pair above this width (models/clip.py:275-286), not yet ported
_LAYER_KERNEL_MAX_WIDTH = 768


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to image_retrieval_tpu_torch yet "
        "(see ROADMAP.md, queue 2)")


def layer_mode(cfg: ModelConfig, width: int) -> str:
    """'int8_layer' (the serving kernel) or 'plain'; raises on the
    execution strategies the port does not have yet."""
    for flag in ("pallas_attention", "fused_attn_block", "fused_mlp_block",
                 "fused_train_vjp", "fused_attention"):
        if getattr(cfg, flag):
            raise _unsupported(f"ModelConfig.{flag}")
    if cfg.vision_seq_pad and cfg.vision_seq_pad > (cfg.image_size // cfg.patch_size) ** 2 + 1:
        raise _unsupported("ModelConfig.vision_seq_pad")
    if cfg.fused_layer_block and cfg.int8_matmuls:
        if width > _LAYER_KERNEL_MAX_WIDTH:
            raise _unsupported(
                f"serving_config at width {width} (the int8 sub-block "
                "kernels attention_block_int8 + mlp_block_int8)")
        return "int8_layer"
    if cfg.fused_layer_block:
        raise _unsupported("fused_layer_block without int8_matmuls (layer_block)")
    if cfg.int8_matmuls:
        raise _unsupported("int8_matmuls without fused_layer_block (QuantDense)")
    return "plain"


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape, dtype=torch.float32))


def _f32_product(a: torch.Tensor, w: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """jnp.dot(a.astype(dt), w.astype(dt), preferred_element_type=f32):
    round both to the compute type, then multiply and sum in f32."""
    return a.to(dt).float() @ w.to(dt).float()


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
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.width, self.heads = width, heads
        self.q_proj = Dense(width, width)
        self.k_proj = Dense(width, width)
        self.v_proj = Dense(width, width)
        self.out_proj = Dense(width, width)

    def forward(self, h, dt, mask: Optional[torch.Tensor]):
        b, t, _ = h.shape
        hd = self.width // self.heads
        split = lambda a: a.reshape(b, t, self.heads, hd).transpose(1, 2)
        q = split(self.q_proj(h, dt)) * (hd ** -0.5)  # scaled in dt, as Flax
        k = split(self.k_proj(h, dt))
        v = split(self.v_proj(h, dt))
        logits = q.float() @ k.float().transpose(-1, -2)
        if mask is not None:
            logits = logits + mask
        probs = torch.softmax(logits, dim=-1).to(dt)
        out = (probs @ v).transpose(1, 2).reshape(b, t, self.width)
        return self.out_proj(out, dt)


class MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.fc1 = Dense(width, 4 * width)
        self.fc2 = Dense(4 * width, width)

    def forward(self, h, dt):
        return self.fc2(quick_gelu(self.fc1(h, dt)), dt)


class Block(nn.Module):
    """Pre-LN transformer layer; `mode` is layer_mode()'s answer."""

    def __init__(self, width: int, heads: int, causal: bool, mode: str):
        super().__init__()
        self.heads, self.causal, self.mode = heads, causal, mode
        self.ln1 = LayerNorm(width)
        self.attn = Attention(width, heads)
        self.ln2 = LayerNorm(width)
        self.mlp = MLP(width)
        self._int8 = None

    def _layer_params(self):
        a, m = self.attn, self.mlp
        return [self.ln1.scale, self.ln1.bias,
                a.q_proj.kernel, a.q_proj.bias, a.k_proj.kernel, a.k_proj.bias,
                a.v_proj.kernel, a.v_proj.bias, a.out_proj.kernel, a.out_proj.bias,
                self.ln2.scale, self.ln2.bias,
                m.fc1.kernel, m.fc1.bias, m.fc2.kernel, m.fc2.bias]

    def int8_weights(self):
        """The layer quantized on first use (bitwise quantize_weight of the
        f32 parameters), then cached. Loading a state dict or moving or
        casting the module drops the cache; serving edits no parameter in
        place."""
        if self._int8 is None:
            with torch.no_grad():
                self._int8 = quantize_layer(*self._layer_params())
        return self._int8

    def _load_from_state_dict(self, *args, **kwargs):
        self._int8 = None
        super()._load_from_state_dict(*args, **kwargs)

    def _apply(self, fn, *args, **kwargs):
        self._int8 = None
        return super()._apply(fn, *args, **kwargs)

    def forward(self, x, dt, mask=None):
        if self.mode == "int8_layer":
            return layer_block_int8(x.to(dt).contiguous(), self.int8_weights(),
                                    self.heads, self.causal)
        x = x + self.attn(self.ln1(x), dt, mask)
        return x + self.mlp(self.ln2(x), dt)


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


class CLIPVisionTower(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        n = (cfg.image_size // cfg.patch_size) ** 2
        mode = layer_mode(cfg, cfg.vision_width)
        self.patch_embed = PatchEmbed(cfg.vision_width, cfg.patch_size)
        self.class_embedding = _param(cfg.vision_width)
        self.position_embedding = _param(n + 1, cfg.vision_width)
        self.pre_ln = LayerNorm(cfg.vision_width)
        self.blocks = nn.ModuleList(
            Block(cfg.vision_width, cfg.vision_heads, False, mode)
            for _ in range(cfg.vision_layers))
        self.post_ln = LayerNorm(cfg.vision_width)
        self.proj = _param(cfg.vision_width, cfg.embed_dim)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized pixels -> (B, embed_dim) f32, unnormalized."""
        dt = self.dtype
        x = self.patch_embed(pixels.to(dt))
        cls = self.class_embedding.to(dt).expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + self.position_embedding.to(dt)
        x = self.pre_ln(x).to(dt)
        for blk in self.blocks:
            x = blk(x, dt)
        return _f32_product(self.post_ln(x[:, 0]), self.proj, dt)


class CLIPTextTower(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        mode = layer_mode(cfg, cfg.text_width)
        self.token_embedding = _param(cfg.vocab_size, cfg.text_width)
        self.position_embedding = _param(cfg.context_length, cfg.text_width)
        self.blocks = nn.ModuleList(
            Block(cfg.text_width, cfg.text_heads, True, mode)
            for _ in range(cfg.text_layers))
        self.final_ln = LayerNorm(cfg.text_width)
        self.proj = _param(cfg.text_width, cfg.embed_dim)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        """(B, T) token ids -> (B, embed_dim) f32, pooled at argmax(id) (the
        EOT token has the largest id; argmax takes the first on ties)."""
        dt = self.dtype
        b, t = token_ids.shape
        x = self.token_embedding.to(dt)[token_ids] + self.position_embedding.to(dt)[:t]
        mask = torch.triu(torch.full((t, t), float("-inf"), device=x.device),
                          diagonal=1)
        for blk in self.blocks:
            x = blk(x, dt, mask)
        x = self.final_ln(x)
        pooled = x[torch.arange(b, device=x.device), token_ids.argmax(-1)]
        return _f32_product(pooled, self.proj, dt)


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
