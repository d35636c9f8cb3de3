"""The plain CLIP towers under the serving arithmetic, in PyTorch tensor
operations: the reference that the search and ingest cells are judged by.

It imports nothing of the program. It takes the benchmark's seeded f32
weights (a dict under the state-dict names of the towers, kernels in
(in, out) layout) and works out itself what the program derives from them:
the per-output-channel int8 weights and their scales, and per row the int8
activations and their scales. The arithmetic is the one the configuration
states (`int8_matmuls` over a bf16 compute type, as in CLIP's serving
strategy): one pre-LN layer is

    h   = rowquant(LN1_f32(x))                      int8 rows, f32 row scales
    qkv = bf16(int32 sum(h, Wqkv) * hs * ws + b)
    a   = per-image attention: f32 scores scaled after the dot, f32 softmax,
          probabilities cast to bf16, PV summed in f32, cast to bf16
    x1  = x + bf16(int32 sum(rowquant(a), Wo) * s * s + b)
    g   = quick_gelu(int32 sum(rowquant(LN2_f32(x1)), W1) * s * s + b)   f32
    out = x1 + bf16(int32 sum(rowquant(g), W2) * s * s + b)

with the LayerNorm's fast variance, max(absmax, 1e-12) / 127 scales by true
division and round-half-even. The integer sums are taken in float64, which
holds them exactly. Every f32 product is a full f32 product: the caller
turns TF32 off (`full_f32`).

`levels` is the quantization grid: 127 is the configuration's int8; the
control passes 7, the int4 grid one precision below it.
"""

from __future__ import annotations

import contextlib

import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
INT8 = 127
INT4 = 7


@contextlib.contextmanager
def full_f32(tf32: bool = False):
    """f32 products in full f32 (TF32 off) inside the block, or in TF32 with
    `tf32`; the previous settings come back after it."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _scale(amax: torch.Tensor, levels: int) -> torch.Tensor:
    # a tensor divisor: CUDA turns a division by a Python number into a
    # multiplication by its reciprocal, which is not the rounded quotient
    return torch.clamp(amax, min=1e-12) / torch.full_like(amax, float(levels))


def quantize_weight(w: torch.Tensor, levels: int = INT8):
    """f32 (in, out) -> (integer values as f32, (out,) f32 scales)."""
    s = _scale(w.abs().amax(0), levels)
    return torch.round(w / s), s


def rowquant(h: torch.Tensor, levels: int = INT8):
    """f32 (m, w) -> (integer values as f32, (m, 1) f32 scales)."""
    s = _scale(h.abs().amax(-1, keepdim=True), levels)
    return torch.round(h / s), s


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in f32 with the fast variance E[x^2] - mu^2, clamped at 0."""
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _int_proj(hq, hs, wq, ws, b, dt):
    acc = hq.double() @ wq.double()  # exact integer sums
    return (acc.float() * hs * ws + b).to(dt)


class Tower:
    """One tower's layers with their weights quantized once on `levels`."""

    def __init__(self, weights: dict, prefix: str, layers: int, heads: int,
                 levels: int = INT8):
        self.heads, self.levels = heads, levels
        self.blocks = []
        for i in range(layers):
            p = f"{prefix}.blocks.{i}."
            w = lambda name: weights[p + name].float()
            wqkv = torch.cat([w("attn.q_proj.kernel"), w("attn.k_proj.kernel"),
                              w("attn.v_proj.kernel")], 1)
            self.blocks.append({
                "ln1": (w("ln1.scale"), w("ln1.bias")),
                "qkv": (*quantize_weight(wqkv, levels),
                        torch.cat([w("attn.q_proj.bias"), w("attn.k_proj.bias"),
                                   w("attn.v_proj.bias")])),
                "out": (*quantize_weight(w("attn.out_proj.kernel"), levels),
                        w("attn.out_proj.bias")),
                "ln2": (w("ln2.scale"), w("ln2.bias")),
                "fc1": (*quantize_weight(w("mlp.fc1.kernel"), levels), w("mlp.fc1.bias")),
                "fc2": (*quantize_weight(w("mlp.fc2.kernel"), levels), w("mlp.fc2.bias")),
            })

    def attention(self, qkv, b, t, w, causal, dt):
        hd = w // self.heads
        q, k, v = (a.reshape(b, t, self.heads, hd).permute(0, 2, 1, 3).float()
                   for a in qkv.reshape(b, t, 3, w).unbind(2))
        s = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5)
        if causal:
            s = s + torch.triu(torch.full((t, t), float("-inf"), device=s.device), diagonal=1)
        s = s - s.amax(-1, keepdim=True)
        p = torch.exp(s)
        p = p / p.sum(-1, keepdim=True)
        o = torch.matmul(p.to(dt).float(), v).to(dt)
        return o.permute(0, 2, 1, 3).reshape(b * t, w)

    def layer(self, blk, x, causal):
        b, t, w = x.shape
        dt, lv = x.dtype, self.levels
        xb = x.reshape(b * t, w)
        hq, hs = rowquant(layernorm(xb.float(), *blk["ln1"]), lv)
        qkv = _int_proj(hq, hs, *blk["qkv"], dt)
        aq, as_ = rowquant(self.attention(qkv, b, t, w, causal, dt).float(), lv)
        x1 = xb + _int_proj(aq, as_, *blk["out"], dt)
        hq, hs = rowquant(layernorm(x1.float(), *blk["ln2"]), lv)
        g = quick_gelu(_int_proj(hq, hs, *blk["fc1"], torch.float32))
        gq, gs = rowquant(g, lv)
        return (x1 + _int_proj(gq, gs, *blk["fc2"], dt)).reshape(b, t, w)

    def __call__(self, x, causal):
        for blk in self.blocks:
            x = self.layer(blk, x, causal)
        return x


def _f32_projection(h: torch.Tensor, proj: torch.Tensor, dt) -> torch.Tensor:
    """The final projection: both operands rounded to the compute type, the
    products summed exactly enough (float64), returned as f32."""
    return (h.to(dt).double() @ proj.to(dt).double()).float()


class CLIPReference:
    """Both towers of one configuration (`model`: the widths of the
    configuration file) over the benchmark's weights."""

    def __init__(self, model: dict, weights: dict, levels: int = INT8,
                 towers=("vision", "text")):
        self.m, self.w, self.dt = model, weights, torch.bfloat16
        if "vision" in towers:
            self.vision = Tower(weights, "vision", model["vision_layers"],
                                model["vision_heads"], levels)
        if "text" in towers:
            self.text = Tower(weights, "text", model["text_layers"], model["text_heads"],
                              levels)

    @torch.no_grad()
    def encode_u8(self, pixels_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 RGB -> (B, embed_dim) f32 unnormalized."""
        dev, dt, w = pixels_u8.device, self.dt, self.w
        mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=dev)
        std = torch.tensor(CLIP_STD, dtype=torch.float32, device=dev)
        x = ((pixels_u8.float() / 255.0 - mean) / std).to(dt)
        b, hgt, wid, _ = x.shape
        p = self.m["patch_size"]
        gh, gw = hgt // p, wid // p
        x = x.reshape(b, gh, p, gw, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, p * p * 3)
        kernel = w["vision.patch_embed.kernel"].to(dt).reshape(p * p * 3, -1)
        x = (x.float() @ kernel.float()).to(dt)
        cls = w["vision.class_embedding"].to(dt).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1) + w["vision.position_embedding"].to(dt)
        x = layernorm(x.float(), w["vision.pre_ln.scale"], w["vision.pre_ln.bias"]).to(dt)
        x = self.vision(x, causal=False)
        h = layernorm(x[:, 0].float(), w["vision.post_ln.scale"], w["vision.post_ln.bias"])
        return _f32_projection(h, w["vision.proj"], dt)

    @torch.no_grad()
    def encode_tokens(self, ids: torch.Tensor) -> torch.Tensor:
        """(B, T) token ids -> (B, embed_dim) f32 unnormalized, pooled at the
        first largest id (the end-of-text token)."""
        dt, w = self.dt, self.w
        t = ids.shape[1]
        x = w["text.token_embedding"].to(dt)[ids] + w["text.position_embedding"].to(dt)[:t]
        x = self.text(x, causal=True)
        x = layernorm(x.float(), w["text.final_ln.scale"], w["text.final_ln.bias"])
        pooled = x[torch.arange(x.shape[0], device=x.device), ids.argmax(-1)]
        return _f32_projection(pooled, w["text.proj"], dt)
