"""The int8 whole-layer serving kernel and its plain PyTorch version.

Port of the serving family of ``image_retrieval_tpu/ops/flash_attention.py``:
``_fast_layernorm_f32`` (l.199), ``_quantize_weight`` (l.532),
``_rowquant`` (l.539) and ``layer_block_int8`` (l.879), whose TPU kernel is
``_layer_block_int8_kernel`` (l.772). One call runs a whole pre-LN
transformer layer:

    h   = rowquant(LN1_f32(x))                      int8 rows, f32 row scales
    qkv = int8 GEMM(h, Wqkv) * hs * ws + b          -> compute dtype
    a   = per-image MHA(q, k, v), f32 softmax, optional causal mask
    x1  = x + (int8 GEMM(rowquant(a), Wo) * s * s + b -> compute dtype)
    g   = quick_gelu(int8 GEMM(rowquant(LN2_f32(x1)), W1) * s * s + b)   f32
    out = x1 + (int8 GEMM(rowquant(g), W2) * s * s + b -> compute dtype)

``layer_block_int8`` launches the hand-written Hopper kernel chain
(csrc/layer_block_int8.cu) for a CUDA tensor and runs
``layer_block_int8_reference`` for a CPU tensor; it never falls back from the
card to the plain version. There is no backward yet (serving only).

Weights are quantized once per layer (``quantize_layer``) from the f32
parameters, bitwise as the JAX package's ``_quantize_weight`` does, and kept
output-major ((N, K), K contiguous) because that is the operand layout of the
kernel's int8 ``mma.sync``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Tuple

import torch

from image_retrieval_tpu_torch.device import require_full_f32


def fast_layernorm_f32(xf: torch.Tensor, scale: torch.Tensor,
                       bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """flax LayerNorm semantics in f32: the fast variance E[x^2] - mu^2,
    clamped at 0 (torch.nn.functional.layer_norm uses the two-pass form).
    Same operation order as the JAX package's _fast_layernorm_f32."""
    mu = xf.mean(-1, keepdim=True)
    ms = (xf * xf).mean(-1, keepdim=True)
    var = torch.clamp(ms - mu * mu, min=0.0)
    return (xf - mu) * torch.rsqrt(var + eps) * scale + bias


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (in, out) -> (int8 values, f32 (1, out) per-channel scales).

    True division and round-half-even, bitwise equal to _quantize_weight."""
    s = torch.clamp(w.abs().amax(0), min=1e-12) / 127.0
    return torch.round(w / s).to(torch.int8), s.reshape(1, -1).to(torch.float32)


def rowquant(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (m, w) -> (int8 values, f32 (m, 1) per-row scales)."""
    s = torch.clamp(h.abs().amax(-1, keepdim=True), min=1e-12) / 127.0
    return torch.round(h / s).to(torch.int8), s


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


@dataclasses.dataclass(frozen=True)
class Int8LayerWeights:
    """One layer's parameters in the kernel's form. Int8 matrices are
    output-major (N, K); scales and biases are f32 (N,); LayerNorm
    parameters f32 (W,)."""

    ln1_s: torch.Tensor
    ln1_b: torch.Tensor
    wqkv_t: torch.Tensor  # (3W, W) int8: [q | k | v] output channels
    wqkv_s: torch.Tensor
    bqkv: torch.Tensor
    wo_t: torch.Tensor  # (W, W)
    wo_s: torch.Tensor
    bo: torch.Tensor
    ln2_s: torch.Tensor
    ln2_b: torch.Tensor
    w1_t: torch.Tensor  # (4W, W)
    w1_s: torch.Tensor
    b1: torch.Tensor
    w2_t: torch.Tensor  # (W, 4W)
    w2_s: torch.Tensor
    b2: torch.Tensor

    @property
    def width(self) -> int:
        return self.wo_t.shape[0]

    @property
    def hidden(self) -> int:
        return self.w1_t.shape[0]

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def quantize_layer(ln1_s, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, ln2_s,
                   ln2_b, w1, b1, w2, b2) -> Int8LayerWeights:
    """f32 layer parameters (JAX (in, out) kernel layout) -> Int8LayerWeights.

    QKV is quantized as one (W, 3W) matrix: per-output-channel scales make
    that bitwise equal to three separate quantizations (the TPU kernel's
    concatenation, flash_attention.py:787-789)."""
    f = lambda a: a.detach().to(torch.float32)

    def q(w):
        wq_, s = quantize_weight(f(w))
        return wq_.t().contiguous(), s.reshape(-1).contiguous()

    wqkv_t, wqkv_s = q(torch.cat([f(wq), f(wk), f(wv)], dim=1))
    wo_t, wo_s = q(wo)
    w1_t, w1_s = q(w1)
    w2_t, w2_s = q(w2)
    c = lambda a: f(a).reshape(-1).contiguous()
    return Int8LayerWeights(
        c(ln1_s), c(ln1_b), wqkv_t, wqkv_s,
        torch.cat([c(bq), c(bk), c(bv)]), wo_t, wo_s, c(bo),
        c(ln2_s), c(ln2_b), w1_t, w1_s, c(b1), w2_t, w2_s, c(b2),
    )


# ---------------------------------------------------------------------------
# Plain PyTorch version (the semantics; CPU path and the kernel's check)
# ---------------------------------------------------------------------------


def _int8_proj(hq, hs, w_t, ws, b, dt):
    # int8 x int8 products summed in float64 are exact (|sum| <= 127^2 * K
    # < 2^53), i.e. the int32 accumulation of the kernel, on any device.
    acc = hq.to(torch.float64) @ w_t.to(torch.float64).t()
    # dequant order of the JAX kernel: acc.astype(f32) * hs * ws + b
    return (acc.to(torch.float32) * hs * ws + b).to(dt)


def _attention_reference(qkv, b, t, w, heads, causal, dt):
    """Per-(image, head) attention as the TPU kernel computes it
    (_inkernel_attention, flash_attention.py:258): QK^T in f32, scaled after
    the dot, f32 softmax, probabilities cast to the compute type, PV
    accumulated in f32."""
    hd = w // heads
    q, k, v = qkv.reshape(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4).float()
    s = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5)
    if causal:
        s = s + torch.triu(
            torch.full((t, t), float("-inf"), device=s.device), diagonal=1)
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    p = (p / p.sum(-1, keepdim=True)).to(dt)
    o = torch.matmul(p.float(), v).to(dt)
    return o.permute(0, 2, 1, 3).reshape(b * t, w)


def layer_block_int8_reference(x: torch.Tensor, weights: Int8LayerWeights,
                               heads: int, causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the whole int8 layer, on x's device.

    Every f32 product here must be a full f32 product, as in the JAX
    reference, so on a CUDA tensor it raises if the caller has turned TF32
    on (torch.backends.cuda.matmul.allow_tf32); it uses no cuDNN."""
    require_full_f32(x.device)
    b, t, w = x.shape
    dt = x.dtype
    wt = weights
    xb = x.reshape(b * t, w)
    hq, hs = rowquant(fast_layernorm_f32(xb.float(), wt.ln1_s, wt.ln1_b))
    qkv = _int8_proj(hq, hs, wt.wqkv_t, wt.wqkv_s, wt.bqkv, dt)
    attn = _attention_reference(qkv, b, t, w, heads, causal, dt)
    aq, as_ = rowquant(attn.float())
    # the projection is cast to the compute type BEFORE the residual add
    x1 = xb + _int8_proj(aq, as_, wt.wo_t, wt.wo_s, wt.bo, dt)
    h2q, h2s = rowquant(fast_layernorm_f32(x1.float(), wt.ln2_s, wt.ln2_b))
    # fc1 stays f32 through quick_gelu into the requantization
    g = quick_gelu(_int8_proj(h2q, h2s, wt.w1_t, wt.w1_s, wt.b1, torch.float32))
    gq, gs = rowquant(g)
    out = x1 + _int8_proj(gq, gs, wt.w2_t, wt.w2_s, wt.b2, dt)
    return out.reshape(b, t, w)


# ---------------------------------------------------------------------------
# How closely the kernel must agree with the plain version
# ---------------------------------------------------------------------------

# Both sides quantize the same values by the same rules. They differ only
# where an f32 sum taken in another order (LayerNorm moments, QK^T, PV)
# lands on the other side of an int8 rounding boundary (a "flip"): one
# activation moves by one level, which moves the outputs of its row (and,
# through attention, its image) in proportion to the layer's update
# (out - x), and in bf16 an output may round to its neighbour. Readings on
# an NVIDIA H100 80GB HBM3 (700 W), 72 cases (6 seeds; the two tower
# shapes and a ragged one; weights at CLIP-like and 5x larger scales; bf16
# and f32; x of unit scale): max abs error <= 0.014 x max|out - x| in f32
# and <= 2.5 bf16 ulps of max|out| in bf16; at most 12.4 % of elements off
# by more than 1e-3; per-token cosine of the update >= 0.99978. The limits
# sit 1.4-2.4x beyond those readings. A layer that drops a bias add
# (|b| ~ 0.02) moves 70-96 % of the elements by more than 1e-3 and, at
# CLIP-like scales, brings the update's cosine to 0.9917-0.9993: it fails
# at least two of the limits.
AGREE_F32_MAX_ABS_REL = 2e-2  # x max|want - x|
AGREE_BF16_ULPS = 4  # bf16 ulps at max|want|
AGREE_FLIP_ATOL = 1e-3
AGREE_FLIP_SHARE = 0.3
AGREE_MIN_UPDATE_COS = 0.9995


def kernel_agreement(got: torch.Tensor, want: torch.Tensor,
                     x: torch.Tensor) -> dict:
    """Hold the kernel's output `got` against the plain version's `want`
    on the same layer input `x` (B, T, W). Returns the readings, the
    max-abs limit for x's dtype, and `ok`."""
    got, want, xf = got.double(), want.double(), x.double()
    err = (got - want).abs()
    du = (got - xf).reshape(-1, x.shape[-1])
    dw = (want - xf).reshape(-1, x.shape[-1])
    if x.dtype == torch.bfloat16:
        top = max(float(want.abs().max()), 1e-30)
        limit = AGREE_BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
    else:
        limit = AGREE_F32_MAX_ABS_REL * float(dw.abs().max())
    cos = (du * dw).sum(-1) / (du.norm(dim=-1) * dw.norm(dim=-1)).clamp_min(1e-300)
    r = {"max_abs_err": float(err.max()), "max_abs_limit": limit,
         "flip_share": float((err > AGREE_FLIP_ATOL).double().mean()),
         "min_update_cos": float(cos.min())}
    r["ok"] = (bool(torch.isfinite(got).all()) and r["max_abs_err"] <= limit
               and r["flip_share"] <= AGREE_FLIP_SHARE
               and r["min_update_cos"] >= AGREE_MIN_UPDATE_COS)
    return r


# ---------------------------------------------------------------------------
# The kernel's wrapper
# ---------------------------------------------------------------------------

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


def _check_weights(weights: Int8LayerWeights, w: int, device) -> int:
    hidden = weights.hidden
    want = {
        "ln1_s": ((w,), torch.float32), "ln1_b": ((w,), torch.float32),
        "wqkv_t": ((3 * w, w), torch.int8), "wqkv_s": ((3 * w,), torch.float32),
        "bqkv": ((3 * w,), torch.float32),
        "wo_t": ((w, w), torch.int8), "wo_s": ((w,), torch.float32),
        "bo": ((w,), torch.float32),
        "ln2_s": ((w,), torch.float32), "ln2_b": ((w,), torch.float32),
        "w1_t": ((hidden, w), torch.int8), "w1_s": ((hidden,), torch.float32),
        "b1": ((hidden,), torch.float32),
        "w2_t": ((w, hidden), torch.int8), "w2_s": ((w,), torch.float32),
        "b2": ((w,), torch.float32),
    }
    for name, (shape, dtype) in want.items():
        a = getattr(weights, name)
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"layer_block_int8: {name} is {tuple(a.shape)} "
                             f"{a.dtype}, expected {shape} {dtype}")
        if a.device != device or not a.is_contiguous():
            raise ValueError(f"layer_block_int8: {name} must be contiguous "
                             f"on {device}")
        if a.data_ptr() % 16:  # the GEMM copies 16-byte chunks (cp.async)
            raise ValueError(f"layer_block_int8: {name} is not 16-byte aligned")
    return hidden


def _layer_block_int8_cuda(x, weights, heads, causal):
    from image_retrieval_tpu_torch.ops._build import load_library

    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_block_int8 kernel takes bfloat16 or float32, "
                        f"got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError("layer_block_int8 kernel takes a contiguous (B, T, W) x")
    b, t, w = x.shape
    hidden = _check_weights(weights, w, x.device)
    if w % heads:
        raise ValueError(f"width {w} is not a multiple of heads {heads}")
    if w % 64 or hidden % 64:
        raise ValueError(f"the kernel's 64-wide GEMM tiles need width and "
                         f"hidden divisible by 64, got {w}, {hidden}")
    lib = load_library()
    hd = w // heads
    smem = lib.irt_attention_smem_bytes(t, hd)
    if hd > 128 or smem > 232448:
        raise ValueError(f"attention tile (t={t}, head_dim={hd}) needs {smem} "
                         "bytes of shared memory; the kernel holds one "
                         "(image, head) in at most 227 KB")
    out = torch.empty_like(x)
    ws = torch.empty(
        lib.irt_layer_block_int8_workspace_bytes(b * t, w, hidden,
                                                 x.element_size()),
        dtype=torch.uint8, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.irt_layer_block_int8(
            x.data_ptr(), out.data_ptr(),
            *(a.data_ptr() for a in weights.tensors()),
            ws.data_ptr(), b, t, w, hidden, heads, int(bool(causal)),
            _DTYPE_CODES[x.dtype], ctypes.c_float(hd ** -0.5), stream,
        )
    if rc != 0:
        raise RuntimeError("layer_block_int8 kernel failed: "
                           + lib.irt_error_string(rc).decode())
    layer_block_int8.launches += 1
    return out


def layer_block_int8(x: torch.Tensor, weights: Int8LayerWeights, heads: int,
                     causal: bool = False) -> torch.Tensor:
    """Whole int8 transformer layer on (B, T, W) x in its compute dtype.

    A CUDA tensor goes through the Hopper kernel chain (or this raises); a
    CPU tensor takes the plain version. ``layer_block_int8.launches`` counts
    kernel launches."""
    if x.device.type == "cuda":
        return _layer_block_int8_cuda(x, weights, heads, causal)
    if x.device.type == "cpu":
        return layer_block_int8_reference(x, weights, heads, causal)
    raise ValueError(f"layer_block_int8: unsupported device {x.device}")


layer_block_int8.launches = 0
