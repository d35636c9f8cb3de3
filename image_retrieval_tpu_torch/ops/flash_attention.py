"""The transformer-layer kernels and their plain PyTorch versions.

Port of ``image_retrieval_tpu/ops/flash_attention.py``. Two families:

**The int8 serving family**: ``_fast_layernorm_f32`` (l.199),
``_quantize_weight`` (l.532), ``_rowquant`` (l.539), ``layer_block_int8``
(l.879, TPU kernel ``_layer_block_int8_kernel`` l.772) and its two halves
``attention_block_int8`` (l.643, ``_attn_block_int8_kernel`` l.554) and
``mlp_block_int8`` (l.745, ``_mlp_block_int8_kernel`` l.671); and
``QuantDense`` / ``_quant_matmul`` (``models/clip.py`` l.37-110). One whole
pre-LN transformer layer is:

    h   = rowquant(LN1_f32(x))                      int8 rows, f32 row scales
    qkv = int8 GEMM(h, Wqkv) * hs * ws + b          -> compute dtype
    a   = per-image MHA(q, k, v), f32 softmax, optional causal mask
    x1  = x + (int8 GEMM(rowquant(a), Wo) * s * s + b -> compute dtype)
    g   = quick_gelu(int8 GEMM(rowquant(LN2_f32(x1)), W1) * s * s + b)   f32
    out = x1 + (int8 GEMM(rowquant(g), W2) * s * s + b -> compute dtype)

``attention_block_int8`` returns x1, ``mlp_block_int8`` takes it to out, and
``layer_block_int8`` does both; x1 passes in the compute dtype either way,
so the plain versions of the halves compose to the plain whole layer bit
for bit. ``quant_dense`` is one such projection on its own. Weights are
quantized per layer (``quantize_layer``, per half ``quantize_attn`` /
``quantize_mlp``) from the f32 parameters, bitwise as the JAX package's
``_quantize_weight`` does. Serving quantizes once and keeps the result; for
training, ``layer_block_int8_train``, ``attention_block_int8_train``,
``mlp_block_int8_train`` and ``quant_dense_train`` take the f32 parameters,
quantize them on every call, run the same kernels forward and give the JAX
package's straight-through backward: the gradients of the dense,
unquantized plain version (there is no backward kernel).

**The family in the compute dtype** (bf16 or f32, nothing quantized):
``layer_block`` (l.1003, TPU kernel ``_layer_block_kernel`` l.931), its halves
``attention_block`` (l.396, ``_attn_block_kernel`` l.346) and ``mlp_block``
(l.502, ``_mlp_block_kernel`` l.457), and the bare ``multihead_attention``
(l.171, ``_attn_kernel`` l.87). With dt the dtype of x:

    h   = dt(LN1_f32(x))
    qkv = dt(f32 sum(h, dt(Wqkv)) + b)              three casts of f32 sums
    a   = per-image MHA(q, k, v): f32 scores scaled after the dot, f32
          softmax, probabilities cast to dt, PV summed in f32, cast to dt
    x1  = x + dt(f32 sum(a, dt(Wo)) + b)            the add in dt
    g   = dt(quick_gelu(f32 sum(dt(LN2_f32(x1)), dt(W1)) + b))   gelu in f32
    out = x1 + dt(f32 sum(g, dt(W2)) + b)

``attention_block`` returns x1, ``mlp_block`` takes it to out, ``layer_block``
does both, and again the plain halves compose to the plain layer bit for
bit. Weights are cast to the compute dtype once per layer
(``prepare_layer``), where the JAX entries cast them on every call. Each of
the four is differentiable: on a CUDA tensor the forward is the kernel and
the backward differentiates the plain version on the saved inputs (the JAX
entries' custom VJPs recompute through their XLA mirrors the same way); on a
CPU tensor autograd runs through the plain version.

**The training form of the attention half**: ``attention_block_train``
(l.1225, TPU kernel ``_attn_block_saved_kernel`` l.1051). Its forward is
``attention_block``'s and also keeps q, k, v and a in the compute dtype and
the f32 probabilities before their cast (``attention_block_saved``); its
backward is written out by hand over those tensors
(``attention_block_saved_backward``, the port of ``_attn_block_saved_bwd``
l.1165 and ``_ln_bwd_f32`` l.1148) and recomputes only the LayerNorm. A call
that records no gradient is ``attention_block``.

Each wrapper launches its hand-written Hopper kernel chain (csrc/) for a
CUDA tensor and runs its ``*_reference`` for a CPU tensor; none falls back
from the card to the plain version. Weight matrices are kept output-major
((N, K), K contiguous) because that is the operand layout of the kernels'
GEMMs (``wgmma``, which takes 8-bit operands K-major only). ``gemm_bf16``
and ``gemm_s8`` (one persistent kernel for both operand types) run them
alone, with ``gemm_plan`` their launch plan. The int8 MLP's fc1 ->
quick_gelu -> rowquant is one clustered launch of the int8 GEMM where
``rowquant_gemm_plan`` says so (``gemm_s8(..., "gelu_rowquant")`` alone);
``ln_rowquant`` and ``ln_cast`` are the int8 and the compute-type chains'
row passes alone.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
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


def _absmax_scale(amax: torch.Tensor) -> torch.Tensor:
    """max(absmax, 1e-12) / 127 as a true division. The divisor is a tensor:
    PyTorch's CUDA division by a Python scalar multiplies by its reciprocal,
    which is not the correctly rounded quotient the JAX package and the
    kernels (__fdiv_rn) compute."""
    return torch.clamp(amax, min=1e-12) / torch.full_like(amax, 127.0)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (in, out) -> (int8 values, f32 (1, out) per-channel scales).

    True division and round-half-even, bitwise equal to _quantize_weight."""
    s = _absmax_scale(w.abs().amax(0))
    return torch.round(w / s).to(torch.int8), s.reshape(1, -1).to(torch.float32)


def rowquant(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 (m, w) -> (int8 values, f32 (m, 1) per-row scales)."""
    s = _absmax_scale(h.abs().amax(-1, keepdim=True))
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

    @property
    def attn(self) -> "Int8AttnWeights":
        return Int8AttnWeights(self.ln1_s, self.ln1_b, self.wqkv_t, self.wqkv_s,
                               self.bqkv, self.wo_t, self.wo_s, self.bo)

    @property
    def mlp(self) -> "Int8MlpWeights":
        return Int8MlpWeights(self.ln2_s, self.ln2_b, self.w1_t, self.w1_s,
                              self.b1, self.w2_t, self.w2_s, self.b2)


@dataclasses.dataclass(frozen=True)
class Int8AttnWeights:
    """The attention half of Int8LayerWeights (the same tensors)."""

    ln_s: torch.Tensor
    ln_b: torch.Tensor
    wqkv_t: torch.Tensor  # (3W, W) int8: [q | k | v] output channels
    wqkv_s: torch.Tensor
    bqkv: torch.Tensor
    wo_t: torch.Tensor  # (W, W)
    wo_s: torch.Tensor
    bo: torch.Tensor

    @property
    def width(self) -> int:
        return self.wo_t.shape[0]

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


@dataclasses.dataclass(frozen=True)
class Int8MlpWeights:
    """The MLP half of Int8LayerWeights (the same tensors)."""

    ln_s: torch.Tensor
    ln_b: torch.Tensor
    w1_t: torch.Tensor  # (4W, W)
    w1_s: torch.Tensor
    b1: torch.Tensor
    w2_t: torch.Tensor  # (W, 4W)
    w2_s: torch.Tensor
    b2: torch.Tensor

    @property
    def width(self) -> int:
        return self.w2_t.shape[0]

    @property
    def hidden(self) -> int:
        return self.w1_t.shape[0]

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def _f32(a: torch.Tensor) -> torch.Tensor:
    return a.detach().to(torch.float32)


def _flat32(a: torch.Tensor) -> torch.Tensor:
    """A bias, scale or LayerNorm parameter as a contiguous f32 vector
    (differentiable)."""
    return a.to(torch.float32).reshape(-1).contiguous()


def _vec(a: torch.Tensor) -> torch.Tensor:
    return _flat32(a.detach())


def quantize_kernel(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """An f32 (in, out) kernel -> the int8 form the kernels take: int8
    (out, in) output-major values and f32 (out,) per-channel scales
    (quantize_weight's bits)."""
    wq_, s = quantize_weight(_f32(w))
    return wq_.t().contiguous(), s.reshape(-1).contiguous()


def quantize_attn(ln_s, ln_b, wq, bq, wk, bk, wv, bv, wo, bo) -> Int8AttnWeights:
    """The attention half's f32 parameters -> Int8AttnWeights. QKV is
    quantized as one (W, 3W) matrix: per-output-channel scales make that
    bitwise equal to three separate quantizations (the TPU kernel's
    concatenation, flash_attention.py:787-789)."""
    wqkv_t, wqkv_s = quantize_kernel(torch.cat([_f32(wq), _f32(wk), _f32(wv)], dim=1))
    wo_t, wo_s = quantize_kernel(wo)
    return Int8AttnWeights(_vec(ln_s), _vec(ln_b), wqkv_t, wqkv_s,
                           torch.cat([_vec(bq), _vec(bk), _vec(bv)]), wo_t, wo_s, _vec(bo))


def quantize_mlp(ln_s, ln_b, w1, b1, w2, b2) -> Int8MlpWeights:
    """The MLP half's f32 parameters -> Int8MlpWeights."""
    return Int8MlpWeights(_vec(ln_s), _vec(ln_b), *quantize_kernel(w1), _vec(b1),
                          *quantize_kernel(w2), _vec(b2))


def quantize_layer(ln1_s, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, ln2_s,
                   ln2_b, w1, b1, w2, b2) -> Int8LayerWeights:
    """f32 layer parameters (JAX (in, out) kernel layout) -> Int8LayerWeights:
    the two halves, quantize_attn and quantize_mlp."""
    attn = quantize_attn(ln1_s, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo)
    mlp = quantize_mlp(ln2_s, ln2_b, w1, b1, w2, b2)
    return Int8LayerWeights(*attn.tensors(), *mlp.tensors())


# ---------------------------------------------------------------------------
# Plain PyTorch version (the semantics; CPU path and the kernel's check)
# ---------------------------------------------------------------------------


def _int8_proj(hq, hs, w_t, ws, b, dt):
    # int8 x int8 products summed in float64 are exact (|sum| <= 127^2 * K
    # < 2^53), i.e. the int32 accumulation of the kernel, on any device.
    acc = hq.to(torch.float64) @ w_t.to(torch.float64).t()
    # dequant order of the JAX kernel: acc.astype(f32) * hs * ws + b
    return (acc.to(torch.float32) * hs * ws + b).to(dt)


def _attention_with_probs(q, k, v, heads, causal):
    """multihead_attention_reference and, beside its output, the (B, H, T, T)
    f32 probabilities before their cast to the compute type."""
    b, t, w = q.shape
    hd, dt = w // heads, q.dtype
    q, k, v = (a.reshape(b, t, heads, hd).permute(0, 2, 1, 3).float() for a in (q, k, v))
    s = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5)
    if causal:
        s = s + torch.triu(
            torch.full((t, t), float("-inf"), device=s.device), diagonal=1)
    s = s - s.amax(-1, keepdim=True)
    p = torch.exp(s)
    p = p / p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(dt).float(), v).to(dt)
    return o.permute(0, 2, 1, 3).reshape(b, t, w), p


def multihead_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                  heads: int, causal: bool = False) -> torch.Tensor:
    """Per-(image, head) attention on (B, T, W) q, k, v as the TPU kernels
    compute it (_attn_kernel, flash_attention.py:87; _inkernel_attention,
    :258): QK^T in f32, scaled after the dot, f32 softmax, probabilities cast
    to the compute type, PV accumulated in f32 and cast. The plain version of
    multihead_attention (which has no mask; `causal` serves the layer
    kernels' attention step)."""
    return _attention_with_probs(q, k, v, heads, causal)[0]


def _attention_reference(qkv, b, t, w, heads, causal, dt):
    """The same on packed (B * T, 3 W) [q | k | v] rows -> (B * T, W)."""
    q, k, v = qkv.reshape(b, t, 3, w).unbind(2)
    return multihead_attention_reference(q, k, v, heads, causal).reshape(b * t, w)


def attention_block_int8_reference(x: torch.Tensor, weights: Int8AttnWeights,
                                   heads: int, causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the int8 attention sub-block, on x's device.

    Every f32 product here must be a full f32 product, as in the JAX
    reference, so on a CUDA tensor it raises if the caller has turned TF32
    on (torch.backends.cuda.matmul.allow_tf32); it uses no cuDNN."""
    require_full_f32(x.device)
    b, t, w = x.shape
    dt = x.dtype
    wt = weights
    xb = x.reshape(b * t, w)
    hq, hs = rowquant(fast_layernorm_f32(xb.float(), wt.ln_s, wt.ln_b))
    qkv = _int8_proj(hq, hs, wt.wqkv_t, wt.wqkv_s, wt.bqkv, dt)
    attn = _attention_reference(qkv, b, t, w, heads, causal, dt)
    aq, as_ = rowquant(attn.float())
    # the projection is cast to the compute type BEFORE the residual add
    return (xb + _int8_proj(aq, as_, wt.wo_t, wt.wo_s, wt.bo, dt)).reshape(b, t, w)


def mlp_block_int8_reference(x: torch.Tensor, weights: Int8MlpWeights) -> torch.Tensor:
    """Plain PyTorch version of the int8 MLP sub-block, on x's device (full
    f32 products, as attention_block_int8_reference)."""
    require_full_f32(x.device)
    b, t, w = x.shape
    wt = weights
    xb = x.reshape(b * t, w)
    hq, hs = rowquant(fast_layernorm_f32(xb.float(), wt.ln_s, wt.ln_b))
    # fc1 stays f32 through quick_gelu into the requantization
    g = quick_gelu(_int8_proj(hq, hs, wt.w1_t, wt.w1_s, wt.b1, torch.float32))
    gq, gs = rowquant(g)
    return (xb + _int8_proj(gq, gs, wt.w2_t, wt.w2_s, wt.b2, x.dtype)).reshape(b, t, w)


def layer_block_int8_reference(x: torch.Tensor, weights: Int8LayerWeights,
                               heads: int, causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the whole int8 layer: the two halves, with
    the mid-layer activation in the compute dtype as in the kernel."""
    x1 = attention_block_int8_reference(x, weights.attn, heads, causal)
    return mlp_block_int8_reference(x1, weights.mlp)


def quant_dense_reference(x: torch.Tensor, w_t: torch.Tensor, w_s: torch.Tensor,
                          bias: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of QuantDense (_quant_matmul's arithmetic): x
    quantized per row in f32, acc.astype(f32) * xscale * wscale, + bias in
    f32, then the cast. x (..., K); w_t (N, K) int8 with scales w_s (N,)."""
    require_full_f32(x.device)
    xq, xs = rowquant(x.reshape(-1, x.shape[-1]).float())
    out = _int8_proj(xq, xs, w_t, w_s, bias, out_dtype)
    return out.reshape(*x.shape[:-1], w_t.shape[0])


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
# The kernels' wrappers
# ---------------------------------------------------------------------------

_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
_MAX_LN_WIDTH = 12288  # the widest row the compute-type chains take (dense_common.cuh)


def _check_tensor(fn: str, name: str, a: torch.Tensor, shape, dtype, device) -> None:
    if tuple(a.shape) != tuple(shape) or a.dtype != dtype:
        raise ValueError(f"{fn}: {name} is {tuple(a.shape)} {a.dtype}, "
                         f"expected {tuple(shape)} {dtype}")
    if a.device != device or not a.is_contiguous():
        raise ValueError(f"{fn}: {name} must be contiguous on {device}")
    if a.data_ptr() % 16:  # the GEMM copies 16-byte chunks (cp.async)
        raise ValueError(f"{fn}: {name} is not 16-byte aligned")


def _check_attn_weights(fn: str, wt: Int8AttnWeights, w: int, device) -> None:
    f32, i8 = torch.float32, torch.int8
    for name, shape, dtype in (
            ("ln_s", (w,), f32), ("ln_b", (w,), f32),
            ("wqkv_t", (3 * w, w), i8), ("wqkv_s", (3 * w,), f32), ("bqkv", (3 * w,), f32),
            ("wo_t", (w, w), i8), ("wo_s", (w,), f32), ("bo", (w,), f32)):
        _check_tensor(fn, name, getattr(wt, name), shape, dtype, device)


def _check_mlp_weights(fn: str, wt: Int8MlpWeights, w: int, device) -> int:
    f32, i8 = torch.float32, torch.int8
    hidden = wt.hidden
    for name, shape, dtype in (
            ("ln_s", (w,), f32), ("ln_b", (w,), f32),
            ("w1_t", (hidden, w), i8), ("w1_s", (hidden,), f32), ("b1", (hidden,), f32),
            ("w2_t", (w, hidden), i8), ("w2_s", (w,), f32), ("b2", (w,), f32)):
        _check_tensor(fn, name, getattr(wt, name), shape, dtype, device)
    return hidden


def _check_x(fn: str, x: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn} kernel takes bfloat16 or float32, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"{fn} kernel takes a contiguous (B, T, W) x")
    if x.data_ptr() % 16:
        raise ValueError(f"{fn}: x is not 16-byte aligned")


def _check_gemm_dims(fn: str, *dims: int) -> None:
    if any(d % 64 for d in dims):
        raise ValueError(f"{fn}: the kernel's 64-wide GEMM tiles need width and "
                         f"hidden divisible by 64, got {', '.join(map(str, dims))}")


# The attention step's launch plan, mirrored from csrc/ (attention_sm90.cuh
# and attention_mma.cuh in bf16, block_common.cuh's attention_tile_rows in
# f32) so that a shape is judged, and refused with its reason, before any
# launch; the C side's irt_attention_tile_rows / irt_attention_smem_bytes /
# irt_attention_route answer the same (tests/test_torch_gpu.py holds them
# equal).
_MAX_SMEM = 232448  # dynamic shared memory one block may ask for on sm_90 (227 KB)
_MMA_WARPS, _MMA_CHUNK_KEYS, _MMA_HALF_KEYS, _MMA_FILL_BLOCKS = 4, 80, 144, 2 * 132
# the wgmma form: head_dim 64, up to 288 keys, 64-row query tiles, one block
# an SM of an H100 holding two K and V stages (288 rows of 128 bytes each)
# and four Q stages (64 rows), aligned to 1,024 bytes
_WG_HEAD_DIM, _WG_MAX_KEYS, _WG_TILE_ROWS, _WG_BLOCKS = 64, 288, 64, 132
_WG_SMEM = 2 * 2 * _WG_MAX_KEYS * 128 + 4 * _WG_TILE_ROWS * 128 + 1024
ATTENTION_ROUTES = ("f32 on the CUDA cores", "bf16 tensor cores, scores computed once",
                    "bf16 tensor cores, scores computed once, two warps to a tile",
                    "bf16 tensor cores, three passes over 80-key chunks",
                    "bf16 wgmma fed by TMA, a 64-row tile's whole score rows in a "
                    "warpgroup's registers, persistent blocks")


@dataclasses.dataclass(frozen=True)
class AttentionPlan:
    route: int           # index into ATTENTION_ROUTES
    rows_per_block: int  # query rows one block (route 4: one work item) takes; 0 when refused
    blocks: int          # blocks of one launch over `pairs` (image, head) pairs
    smem_bytes: int      # dynamic shared memory of one block
    refused: str | None  # why the kernel does not take the shape


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def _f32_smem_bytes(t: int, hd: int, tile: int) -> int:
    s4, t4 = _up(t, 4), _up(tile, 4)
    return 4 * (s4 * (hd + 4) + s4 * hd + t4 * (hd + 4) + t4 * s4)


def _f32_tile_rows(t: int, hd: int) -> int:
    tile = 64
    while tile > 1 and tile // 2 >= t:
        tile //= 2
    while tile > 1 and _f32_smem_bytes(t, hd, tile) > _MAX_SMEM:
        tile //= 2
    return 0 if _f32_smem_bytes(t, hd, tile) > _MAX_SMEM else tile


@functools.lru_cache(maxsize=1024)
def attention_plan(t: int, hd: int, dtype: torch.dtype, pairs: int = 1) -> AttentionPlan:
    """How the attention kernel runs t tokens at head_dim hd in `dtype` over
    `pairs` = batch * heads (image, head) pairs. bf16 at head_dim 64 and
    81-288 keys (t rounded up to 16; L/14's 257, B/16's 197): persistent
    blocks, one an SM, walk work items of one (image, head) and its 64-row
    query tiles (split into ranges only while the items are fewer than 132),
    K, V and the query tiles loaded by TMA into two and four stages. Other
    bf16 shapes: four row groups of 16-row query tiles a block (one warp
    each, two with keys split in halves for 81-288 keys at hd < 64), K and V
    of the (image, head) in shared memory at head_dim padded to 16, 32, 64
    or 128 (+ 8), the scores in registers; the query tiles are split over
    blocks only until the launch has 264 blocks (two per SM). f32: the
    scalar kernel's power-of-two row tiles."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"the attention kernel takes bfloat16 or float32, got {dtype}")
    refused = None
    if hd % 4 or hd > 128 or hd <= 0:
        refused = f"head_dim {hd} must be a multiple of 4, at most 128"
    keys = _up(t, 16)
    if dtype == torch.bfloat16 and hd == _WG_HEAD_DIM and _MMA_CHUNK_KEYS < keys <= _WG_MAX_KEYS:
        tiles = -(-t // _WG_TILE_ROWS)
        splits = 1 if pairs >= _WG_BLOCKS else min(tiles, -(-_WG_BLOCKS // pairs))
        per = -(-tiles // splits)
        items = pairs * -(-tiles // per)
        route, smem, rows, blocks = 4, _WG_SMEM, _WG_TILE_ROWS * per, min(items, _WG_BLOCKS)
    elif dtype == torch.bfloat16:
        kd = 1 if hd <= 16 else 2 if hd <= 32 else 4 if hd <= 64 else 8
        route = (1 if keys <= _MMA_CHUNK_KEYS
                 else 2 if keys <= 2 * _MMA_HALF_KEYS and hd <= 64 else 3)
        smem = (2 * keys + 16 * _MMA_WARPS) * (16 * kd + 8) * 2
        if route == 2:  # per row group: two halves' maxima and sums, one half's PV sums
            smem += _MMA_WARPS * (2 * 2 * 16 + 2 * kd * 4 * 32) * 4
        tiles = -(-t // 16)
        groups = max(1, min(-(-_MMA_FILL_BLOCKS // pairs), -(-tiles // _MMA_WARPS)))
        per_block = -(-tiles // groups)
        rows, blocks = 16 * per_block, pairs * -(-tiles // per_block)
    else:
        tile = _f32_tile_rows(t, hd)
        smem = _f32_smem_bytes(t, hd, max(tile, 1))
        route, rows, blocks = 0, tile, pairs * -(-t // max(tile, 1))
    if refused is None and smem > _MAX_SMEM:
        what = "query tile" if dtype == torch.bfloat16 else "query row"
        refused = (f"K and V of one (image, head) at t={t}, head_dim={hd} do not fit in a "
                   f"block's 227 KB of shared memory beside one {what} in "
                   f"{str(dtype)[6:]} ({smem} bytes)")
    if refused is not None:
        rows = blocks = 0
    return AttentionPlan(route, rows, blocks, smem, refused)


def _check_attention_shape(fn: str, t: int, w: int, heads: int, dtype: torch.dtype) -> int:
    """Raises with the reason when the attention kernel does not take the
    shape (attention_plan); returns head_dim."""
    if w % heads:
        raise ValueError(f"{fn}: width {w} is not a multiple of heads {heads}")
    plan = attention_plan(t, w // heads, dtype)
    if plan.refused is not None:
        raise ValueError(f"{fn}: {plan.refused}")
    return w // heads


# The GEMM's launch plan, mirrored from csrc/gemm_sm90.cuh (irt_gemm_plan
# answers the same; tests/test_torch_gpu.py holds them equal). Every chain's
# projections in bf16 and int8 run on it.
_GEMM_DTYPES = {torch.bfloat16: 0, torch.int8: 1}
_GEMM_TILE_N, _GEMM_ROW_BYTES, _GEMM_ALIGN = 128, 128, 1024
# the blocks an H100's 132 SMs hold at once, one an SM (irt_gemm_max_blocks
# reads the card's); a block's shared memory at most, of which the kernel's
# static barriers take at most 256 bytes; a warpgroup's 64 x 128 bf16 output
# slab; 64-row warpgroups of the tallest tile
GEMM_BLOCKS = 132
_GEMM_SMEM_LIMIT, _GEMM_STATIC, _GEMM_GROUP_OUT, _GEMM_MAX_GROUPS = 232448, 256, 64 * 128 * 2, 3
# the column parameters a tile stages (bf16: the bias; int8: the column
# scales too)
_GEMM_COL_PARAMS = {torch.bfloat16: 1, torch.int8: 2}


@dataclasses.dataclass(frozen=True)
class GemmPlan:
    rows: int                # output rows of a tile: 64 G (G = 1-3), one consumer
                             # warpgroup per 64
    stages: int              # depth of the shared-memory ring of TMA loads
    smem_bytes: int          # dynamic shared memory of one block
    grid: Tuple[int, int]    # (blocks, 1), persistent over the tiles
    threads: int             # 128 per consumer warpgroup and one producer warp
    refused: str | None      # why the kernel does not take the shape
    tiles: Tuple[int, int] = (0, 0)  # (column tiles of 128, row tiles)
    waves: int = 0           # tiles per launched block, rounded up


def gemm_block(groups: int, params: int) -> Tuple[int, int, int]:
    """(stages, shared memory bytes, threads) of a GEMM block for tiles of
    64 `groups` rows: a consumer warpgroup per 64 rows and a producer warp;
    each warpgroup's 64 x 128 bf16 output slab and `params` staged column
    parameters (128 f32 each), and as many stages of (64 groups + 128) rows
    of 128 bytes as fit beside them within 227 KB less the static barriers,
    at most 8."""
    stage = (64 * groups + _GEMM_TILE_N) * _GEMM_ROW_BYTES
    fixed = groups * (_GEMM_GROUP_OUT + params * _GEMM_TILE_N * 4) + _GEMM_ALIGN
    stages = min(8, (_GEMM_SMEM_LIMIT - _GEMM_STATIC - fixed) // stage)
    return stages, stages * stage + fixed, 128 * groups + 32


def _gemm_refusal(m: int, n: int, k: int) -> str | None:
    if m < 1:
        return f"M = {m}: the GEMM needs at least one row"
    if n < 64 or k < 64 or n % 64 or k % 64:
        return f"N = {n} and K = {k} must be positive multiples of 64"
    return None


@functools.lru_cache(maxsize=1024)
def gemm_plan(m: int, n: int, k: int, dtype: torch.dtype, blocks: int = GEMM_BLOCKS
              ) -> GemmPlan:
    """How the GEMM runs C (m, n) = A (m, k) Bt (n, k)^T with operands of
    `dtype` (bf16 or int8) on a card that holds `blocks` of its blocks at
    once: tiles of 128 columns and 64 G rows (G consumer warpgroups, 1-3),
    min(blocks, tiles) blocks walking the tiles persistently, a row band's
    column tiles together. G minimises waves x (G + 2), the waves of tiles
    times the L2 bytes of a block's K step ((G + 2) x 8 KB), ties to the
    taller tile."""
    if dtype not in _GEMM_DTYPES:
        raise TypeError(f"the GEMM takes bfloat16 or int8 operands, got {dtype}")
    refused = _gemm_refusal(m, n, k)
    if refused is None and blocks < 1:
        refused = f"{blocks} blocks: the card must hold at least one"
    if refused is not None:
        return GemmPlan(0, 0, 0, (0, 0), 0, refused)
    cols = -(-n // _GEMM_TILE_N)
    groups = min(range(_GEMM_MAX_GROUPS, 0, -1),
                 key=lambda g: -(-(-(-m // (64 * g)) * cols) // blocks) * (g + 2))
    bands = -(-m // (64 * groups))
    if bands > 65535:
        return GemmPlan(0, 0, 0, (0, 0), 0,
                        f"M = {m} needs more than 65535 row tiles of {64 * groups}")
    stages, smem, threads = gemm_block(groups, _GEMM_COL_PARAMS[dtype])
    tiles = bands * cols
    return GemmPlan(64 * groups, stages, smem, (min(tiles, blocks), 1), threads, None,
                    (cols, bands), -(-tiles // blocks))


# The launch plan of fc1 -> quick_gelu -> rowquant as one clustered GEMM,
# mirrored from csrc/gemm_sm90.cuh (irt_rowquant_gemm_plan answers the same;
# tests/test_torch_gpu.py holds them equal). The int8 MLP halves (K1, K2b)
# and gemm_s8(..., "gelu_rowquant") follow it.
ROWQUANT_GEMM_ROUTES = ("fused", "two launches")
_RQ_ROWS, _RQ_COLS, _RQ_STAGES, _RQ_MAX_CLUSTER = 64, 512, 3, 8


@dataclasses.dataclass(frozen=True)
class RowquantGemmPlan:
    route: str               # "fused": one clustered launch; "two launches": the
                             # GEMM writing f32 rows, then a rowquant launch
    why: str                 # why the shape takes that route
    cluster: int             # blocks of a cluster, N / 512 (0 on the two-launch route)
    rows: int                # rows of a block (64)
    cols: int                # columns of a block (512: four warpgroups of 128)
    stages: int              # depth of the shared-memory ring of TMA loads
    smem_bytes: int          # dynamic shared memory of one block
    grid: Tuple[int, int]    # (cluster, row tiles)
    threads: int             # four consumer warpgroups and one producer warp
    refused: str | None      # why the int8 GEMM does not take the shape


@functools.lru_cache(maxsize=1024)
def rowquant_gemm_plan(m: int, n: int, k: int) -> RowquantGemmPlan:
    """How the int8 MLP computes rowquant(quick_gelu(fc1)) for m rows of k
    values into n hidden columns. The absmax of a row spans all n columns,
    so the blocks of 64 rows x 512 columns that share a row tile form a
    thread block cluster of n / 512 blocks, which exchange their rows' |max|
    in distributed shared memory: one launch, no f32 row in device memory.
    Where no portable cluster (at most 8 blocks) covers a row, or the rows
    need more than 65535 row tiles, the plan takes two launches: the GEMM
    writing f32, then the rowquant pass. Both give the same bits."""
    refused = gemm_plan(m, n, k, torch.int8).refused
    if refused is not None:
        return RowquantGemmPlan("", "", 0, 0, 0, 0, 0, (0, 0), 0, refused)
    two = functools.partial(RowquantGemmPlan, "two launches", cluster=0, rows=0, cols=0,
                            stages=0, smem_bytes=0, grid=(0, 0), threads=0, refused=None)
    if n % _RQ_COLS:
        return two(f"N = {n} is not a multiple of the {_RQ_COLS} columns of a block")
    if n // _RQ_COLS > _RQ_MAX_CLUSTER:
        return two(f"N = {n} needs a cluster of {n // _RQ_COLS} blocks, more than the "
                   f"{_RQ_MAX_CLUSTER} of a portable cluster")
    row_tiles = -(-m // _RQ_ROWS)
    if row_tiles > 65535:
        return two(f"M = {m} needs more than 65535 row tiles of {_RQ_ROWS}")
    cluster = n // _RQ_COLS
    return RowquantGemmPlan(
        "fused", f"a cluster of {cluster} blocks of {_RQ_ROWS} x {_RQ_COLS} covers the {n} "
        f"columns of a row tile", cluster, _RQ_ROWS, _RQ_COLS, _RQ_STAGES,
        _RQ_STAGES * (_RQ_ROWS + _RQ_COLS) * _GEMM_ROW_BYTES + _GEMM_ALIGN,
        (cluster, row_tiles), 128 * (_RQ_COLS // _GEMM_TILE_N) + 32, None)


# The chains' workspaces, mirrored from csrc/int8_common.cuh (carve_attn,
# carve_mlp: 256-byte aligned pieces). The MLP half holds the f32 hidden
# rows only on the two-launch route of rowquant_gemm_plan.
def _align256(n: int) -> int:
    return -(-n // 256) * 256


def attention_block_int8_workspace_bytes(m: int, w: int, elem_bytes: int) -> int:
    mw = m * w
    return (2 * _align256(mw) + 2 * _align256(4 * m) + _align256(3 * mw * elem_bytes)
            + _align256(mw * elem_bytes))


def mlp_block_int8_workspace_bytes(m: int, w: int, hidden: int) -> int:
    f32_rows = 0 if rowquant_gemm_plan(m, hidden, w).route == "fused" else 4 * m * hidden
    return (_align256(m * w) + 2 * _align256(4 * m) + _align256(m * hidden)
            + _align256(f32_rows))


def layer_block_int8_workspace_bytes(m: int, w: int, hidden: int, elem_bytes: int) -> int:
    return (attention_block_int8_workspace_bytes(m, w, elem_bytes)
            + _align256(m * w * elem_bytes) + mlp_block_int8_workspace_bytes(m, w, hidden))


def _run(fn, lib, device, call):
    """`call(stream)` on PyTorch's current stream of `device`; raises on a
    refused launch, counts an accepted one."""
    with torch.cuda.device(device):
        rc = call(torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} kernel failed: "
                           + lib.irt_error_string(rc).decode())
    fn.launches += 1


def _workspace(nbytes: int, device) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _layer_block_int8_cuda(x, weights, heads, causal):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "layer_block_int8"
    _check_x(fn, x)
    b, t, w = x.shape
    _check_attn_weights(fn, weights.attn, w, x.device)
    hidden = _check_mlp_weights(fn, weights.mlp, w, x.device)
    _check_gemm_dims(fn, w, hidden)
    lib = load_library()
    hd = _check_attention_shape(fn, t, w, heads, x.dtype)
    out = torch.empty_like(x)
    ws = _workspace(layer_block_int8_workspace_bytes(b * t, w, hidden, x.element_size()),
                    x.device)
    _run(layer_block_int8, lib, x.device, lambda stream: lib.irt_layer_block_int8(
        x.data_ptr(), out.data_ptr(), *(a.data_ptr() for a in weights.tensors()),
        ws.data_ptr(), b, t, w, hidden, heads, int(bool(causal)),
        _DTYPE_CODES[x.dtype], ctypes.c_float(hd ** -0.5), stream))
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


def _attention_block_int8_cuda(x, weights, heads, causal):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "attention_block_int8"
    _check_x(fn, x)
    b, t, w = x.shape
    _check_attn_weights(fn, weights, w, x.device)
    _check_gemm_dims(fn, w)
    lib = load_library()
    hd = _check_attention_shape(fn, t, w, heads, x.dtype)
    out = torch.empty_like(x)
    ws = _workspace(attention_block_int8_workspace_bytes(b * t, w, x.element_size()),
                    x.device)
    _run(attention_block_int8, lib, x.device, lambda stream: lib.irt_attention_block_int8(
        x.data_ptr(), out.data_ptr(), *(a.data_ptr() for a in weights.tensors()),
        ws.data_ptr(), b, t, w, heads, int(bool(causal)), _DTYPE_CODES[x.dtype],
        ctypes.c_float(hd ** -0.5), stream))
    return out


def attention_block_int8(x: torch.Tensor, weights: Int8AttnWeights, heads: int,
                         causal: bool = False) -> torch.Tensor:
    """The int8 attention sub-block, x + out_proj(MHA(LN1(x))), on (B, T, W)
    x in its compute dtype. CUDA: the Hopper kernel chain (or this raises);
    CPU: the plain version. ``attention_block_int8.launches`` counts kernel
    launches."""
    if x.device.type == "cuda":
        return _attention_block_int8_cuda(x, weights, heads, causal)
    if x.device.type == "cpu":
        return attention_block_int8_reference(x, weights, heads, causal)
    raise ValueError(f"attention_block_int8: unsupported device {x.device}")


attention_block_int8.launches = 0


def _mlp_block_int8_cuda(x, weights):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "mlp_block_int8"
    _check_x(fn, x)
    b, t, w = x.shape
    hidden = _check_mlp_weights(fn, weights, w, x.device)
    _check_gemm_dims(fn, w, hidden)
    lib = load_library()
    out = torch.empty_like(x)
    ws = _workspace(mlp_block_int8_workspace_bytes(b * t, w, hidden), x.device)
    _run(mlp_block_int8, lib, x.device, lambda stream: lib.irt_mlp_block_int8(
        x.data_ptr(), out.data_ptr(), *(a.data_ptr() for a in weights.tensors()),
        ws.data_ptr(), b * t, w, hidden, _DTYPE_CODES[x.dtype], stream))
    return out


def mlp_block_int8(x: torch.Tensor, weights: Int8MlpWeights) -> torch.Tensor:
    """The int8 MLP sub-block, x + fc2(quick_gelu(fc1(LN2(x)))), on (B, T, W)
    x in its compute dtype. CUDA: the Hopper kernel chain (or this raises);
    CPU: the plain version. ``mlp_block_int8.launches`` counts kernel
    launches."""
    if x.device.type == "cuda":
        return _mlp_block_int8_cuda(x, weights)
    if x.device.type == "cpu":
        return mlp_block_int8_reference(x, weights)
    raise ValueError(f"mlp_block_int8: unsupported device {x.device}")


mlp_block_int8.launches = 0


def ln_rowquant_reference(x: torch.Tensor, ln_s: torch.Tensor | None = None,
                          ln_b: torch.Tensor | None = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the row pass, on x's device: rowquant of
    fast_layernorm_f32(x) (or of x in f32), with (m,) row scales."""
    require_full_f32(x.device)
    xf = x.float()
    q, s = rowquant(xf if ln_s is None else fast_layernorm_f32(xf, ln_s, ln_b))
    return q, s.reshape(-1)


def _ln_rowquant_cuda(x, ln_s, ln_b):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "ln_rowquant"
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn} kernel takes bfloat16 or float32, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{fn} kernel takes a contiguous, 16-byte aligned (m, width) x")
    m, width = x.shape
    _check_gemm_dims(fn, width)
    if ln_s is not None:
        for name, v in (("ln_s", ln_s), ("ln_b", ln_b)):
            _check_tensor(fn, name, v, (width,), torch.float32, x.device)
    lib = load_library()
    q = torch.empty((m, width), dtype=torch.int8, device=x.device)
    qs = torch.empty((m,), dtype=torch.float32, device=x.device)
    _run(ln_rowquant, lib, x.device, lambda stream: lib.irt_ln_rowquant(
        x.data_ptr(), None if ln_s is None else ln_s.data_ptr(),
        None if ln_b is None else ln_b.data_ptr(), q.data_ptr(), qs.data_ptr(), m, width,
        _DTYPE_CODES[x.dtype], int(ln_s is not None), stream))
    return q, qs


def ln_rowquant(x: torch.Tensor, ln_s: torch.Tensor | None = None,
                ln_b: torch.Tensor | None = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 chains' row pass alone, for tests and timing: (m, width) x in
    bf16 or f32 -> rowquant(fast_layernorm_f32(x)) with ln_s and ln_b, else
    rowquant(x): (int8 (m, width), f32 (m,) row scales). CUDA: the warp-per-row
    kernel of csrc/int8_common.cuh (or this raises); CPU: the plain version.
    ``ln_rowquant.launches`` counts kernel launches."""
    if (ln_s is None) != (ln_b is None):
        raise ValueError("ln_rowquant: give both LayerNorm parameters or neither")
    if x.device.type == "cuda":
        return _ln_rowquant_cuda(x, ln_s, ln_b)
    if x.device.type == "cpu":
        return ln_rowquant_reference(x, ln_s, ln_b)
    raise ValueError(f"ln_rowquant: unsupported device {x.device}")


ln_rowquant.launches = 0


def ln_cast_reference(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the compute-type chains' LayerNorm pass:
    fast_layernorm_f32 of x (m, width) in f32, cast to x's dtype."""
    require_full_f32(x.device)
    return fast_layernorm_f32(x.float(), ln_s, ln_b).to(x.dtype)


def _ln_cast_cuda(x, ln_s, ln_b):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "ln_cast"
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn} kernel takes bfloat16 or float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"{fn} kernel takes an (m, width) x, got {tuple(x.shape)}")
    m, width = x.shape
    _check_tensor(fn, "x", x, (m, width), x.dtype, x.device)
    _check_gemm_dims(fn, width)
    if width > _MAX_LN_WIDTH:
        raise ValueError(f"{fn}: width {width} is wider than the chains' {_MAX_LN_WIDTH}")
    for name, v in (("ln_s", ln_s), ("ln_b", ln_b)):
        _check_tensor(fn, name, v, (width,), torch.float32, x.device)
    lib = load_library()
    h = torch.empty_like(x)
    _run(ln_cast, lib, x.device, lambda stream: lib.irt_ln_cast(
        x.data_ptr(), ln_s.data_ptr(), ln_b.data_ptr(), h.data_ptr(), m, width,
        _DTYPE_CODES[x.dtype], stream))
    return h


def ln_cast(x: torch.Tensor, ln_s: torch.Tensor, ln_b: torch.Tensor) -> torch.Tensor:
    """The compute-type chains' LayerNorm pass alone, for tests and timing:
    (m, width) x in bf16 or f32 -> fast_layernorm_f32(x) cast to x's dtype.
    CUDA: the warp-per-row kernel of csrc/dense_common.cuh (or this raises);
    CPU: the plain version. ``ln_cast.launches`` counts kernel launches."""
    if x.device.type == "cuda":
        return _ln_cast_cuda(x, ln_s, ln_b)
    if x.device.type == "cpu":
        return ln_cast_reference(x, ln_s, ln_b)
    raise ValueError(f"ln_cast: unsupported device {x.device}")


ln_cast.launches = 0


def _quant_dense_cuda(x, w_t, w_s, bias, out_dtype):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "quant_dense"
    if x.dtype not in _DTYPE_CODES or out_dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn} kernel takes bfloat16 or float32, got {x.dtype} "
                        f"-> {out_dtype}")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"{fn} kernel takes a contiguous (..., K) x")
    if x.data_ptr() % 16:
        raise ValueError(f"{fn}: x is not 16-byte aligned")
    k, n = x.shape[-1], w_t.shape[0]
    m = x.numel() // k
    _check_tensor(fn, "w_t", w_t, (n, k), torch.int8, x.device)
    _check_tensor(fn, "w_s", w_s, (n,), torch.float32, x.device)
    _check_tensor(fn, "bias", bias, (n,), torch.float32, x.device)
    _check_gemm_dims(fn, k, n)
    lib = load_library()
    out = torch.empty((*x.shape[:-1], n), dtype=out_dtype, device=x.device)
    ws = _workspace(lib.irt_quant_dense_workspace_bytes(m, k), x.device)
    _run(quant_dense, lib, x.device, lambda stream: lib.irt_quant_dense(
        x.data_ptr(), out.data_ptr(), w_t.data_ptr(), w_s.data_ptr(), bias.data_ptr(),
        ws.data_ptr(), m, k, n, _DTYPE_CODES[x.dtype], _DTYPE_CODES[out_dtype], stream))
    return out


def quant_dense(x: torch.Tensor, w_t: torch.Tensor, w_s: torch.Tensor,
                bias: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """QuantDense: (..., K) x (f32 or bf16) through an int8 x int8 -> int32
    projection with per-row activation scales, to (..., N) in `out_dtype`.
    CUDA: rowquant + int8 GEMM kernels (or this raises); CPU: the plain
    version. ``quant_dense.launches`` counts kernel launches."""
    if x.device.type == "cuda":
        return _quant_dense_cuda(x, w_t, w_s, bias, out_dtype)
    if x.device.type == "cpu":
        return quant_dense_reference(x, w_t, w_s, bias, out_dtype)
    raise ValueError(f"quant_dense: unsupported device {x.device}")


quant_dense.launches = 0


def _attention_cuda(qkv, batch, heads, causal):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "tiled_attention"
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn} kernel takes bfloat16 or float32, got {qkv.dtype}")
    if qkv.dim() != 2 or not qkv.is_contiguous() or qkv.shape[1] % 3 or qkv.shape[0] % batch:
        raise ValueError(f"{fn} kernel takes a contiguous (B * T, 3 W) [q | k | v]")
    if qkv.data_ptr() % 16:
        raise ValueError(f"{fn}: qkv is not 16-byte aligned")
    t, w = qkv.shape[0] // batch, qkv.shape[1] // 3
    lib = load_library()
    hd = _check_attention_shape(fn, t, w, heads, qkv.dtype)
    out = torch.empty((qkv.shape[0], w), dtype=qkv.dtype, device=qkv.device)
    _run(tiled_attention, lib, qkv.device, lambda stream: lib.irt_attention(
        qkv.data_ptr(), out.data_ptr(), batch, t, w, heads, int(bool(causal)),
        _DTYPE_CODES[qkv.dtype], ctypes.c_float(hd ** -0.5), stream))
    return out


def tiled_attention(qkv: torch.Tensor, batch: int, heads: int,
                    causal: bool = False) -> torch.Tensor:
    """The attention step of the int8 kernels on its own: packed
    (B * T, 3 W) [q | k | v] rows in the compute dtype -> (B * T, W). CUDA:
    the tiled kernel (or this raises); CPU: the plain version."""
    if qkv.device.type == "cuda":
        return _attention_cuda(qkv, batch, heads, causal)
    if qkv.device.type == "cpu":
        return _attention_reference(qkv, batch, qkv.shape[0] // batch,
                                    qkv.shape[1] // 3, heads, causal, qkv.dtype)
    raise ValueError(f"tiled_attention: unsupported device {qkv.device}")


tiled_attention.launches = 0


# ---------------------------------------------------------------------------
# The GEMM alone (csrc/gemm_sm90.cu): for tests and timing; the chains above
# and below launch the same kernels inside their own entries
# ---------------------------------------------------------------------------

GEMM_EPILOGUES = ("bias", "gelu", "residual")
# gemm_s8 only: quick_gelu in f32, then each row requantized to int8 with its
# f32 scale (the int8 MLP's fc1 stage, rowquant_gemm_plan)
GELU_ROWQUANT = "gelu_rowquant"


def _gelu_f32(v: torch.Tensor) -> torch.Tensor:
    """quick_gelu in the kernels' own f32 operations: v * (1 / (1 + exp(-(1.702 v))))."""
    return v * torch.reciprocal(1.0 + torch.exp(-(1.702 * v)))


def gemm_bf16_reference(a: torch.Tensor, bt: torch.Tensor, bias: torch.Tensor,
                        epilogue: str = "bias", residual: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """Plain PyTorch version of the bf16 GEMM: the f32 sum of a (m, k) bf16
    times bt (n, k) bf16 plus bias (n,) f32, then the cast ("bias"),
    quick_gelu in f32 and the cast ("gelu"), or the cast and residual + it in
    bf16 ("residual"): the projections of mlp_block_reference."""
    require_full_f32(a.device)
    v = _dense_proj(a, bt, bias)
    if epilogue == "gelu":
        return quick_gelu(v).to(a.dtype)
    if epilogue == "residual":
        return residual + v.to(a.dtype)
    return v.to(a.dtype)


def gemm_s8_reference(a: torch.Tensor, bt: torch.Tensor, row_scale: torch.Tensor,
                      col_scale: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype,
                      epilogue: str = "bias", residual: torch.Tensor | None = None
                      ) -> torch.Tensor:
    """Plain PyTorch version of the int8 GEMM: the exact int32 sum of a (m, k)
    int8 times bt (n, k) int8, times row_scale (m,) and col_scale (n,), plus
    bias (n,), in f32 (_int8_proj's order), then the cast ("bias"), quick_gelu
    in f32 and the cast ("gelu"), or the cast and residual + it in out_dtype
    ("residual"). The same correctly rounded f32 operations as the kernel's
    epilogue, in its order. "gelu_rowquant" (out_dtype int8) is "gelu" in f32
    followed by rowquant: (int8 (m, n), f32 (m,) row scales)."""
    if epilogue == GELU_ROWQUANT:
        gq, gs = rowquant(gemm_s8_reference(a, bt, row_scale, col_scale, bias, torch.float32,
                                            "gelu"))
        return gq, gs.reshape(-1)
    acc = a.to(torch.float64) @ bt.to(torch.float64).t()
    v = acc.to(torch.float32) * row_scale.reshape(-1, 1) * col_scale + bias
    if epilogue == "gelu":
        return _gelu_f32(v).to(out_dtype)
    if epilogue == "residual":
        return residual + v.to(out_dtype)
    return v.to(out_dtype)


def gemm_bf16_agreement(got: torch.Tensor, a: torch.Tensor, bt: torch.Tensor,
                        bias: torch.Tensor, epilogue: str = "bias",
                        residual: torch.Tensor | None = None) -> dict:
    """Hold the bf16 GEMM's output `got` against the float64 value of its
    function on the same operands (the int8 GEMM is held bit for bit instead:
    its sums are exact). The limit per output is an error bound: the f32 sum
    v' of K products and the bias errs by e <= (K S + |v|) u32 (S = sum |a b|
    + |bias|, u32 = 2^-24, taken twice over); rounding to bf16 moves a value
    by at most u = 2^-8 of itself; quick_gelu's slope stays below 1.2 and its
    f32 operations (expf, the reciprocal) add under 2^-20 |v|; the residual
    add rounds the projection and then the sum. Returns the largest error,
    the largest ratio of error to limit, and `ok`."""
    u, u32 = 2.0 ** -8, 2.0 ** -23
    a64, bt64 = a.double(), bt.double()
    v = a64 @ bt64.t() + bias.double()
    e = u32 * (a.shape[1] * (a64.abs() @ bt64.abs().t() + bias.double().abs()) + v.abs())
    if epilogue == "gelu":
        want = v * torch.sigmoid(1.702 * v)
        e1 = 1.2 * e + 2.0 ** -20 * v.abs()
        limit = u * (want.abs() + e1) + e1
    elif epilogue == "residual":
        want = residual.double() + v
        e1 = u * v.abs() + (1 + u) * e
        limit = u * (want.abs() + e1) + e1 + u32 * want.abs()
    else:
        want = v
        limit = u * (v.abs() + e) + e
    err = (got.double() - want).abs()
    ratio = float((err / limit).max())
    return {"max_abs_err": float(err.max()), "max_share_of_limit": ratio,
            "ok": bool(torch.isfinite(got).all()) and ratio <= 1.0}


def _check_gemm_operands(fn: str, a, bt, dtype):
    """Shapes, dtypes and placement of one GEMM's operands; returns (m, n, k)."""
    if a.dtype != dtype or bt.dtype != dtype:
        raise TypeError(f"{fn} takes {dtype} operands, got {a.dtype} and {bt.dtype}")
    if a.dim() != 2 or bt.dim() != 2 or a.shape[1] != bt.shape[1]:
        raise ValueError(f"{fn} takes a (m, k) and bt (n, k), got {tuple(a.shape)} and "
                         f"{tuple(bt.shape)}")
    (m, k), n = a.shape, bt.shape[0]
    _check_tensor(fn, "a", a, (m, k), dtype, a.device)
    _check_tensor(fn, "bt", bt, (n, k), dtype, a.device)
    plan = gemm_plan(m, n, k, dtype)
    if plan.refused is not None:
        raise ValueError(f"{fn}: {plan.refused}")
    return m, n, k


def _check_gemm_call(fn: str, a, bt, dtype, epilogue, residual, out_dtype, out):
    """Shapes, dtypes and placement of one GEMM call; returns (m, n, k, the
    epilogue's code, out)."""
    m, n, k = _check_gemm_operands(fn, a, bt, dtype)
    if epilogue not in GEMM_EPILOGUES:
        raise ValueError(f"{fn}: epilogue {epilogue!r} is not one of {GEMM_EPILOGUES}")
    if (epilogue == "residual") != (residual is not None):
        raise ValueError(f"{fn}: a residual goes with the 'residual' epilogue and no other")
    if residual is not None:
        _check_tensor(fn, "residual", residual, (m, n), out_dtype, a.device)
    if out is None:
        out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    _check_tensor(fn, "out", out, (m, n), out_dtype, a.device)
    return m, n, k, GEMM_EPILOGUES.index(epilogue), out


def _gemm_bf16_cuda(a, bt, bias, epilogue, residual, out):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "gemm_bf16"
    m, n, k, ep, out = _check_gemm_call(fn, a, bt, torch.bfloat16, epilogue, residual,
                                        torch.bfloat16, out)
    _check_tensor(fn, "bias", bias, (n,), torch.float32, a.device)
    lib = load_library()
    _run(gemm_bf16, lib, a.device, lambda stream: lib.irt_gemm_bf16(
        a.data_ptr(), bt.data_ptr(), bias.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(), m, n, k, ep,
        stream))
    return out


def gemm_bf16(a: torch.Tensor, bt: torch.Tensor, bias: torch.Tensor, epilogue: str = "bias",
              residual: torch.Tensor | None = None, out: torch.Tensor | None = None
              ) -> torch.Tensor:
    """The bf16 GEMM of the compute-dtype chains alone: a (m, k) bf16, bt
    (n, k) bf16, bias (n,) f32 -> (m, n) bf16 by `epilogue`
    (gemm_bf16_reference), into `out` if given. CUDA: the wgmma kernel (or
    this raises); CPU: the plain version. ``gemm_bf16.launches`` counts
    kernel launches."""
    if a.device.type == "cuda":
        return _gemm_bf16_cuda(a, bt, bias, epilogue, residual, out)
    if a.device.type == "cpu":
        return gemm_bf16_reference(a, bt, bias, epilogue, residual)
    raise ValueError(f"gemm_bf16: unsupported device {a.device}")


gemm_bf16.launches = 0


def _gemm_s8_rowquant_cuda(a, bt, row_scale, col_scale, bias, residual, out):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "gemm_s8"
    if residual is not None or out is not None:
        raise ValueError(f"{fn}: the {GELU_ROWQUANT!r} epilogue returns its int8 rows and "
                         f"their scales, and takes no residual and no out")
    m, n, k = _check_gemm_operands(fn, a, bt, torch.int8)
    _check_tensor(fn, "row_scale", row_scale, (m,), torch.float32, a.device)
    for name, v in (("col_scale", col_scale), ("bias", bias)):
        _check_tensor(fn, name, v, (n,), torch.float32, a.device)
    lib = load_library()
    # the f32 rows pass through device memory on the two-launch route only
    ws = None if rowquant_gemm_plan(m, n, k).route == "fused" else _workspace(4 * m * n,
                                                                              a.device)
    gq = torch.empty((m, n), dtype=torch.int8, device=a.device)
    gs = torch.empty((m,), dtype=torch.float32, device=a.device)
    _run(gemm_s8, lib, a.device, lambda stream: lib.irt_gemm_s8_gelu_rowquant(
        a.data_ptr(), bt.data_ptr(), row_scale.data_ptr(), col_scale.data_ptr(),
        bias.data_ptr(), None if ws is None else ws.data_ptr(), gq.data_ptr(), gs.data_ptr(),
        m, n, k, stream))
    return gq, gs


def _gemm_s8_cuda(a, bt, row_scale, col_scale, bias, out_dtype, epilogue, residual, out):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "gemm_s8"
    if epilogue == GELU_ROWQUANT:
        return _gemm_s8_rowquant_cuda(a, bt, row_scale, col_scale, bias, residual, out)
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn} writes bfloat16 or float32, got {out_dtype}")
    m, n, k, ep, out = _check_gemm_call(fn, a, bt, torch.int8, epilogue, residual,
                                        out_dtype, out)
    _check_tensor(fn, "row_scale", row_scale, (m,), torch.float32, a.device)
    for name, v in (("col_scale", col_scale), ("bias", bias)):
        _check_tensor(fn, name, v, (n,), torch.float32, a.device)
    lib = load_library()
    _run(gemm_s8, lib, a.device, lambda stream: lib.irt_gemm_s8(
        a.data_ptr(), bt.data_ptr(), row_scale.data_ptr(), col_scale.data_ptr(),
        bias.data_ptr(), None if residual is None else residual.data_ptr(), out.data_ptr(),
        m, n, k, ep, _DTYPE_CODES[out_dtype], stream))
    return out


def gemm_s8(a: torch.Tensor, bt: torch.Tensor, row_scale: torch.Tensor,
            col_scale: torch.Tensor, bias: torch.Tensor, out_dtype: torch.dtype,
            epilogue: str = "bias", residual: torch.Tensor | None = None,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """The int8 GEMM of the int8 chains alone: a (m, k) int8, bt (n, k) int8,
    row_scale (m,), col_scale (n,), bias (n,) f32 -> (m, n) in out_dtype
    (bf16 or f32) by `epilogue` (gemm_s8_reference), into `out` if given.
    With epilogue "gelu_rowquant" and out_dtype int8: the int8 MLP's fc1
    stage, returning (int8 (m, n), f32 (m,) row scales) by the route of
    rowquant_gemm_plan. CUDA: the wgmma kernel (or this raises); CPU: the
    plain version. ``gemm_s8.launches`` counts wrapper calls that launched."""
    if epilogue == GELU_ROWQUANT and out_dtype != torch.int8:
        raise ValueError(f"gemm_s8: the {GELU_ROWQUANT!r} epilogue writes int8, not "
                         f"{out_dtype}")
    if a.device.type == "cuda":
        return _gemm_s8_cuda(a, bt, row_scale, col_scale, bias, out_dtype, epilogue,
                             residual, out)
    if a.device.type == "cpu":
        return gemm_s8_reference(a, bt, row_scale, col_scale, bias, out_dtype, epilogue,
                                 residual)
    raise ValueError(f"gemm_s8: unsupported device {a.device}")


gemm_s8.launches = 0


# ---------------------------------------------------------------------------
# The family in the compute dtype: layer_block, attention_block, mlp_block,
# multihead_attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerWeights:
    """One layer's parameters in the form of the kernels that keep their
    projections in the compute dtype. Matrices are in that dtype,
    output-major (N, K); biases and LayerNorm parameters f32."""

    ln1_s: torch.Tensor
    ln1_b: torch.Tensor
    wqkv_t: torch.Tensor  # (3W, W): [q | k | v] output channels
    bqkv: torch.Tensor
    wo_t: torch.Tensor  # (W, W)
    bo: torch.Tensor
    ln2_s: torch.Tensor
    ln2_b: torch.Tensor
    w1_t: torch.Tensor  # (4W, W)
    b1: torch.Tensor
    w2_t: torch.Tensor  # (W, 4W)
    b2: torch.Tensor

    @property
    def width(self) -> int:
        return self.wo_t.shape[0]

    @property
    def hidden(self) -> int:
        return self.w1_t.shape[0]

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]

    @property
    def attn(self) -> "AttnWeights":
        return AttnWeights(self.ln1_s, self.ln1_b, self.wqkv_t, self.bqkv, self.wo_t, self.bo)

    @property
    def mlp(self) -> "MlpWeights":
        return MlpWeights(self.ln2_s, self.ln2_b, self.w1_t, self.b1, self.w2_t, self.b2)


@dataclasses.dataclass(frozen=True)
class AttnWeights:
    """The attention half of LayerWeights (the same tensors)."""

    ln_s: torch.Tensor
    ln_b: torch.Tensor
    wqkv_t: torch.Tensor  # (3W, W): [q | k | v] output channels
    bqkv: torch.Tensor
    wo_t: torch.Tensor  # (W, W)
    bo: torch.Tensor

    @property
    def width(self) -> int:
        return self.wo_t.shape[0]

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


@dataclasses.dataclass(frozen=True)
class MlpWeights:
    """The MLP half of LayerWeights (the same tensors)."""

    ln_s: torch.Tensor
    ln_b: torch.Tensor
    w1_t: torch.Tensor  # (4W, W)
    b1: torch.Tensor
    w2_t: torch.Tensor  # (W, 4W)
    b2: torch.Tensor

    @property
    def width(self) -> int:
        return self.w2_t.shape[0]

    @property
    def hidden(self) -> int:
        return self.w1_t.shape[0]

    def tensors(self):
        return [getattr(self, f.name) for f in dataclasses.fields(self)]


def prepare_attn(ln_s, ln_b, wq, bq, wk, bk, wv, bv, wo, bo,
                 dtype: torch.dtype) -> AttnWeights:
    """The attention half's parameters (JAX (in, out) kernel layout) ->
    AttnWeights in the compute `dtype`: the casts the JAX entries make on
    every call (wq.astype(dt), flash_attention.py:389-391). Every step is
    differentiable."""
    m = lambda w: w.to(dtype).t().contiguous()
    return AttnWeights(_flat32(ln_s), _flat32(ln_b), m(torch.cat([wq, wk, wv], dim=1)),
                       torch.cat([_flat32(bq), _flat32(bk), _flat32(bv)]), m(wo),
                       _flat32(bo))


def prepare_mlp(ln_s, ln_b, w1, b1, w2, b2, dtype: torch.dtype) -> MlpWeights:
    """The MLP half's parameters -> MlpWeights in the compute `dtype`
    (flash_attention.py:497), differentiably."""
    m = lambda w: w.to(dtype).t().contiguous()
    return MlpWeights(_flat32(ln_s), _flat32(ln_b), m(w1), _flat32(b1), m(w2),
                      _flat32(b2))


def prepare_layer(ln1_s, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, ln2_s, ln2_b,
                  w1, b1, w2, b2, dtype: torch.dtype) -> LayerWeights:
    """Layer parameters (JAX (in, out) kernel layout) -> LayerWeights in the
    compute `dtype`: the casts the JAX entries make on every call
    (flash_attention.py:995-998), made once. Every step is differentiable,
    so gradients taken through the four wrappers reach the parameters given
    here."""
    attn = prepare_attn(ln1_s, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, dtype)
    mlp = prepare_mlp(ln2_s, ln2_b, w1, b1, w2, b2, dtype)
    return LayerWeights(*attn.tensors(), *mlp.tensors())


def _dense_proj(h: torch.Tensor, w_t: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.dot(h, w, preferred_element_type=f32) + b on operands already in
    the compute type: exact products summed in f32, the bias added in f32."""
    return h.float() @ w_t.float().t() + b


def _check_compute_dtype(fn: str, x: torch.Tensor, *mats: torch.Tensor) -> None:
    for m in mats:
        if m.dtype != x.dtype:
            raise ValueError(f"{fn}: weights are {m.dtype} but x is {x.dtype}; "
                             "prepare_layer casts them to the compute dtype")


def attention_block_reference(x: torch.Tensor, weights: AttnWeights, heads: int,
                              causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the attention sub-block, on x's device. Every
    product is a full f32 product of values in the compute dtype, so on a
    CUDA tensor it raises if the caller has turned TF32 on."""
    require_full_f32(x.device)
    wt = weights
    _check_compute_dtype("attention_block", x, wt.wqkv_t, wt.wo_t)
    b, t, w = x.shape
    dt = x.dtype
    xb = x.reshape(b * t, w)
    h = fast_layernorm_f32(xb.float(), wt.ln_s, wt.ln_b).to(dt)
    qkv = _dense_proj(h, wt.wqkv_t, wt.bqkv).to(dt)  # three casts of f32 sums with their bias
    attn = _attention_reference(qkv, b, t, w, heads, causal, dt)
    # the projection is cast to the compute type BEFORE the residual add
    return (xb + _dense_proj(attn, wt.wo_t, wt.bo).to(dt)).reshape(b, t, w)


def attention_block_saved_reference(x: torch.Tensor, weights: AttnWeights, heads: int,
                                    causal: bool = False):
    """Plain PyTorch version of the training forward (_attn_block_saved_kernel,
    flash_attention.py:1051): attention_block_reference's output, operation
    for operation, and what its backward needs: (o, q, k, v, a, probs) with
    q, k, v, a (B, T, W) in the compute dtype (q, k, v are views of one
    packed (B, T, 3 W) tensor) and probs (B, H, T, T) in f32 before the cast
    that the PV product takes; under `causal` exact zeros above the
    diagonal."""
    require_full_f32(x.device)
    wt = weights
    _check_compute_dtype("attention_block_train", x, wt.wqkv_t, wt.wo_t)
    b, t, w = x.shape
    dt = x.dtype
    xb = x.reshape(b * t, w)
    h = fast_layernorm_f32(xb.float(), wt.ln_s, wt.ln_b).to(dt)
    qkv = _dense_proj(h, wt.wqkv_t, wt.bqkv).to(dt)
    q, k, v = qkv.reshape(b, t, 3, w).unbind(2)
    attn, probs = _attention_with_probs(q, k, v, heads, causal)
    o = (xb + _dense_proj(attn.reshape(b * t, w), wt.wo_t, wt.bo).to(dt)).reshape(b, t, w)
    return o, q, k, v, attn, probs


def _ln_bwd_f32(dh: torch.Tensor, x32: torch.Tensor, ln_scale: torch.Tensor,
                eps: float = 1e-5):
    """Backward of fast_layernorm_f32 to its input and (scale, bias), the
    JAX package's _ln_bwd_f32 (flash_attention.py:1148) line by line."""
    mu = x32.mean(-1, keepdim=True)
    ms = (x32 * x32).mean(-1, keepdim=True)
    var = torch.clamp(ms - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + eps)
    xhat = (x32 - mu) * rstd
    dxhat = dh * ln_scale.float()
    dx = rstd * (dxhat - dxhat.mean(-1, keepdim=True)
                 - xhat * (dxhat * xhat).mean(-1, keepdim=True))
    lead = tuple(range(dh.dim() - 1))
    return dx, (dh * xhat).sum(lead), dh.sum(lead)


def attention_block_saved_backward(g: torch.Tensor, x: torch.Tensor, weights: AttnWeights,
                                   q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                   attn: torch.Tensor, probs: torch.Tensor, heads: int):
    """The hand-written backward of the attention sub-block over what
    attention_block_saved kept: _attn_block_saved_bwd (flash_attention.py:1165)
    in tensor operations, every product in f32, nothing of the forward
    recomputed but the LayerNorm. `g` is the gradient of the output.
    Returns the gradients of (x, ln_s, ln_b, wqkv_t, bqkv, wo_t, bo) in the
    dtypes of those tensors. The weights here are the ones the forward
    multiplied by (already in the compute dtype), where the JAX function
    reads its f32 parameters: in f32 the two are the same numbers."""
    require_full_f32(x.device)
    wt = weights
    b, t, w = x.shape
    hd = w // heads
    scale = hd ** -0.5
    dt = x.dtype
    g32 = g.float()
    x32 = x.float()

    # out projection + residual: out = attn @ wo + bo ; y = x + out
    g2 = g32.reshape(b * t, w)
    attn2 = attn.float().reshape(b * t, w)
    dwo_t = g2.t() @ attn2
    dbo = g2.sum(0)
    dattn = (g2 @ wt.wo_t.float()).reshape(b, t, heads, hd)

    # attention: per-head softmax(q k^T scale) @ v over the saved f32 probs
    qh, kh, vh = (a.float().reshape(b, t, heads, hd) for a in (q, k, v))
    # the forward mixed with the probabilities cast to the compute dtype, so
    # dv takes the cast values; the softmax itself ran in f32
    probs_mix = probs.to(dt).float()
    dv_h = torch.einsum("bhqk,bqhd->bkhd", probs_mix, dattn)
    dp = torch.einsum("bqhd,bkhd->bhqk", dattn, vh)
    ds = probs * (dp - (dp * probs).sum(-1, keepdim=True))
    dq_h = torch.einsum("bhqk,bkhd->bqhd", ds, kh) * scale
    dk_h = torch.einsum("bhqk,bqhd->bkhd", ds, qh) * scale

    # projections: [q | k | v] = h @ wqkv + bqkv, h = LN(x) cast to dt
    h2 = fast_layernorm_f32(x32, wt.ln_s.float(), wt.ln_b.float()).to(dt).float()
    h2 = h2.reshape(b * t, w)
    dqkv2 = torch.cat([a.reshape(b * t, w) for a in (dq_h, dk_h, dv_h)], dim=1)
    dwqkv_t = dqkv2.t() @ h2
    dbqkv = dqkv2.sum(0)
    dh = (dqkv2 @ wt.wqkv_t.float()).reshape(b, t, w)

    dx_ln, dls, dlb = _ln_bwd_f32(dh, x32, wt.ln_s)
    dx = (g32 + dx_ln).to(dt)
    cast = lambda grad, prim: grad.to(prim.dtype)
    return (dx, cast(dls, wt.ln_s), cast(dlb, wt.ln_b), cast(dwqkv_t, wt.wqkv_t),
            cast(dbqkv, wt.bqkv), cast(dwo_t, wt.wo_t), cast(dbo, wt.bo))


def mlp_block_reference(x: torch.Tensor, weights: MlpWeights) -> torch.Tensor:
    """Plain PyTorch version of the MLP sub-block, on x's device (full f32
    products, as attention_block_reference)."""
    require_full_f32(x.device)
    wt = weights
    _check_compute_dtype("mlp_block", x, wt.w1_t, wt.w2_t)
    b, t, w = x.shape
    dt = x.dtype
    xb = x.reshape(b * t, w)
    h = fast_layernorm_f32(xb.float(), wt.ln_s, wt.ln_b).to(dt)
    # fc1 stays f32 through quick_gelu and is cast only after it
    a = quick_gelu(_dense_proj(h, wt.w1_t, wt.b1)).to(dt)
    return (xb + _dense_proj(a, wt.w2_t, wt.b2).to(dt)).reshape(b, t, w)


def layer_block_reference(x: torch.Tensor, weights: LayerWeights, heads: int,
                          causal: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the whole layer: the two halves, with the
    mid-layer activation in the compute dtype as in the kernel."""
    x1 = attention_block_reference(x, weights.attn, heads, causal)
    return mlp_block_reference(x1, weights.mlp)


# Kernel and plain version make the same casts in the same places and differ
# only by the order of their f32 sums (LayerNorm moments, the K loops of the
# products, QK^T, PV, the softmax's sum) and by expf / rsqrt against
# PyTorch's. In f32 that is rounding noise on the layer's update (out - x).
# In bf16 a sum that lands on the other side of a bf16 rounding boundary
# moves one value to its neighbour, which perturbs everything computed from
# it, so the share of outputs that differ (each by one bf16 step) grows with
# the number of casts chained in front of the output: two in the MLP half,
# four in the attention half, seven in the whole layer. Readings on an
# NVIDIA H100 80GB HBM3 (700 W; `chip_smoke.py --dense-readings`: 144 cases:
# 3 seeds, both ViT-B/32 tower shapes, the ViT-L/14 vision shape and a ragged
# one, weights at CLIP-like and 3x larger scales, bf16 and f32): f32 max abs
# error <= 4.2e-6 x max|out - x|; bf16 max abs error 1 bf16 step of
# max|out|, differing outputs <= 1.0 % (MLP), 3.1 % (attention), 27.9 %
# (layer), per-token cosine of the update >= 0.99982. The limits sit 1.6-5x
# beyond. Wrong layers computed on the same card: a dropped bias add (|b| ~
# 0.02) moves 67-97 % of the bf16 outputs and errs by 200-1000x the f32
# limit; fc1 cast to bf16 before quick_gelu moves 18-42 % of the MLP half's
# outputs. That last mistake is caught at the MLP half (6x its limit) but
# not at the whole layer, whose own roundings move as many: the layer kernel
# is therefore also held bit for bit against the two half kernels in turn,
# which run the same device code.
DENSE_F32_MAX_ABS_REL = 2e-5  # x max|want - x|
DENSE_BF16_ULPS = 2  # bf16 steps at max|want|
DENSE_BF16_DIFF_SHARE = {"mlp": 0.03, "attn": 0.08, "layer": 0.45}
DENSE_MIN_UPDATE_COS = 0.9995


def dense_agreement(got: torch.Tensor, want: torch.Tensor, x: torch.Tensor,
                    kind: str) -> dict:
    """Hold a compute-dtype kernel's output `got` against the plain
    version's `want` on the same input `x` (B, T, W); `kind` says which part
    of a layer they compute ("layer", "attn" or "mlp"). Returns the
    readings, the max-abs limit for x's dtype, and `ok`."""
    got, want, xf = got.double(), want.double(), x.double()
    err = (got - want).abs()
    du = (got - xf).reshape(-1, x.shape[-1])
    dw = (want - xf).reshape(-1, x.shape[-1])
    bf16 = x.dtype == torch.bfloat16
    if bf16:
        top = max(float(want.abs().max()), 1e-30)
        limit = DENSE_BF16_ULPS * 2.0 ** (math.floor(math.log2(top)) - 7)
    else:
        limit = DENSE_F32_MAX_ABS_REL * float(dw.abs().max())
    cos = (du * dw).sum(-1) / (du.norm(dim=-1) * dw.norm(dim=-1)).clamp_min(1e-300)
    r = {"max_abs_err": float(err.max()), "max_abs_limit": limit,
         "diff_share": float((err > 0).double().mean()),
         "min_update_cos": float(cos.min())}
    r["ok"] = (bool(torch.isfinite(got).all()) and r["max_abs_err"] <= limit
               and (not bf16 or r["diff_share"] <= DENSE_BF16_DIFF_SHARE[kind])
               and r["min_update_cos"] >= DENSE_MIN_UPDATE_COS)
    return r


class _KernelFunction(torch.autograd.Function):
    """A kernel forward with the plain version's backward: `launch(*tensors)`
    runs the kernel; the backward differentiates `plain(*tensors)` on the
    saved inputs (the JAX entries' custom VJPs recompute through their XLA
    mirrors in the same way: there is no backward kernel)."""

    @staticmethod
    def forward(ctx, launch, plain, *tensors):
        ctx.plain = plain
        ctx.save_for_backward(*tensors)
        return launch(*tensors)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, needs)]
            out = ctx.plain(*ins)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(ins, needs) if n], grad, allow_unused=True))
        return (None, None, *(next(grads) if n else None for n in needs))


def _kernel_call(launch, plain, *tensors):
    """launch(*tensors) with the plain version's backward (_KernelFunction)
    while a gradient is being recorded; a call that records none launches
    directly and skips the autograd Function's host time."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _KernelFunction.apply(launch, plain, *tensors)
    return launch(*tensors)


def _check_dense_weights(fn: str, x: torch.Tensor, wt, shapes) -> None:
    for name, shape in shapes:
        dtype = x.dtype if name.endswith("_t") else torch.float32
        _check_tensor(fn, name, getattr(wt, name), shape, dtype, x.device)


def _attn_shapes(w: int):
    return (("ln_s", (w,)), ("ln_b", (w,)), ("wqkv_t", (3 * w, w)), ("bqkv", (3 * w,)),
            ("wo_t", (w, w)), ("bo", (w,)))


def _mlp_shapes(w: int, hidden: int):
    return (("ln_s", (w,)), ("ln_b", (w,)), ("w1_t", (hidden, w)), ("b1", (hidden,)),
            ("w2_t", (w, hidden)), ("b2", (w,)))


def _layer_block_cuda(x, weights, heads, causal):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "layer_block"
    _check_x(fn, x)
    b, t, w = x.shape
    hidden = weights.hidden
    _check_dense_weights(fn, x, weights.attn, _attn_shapes(w))
    _check_dense_weights(fn, x, weights.mlp, _mlp_shapes(w, hidden))
    _check_gemm_dims(fn, w, hidden)
    lib = load_library()
    hd = _check_attention_shape(fn, t, w, heads, x.dtype)
    out = torch.empty_like(x)
    ws = _workspace(lib.irt_layer_block_workspace_bytes(b * t, w, hidden, x.element_size()),
                    x.device)
    _run(layer_block, lib, x.device, lambda stream: lib.irt_layer_block(
        x.data_ptr(), out.data_ptr(), *(a.data_ptr() for a in weights.tensors()),
        ws.data_ptr(), b, t, w, hidden, heads, int(bool(causal)), _DTYPE_CODES[x.dtype],
        ctypes.c_float(hd ** -0.5), stream))
    return out


def layer_block(x: torch.Tensor, weights: LayerWeights, heads: int,
                causal: bool = False) -> torch.Tensor:
    """Whole transformer layer in the compute dtype on (B, T, W) x.

    A CUDA tensor goes through the Hopper kernel chain (or this raises), with
    the plain version's backward; a CPU tensor takes the plain version.
    ``layer_block.launches`` counts kernel launches."""
    if x.device.type == "cuda":
        return _kernel_call(
            lambda x, *ts: _layer_block_cuda(x, LayerWeights(*ts), heads, causal),
            lambda x, *ts: layer_block_reference(x, LayerWeights(*ts), heads, causal),
            x, *weights.tensors())
    if x.device.type == "cpu":
        return layer_block_reference(x, weights, heads, causal)
    raise ValueError(f"layer_block: unsupported device {x.device}")


layer_block.launches = 0


def _attention_block_cuda(x, weights, heads, causal):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "attention_block"
    _check_x(fn, x)
    b, t, w = x.shape
    _check_dense_weights(fn, x, weights, _attn_shapes(w))
    _check_gemm_dims(fn, w)
    lib = load_library()
    hd = _check_attention_shape(fn, t, w, heads, x.dtype)
    out = torch.empty_like(x)
    ws = _workspace(lib.irt_attention_block_workspace_bytes(b * t, w, x.element_size()),
                    x.device)
    _run(attention_block, lib, x.device, lambda stream: lib.irt_attention_block(
        x.data_ptr(), out.data_ptr(), *(a.data_ptr() for a in weights.tensors()),
        ws.data_ptr(), b, t, w, heads, int(bool(causal)), _DTYPE_CODES[x.dtype],
        ctypes.c_float(hd ** -0.5), stream))
    return out


def attention_block(x: torch.Tensor, weights: AttnWeights, heads: int,
                    causal: bool = False) -> torch.Tensor:
    """The attention sub-block in the compute dtype, x + out_proj(MHA(LN1(x))),
    on (B, T, W) x. CUDA: the Hopper kernel chain (or this raises), with the
    plain version's backward; CPU: the plain version.
    ``attention_block.launches`` counts kernel launches."""
    if x.device.type == "cuda":
        return _kernel_call(
            lambda x, *ts: _attention_block_cuda(x, AttnWeights(*ts), heads, causal),
            lambda x, *ts: attention_block_reference(x, AttnWeights(*ts), heads, causal),
            x, *weights.tensors())
    if x.device.type == "cpu":
        return attention_block_reference(x, weights, heads, causal)
    raise ValueError(f"attention_block: unsupported device {x.device}")


attention_block.launches = 0


def _attention_block_train_cuda(x, weights, heads, causal):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "attention_block_train"
    _check_x(fn, x)
    b, t, w = x.shape
    _check_dense_weights(fn, x, weights, _attn_shapes(w))
    _check_gemm_dims(fn, w)
    lib = load_library()
    hd = _check_attention_shape(fn, t, w, heads, x.dtype)
    out = torch.empty_like(x)
    # outputs of their own, not scratch: the backward reads them later
    qkv = torch.empty((b, t, 3 * w), dtype=x.dtype, device=x.device)
    attn = torch.empty_like(x)
    probs = torch.empty((b, heads, t, t), dtype=torch.float32, device=x.device)
    ws = _workspace(lib.irt_attention_block_train_workspace_bytes(b * t, w, x.element_size()),
                    x.device)
    _run(attention_block_train, lib, x.device, lambda stream: lib.irt_attention_block_train(
        x.data_ptr(), out.data_ptr(), qkv.data_ptr(), attn.data_ptr(), probs.data_ptr(),
        *(a.data_ptr() for a in weights.tensors()), ws.data_ptr(), b, t, w, heads,
        int(bool(causal)), _DTYPE_CODES[x.dtype], ctypes.c_float(hd ** -0.5), stream))
    q, k, v = qkv.reshape(b, t, 3, w).unbind(2)
    return out, q, k, v, attn, probs


def attention_block_saved(x: torch.Tensor, weights: AttnWeights, heads: int,
                          causal: bool = False):
    """The training forward on (B, T, W) x: (o, q, k, v, a, probs) as
    attention_block_saved_reference describes them. CUDA: the Hopper kernel
    chain (or this raises), counted in ``attention_block_train.launches``;
    CPU: the plain version. Not differentiable by itself:
    attention_block_train is."""
    if x.device.type == "cuda":
        return _attention_block_train_cuda(x, weights, heads, causal)
    if x.device.type == "cpu":
        return attention_block_saved_reference(x, weights, heads, causal)
    raise ValueError(f"attention_block_train: unsupported device {x.device}")


class _SavedAttentionFunction(torch.autograd.Function):
    """attention_block_saved forward, attention_block_saved_backward over
    what it kept (the JAX entry's custom VJP, flash_attention.py:1238-1248)."""

    @staticmethod
    def forward(ctx, heads, causal, x, *tensors):
        o, q, k, v, attn, probs = attention_block_saved(x, AttnWeights(*tensors), heads, causal)
        ctx.heads = heads
        ctx.save_for_backward(x, *tensors, q, k, v, attn, probs)
        return o

    @staticmethod
    def backward(ctx, g):
        x, *rest = ctx.saved_tensors
        grads = attention_block_saved_backward(
            g, x, AttnWeights(*rest[:6]), *rest[6:], ctx.heads)
        return (None, None, *(gr if need else None
                              for gr, need in zip(grads, ctx.needs_input_grad[2:])))


def attention_block_train(x: torch.Tensor, weights: AttnWeights, heads: int,
                          causal: bool = False) -> torch.Tensor:
    """attention_block with a backward that recomputes no forward: while a
    gradient is being recorded the forward keeps q, k, v, a and the f32
    probabilities (CUDA: the Hopper kernel chain of attention_block_saved, or
    this raises; CPU: the plain version) and the backward is
    attention_block_saved_backward over them. A call that records no
    gradient takes attention_block and keeps nothing, as the JAX entry's
    primal does. ``attention_block_train.launches`` counts launches of the
    saving kernel only."""
    if not (torch.is_grad_enabled()
            and any(a.requires_grad for a in (x, *weights.tensors()))):
        return attention_block(x, weights, heads, causal)
    return _SavedAttentionFunction.apply(heads, causal, x, *weights.tensors())


attention_block_train.launches = 0


def _mlp_block_cuda(x, weights):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "mlp_block"
    _check_x(fn, x)
    b, t, w = x.shape
    hidden = weights.hidden
    _check_dense_weights(fn, x, weights, _mlp_shapes(w, hidden))
    _check_gemm_dims(fn, w, hidden)
    lib = load_library()
    out = torch.empty_like(x)
    ws = _workspace(lib.irt_mlp_block_workspace_bytes(b * t, w, hidden, x.element_size()),
                    x.device)
    _run(mlp_block, lib, x.device, lambda stream: lib.irt_mlp_block(
        x.data_ptr(), out.data_ptr(), *(a.data_ptr() for a in weights.tensors()),
        ws.data_ptr(), b * t, w, hidden, _DTYPE_CODES[x.dtype], stream))
    return out


def mlp_block(x: torch.Tensor, weights: MlpWeights) -> torch.Tensor:
    """The MLP sub-block in the compute dtype, x + fc2(quick_gelu(fc1(LN2(x)))),
    on (B, T, W) x. CUDA: the Hopper kernel chain (or this raises), with the
    plain version's backward; CPU: the plain version. ``mlp_block.launches``
    counts kernel launches."""
    if x.device.type == "cuda":
        return _kernel_call(
            lambda x, *ts: _mlp_block_cuda(x, MlpWeights(*ts)),
            lambda x, *ts: mlp_block_reference(x, MlpWeights(*ts)),
            x, *weights.tensors())
    if x.device.type == "cpu":
        return mlp_block_reference(x, weights)
    raise ValueError(f"mlp_block: unsupported device {x.device}")


mlp_block.launches = 0


def _multihead_attention_cuda(q, k, v, heads):
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "multihead_attention"
    _check_x(fn, q)
    for name, a in (("k", k), ("v", v)):
        _check_tensor(fn, name, a, q.shape, q.dtype, q.device)
    b, t, w = q.shape
    lib = load_library()
    hd = _check_attention_shape(fn, t, w, heads, q.dtype)
    out = torch.empty_like(q)
    _run(multihead_attention, lib, q.device, lambda stream: lib.irt_multihead_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, t, w, heads,
        _DTYPE_CODES[q.dtype], ctypes.c_float(hd ** -0.5), stream))
    return out


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        heads: int) -> torch.Tensor:
    """Self-attention per image on (B, T, W) q, k, v in the compute dtype, no
    mask. CUDA: the tiled attention kernel on contiguous tensors (or this
    raises), with the plain version's backward; CPU: the plain version.
    ``multihead_attention.launches`` counts kernel launches."""
    if q.device.type == "cuda":
        return _kernel_call(
            lambda q, k, v: _multihead_attention_cuda(q, k, v, heads),
            lambda q, k, v: multihead_attention_reference(q, k, v, heads),
            q, k, v)
    if q.device.type == "cpu":
        return multihead_attention_reference(q, k, v, heads)
    raise ValueError(f"multihead_attention: unsupported device {q.device}")


multihead_attention.launches = 0


def attention_as_route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int,
                       route: int, causal: bool = False) -> torch.Tensor:
    """The bf16 attention on CUDA (B, T, W) q, k, v through the kernel form
    `route` names (``attention_plan``'s numbers): 4, the wgmma form, where
    it takes the shape, or the mma.sync form the shape has without it. For
    timing the two forms in turns and for the card tests only: the main
    path's wrappers take the plan's form and no route. q, k and v share one
    row stride, so they may be views into packed [q | k | v] rows. Counts no
    launch; raises where the form does not take the shape."""
    from image_retrieval_tpu_torch.ops._build import load_library

    fn = "attention_as_route"
    if q.device.type != "cuda" or q.dtype != torch.bfloat16 or q.dim() != 3:
        raise ValueError(f"{fn} takes (B, T, W) bfloat16 tensors on the card")
    b, t, w = q.shape
    for a in (k, v):
        if a.shape != q.shape or a.dtype != q.dtype or a.device != q.device:
            raise ValueError(f"{fn}: q, k and v differ in shape, dtype or device")
    if any(a.stride() != q.stride() for a in (k, v)) or q.stride(2) != 1 or \
            q.stride(0) != t * q.stride(1) or any(a.data_ptr() % 16 for a in (q, k, v)):
        raise ValueError(f"{fn}: q, k and v need one row stride, unit columns and "
                         "16-byte alignment")
    hd = _check_attention_shape(fn, t, w, heads, q.dtype)
    lib = load_library()
    out = torch.empty((b, t, w), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.irt_attention_as_route(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), q.stride(1), out.data_ptr(), b, t, w,
            heads, int(bool(causal)), ctypes.c_float(hd ** -0.5), route,
            torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn}: route {route} at t={t}, head_dim={hd}: "
                           + lib.irt_error_string(rc).decode())
    return out


# ---------------------------------------------------------------------------
# Training through the int8 family: the straight-through backward
# ---------------------------------------------------------------------------
#
# The JAX int8 entries carry custom VJPs whose backward is the VJP of the
# dense, unquantized math at the saved inputs and the f32 parameters
# (_layer8_bwd flash_attention.py:900-915, _blk8_bwd :661-666, _mlp8_bwd
# :755-758; _quant_matmul_bwd models/clip.py:62-73): rounding would
# otherwise zero every weight gradient. The entries below take the f32
# parameters, quantize them on every call (quantize_layer's bits) and run
# the int8 kernel chain (on a CPU tensor its plain version) forward; the
# backward differentiates the plain dense version, layer_block_reference and
# its halves over prepare_layer's casts, or x @ W + b (_KernelFunction).
# There is no backward kernel, as the JAX package has none. A call that
# records no gradient launches directly.


def layer_block_int8_train(x: torch.Tensor, params, heads: int,
                           causal: bool = False) -> torch.Tensor:
    """layer_block_int8 on the layer's 16 f32 parameters (the order of
    quantize_layer's arguments) with the straight-through backward: the
    gradients of layer_block_reference over prepare_layer(params, x.dtype).
    Launches are counted in ``layer_block_int8.launches``."""
    return _kernel_call(
        lambda x, *ps: layer_block_int8(x, quantize_layer(*ps), heads, causal),
        lambda x, *ps: layer_block_reference(x, prepare_layer(*ps, dtype=x.dtype),
                                             heads, causal),
        x, *params)


def attention_block_int8_train(x: torch.Tensor, params, heads: int,
                               causal: bool = False) -> torch.Tensor:
    """attention_block_int8 on the attention half's 10 f32 parameters (ln
    scale and bias, then q, k, v, out kernels and biases) with the
    straight-through backward of attention_block_reference. Launches are
    counted in ``attention_block_int8.launches``."""
    return _kernel_call(
        lambda x, *ps: attention_block_int8(x, quantize_attn(*ps), heads, causal),
        lambda x, *ps: attention_block_reference(x, prepare_attn(*ps, dtype=x.dtype),
                                                 heads, causal),
        x, *params)


def mlp_block_int8_train(x: torch.Tensor, params) -> torch.Tensor:
    """mlp_block_int8 on the MLP half's 6 f32 parameters (ln scale and bias,
    fc1 kernel and bias, fc2 kernel and bias) with the straight-through
    backward of mlp_block_reference. Launches are counted in
    ``mlp_block_int8.launches``."""
    return _kernel_call(
        lambda x, *ps: mlp_block_int8(x, quantize_mlp(*ps)),
        lambda x, *ps: mlp_block_reference(x, prepare_mlp(*ps, dtype=x.dtype)),
        x, *params)


def _dense_f32(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """QuantDense's math without the quantization: (x @ kernel + bias) in
    f32, cast to `out_dtype`; its gradient is _quant_matmul_bwd's (dx = g W^T
    in f32 cast to x's dtype, dW = x^T g) and the bias add's."""
    return (x.float() @ kernel.float() + bias.float()).to(out_dtype)


def quant_dense_train(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                      out_dtype: torch.dtype) -> torch.Tensor:
    """QuantDense on its f32 (in, out) kernel and (out,) bias, quantized on
    every call, with the straight-through backward. Launches are counted in
    ``quant_dense.launches``."""
    return _kernel_call(
        lambda x, k, b: quant_dense(x, *quantize_kernel(k), _vec(b), out_dtype),
        lambda x, k, b: _dense_f32(x, k, b, out_dtype),
        x, kernel, bias)
