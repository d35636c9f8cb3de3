"""fc1 -> quick_gelu -> rowquant as one clustered GEMM: the launch plan as
the port mirrors it in Python (ops/flash_attention.py::rowquant_gemm_plan),
the int8 chains' workspaces without the f32 hidden rows, and the stage's
plain version (gemm_s8(..., "gelu_rowquant") on CPU tensors) against the JAX
package's _rowquant(_quick_gelu(_int8_proj(...))).

The C side answers the same plan and workspace sizes
(tests/test_torch_gpu.py::test_rowquant_gemm_plan_matches_the_kernel), and
the kernel is held against the plain version bit for bit there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_retrieval_tpu.ops import flash_attention as jfa
from image_retrieval_tpu_torch.ops import flash_attention as fa

# (tokens per sequence, width) of the ViT-B/32 and ViT-L/14 towers; hidden = 4 width
TOWERS = {"b32-vision": (50, 768), "b32-text": (77, 512), "l14-vision": (257, 1024),
          "l14-text": (77, 768)}
# the encoder's bucket ladder (models/encoder.py CLIPEncoder._BUCKETS)
LADDER = (8, 32, 128, 192, 256)
# hidden width -> blocks of 512 columns in a cluster
CLUSTERS = {2048: 4, 3072: 6, 4096: 8}
SMEM_LIMIT = 232448  # dynamic shared memory one block may ask for (227 KB)


@pytest.mark.parametrize("batch", LADDER)
@pytest.mark.parametrize("tower", list(TOWERS))
def test_the_fused_plan_covers_every_fc1(tower, batch):
    """Every fc1 of the presets' towers at the ladder's batches takes one
    clustered launch whose blocks cover every column of every row tile."""
    t, w = TOWERS[tower]
    m, hidden = batch * t, 4 * w
    plan = fa.rowquant_gemm_plan(m, hidden, w)
    assert plan.refused is None and plan.route == "fused", plan.why
    assert plan.cluster == CLUSTERS[hidden] <= 8
    gx, gy = plan.grid
    assert gx == plan.cluster and gx * plan.cols == hidden
    assert gy * plan.rows >= m > (gy - 1) * plan.rows
    assert (plan.rows, plan.cols, plan.stages, plan.threads) == (64, 512, 3, 4 * 128 + 32)
    assert f"cluster of {plan.cluster} blocks" in plan.why


def test_a_block_fits_an_sm():
    """Three stages of a 64-row A tile and four 128-row B boxes of 128 bytes,
    with 1 KB of alignment slack, fit the 227 KB a block may take; with the
    barriers and the epilogue's 1.25 KB of row maxima, one block an SM fits
    its 228 KB; 544 threads at the 120 registers __launch_bounds__(544, 1)
    leaves fit its 65,536 registers."""
    plan = fa.rowquant_gemm_plan(12800, 3072, 768)
    assert plan.smem_bytes == 3 * (64 + 512) * 128 + 1024 <= SMEM_LIMIT
    static = 6 * 8 + 4 * 64 * 4 + 64 * 4
    assert plan.smem_bytes + static + 1024 <= 228 * 1024
    assert plan.threads * 120 <= 65536


@pytest.mark.parametrize("m,n,k,why", [
    (150, 256, 64, "not a multiple of the 512 columns"),   # a width-64 layer
    (150, 640, 128, "not a multiple of the 512 columns"),
    (150, 1536 + 64, 512, "not a multiple of the 512 columns"),
    (150, 5120, 1280, "cluster of 10 blocks, more than the 8"),  # ViT-H/14
    (150, 6144, 1536, "cluster of 12 blocks, more than the 8"),
    (65535 * 64 + 1, 512, 64, "65535 row tiles of 64"),
])
def test_widths_no_cluster_covers_take_two_launches(m, n, k, why):
    plan = fa.rowquant_gemm_plan(m, n, k)
    assert plan.refused is None and plan.route == "two launches"
    assert why in plan.why
    assert (plan.cluster, plan.grid, plan.smem_bytes) == (0, (0, 0), 0)


@pytest.mark.parametrize("m,n,k", [(0, 512, 64), (8, 96, 64), (8, 512, 100)])
def test_shapes_the_gemm_refuses_are_refused(m, n, k):
    plan = fa.rowquant_gemm_plan(m, n, k)
    assert plan.refused == fa.gemm_plan(m, n, k, torch.int8).refused is not None
    assert plan.route == ""


def _align(n):
    return (n + 255) // 256 * 256


@pytest.mark.parametrize("m,w,hidden", [(400, 768, 3072), (12800, 768, 3072),
                                        (32896, 1024, 4096), (616, 512, 2048),
                                        (39, 64, 256), (150, 1280, 5120)])
@pytest.mark.parametrize("elem_bytes", [2, 4])
def test_workspace_mirror_leaves_out_the_f32_rows(m, w, hidden, elem_bytes):
    """The C side's carve_attn / carve_mlp in 256-byte pieces: the attention
    half's int8 rows, scales, qkv and attention output; x1; the MLP half's
    int8 rows and scales on both sides of fc1, and the f32 hidden rows only
    on the two-launch route."""
    fused = fa.rowquant_gemm_plan(m, hidden, w).route == "fused"
    attn = 2 * _align(m * w) + 2 * _align(4 * m) + _align(3 * m * w * elem_bytes) + _align(
        m * w * elem_bytes)
    f32_rows = _align(4 * m * hidden)
    mlp = _align(m * w) + 2 * _align(4 * m) + _align(m * hidden) + (0 if fused else f32_rows)
    assert fa.attention_block_int8_workspace_bytes(m, w, elem_bytes) == attn
    assert fa.mlp_block_int8_workspace_bytes(m, w, hidden) == mlp
    assert fa.layer_block_int8_workspace_bytes(m, w, hidden, elem_bytes) == (
        attn + _align(m * w * elem_bytes) + mlp)
    assert fused == (hidden % 512 == 0 and hidden <= 4096)


def _fc1_operands(rng, m, k, n):
    """int8 LN rows with their scales and quantized fc1 weights, as numpy
    arrays: (hq, hs (m, 1), w1q (k, n), w1s (1, n), b1 (n,))."""
    h = rng.normal(size=(m, k)).astype(np.float32)
    hq, hs = fa.rowquant(torch.from_numpy(h))
    w1q, w1s = fa.quantize_weight(torch.from_numpy(
        (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)))
    b1 = (0.02 * rng.normal(size=n)).astype(np.float32)
    return hq.numpy(), hs.numpy(), w1q.numpy(), w1s.numpy(), b1


def _port_args(hq, hs, w1q, w1s, b1):
    t = torch.from_numpy
    return (t(hq), t(np.ascontiguousarray(w1q.T)), t(hs).reshape(-1), t(w1s).reshape(-1),
            t(b1))


@pytest.mark.parametrize("m,k,n", [(1, 64, 256), (63, 128, 512), (65, 64, 1024),
                                   (150, 192, 640)])
def test_cpu_gelu_rowquant_is_the_plain_version(m, k, n):
    """On CPU tensors the stage is rowquant(gemm_s8_reference(..., "gelu",
    f32)) bit for bit, launches nothing, and returns one f32 scale a row."""
    args = _port_args(*_fc1_operands(np.random.default_rng(m + n), m, k, n))
    before = fa.gemm_s8.launches
    gq, gs = fa.gemm_s8(*args, torch.int8, fa.GELU_ROWQUANT)
    wq, ws = fa.rowquant(fa.gemm_s8_reference(*args, torch.float32, "gelu"))
    assert fa.gemm_s8.launches == before
    assert gq.dtype == torch.int8 and gq.shape == (m, n) and torch.equal(gq, wq)
    assert gs.dtype == torch.float32 and gs.shape == (m,) and torch.equal(gs, ws.reshape(-1))
    assert torch.equal(fa.gemm_s8_reference(*args, torch.int8, fa.GELU_ROWQUANT)[0], gq)


# The port's quick_gelu is v * (1 / (1 + exp(-1.702 v))) in correctly rounded
# f32 operations (the kernel's own); JAX's is v * sigmoid(1.702 v) through
# XLA's logistic. The two differ by an f32 rounding on some values, which can
# move a row's absmax, and so its scale, by an ulp or two, and an element
# whose v / s sits on a rounding boundary by one int8 level. Readings at
# hidden 256 and 512 over three seeds: the scales of one case within 1.32 x
# 2^-23 relative (one ulp), the others equal; no element apart. Limits: 4 x
# 2^-23 relative, one level, on at most 1 % of the elements.
GS_RTOL = 4 * 2.0 ** -23
GQ_SHARE = 0.01


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("m,k,n", [(150, 64, 256), (77, 128, 512)])
def test_gelu_rowquant_matches_jax(seed, m, k, n):
    hq, hs, w1q, w1s, b1 = _fc1_operands(np.random.default_rng(seed), m, k, n)
    ja = jfa._quick_gelu(jfa._int8_proj(jnp.asarray(hq), jnp.asarray(hs), jnp.asarray(w1q),
                                        jnp.asarray(w1s), jnp.asarray(b1).reshape(1, -1),
                                        jnp.float32))
    jq, js = (np.asarray(a) for a in jfa._rowquant(ja))
    gq, gs = fa.gemm_s8(*_port_args(hq, hs, w1q, w1s, b1), torch.int8, fa.GELU_ROWQUANT)
    np.testing.assert_allclose(gs.numpy(), js.reshape(-1), rtol=GS_RTOL, atol=0)
    off = np.abs(gq.numpy().astype(np.int32) - jq.astype(np.int32))
    assert off.max() <= 1 and (off > 0).mean() <= GQ_SHARE, ((off > 0).mean(), off.max())


def test_gelu_rowquant_writes_int8_only():
    args = _port_args(*_fc1_operands(np.random.default_rng(5), 4, 64, 512))
    with pytest.raises(ValueError, match="writes int8"):
        fa.gemm_s8(*args, torch.float32, fa.GELU_ROWQUANT)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", [64, 512, 768, 1024])
def test_cpu_row_pass_is_the_plain_version(width, dtype):
    rng = np.random.default_rng(width)
    x = torch.from_numpy(rng.normal(size=(5, width)).astype(np.float32)).to(dtype)
    s, b = (torch.from_numpy(rng.normal(size=width).astype(np.float32)) for _ in range(2))
    before = fa.ln_rowquant.launches
    for args in ((), (s, b)):
        q, qs = fa.ln_rowquant(x, *args)
        xf = x.float() if not args else fa.fast_layernorm_f32(x.float(), s, b)
        wq, ws = fa.rowquant(xf)
        assert torch.equal(q, wq) and torch.equal(qs, ws.reshape(-1))
    assert fa.ln_rowquant.launches == before
    with pytest.raises(ValueError, match="both"):
        fa.ln_rowquant(x, s)
