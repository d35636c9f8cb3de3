"""Tests of the port that need a CUDA card; each skips without one.

This file imports no JAX, so it also runs on a GPU machine without JAX:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q

(`--noconftest` skips tests/conftest.py, which configures JAX.)
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from image_retrieval_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Hopper kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer_weights(rng, w, device):
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    hidden = 4 * w
    params = [
        1 + 0.1 * f(w), 0.1 * f(w),
        f(w, w) / math.sqrt(w), 0.02 * f(w), f(w, w) / math.sqrt(w), 0.02 * f(w),
        f(w, w) / math.sqrt(w), 0.02 * f(w), f(w, w) / math.sqrt(w), 0.02 * f(w),
        1 + 0.1 * f(w), 0.1 * f(w),
        f(w, hidden) / math.sqrt(w), 0.02 * f(hidden),
        f(hidden, w) / math.sqrt(hidden), 0.02 * f(w),
    ]
    return fa.quantize_layer(*[p.to(device) for p in params])


@pytest.mark.parametrize("b,t,w,heads,causal", [
    (8, 50, 768, 12, False),   # ViT-B/32 vision layer
    (8, 77, 512, 8, True),     # text layer
    (3, 13, 128, 2, True),     # ragged token rows (M % 64 != 0)
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_matches_plain(cuda, b, t, w, heads, causal, dtype):
    rng = np.random.default_rng(9)
    wts = _layer_weights(rng, w, cuda)
    x = torch.from_numpy(rng.normal(size=(b, t, w)).astype(np.float32)).to(
        cuda, getattr(torch, dtype))
    before = fa.layer_block_int8.launches
    got = fa.layer_block_int8(x, wts, heads, causal)
    want = fa.layer_block_int8_reference(x, wts, heads, causal)
    torch.cuda.synchronize()
    assert fa.layer_block_int8.launches == before + 1
    # the limits chip_smoke.py applies (set from int8 rounding flips)
    r = fa.kernel_agreement(got, want, x)
    assert r["ok"], r


def test_kernel_rejects_unsupported_width(cuda):
    wts = _layer_weights(np.random.default_rng(1), 96, cuda)
    with pytest.raises(ValueError, match="divisible by 64"):
        fa.layer_block_int8(torch.zeros(2, 5, 96, device=cuda), wts, 3)


def _x(rng, shape, device, dtype):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        device, getattr(torch, dtype))


# Ragged token counts, every head width the towers use, one and three
# images, with and without the causal mask; (4, 197, 768) is ViT-B/16 and
# (2, 257, 1024) ViT-L/14 vision, which need the query rows tiled.
SUBBLOCK_SHAPES = [
    (1, 1, 64, 2, False), (3, 50, 768, 12, False), (3, 77, 512, 8, True),
    (1, 197, 768, 12, False), (2, 257, 1024, 16, False), (3, 77, 256, 2, True),
    (1, 50, 128, 4, False), (3, 197, 128, 1, True),
]


@pytest.mark.parametrize("b,t,w,heads,causal", SUBBLOCK_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_block_kernel_matches_plain(cuda, b, t, w, heads, causal, dtype):
    rng = np.random.default_rng(t * w)
    wts = _layer_weights(rng, w, cuda).attn
    x = _x(rng, (b, t, w), cuda, dtype)
    before = fa.attention_block_int8.launches
    got = fa.attention_block_int8(x, wts, heads, causal)
    want = fa.attention_block_int8_reference(x, wts, heads, causal)
    torch.cuda.synchronize()
    assert fa.attention_block_int8.launches == before + 1
    r = fa.kernel_agreement(got, want, x)
    assert r["ok"], r


@pytest.mark.parametrize("b,t,w", [(1, 1, 64), (3, 50, 768), (2, 257, 1024), (3, 77, 512)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_mlp_block_kernel_matches_plain(cuda, b, t, w, dtype):
    rng = np.random.default_rng(t + w)
    wts = _layer_weights(rng, w, cuda).mlp
    x = _x(rng, (b, t, w), cuda, dtype)
    before = fa.mlp_block_int8.launches
    got = fa.mlp_block_int8(x, wts)
    want = fa.mlp_block_int8_reference(x, wts)
    torch.cuda.synchronize()
    assert fa.mlp_block_int8.launches == before + 1
    r = fa.kernel_agreement(got, want, x)
    assert r["ok"], r


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_subblocks_compose_to_the_layer_kernel(cuda, dtype):
    """K2a then K2b run the same launches as K1 on the same values: bitwise."""
    rng = np.random.default_rng(11)
    wts = _layer_weights(rng, 768, cuda)
    x = _x(rng, (3, 50, 768), cuda, dtype)
    two = fa.mlp_block_int8(fa.attention_block_int8(x, wts.attn, 12), wts.mlp)
    one = fa.layer_block_int8(x, wts, 12)
    torch.cuda.synchronize()
    assert torch.equal(two, one)


# Token counts of the presets (50, 77, 197, 257), of one, around the 16-row
# tiles and the 80-key chunk (13, 17, 65), the wgmma form's edges and a
# ragged 64-row tile (81, 128, 200, 288) and past the 288 keys whose scores
# stay in registers (300); head widths that are and are not powers of two.
@pytest.mark.parametrize("t", [1, 13, 17, 50, 65, 77, 81, 128, 197, 200, 257, 288, 300])
@pytest.mark.parametrize("hd", [16, 32, 48, 64, 80, 128])
@pytest.mark.parametrize("b,causal", [(1, False), (3, True)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tiled_attention_matches_plain(cuda, t, hd, b, causal, dtype):
    """Same order of operations per row on both sides; they differ by the
    f32 sum order of the dots (and, in bf16, by a probability or an output
    rounding to its neighbour): 2 bf16 ulps of the largest value, 1e-5 in
    f32 for values of order 1."""
    rng = np.random.default_rng(t * hd + b)
    heads = 2
    qkv = _x(rng, (b * t, 3 * heads * hd), cuda, dtype)
    if dtype == "float32" and hd == 128 and t >= 257:
        # f32 K and V alone are 257 KB: the wrapper raises. bf16 K and V fit.
        with pytest.raises(ValueError, match="do not fit"):
            fa.tiled_attention(qkv, b, heads, causal)
        return
    before = fa.tiled_attention.launches
    got = fa.tiled_attention(qkv, b, heads, causal)
    want = fa._attention_reference(qkv, b, t, heads * hd, heads, causal, qkv.dtype)
    torch.cuda.synchronize()
    assert fa.tiled_attention.launches == before + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    top = float(want.float().abs().max())
    atol = 2 * top * 2.0 ** -8 if dtype == "bfloat16" else 1e-5
    assert float((got.float() - want.float()).abs().max()) <= atol


@pytest.mark.parametrize("t,hd,causal", [
    (13, 48, True), (17, 80, False), (50, 64, False), (77, 20, True), (257, 64, True),
    (300, 64, False), (81, 64, False), (200, 64, True), (288, 64, False), (257, 64, False)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tiled_attention_reads_nothing_past_its_rows(cuda, t, hd, causal, dtype):
    """A NaN guard band: packed qkv as a view into a larger buffer that holds
    NaN after its last row. A read past the rows (a padded query tile, keys
    rounded up to 16) would reach the output as NaN; rows and columns past
    the shape are zero-filled instead, so the view gives the bits of a
    tensor of its own."""
    rng = np.random.default_rng(t + hd)
    b, heads = 2, 2
    qkv = _x(rng, (b * t, 3 * heads * hd), cuda, dtype)
    buf = torch.full((b * t + 64, 3 * heads * hd), float("nan"), dtype=qkv.dtype, device=cuda)
    buf[: b * t] = qkv
    got = fa.tiled_attention(buf[: b * t], b, heads, causal)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, fa.tiled_attention(qkv, b, heads, causal))


@pytest.mark.parametrize("t,causal", [(50, False), (77, True), (257, False), (300, True),
                                      (257, True), (81, False), (288, True)])
def test_tiled_attention_with_scores_far_apart(cuda, t, causal):
    """q and k 12 x larger: scores hundreds apart, exponentials that
    underflow to 0 or fall below 2^-90, so that the bf16 kernel divides by
    __fdiv_rn; the limits of test_tiled_attention_matches_plain."""
    rng = np.random.default_rng(t)
    b, heads, hd = 2, 2, 64
    qkv = torch.from_numpy(rng.normal(size=(b * t, 3 * heads * hd)).astype(np.float32))
    qkv[:, : 2 * heads * hd] *= 12
    qkv = qkv.to(cuda, torch.bfloat16)
    got = fa.tiled_attention(qkv, b, heads, causal)
    want = fa._attention_reference(qkv, b, t, heads * hd, heads, causal, qkv.dtype)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    top = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2 * top * 2.0 ** -8


def test_attention_division_is_fdiv_rn(cuda):
    """The bf16 attention divides each exponential by its row's sum without a
    branch (two corrections of e times the correctly rounded 1 / sum) and
    takes __fdiv_rn only for a tile where a score lies 62 or more below its
    row's max, so that no exponential it divides lies below 2^-90: over that
    range the two give the same bits. 2^32 pseudo-random pairs."""
    from image_retrieval_tpu_torch.ops._build import load_library

    lib = load_library()
    bad = torch.zeros(1, dtype=torch.int64, device=cuda)
    rc = lib.irt_attention_division_check(bad.data_ptr(), 1 << 32,
                                          torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0 and int(bad.item()) == 0


def test_attention_exponential_is_expf(cuda):
    """The wgmma attention takes exp(s - max) on the unscaled dots with the
    scale 1/8 (head_dim 64) moved into expf's own constants: over 2^30
    pseudo-random differences (and 0 and -inf) it gives expf's bits."""
    from image_retrieval_tpu_torch.ops._build import load_library

    lib = load_library()
    bad = torch.zeros(1, dtype=torch.int64, device=cuda)
    rc = lib.irt_attention_exp_check(bad.data_ptr(), 1 << 30,
                                     torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0 and int(bad.item()) == 0


def test_attention_plan_matches_the_kernels(cuda):
    """ops/flash_attention.py::attention_plan is the C side's launch plan:
    rows per block, shared memory and kernel form for every dtype, over
    token counts at the edges of each form and of shared memory."""
    from image_retrieval_tpu_torch.ops._build import load_library

    lib = load_library()
    for t in (1, 13, 16, 17, 50, 65, 77, 80, 81, 96, 128, 197, 200, 257, 272, 273, 288, 289,
              300, 384, 385, 600, 768, 769):
        for hd in (2, 4, 16, 20, 48, 64, 80, 128, 132):
            for dtype, code in ((torch.bfloat16, 0), (torch.float32, 1)):
                for pairs in (1, 64, 96, 2048, 3072):
                    plan = fa.attention_plan(t, hd, dtype, pairs)
                    case = (t, hd, dtype, pairs)
                    assert lib.irt_attention_tile_rows(t, hd, code, pairs) == \
                        plan.rows_per_block, case
                    assert lib.irt_attention_smem_bytes(t, hd, code) == plan.smem_bytes, case
                    assert lib.irt_attention_route(t, hd, code) == plan.route, case


# The wgmma form's token counts (81-288 keys at head_dim 64): its edges, a
# query tile of 64 rows exactly, a ragged one, and the L/14 tower's.
WG_TOKENS = [81, 128, 200, 257, 288]


@pytest.mark.parametrize("t", WG_TOKENS)
@pytest.mark.parametrize("causal", [False, True])
def test_attention_forms_match_plain(cuda, t, causal):
    """Both bf16 forms at the wgmma form's shapes, each named through
    attention_as_route: the wgmma form (4) and the two-warp mma.sync form
    (2) these shapes took before it, against the plain version with the
    limits of test_tiled_attention_matches_plain; tiled_attention and
    multihead_attention take the wgmma form, bit for bit."""
    rng = np.random.default_rng(t + 7 * causal)
    b, heads, hd = 3, 4, 64
    qkv = _x(rng, (b * t, 3 * heads * hd), cuda, "bfloat16")
    q, k, v = qkv.view(b, t, -1).split(heads * hd, -1)
    want = fa._attention_reference(qkv, b, t, heads * hd, heads, causal, qkv.dtype)
    want = want.view(b, t, -1).float()
    assert fa.attention_plan(t, hd, torch.bfloat16, b * heads).route == 4
    top = float(want.abs().max())
    outs = {}
    for route in (4, 2):
        outs[route] = fa.attention_as_route(q, k, v, heads, route, causal)
        torch.cuda.synchronize()
        assert torch.isfinite(outs[route]).all(), route
        assert float((outs[route].float() - want).abs().max()) <= 2 * top * 2.0 ** -8, route
    before = fa.tiled_attention.launches
    assert torch.equal(fa.tiled_attention(qkv, b, heads, causal).view(b, t, -1), outs[4])
    assert fa.tiled_attention.launches == before + 1
    if not causal:
        qc, kc, vc = (a.contiguous() for a in (q, k, v))
        assert torch.equal(fa.multihead_attention(qc, kc, vc, heads), outs[4])


@pytest.mark.parametrize("b,t,causal", [(64, 257, False), (64, 257, True), (37, 200, False),
                                      (33, 81, True), (48, 288, False)])
def test_attention_wgmma_many_tiles_a_block(cuda, b, t, causal):
    """Batches whose (image, head)s outnumber the 132 persistent blocks, so
    that each block walks several items and their tiles, an even or an odd
    count of them, its two warpgroups taking turns: against the plain
    version with the limits of test_tiled_attention_matches_plain."""
    rng = np.random.default_rng(b + t)
    heads, hd = 4, 64
    qkv = _x(rng, (b * t, 3 * heads * hd), cuda, "bfloat16")
    assert fa.attention_plan(t, hd, torch.bfloat16, b * heads).route == 4
    got = fa.tiled_attention(qkv, b, heads, causal)
    want = fa._attention_reference(qkv, b, t, heads * hd, heads, causal, qkv.dtype)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    top = float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= 2 * top * 2.0 ** -8


def test_attention_as_route_refuses_a_form_that_does_not_take_the_shape(cuda):
    """Only the plan's form or, where the wgmma form takes the shape, the
    mma.sync form it replaced: nothing else launches."""
    rng = np.random.default_rng(3)
    for t, hd, good, bad in ((50, 64, 1, 4), (257, 32, 2, 4), (257, 64, 4, 1), (300, 64, 3, 4)):
        q, k, v = (_x(rng, (2, t, 2 * hd), cuda, "bfloat16") for _ in range(3))
        fa.attention_as_route(q, k, v, 2, good)
        with pytest.raises(RuntimeError, match="invalid shape"):
            fa.attention_as_route(q, k, v, 2, bad)
    torch.cuda.synchronize()


@pytest.mark.parametrize("m,k,n", [(1, 64, 64), (150, 768, 2304), (514, 1024, 4096),
                                    (77, 4096, 1024)])
@pytest.mark.parametrize("in_dtype,out_dtype", [
    ("float32", "float32"), ("float32", "bfloat16"), ("bfloat16", "bfloat16")])
def test_quant_dense_kernel_matches_plain(cuda, m, k, n, in_dtype, out_dtype):
    """The int32 sums are exact on both sides, and the rowquant and the
    rescale run the same correctly rounded f32 operations in the same order
    (no exp, no sum whose order could differ): the two are equal bit for
    bit. The plain version's scale must be a true division for that
    (ops/flash_attention.py::_absmax_scale)."""
    rng = np.random.default_rng(m + k)
    w_t, w_s = fa.quantize_weight(torch.from_numpy(
        rng.normal(size=(k, n)).astype(np.float32) / math.sqrt(k)))
    w_t, w_s = w_t.t().contiguous().to(cuda), w_s.reshape(-1).to(cuda)
    bias = torch.from_numpy(0.02 * rng.normal(size=n).astype(np.float32)).to(cuda)
    x = _x(rng, (m, k), cuda, in_dtype)
    od = getattr(torch, out_dtype)
    before = fa.quant_dense.launches
    got = fa.quant_dense(x, w_t, w_s, bias, od)
    want = fa.quant_dense_reference(x, w_t, w_s, bias, od)
    torch.cuda.synchronize()
    assert fa.quant_dense.launches == before + 1
    assert got.dtype == od and torch.equal(got, want)


# ---------------------------------------------------------------------------
# The GEMM every chain runs (csrc/gemm_sm90.cuh), alone
# ---------------------------------------------------------------------------

# ragged M on every tile form: 1-400 take 64-row tiles (a block a tile),
# 1000 at N = 4096 128 rows, 4928 at N >= 1024 192 rows (persistent blocks;
# gemm_plan, the same for bf16 and int8)
GEMM_M = (1, 63, 65, 400, 1000, 4928)
GEMM_N = GEMM_K = (64, 192, 1024, 4096)


def test_gemm_plan_matches_the_kernels(cuda):
    """ops/flash_attention.py::gemm_plan is the C side's launch plan: tile
    rows, stages, shared memory, grid, threads, tiles and waves for
    both operand types (each on the card's own count of blocks and on
    another), and the same shapes refused."""
    import ctypes

    from image_retrieval_tpu_torch.ops._build import load_library

    lib = load_library()
    card = lib.irt_gemm_max_blocks(0)
    card8 = lib.irt_gemm_max_blocks(1)
    assert 1 <= card <= 132 and 1 <= card8 <= 132, (card, card8)
    got = (ctypes.c_int * 9)()
    for m in (0, 1, 63, 64, 65, 400, 1024, 4928, 6400, 12800, 16448, 32896, 65535 * 64,
              65535 * 64 + 1, 65535 * 128, 65535 * 128 + 1, 65535 * 192, 65535 * 192 + 1,
              65535 * 256, 65535 * 256 + 1):
        for n in (0, 32, 64, 96, 192, 320, 768, 1024, 2304, 3072, 4096):
            for k in (0, 32, 64, 100, 192, 768, 1024, 4096):
                for dtype, code, blocks in ((torch.bfloat16, 0, card), (torch.bfloat16, 0, 120),
                                            (torch.int8, 1, card8), (torch.int8, 1, 120)):
                    plan = fa.gemm_plan(m, n, k, dtype, blocks)
                    rc = lib.irt_gemm_plan(m, n, k, code, blocks, got)
                    case = (m, n, k, dtype, blocks)
                    assert (rc != 0) == (plan.refused is not None), case
                    if rc == 0:
                        assert tuple(got) == (plan.rows, plan.stages, plan.smem_bytes,
                                              *plan.grid, plan.threads, *plan.tiles,
                                              plan.waves), case


def _gemm_operands(m, n, k, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == torch.int8:
        a = torch.randint(-127, 128, (m, k), generator=g, device="cuda", dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=g, device="cuda", dtype=torch.int8)
        # scales of the size rowquant and quantize_weight give
        rs = 0.02 * torch.rand(m, generator=g, device="cuda") + 1e-3
        cs = (0.02 * torch.rand(n, generator=g, device="cuda") + 1e-3) / math.sqrt(k)
        bias = 0.02 * torch.randn(n, generator=g, device="cuda")
        return a, bt, rs, cs, bias
    a = torch.randn((m, k), generator=g, device="cuda").to(dtype)
    bt = (torch.randn((n, k), generator=g, device="cuda") / math.sqrt(k)).to(dtype)
    return a, bt, 0.02 * torch.randn(n, generator=g, device="cuda")


def _s8_all_epilogues(m, n, k, seed, out_rows=None):
    """gemm_s8 against gemm_s8_reference, bit for bit, in every epilogue and
    both output types; with out_rows, into the first m rows of a buffer of
    out_rows rows whose rows past m must keep their guard value."""
    a, bt, rs, cs, bias = _gemm_operands(m, n, k, torch.int8, seed)
    for out_dtype in (torch.bfloat16, torch.float32):
        residual = torch.randn((m, n), device="cuda").to(out_dtype)
        for epilogue in fa.GEMM_EPILOGUES:
            r = residual if epilogue == "residual" else None
            buf = torch.full((out_rows or m, n), 7.0, dtype=out_dtype, device="cuda")
            before = fa.gemm_s8.launches
            got = fa.gemm_s8(a, bt, rs, cs, bias, out_dtype, epilogue, r, out=buf[:m])
            want = fa.gemm_s8_reference(a, bt, rs, cs, bias, out_dtype, epilogue, r)
            torch.cuda.synchronize()
            assert fa.gemm_s8.launches == before + 1
            assert got.dtype == out_dtype and torch.equal(got, want), (epilogue, out_dtype)
            assert bool((buf[m:] == 7.0).all()), (epilogue, out_dtype)


@pytest.mark.parametrize("m", GEMM_M)
@pytest.mark.parametrize("n", GEMM_N)
@pytest.mark.parametrize("k", GEMM_K)
def test_gemm_s8_kernel_matches_plain_bitwise(cuda, m, n, k):
    """The int32 sums are exact on both sides (every K, no split, zero-filled
    tails add nothing) and the epilogue runs the same correctly rounded f32
    operations in the same order: every epilogue, both output types, bit for
    bit."""
    _s8_all_epilogues(m, n, k, m * n + k)


@pytest.mark.parametrize("m,n,k", [
    (1, 64, 64),          # one tile, a block; K half a 128-byte step
    (200, 320, 192),      # three column tiles, the last of 64, a block each
    (257, 192, 128),      # a last column tile of 64; M one past 256
    (63, 1024, 64),       # M below one tile, K = 64
    (193, 768, 768),      # M one past 192
    (4928, 768, 768),     # 128-row tiles in two waves, the L/14 text batch's out
    (4929, 768, 64),      # one row into a new band, K = 64
    (8448, 320, 192),     # two waves over three column tiles, the last of 64
    (12800, 768, 3072),   # several persistent waves, a ragged last one, K = 3,072
    (12800, 2304, 768),   # the B/32 image batch's q/k/v: ten waves
    (32896, 1024, 1024),  # the L/14 image batch: a last band of 64 rows on 192-row tiles
    (616, 1536, 512),     # the B/32 text layer at B = 8: 64-row tiles, a block each
])
def test_gemm_s8_bitwise_at_the_plan_edges(cuda, m, n, k):
    """Every epilogue in bf16 (stored by TMA, the residual read by TMA) and
    f32 (stored from registers) at the persistent walk's edges, bit for bit,
    and nothing written past row M."""
    _s8_all_epilogues(m, n, k, m + n + k, out_rows=m + 64)


def _s8_rows(n, k, m, seed=5):
    """gemm_s8 of the first m rows of one seeded (12800, k) A, every epilogue,
    bf16 outputs."""
    a, bt, rs, cs, bias = _gemm_operands(12800, n, k, torch.int8, seed)
    res = torch.randn((12800, n), generator=torch.Generator(device="cuda").manual_seed(seed),
                      device="cuda").to(torch.bfloat16)
    return [fa.gemm_s8(a[:m], bt, rs[:m], cs, bias, torch.bfloat16, e,
                       res[:m] if e == "residual" else None) for e in fa.GEMM_EPILOGUES]


@pytest.mark.parametrize("n,k", [(768, 768), (2304, 768), (768, 3072), (1024, 4096)])
def test_gemm_s8_rows_keep_their_bits_whatever_m_and_plan(cuda, n, k):
    """One wgmma shape and one ascending K order on every plan: a row's
    outputs are the same bits at M = 12,800 (192-row tiles, several waves),
    6,400, 1,000, 400 and 65 (shorter tiles, a block a tile, where the last
    wave would idle or the batch is small), in every epilogue."""
    full = _s8_rows(n, k, 12800)
    heights = set()
    for m in (6400, 1000, 400, 65):
        heights.add(fa.gemm_plan(m, n, k, torch.int8).rows)
        for got, want in zip(_s8_rows(n, k, m), full):
            torch.cuda.synchronize()
            assert torch.equal(got, want[:m]), (m, n, k)
    assert len(heights | {fa.gemm_plan(12800, n, k, torch.int8).rows}) >= 2


@pytest.mark.parametrize("m", GEMM_M)
@pytest.mark.parametrize("n", GEMM_N)
@pytest.mark.parametrize("k", GEMM_K)
def test_gemm_bf16_kernel_within_the_float64_limit(cuda, m, n, k):
    """Every epilogue against the float64 value of its function, by
    gemm_bf16_agreement's limit (derived from K and the bf16 roundings)."""
    a, bt, bias = _gemm_operands(m, n, k, torch.bfloat16, m * n + k)
    residual = torch.randn((m, n), device=cuda).to(torch.bfloat16)
    for epilogue in fa.GEMM_EPILOGUES:
        r = residual if epilogue == "residual" else None
        before = fa.gemm_bf16.launches
        got = fa.gemm_bf16(a, bt, bias, epilogue, r)
        torch.cuda.synchronize()
        assert fa.gemm_bf16.launches == before + 1
        assert got.dtype == torch.bfloat16
        agree = fa.gemm_bf16_agreement(got, a, bt, bias, epilogue, r)
        assert agree["ok"], (epilogue, agree)


def _bf16_rows(n, k, m, seed=5):
    """gemm_bf16 of the first m rows of one seeded (12800, k) A, every epilogue."""
    a, bt, bias = _gemm_operands(12800, n, k, torch.bfloat16, seed)
    res = torch.randn((12800, n), generator=torch.Generator(device="cuda").manual_seed(seed),
                      device="cuda").to(torch.bfloat16)
    return [fa.gemm_bf16(a[:m], bt, bias, e, res[:m] if e == "residual" else None)
            for e in fa.GEMM_EPILOGUES]


@pytest.mark.parametrize("n,k", [(768, 768), (3072, 768), (1024, 4096)])
def test_gemm_bf16_rows_keep_their_bits_whatever_m_and_plan(cuda, n, k):
    """One wgmma shape and one ascending K order on every plan: a row's
    outputs are the same bits at M = 12,800 (256-row tiles), 6,400 (192 at
    N = 768), 1,000, 400 and 65 (64-row tiles at few tiles), in every
    epilogue."""
    full = _bf16_rows(n, k, 12800)
    heights = set()
    for m in (6400, 1000, 400, 65):
        heights.add(fa.gemm_plan(m, n, k, torch.bfloat16).rows)
        for got, want in zip(_bf16_rows(n, k, m), full):
            torch.cuda.synchronize()
            assert torch.equal(got, want[:m]), (m, n, k)
    assert len(heights | {fa.gemm_plan(12800, n, k, torch.bfloat16).rows}) >= 2


@pytest.mark.parametrize("m,n,k", [
    (1, 64, 64),        # a single tile, a single block
    (200, 320, 192),    # three column tiles, the last of 64
    (257, 192, 128),    # a last column tile of 64; M not a multiple of 64
    (6400, 768, 768),   # 192-row tiles, the trainer's out-projection
    (6401, 768, 768),   # one row into a new band
    (4928, 768, 768),   # 128-row tiles, the L/14 text batch (two waves)
    (12800, 768, 3072),  # four persistent waves, K = 3,072
    (32896, 1024, 1024),  # the L/14 image batch: a last band of 64 rows on 192-row tiles
])
def test_gemm_bf16_within_the_float64_limit_at_the_plan_edges(cuda, m, n, k):
    """Every epilogue at the new plan's edges, by gemm_bf16_agreement's
    float64 limit, and nothing written past row M."""
    a, bt, bias = _gemm_operands(m, n, k, torch.bfloat16, m + n + k)
    residual = torch.randn((m, n), device=cuda).to(torch.bfloat16)
    for epilogue in fa.GEMM_EPILOGUES:
        r = residual if epilogue == "residual" else None
        buf = torch.full((m + 64, n), 7.0, dtype=torch.bfloat16, device=cuda)
        got = fa.gemm_bf16(a, bt, bias, epilogue, r, out=buf[:m])
        torch.cuda.synchronize()
        agree = fa.gemm_bf16_agreement(got, a, bt, bias, epilogue, r)
        assert agree["ok"], (epilogue, agree)
        assert bool((buf[m:] == 7.0).all()), epilogue


@pytest.mark.parametrize("width", [512, 768, 1024, 320, 832, 1280, 4160])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ln_cast_matches_plain(cuda, width, dtype):
    """The compute-type chains' LayerNorm pass, a warp per row (the row in
    registers up to 1,024 values, streamed twice beyond), against its plain
    version: the sums differ in order only, so in bf16 an output is at most
    one rounding step of 2^-8 of its size away (the row's statistics move by
    a few f32 units), in f32 within 2e-6 of 1 + |value|; rows past m are not
    written."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(width)
    m = 1000
    x = torch.from_numpy(rng.standard_normal((m, width)).astype(np.float32) * 3 + 0.5)
    x = x.to(device=cuda, dtype=dt)
    g = torch.from_numpy(1 + 0.1 * rng.standard_normal(width).astype(np.float32)).to(cuda)
    b = torch.from_numpy(0.1 * rng.standard_normal(width).astype(np.float32)).to(cuda)
    before = fa.ln_cast.launches
    got = fa.ln_cast(x, g, b)
    want = fa.ln_cast_reference(x, g, b)
    torch.cuda.synchronize()
    assert fa.ln_cast.launches == before + 1
    err = (got.double() - want.double()).abs()
    if dtype == "bfloat16":
        assert bool((err <= 2.0 ** -7 * want.double().abs() + 1e-6).all()), float(err.max())
    else:
        assert bool((err <= 2e-6 * (1 + want.double().abs())).all()), float(err.max())


# ---------------------------------------------------------------------------
# fc1 -> quick_gelu -> rowquant as one clustered GEMM, and the row pass
# ---------------------------------------------------------------------------

# (n, k): the main path's hidden widths with their K (B/32 text, B/32 vision
# and L/14 text, L/14 vision), then widths that take the two-launch route
ROWQUANT_NK = [(2048, 512), (3072, 768), (4096, 1024), (256, 64), (640, 128), (5120, 1280)]


def test_rowquant_gemm_plan_matches_the_kernel(cuda):
    """ops/flash_attention.py::rowquant_gemm_plan is irt_rowquant_gemm_plan:
    route, cluster, tile, stages, shared memory, grid and threads, the same
    shapes refused; the workspace mirrors are the C functions; and the card
    holds at least one cluster of every fused main-path shape."""
    import ctypes

    from image_retrieval_tpu_torch.ops._build import load_library

    lib = load_library()
    got = (ctypes.c_int * 9)()
    for m in (0, 1, 63, 64, 65, 616, 4928, 12800, 32896, 65535 * 64, 65535 * 64 + 1):
        for n in (0, 96, 256, 512, 640, 1024, 2048, 3072, 4096, 4608, 5120):
            for k in (0, 64, 100, 512, 768, 1024):
                plan = fa.rowquant_gemm_plan(m, n, k)
                rc = lib.irt_rowquant_gemm_plan(m, n, k, got)
                case = (m, n, k)
                assert (rc != 0) == (plan.refused is not None), case
                if rc:
                    continue
                fused = plan.route == "fused"
                assert tuple(got) == (int(fused), plan.cluster, plan.rows, plan.cols, plan.stages,
                                      plan.smem_bytes, *plan.grid, plan.threads), case
    for m in (1, 65, 616, 12800, 32896):
        for w, hidden in ((64, 256), (512, 2048), (768, 3072), (1024, 4096), (1280, 5120)):
            for eb in (2, 4):
                assert lib.irt_layer_block_int8_workspace_bytes(m, w, hidden, eb) == \
                    fa.layer_block_int8_workspace_bytes(m, w, hidden, eb)
                assert lib.irt_attention_block_int8_workspace_bytes(m, w, eb) == \
                    fa.attention_block_int8_workspace_bytes(m, w, eb)
            assert lib.irt_mlp_block_int8_workspace_bytes(m, w, hidden) == \
                fa.mlp_block_int8_workspace_bytes(m, w, hidden)
    for n, k in ROWQUANT_NK[:3]:
        assert lib.irt_rowquant_gemm_max_clusters(32896, n, k) >= 1


@pytest.mark.parametrize("m", (1, 63, 65, 4928))
@pytest.mark.parametrize("n,k", ROWQUANT_NK)
def test_gelu_rowquant_kernel_matches_plain_bitwise(cuda, m, n, k):
    """The int32 sums are exact, the finish runs the plain version's f32
    operations in its order, and a max does not depend on the order of its
    inputs: the int8 rows and their scales equal rowquant(gemm_s8_reference
    (..., "gelu", f32)) bit for bit, on the fused route and on the two-launch
    one alike."""
    a, bt, rs, cs, bias = _gemm_operands(m, n, k, torch.int8, m + n + k)
    before = fa.gemm_s8.launches
    gq, gs = fa.gemm_s8(a, bt, rs, cs, bias, torch.int8, fa.GELU_ROWQUANT)
    wq, ws = fa.gemm_s8_reference(a, bt, rs, cs, bias, torch.int8, fa.GELU_ROWQUANT)
    torch.cuda.synchronize()
    assert fa.gemm_s8.launches == before + 1
    assert gq.dtype == torch.int8 and torch.equal(gq, wq), fa.rowquant_gemm_plan(m, n, k).route
    assert gs.shape == (m,) and torch.equal(gs, ws)


def test_gelu_rowquant_zero_rows_and_one_large_column(cuda):
    """Rows of zeros (the 1e-12 floor of the scale) and rows whose absmax
    sits in one block of the cluster (a large column in the fourth of six),
    bit for bit."""
    m, n, k = 130, 3072, 768
    a, bt, rs, cs, bias = _gemm_operands(m, n, k, torch.int8, 7)
    a[::3] = 0
    bias = torch.zeros_like(bias)
    cs = cs.clone()
    cs[2000] *= 50
    gq, gs = fa.gemm_s8(a, bt, rs, cs, bias, torch.int8, fa.GELU_ROWQUANT)
    wq, ws = fa.gemm_s8_reference(a, bt, rs, cs, bias, torch.int8, fa.GELU_ROWQUANT)
    torch.cuda.synchronize()
    assert torch.equal(gq, wq) and torch.equal(gs, ws)
    assert float(gs[0]) == float(torch.tensor(1e-12) / torch.tensor(127.0))


# The row pass at the widths of the layers (64 in tests; 512, 768, 1024 in
# the presets), at widths that are not a multiple of a warp's 16-byte vectors
# (192, 320, 832) and at rows of several warps (4160, 12288: quant_dense's K
# and the two-launch route's hidden rows).
ROW_WIDTHS = (64, 192, 320, 512, 768, 832, 1024, 4160, 12288)


@pytest.mark.parametrize("width", ROW_WIDTHS)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_row_pass_matches_plain(cuda, width, dtype):
    """rowquant alone is bit for bit (the same correctly rounded division and
    the same max); with the LayerNorm the f32 sums run in another order than
    torch's mean, so a value on an int8 rounding boundary may land one level
    away: at most one level, on at most 0.1 % of the elements, and row scales
    within 2^-20 of each other (readings: none of either at these sizes)."""
    rng = np.random.default_rng(width)
    m = 77
    x = _x(rng, (m, width), cuda, dtype)
    ln_s = torch.from_numpy(1 + 0.1 * rng.normal(size=width).astype(np.float32)).to(cuda)
    ln_b = torch.from_numpy(0.1 * rng.normal(size=width).astype(np.float32)).to(cuda)
    before = fa.ln_rowquant.launches
    q, qs = fa.ln_rowquant(x, None, None)
    wq, ws = fa.ln_rowquant_reference(x)
    torch.cuda.synchronize()
    assert fa.ln_rowquant.launches == before + 1
    assert torch.equal(q, wq) and torch.equal(qs, ws)
    q, qs = fa.ln_rowquant(x, ln_s, ln_b)
    wq, ws = fa.ln_rowquant_reference(x, ln_s, ln_b)
    torch.cuda.synchronize()
    off = (q.int() - wq.int()).abs()
    assert int(off.max()) <= 1 and float((off > 0).float().mean()) <= 1e-3
    assert float(((qs - ws).abs() / ws).max()) <= 2.0 ** -20


def test_row_pass_writes_nothing_past_its_rows(cuda):
    """Eight rows a block: the last block's rows past m store nothing."""
    x = _x(np.random.default_rng(1), (13, 768), cuda, "bfloat16")
    from image_retrieval_tpu_torch.ops._build import load_library

    q = torch.full((16, 768), 7, dtype=torch.int8, device=cuda)
    s = torch.full((16,), 7.0, device=cuda)
    want_q, want_s = fa.ln_rowquant_reference(x)
    stream = torch.cuda.current_stream().cuda_stream
    assert load_library().irt_ln_rowquant(x.data_ptr(), None, None, q.data_ptr(), s.data_ptr(),
                                          13, 768, 0, 0, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(q[:13], want_q) and torch.equal(s[:13], want_s)
    assert bool((q[13:] == 7).all()) and bool((s[13:] == 7.0).all())


# K1, K2a and K2b at the presets' tower shapes (a few images or texts each):
# the MLP half on the fused route at every hidden width of the presets
TOWER_SHAPES = [(4, 50, 768, 12, False), (4, 77, 512, 8, True), (2, 257, 1024, 16, False),
                (4, 77, 768, 12, True)]


@pytest.mark.parametrize("b,t,w,heads,causal", TOWER_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("entry", ["layer_block_int8", "attention_block_int8",
                                   "mlp_block_int8"])
def test_int8_chains_match_plain_at_the_tower_shapes(cuda, entry, b, t, w, heads, causal,
                                                     dtype):
    rng = np.random.default_rng(w + t)
    wts = _layer_weights(rng, w, cuda)
    x = _x(rng, (b, t, w), cuda, dtype)
    if entry == "layer_block_int8":
        got = fa.layer_block_int8(x, wts, heads, causal)
        want = fa.layer_block_int8_reference(x, wts, heads, causal)
    elif entry == "attention_block_int8":
        got = fa.attention_block_int8(x, wts.attn, heads, causal)
        want = fa.attention_block_int8_reference(x, wts.attn, heads, causal)
    else:
        got = fa.mlp_block_int8(x, wts.mlp)
        want = fa.mlp_block_int8_reference(x, wts.mlp)
    torch.cuda.synchronize()
    r = fa.kernel_agreement(got, want, x)
    assert r["ok"], r


@pytest.mark.parametrize("b,t,w,heads,causal", [(3, 50, 768, 12, False),
                                                (3, 77, 512, 8, True),
                                                (2, 257, 1024, 16, False),
                                                (3, 13, 64, 2, True),
                                                (2, 257, 1024, 16, True)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_subblocks_compose_to_the_layer_kernel_on_both_routes(cuda, b, t, w, heads, causal,
                                                              dtype):
    """K2a then K2b equal K1 bit for bit where fc1 is one clustered launch
    (hidden 2048-4096) and where it is two (hidden 256)."""
    rng = np.random.default_rng(w)
    wts = _layer_weights(rng, w, cuda)
    x = _x(rng, (b, t, w), cuda, dtype)
    two = fa.mlp_block_int8(fa.attention_block_int8(x, wts.attn, heads, causal), wts.mlp)
    one = fa.layer_block_int8(x, wts, heads, causal)
    torch.cuda.synchronize()
    assert torch.equal(two, one)


@pytest.mark.parametrize("m,n", [(1, 64), (63, 192), (65, 64), (400, 192), (129, 1024)])
def test_gemm_writes_nothing_past_row_m(cuda, m, n):
    """TMA reads whole tiles, zero-filled past M; the epilogue stores rows
    below M only: a guard band after the output keeps its bits."""
    k = 192
    a, bt, bias = _gemm_operands(m, n, k, torch.bfloat16, 3)
    buf = torch.full((m + 64, n), 7.0, dtype=torch.bfloat16, device=cuda)
    fa.gemm_bf16(a, bt, bias, "gelu", out=buf[:m])
    a8, bt8, rs, cs, b8 = _gemm_operands(m, n, k, torch.int8, 3)
    buf32 = torch.full((m + 64, n), 7.0, device=cuda)
    fa.gemm_s8(a8, bt8, rs, cs, b8, torch.float32, "bias", out=buf32[:m])
    torch.cuda.synchronize()
    assert torch.equal(buf[:m], fa.gemm_bf16(a, bt, bias, "gelu"))
    assert torch.equal(buf32[:m], fa.gemm_s8_reference(a8, bt8, rs, cs, b8, torch.float32))
    assert bool((buf[m:] == 7.0).all()) and bool((buf32[m:] == 7.0).all())


def test_gemm_wrappers_reject_what_the_kernel_refuses(cuda):
    a, bt, bias = _gemm_operands(8, 128, 128, torch.bfloat16, 1)
    a8, bt8, rs, cs, b8 = _gemm_operands(8, 128, 128, torch.int8, 1)
    with pytest.raises(ValueError, match="multiples of 64"):
        fa.gemm_bf16(a[:, :96].contiguous(), bt[:, :96].contiguous(), bias)
    with pytest.raises(ValueError, match="multiples of 64"):
        fa.gemm_s8(a8, bt8[:96].contiguous(), rs, cs[:96], b8[:96], torch.float32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.gemm_bf16(torch.zeros(8 * 128 + 1, dtype=torch.bfloat16, device=cuda)[1:]
                     .view(8, 128), bt, bias)
    with pytest.raises(ValueError, match="contiguous"):
        fa.gemm_bf16(a, bt.t().contiguous().t(), bias)
    with pytest.raises(ValueError, match="residual"):
        fa.gemm_bf16(a, bt, bias, "residual")
    with pytest.raises(ValueError, match="residual"):
        fa.gemm_s8(a8, bt8, rs, cs, b8, torch.float32, "bias", torch.zeros(8, 128, device=cuda))
    with pytest.raises(TypeError, match="int8"):
        fa.gemm_s8(a, bt, rs, cs, b8, torch.float32)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        fa.gemm_s8(a8, bt8, rs, cs, b8, torch.float16)


def test_wrappers_reject_bad_input(cuda):
    wts = _layer_weights(np.random.default_rng(2), 128, cuda)
    x = torch.zeros(2, 6, 128, device=cuda)
    for fn, args in ((fa.attention_block_int8, (wts.attn, 2)), (fa.mlp_block_int8, (wts.mlp,))):
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.transpose(0, 1), *args)
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            fn(x.half(), *args)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(torch.zeros(2 * 6 * 128 + 1, device=cuda)[1:].reshape(2, 6, 128), *args)
    with pytest.raises(ValueError, match="head_dim"):
        fa.attention_block_int8(x, wts.attn, 64)  # head_dim 2
    with pytest.raises(ValueError, match="do not fit"):
        fa.tiled_attention(torch.zeros(600, 3 * 64, device=cuda), 1, 1)
    with pytest.raises(ValueError, match="do not fit"):  # bf16 K and V fit up to 768 tokens
        fa.tiled_attention(torch.zeros(800, 3 * 64, dtype=torch.bfloat16, device=cuda), 1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        fa.quant_dense(x[:, :, ::2], wts.wo_t, wts.wo_s, wts.bo, torch.float32)
    with pytest.raises(ValueError, match="expected"):
        fa.quant_dense(x, wts.w1_t.t(), wts.wo_s, wts.bo, torch.float32)
    bad = dataclasses.replace(wts.mlp, w1_t=wts.mlp.w1_t.cpu())
    with pytest.raises(ValueError, match="must be contiguous on"):
        fa.mlp_block_int8(x, bad)


def test_entry_points_default_to_the_card(cuda):
    from image_retrieval_tpu_torch.index import ShardedVectorIndex

    assert ShardedVectorIndex(dim=8).device.type == "cuda"


def test_serving_towers_cuda_vs_cpu(cuda):
    from image_retrieval_tpu_torch.config import Config, ModelConfig, serving_config
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder
    from image_retrieval_tpu_torch.models.tokenizer import get_tokenizer

    cfg = Config(model=serving_config(ModelConfig(
        image_size=64, patch_size=32, vision_width=128, vision_layers=2,
        vision_heads=2, text_width=64, text_layers=2, text_heads=1,
        vocab_size=get_tokenizer().vocab_size, context_length=16, embed_dim=32,
        dtype="bfloat16")))
    gpu_enc = CLIPEncoder(cfg, seed=4, device=cuda)
    cpu_enc = CLIPEncoder(cfg, seed=4, device="cpu")
    px = np.random.default_rng(2).integers(0, 256, size=(5, 64, 64, 3), dtype=np.uint8)
    texts = ["a red car", "two dogs", "an empty street at night"]
    before = fa.layer_block_int8.launches
    got_i, got_t = gpu_enc.encode_pixels(px), gpu_enc.encode_texts(texts)
    assert fa.layer_block_int8.launches == before + 4  # 2 + 2 layers, one batch each
    for got, want in ((got_i, cpu_enc.encode_pixels(px)), (got_t, cpu_enc.encode_texts(texts))):
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_index_cuda_matches_cpu(cuda, dtype):
    from image_retrieval_tpu_torch.config import IndexConfig
    from image_retrieval_tpu_torch.index import ShardedVectorIndex

    rng = np.random.default_rng(3)
    emb = rng.normal(size=(5000, 64)).astype(np.float32)
    emb[100] = emb[7]  # a tie
    q = np.concatenate([emb[7:8], rng.normal(size=(9, 64)).astype(np.float32)])
    out = []
    for dev in (cuda, "cpu"):
        ix = ShardedVectorIndex(dim=64, config=IndexConfig(embedding_dim=64, dtype=dtype),
                                device=dev)
        ix.insert([str(i) for i in range(len(emb))], emb)
        ix.delete_rows([3, 4])
        out.append(ix.search(q, top_k=20))
    np.testing.assert_array_equal(out[0][1], out[1][1])
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=0, atol=1e-5)
    assert list(out[0][1][0, :2]) == [7, 100]


def _int4_gallery(rng, n, d, device):
    from image_retrieval_tpu_torch.ops.int4 import quantize_pack_int4

    rows = rng.normal(size=(n, d)).astype(np.float32)
    rows /= np.linalg.norm(rows, axis=1, keepdims=True)
    packed, scales = quantize_pack_int4(rows)
    valid = rng.random(n) >= 0.05
    return (torch.from_numpy(packed).to(device), torch.from_numpy(scales).to(device),
            torch.from_numpy(valid).to(device))


@pytest.mark.parametrize("d", [64, 512, 768, 40])
@pytest.mark.parametrize("nq", [1, 3, 64, 130, 257])
def test_int4_screen_kernel_matches_plain(cuda, d, nq):
    from image_retrieval_tpu_torch.ops import int4_screen as k3

    rng = np.random.default_rng(d * 1000 + nq)
    n = 3 * 128 + 37  # ragged: not a multiple of the 128-row tile
    packed, scales, valid = _int4_gallery(rng, n, d, cuda)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[nq // 2] = 0.0  # a zero query scores 0 on every valid row
    qu = torch.from_numpy(q).to(cuda, torch.bfloat16)
    for off, rows in ((0, n), (131, n - 131 - 5)):
        before = k3.int4_screen_scores.launches
        got = k3.int4_screen_scores(qu, packed, scales, valid, off, rows)
        want = k3.int4_screen_scores_reference(qu, packed, scales, valid, off, rows)
        torch.cuda.synchronize()
        assert k3.int4_screen_scores.launches == before + 1
        assert got.shape == (nq, rows)
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), fin)
        assert torch.equal(fin[0], valid[off: off + rows])
        assert float((got[fin] - want[fin]).abs().max()) <= k3.SCREEN_MAX_ABS
        assert float(got[nq // 2][fin[nq // 2]].abs().max()) == 0.0


@pytest.mark.parametrize("d", [64, 512, 768, 40, 42])
@pytest.mark.parametrize("nq", [1, 3, 64, 130, 257])
def test_int4_screen_i8_kernel_matches_plain_bitwise(cuda, d, nq):
    """The int8-query screen: an exact int32 sum, converted exactly, times
    the row scale in one f32 multiply on both sides: bit for bit."""
    from image_retrieval_tpu_torch.ops import int4_screen as k3

    rng = np.random.default_rng(d * 1000 + nq)
    n = 3 * 128 + 37
    packed, scales, valid = _int4_gallery(rng, n, d, cuda)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    if nq > 1:
        q[nq // 2] = 0.0  # an all-zero query quantizes to zeros and scores 0
    q8, qs = k3.quantize_queries_i8(torch.from_numpy(q).to(cuda))
    assert q8.dtype == torch.int8 and int(q8.abs().max()) == 127 and qs.shape == (nq, 1)
    for off, rows in ((0, n), (131, n - 131 - 5)):
        before = k3.int4_screen_scores_i8.launches, k3.int4_screen_scores.launches
        got = k3.int4_screen_scores_i8(q8, packed, scales, valid, off, rows)
        want = k3.int4_screen_scores_i8_reference(q8, packed, scales, valid, off, rows)
        torch.cuda.synchronize()
        assert k3.int4_screen_scores_i8.launches == before[0] + 1
        assert k3.int4_screen_scores.launches == before[1]
        assert got.shape == (nq, rows) and torch.equal(got, want)
        assert torch.equal(torch.isfinite(got)[0], valid[off: off + rows])
    # extreme values: every query entry +-127 against every nibble
    q8 = torch.from_numpy(rng.choice([-127, 127], size=(nq, d)).astype(np.int8)).to(cuda)
    assert torch.equal(k3.int4_screen_scores_i8(q8, packed, scales, valid),
                       k3.int4_screen_scores_i8_reference(q8, packed, scales, valid))


# The ring's edges, each as (n, d, nq, row_offset, rows, what is special):
# more tiles than one persistent wave of 132 blocks with a ragged tail; several
# passes over each tile (the queries reloaded per pass); query rows that do
# not fit over the whole of D (reloaded per window of boxes, bf16 only: int8
# rows always do at D <= 2048); a segment whose rows are all invalid; a
# row_offset whose rows start off 16 bytes at D = 40, and a packed base off
# 16 bytes at D = 512 (both take the copying producer); the last segment of a
# gallery; the largest D of the int8 form.
RING_EDGES = {
    "waves": (2 * 132 * 256 + 1036, 512, 8, 0, 2 * 132 * 256 + 1036),
    "waves-offset": (2 * 132 * 256 + 1037, 512, 33, 517, 2 * 132 * 256 + 1037 - 517 - 3),
    "passes": (3000, 512, 257, 211, 2700),
    "windows": (700, 2560, 70, 5, 690),
    "all-invalid": (2000, 512, 16, 256, 1024),
    "unaligned-rows-d40": (1500, 40, 5, 3, 1400),
    "unaligned-base-d512": (1500, 512, 9, 0, 1500),
    "last-segment": (5000, 512, 64, 4096, 5000 - 4096),
    "d2048": (900, 2048, 40, 100, 777),
}


@pytest.mark.parametrize("case,qform", [(c, f) for c in RING_EDGES for f in ("bf16", "i8")
                                        if RING_EDGES[c][1] <= 2048 or f == "bf16"])
def test_int4_screen_ring_edges(cuda, case, qform):
    """Both forms against their plain versions at the ring's edges: K3 within
    SCREEN_MAX_ABS with the same -inf pattern, K12 bit for bit; the plan
    takes the producer and the query mode the case names."""
    from image_retrieval_tpu_torch.ops import int4_screen as k3

    n, d, nq, off, rows = RING_EDGES[case]
    rng = np.random.default_rng(n + d + nq)
    packed, scales, valid = _int4_gallery(rng, n, d, cuda)
    if case == "all-invalid":
        valid[off: off + rows] = False
    if case == "unaligned-base-d512":  # the same rows 8 bytes past a 16-byte boundary
        buf = torch.empty(packed.numel() + 8, dtype=torch.uint8, device=cuda)
        packed = buf[8:].view(packed.shape).copy_(packed)
        assert packed.data_ptr() % 16 == 8
    q = rng.normal(size=(nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    plan = k3.int4_screen_plan(nq, d, rows, off, packed.data_ptr() % 16 == 0, qform)
    assert plan.tma == (case not in ("unaligned-rows-d40", "unaligned-base-d512"))
    assert (plan.tiles > plan.grid) == case.startswith("waves")
    assert (plan.passes > 1) == (nq > 64)
    assert plan.q_boxes < plan.boxes or case != "windows"
    if qform == "i8":
        q8, _ = k3.quantize_queries_i8(torch.from_numpy(q).to(cuda))
        got = k3.int4_screen_scores_i8(q8, packed, scales, valid, off, rows)
        want = k3.int4_screen_scores_i8_reference(q8, packed, scales, valid, off, rows)
        torch.cuda.synchronize()
        assert got.shape == (nq, rows) and torch.equal(got, want)
    else:
        qu = torch.from_numpy(q).to(cuda, torch.bfloat16)
        got = k3.int4_screen_scores(qu, packed, scales, valid, off, rows)
        want = k3.int4_screen_scores_reference(qu, packed, scales, valid, off, rows)
        torch.cuda.synchronize()
        fin = torch.isfinite(want)
        assert got.shape == (nq, rows) and torch.equal(torch.isfinite(got), fin)
        if fin.any():
            assert float((got[fin] - want[fin]).abs().max()) <= k3.SCREEN_MAX_ABS
    assert torch.equal(torch.isinf(got)[0], ~valid[off: off + rows])
    if case == "all-invalid":
        assert bool((got == float("-inf")).all())


def test_int4_screen_plan_matches_the_kernel(cuda):
    """ops/int4_screen.py::int4_screen_plan is the C side's launch plan, field
    by field, and both refuse the same shapes."""
    import ctypes

    from image_retrieval_tpu_torch.ops import int4_screen as k3
    from image_retrieval_tpu_torch.ops._build import load_library

    lib = load_library()
    got = (ctypes.c_int * 15)()
    for nq in (0, 1, 3, 8, 9, 16, 17, 33, 64, 65, 130, 257, 1000):
        for d in (0, 1, 2, 40, 42, 64, 512, 768, 2048, 2050, 2560, 8192, 16384, 65536):
            for rows, off in ((0, 0), (1, 0), (37, 1 << 23), (1 << 21, 0), (1 << 21, 3 << 21),
                              (5000, -1), (300, (1 << 31) - 200)):
                for aligned in (True, False):
                    for qform in k3.QFORMS:
                        for sms in (132, 114):
                            rc = lib.irt_int4_screen_plan(nq, d, rows, off, int(aligned),
                                                          int(qform == "i8"), sms, got)
                            try:
                                plan = k3.int4_screen_plan(nq, d, rows, off, aligned, qform, sms)
                            except ValueError:
                                plan = None
                            key = (nq, d, rows, off, aligned, qform, sms)
                            assert (rc == 0) == (plan is not None), key
                            if plan is not None:
                                assert tuple(got) == dataclasses.astuple(plan), key


def test_int4_screen_topc_i8_ranks_like_bf16(cuda):
    """qform="i8" through the kernel: the plain version's ids and values, and
    the bf16 form's neighbours up to the int8 query grid."""
    from image_retrieval_tpu_torch.ops import int4_screen as k3

    rng = np.random.default_rng(5)
    n, d, nq, c = 5000, 512, 7, 32
    packed, scales, valid = _int4_gallery(rng, n, d, cuda)
    q = rng.normal(size=(nq, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    qu = torch.from_numpy(q).to(cuda, torch.bfloat16)
    v8, i8 = k3.int4_screen_topc(qu, packed, scales, valid, c, seg_rows=2048, qform="i8")
    vc, ic = k3.int4_screen_topc(qu.cpu(), packed.cpu(), scales.cpu(), valid.cpu(), c,
                                 seg_rows=2048, qform="i8")
    assert torch.equal(i8.cpu(), ic) and torch.equal(v8.cpu(), vc)
    vb, ib = k3.int4_screen_topc(qu, packed, scales, valid, c, seg_rows=2048)
    overlap = np.mean([len(set(a.tolist()) & set(b.tolist())) / c
                       for a, b in zip(i8.cpu(), ib.cpu())])
    assert overlap >= 0.9, overlap
    assert float((v8[:, 0] - vb[:, 0]).abs().max()) <= 5e-3


def test_int4_screen_kernel_rejects_bad_input(cuda):
    from image_retrieval_tpu_torch.ops import int4_screen as k3

    packed, scales, valid = _int4_gallery(np.random.default_rng(0), 256, 64, cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        k3.int4_screen_scores(torch.zeros(2, 64, device=cuda), packed, scales, valid)
    with pytest.raises(ValueError, match="dim"):
        k3.int4_screen_scores(torch.zeros(2, 32, device=cuda, dtype=torch.bfloat16),
                              packed, scales, valid)


@pytest.mark.parametrize("d", [64, 512])
def test_int4_index_cuda_modes_match_cpu(cuda, d):
    from image_retrieval_tpu_torch.config import IndexConfig
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.ops import int4_screen as k3

    rng = np.random.default_rng(5)
    n = 5000
    emb = rng.normal(size=(n, d)).astype(np.float32)
    attrs = {"bucket": np.arange(n) % 8}
    q = np.concatenate([rng.normal(size=(9, d)).astype(np.float32),
                        np.zeros((1, d), np.float32)])
    out = {}
    for name, dev, kw in (("host", cuda, {}), ("device", cuda, {"rerank_device": True}),
                          ("cpu", "cpu", {})):
        ix = ShardedVectorIndex(dim=d, config=IndexConfig(
            embedding_dim=d, dtype="int4", rerank_c=128, capacity_step=4096, **kw),
            device=dev)
        ix.insert([str(i) for i in range(n)], emb, attrs=attrs)
        ix.delete_rows(np.arange(0, n, 11))
        before = k3.int4_screen_scores.launches
        out[name] = (ix.search(q, top_k=10), ix.search(q[0], top_k=40, flt="bucket == 3"))
        if dev != "cpu":
            assert k3.int4_screen_scores.launches == before + 2  # one segment each
    for name in ("device", "cpu"):
        for (gv, gi), (wv, wi) in zip(out[name], out["host"]):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)
    (_, _), (fv, fi) = out["host"]
    assert ((fi % 8 == 3) & (fi % 11 != 0)).all()


# ---- the fused metric kernels (K4, K5, K6, K7) -------------------------------

FUSED_WEIGHTS = [(1.0, 1.0, 1.0, 0.0, 0.5), (1.0, 0.0, 0.0, 0.0, 0.0),
                 (0.3, 0.2, 0.5, 0.7, 0.1), (0.0, 0.0, 0.0, 1.0, 0.0),
                 (0.0, 0.0, 0.0, 0.0, 1.0)]


def _fused_inputs(cuda, n, nq, d, seed=0):
    """Unit rows with magnitudes in [0.5, 4], rows 3 and 70 identical, and
    unnormalized queries, the last equal to stored row 5."""
    rng = np.random.default_rng(seed)
    g = rng.standard_normal((n, d)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    m = rng.uniform(0.5, 4.0, n).astype(np.float32)
    g[70], m[70] = g[3], m[3]
    q = (rng.standard_normal((nq, d)) * 0.4).astype(np.float32)
    q[-1] = g[5] * m[5]
    return tuple(torch.from_numpy(a).to(cuda) for a in (q, g, m))


def _fused_limit(fm, want, q, g, m, w_l2, scales=None):
    from image_retrieval_tpu_torch.ops import metrics as M

    qn = torch.linalg.vector_norm(q, dim=1, keepdim=True)
    unit = g.float() if scales is None else g.float() * scales[:, None]
    sq = M.gram_sq(m, q @ unit.t(), qn)
    return fm.score_limit(want, w_l2, fm.gram_l2_slack(sq, m, qn, q.shape[1]))


@pytest.mark.parametrize("d", [512, 768, 40])
@pytest.mark.parametrize("nq", [1, 3, 64, 70])
def test_fused_all_metrics_kernel_matches_plain(cuda, d, nq):
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    q, g, m = _fused_inputs(cuda, 1000, nq, d)
    before = fm.fused_all_metrics.launches
    got = fm.fused_all_metrics(q, g, m)
    want = fm.fused_all_metrics_reference(q, g, m)
    torch.cuda.synchronize()
    assert fm.fused_all_metrics.launches == before + 1
    r = fm.scores_agree(got, want, fm.score_limit(want))
    assert r["ok"], r
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])  # Linf, |dmag|


@pytest.mark.parametrize("d", [512, 768, 40])
@pytest.mark.parametrize("nq", [1, 64, 70])
@pytest.mark.parametrize("w", FUSED_WEIGHTS[:3])
def test_fused_optimized_scores_kernel_matches_plain(cuda, d, nq, w):
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    q, g, m = _fused_inputs(cuda, 1000, nq, d)
    before = fm.fused_optimized_scores.launches
    got = fm.fused_optimized_scores(q, g, m, torch.tensor(w, device=cuda))
    want = fm.fused_optimized_scores_reference(q, g, m, w)
    torch.cuda.synchronize()
    assert fm.fused_optimized_scores.launches == before + 1
    r = fm.scores_agree(got, want, _fused_limit(fm, want, q, g, m, w[2]))
    assert r["ok"], r


@pytest.mark.parametrize("d", [512, 768, 40])
@pytest.mark.parametrize("nq", [1, 64, 70])
@pytest.mark.parametrize("w", FUSED_WEIGHTS)
def test_fused_int8_kernel_matches_plain(cuda, d, nq, w):
    from image_retrieval_tpu_torch.index.vector_index import quantize_int8
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    q, g, m = _fused_inputs(cuda, 1000, nq, d)
    g8, sc = (torch.from_numpy(a).to(cuda) for a in quantize_int8(g.cpu().numpy()))
    before = fm.fused_optimized_scores_int8_pallas.launches
    got = fm.fused_optimized_scores_int8_pallas_v2(q, g8, sc, m, w)
    want = fm.fused_optimized_scores_int8_reference(q, g8, sc, m, w)
    torch.cuda.synchronize()
    assert fm.fused_optimized_scores_int8_pallas.launches == before + 1
    r = fm.scores_agree(got, want, _fused_limit(fm, want, q, g8, m, w[2], sc))
    assert r["ok"], r
    if w[:3] == (0.0, 0.0, 0.0):  # Linf or |dmag| alone: the same operations, bit for bit
        assert torch.equal(got, want)


@pytest.mark.parametrize("rows", ["float32", "bfloat16"])
@pytest.mark.parametrize("nq,k", [(1, 10), (64, 10), (70, 64), (3, 1)])
@pytest.mark.parametrize("w", FUSED_WEIGHTS)
def test_fused_topk_kernel_matches_plain(cuda, rows, nq, k, w):
    from image_retrieval_tpu_torch.ops import fused_metrics as fm
    from image_retrieval_tpu_torch.ops import metrics as M

    n = 70_001  # not a multiple of the tile; 1094 tiles over 528 blocks
    q, g, m = _fused_inputs(cuda, n, nq, 512)
    g = g.to(getattr(torch, rows))
    before = fm.fused_optimized_topk.launches
    got_v, got_i = fm.fused_optimized_topk(q, g, m, w, k=k)
    want_v, want_i = fm.fused_optimized_topk_reference(q, g, m, w, k=k)
    torch.cuda.synchronize()
    assert fm.fused_optimized_topk.launches == before + 1
    assert got_i.dtype == torch.int32 and got_v.shape == (nq, k)
    plain = M.fused_optimized_scores_xla(q, g, m, w, exact_l2=False)
    lim = _fused_limit(fm, plain, q, g, m, w[2])
    r = fm.topk_agree(got_v, got_i, want_v, want_i.to(torch.int64), plain, lim)
    assert r["ok"], r


def test_fused_topk_kernel_small_gallery_and_limits(cuda):
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    q, g, m = _fused_inputs(cuda, 100, 2, 64)
    v, i = fm.fused_optimized_topk(q, g[:7], m[:7], FUSED_WEIGHTS[0], k=10)  # kk = N = 7
    wv, wi = fm.fused_optimized_topk_reference(q, g[:7], m[:7], FUSED_WEIGHTS[0], k=10)
    assert v.shape == (2, 7) and torch.equal(i, wi)
    np.testing.assert_allclose(v.cpu().numpy(), wv.cpu().numpy(), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="limit"):
        fm.fused_optimized_topk(q, g, m, FUSED_WEIGHTS[0], k=65)
    # all magnitudes equal and only |dmag| live: every row ties, lowest rows first
    v, i = fm.fused_optimized_topk(q, g, torch.ones_like(m), FUSED_WEIGHTS[4], k=5)
    assert i.tolist() == [[0, 1, 2, 3, 4]] * 2


@pytest.mark.parametrize("n,k", [(300, 64), (70_001, 10)])
def test_fused_topk_kernel_returns_rows_that_score_minus_inf(cuda, n, k):
    """Fewer finite scores than k: a row of infinite magnitude scores -inf
    and is returned under its own row number, lowest rows first, as the
    plain version returns it; a NaN query ranks every row at -inf."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    q, g, m = _fused_inputs(cuda, n, 3, 512)
    finite = [2, 9, n // 2, n - 1]
    minf = torch.full_like(m, float("inf"))
    minf[finite] = m[finite]
    w = (1.0, 0.0, 0.0, 0.0, 0.5)  # no L2: inf - inf would make it NaN
    v, i = fm.fused_optimized_topk(q, g, minf, w, k=k)
    wv, wi = fm.fused_optimized_topk_reference(q, g, minf, w, k=k)
    assert torch.equal(i, wi)
    assert sorted(i[0, :4].tolist()) == finite and bool(torch.isfinite(v[:, :4]).all())
    assert bool(torch.isneginf(v[:, 4:]).all())
    rest = [r for r in range(k) if r not in finite][: k - 4]
    assert i[:, 4:].tolist() == [rest] * 3
    q[1] = float("nan")
    v, i = fm.fused_optimized_topk(q, g, m, w, k=k)
    assert i[1].tolist() == list(range(k)) and bool(torch.isneginf(v[1]).all())
    assert bool(((i >= 0) & (i < n)).all())


# ---------------------------------------------------------------------------
# The f32 sweep of K4, K6 and K7 (csrc/f32_sweep_sm90.cuh): the plan against
# the C side, and every kernel at the sweep's edges against its plain version
# ---------------------------------------------------------------------------


def test_f32_sweep_plan_matches_the_kernel(cuda):
    """ops/fused_metrics.py::f32_sweep_plan is the C side's launch plan,
    field by field, and both refuse the same shapes."""
    import ctypes

    from image_retrieval_tpu_torch.ops import fused_metrics as fm
    from image_retrieval_tpu_torch.ops._build import load_library

    lib = load_library()
    got = (ctypes.c_int * 17)()
    for nq in (0, 1, 8, 9, 33, 64, 65, 128, 129, 1000):
        for d in (0, 37, 40, 512, 768, 1024, 4096, 8192):
            for live in (31, 1, 3, 2, 8, 16, 4, 5, 17, 21):
                for row_bytes, kk in ((4, 0), (4, 10), (4, 64), (2, 10), (2, 65)):
                    for aligned in (True, False):
                        for n, sms in ((0, 132), (1, 132), (1000, 132), (1_001_344, 132),
                                       (5000, 114)):
                            rc = lib.irt_f32_sweep_plan(nq, n, d, row_bytes, live, kk,
                                                        int(aligned), sms, got)
                            try:
                                plan = fm._f32_plan(nq, n, d, row_bytes, live, kk, aligned, sms)
                            except ValueError:
                                plan = None
                            key = (nq, n, d, row_bytes, live, kk, aligned, sms)
                            assert (rc == 0) == (plan is not None), key
                            if plan is not None:
                                assert tuple(got) == dataclasses.astuple(plan), key


def test_fused_topk_refuses_a_plan_it_was_not_given(cuda):
    """K4 writes its candidate lists into buffers the caller sized from the
    Python plan: the C side refuses a call whose list count or padded-query
    copy is not its own plan's, so the two plans cannot part unnoticed."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm
    from image_retrieval_tpu_torch.ops._build import load_library

    lib = load_library()
    q, g, m = _fused_inputs(cuda, 3000, 9, 512)
    w = FUSED_WEIGHTS[0]
    plan = fm._device_plan(q, g, w, 10)
    assert plan.resident == 1 and plan.lists > 1
    qn = torch.linalg.vector_norm(q, dim=1)
    pad = fm._padded_queries(dataclasses.replace(plan, resident=0), q)
    cand_v = torch.empty((plan.lists + 1, 9, 10), dtype=torch.float32, device=cuda)
    cand_i = torch.empty((plan.lists + 1, 9, 10), dtype=torch.int32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def call(lists, qpad):
        return lib.irt_fused_optimized_topk(
            q.data_ptr(), qn.data_ptr(), qpad, g.data_ptr(), 0, m.data_ptr(), cand_v.data_ptr(),
            cand_i.data_ptr(), 9, 3000, 512, 10, lists, *w, fm._live_bits(w), stream)

    bad = 100000  # IRT_BAD_ARGS (csrc/fused_metrics.cuh)
    assert call(plan.lists - 1, None) == bad
    assert call(plan.lists + 1, None) == bad
    assert call(plan.lists, pad.data_ptr()) == bad  # resident queries given a padded copy
    assert call(plan.lists, None) == 0
    torch.cuda.synchronize()


def _unaligned_like(t):
    """A copy of t whose base is 4 bytes past a 16-byte boundary: the rows
    take the copying producer."""
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = flat[1: 1 + t.numel()].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 != 0
    return out


F32_EDGE_QUERIES = [1, 8, 33, 64, 65]


@pytest.mark.parametrize("d", [512, 768, 37])
@pytest.mark.parametrize("nq", F32_EDGE_QUERIES)
@pytest.mark.parametrize("n", [9, 1000])
def test_f32_sweep_all_metrics_at_the_edges(cuda, d, nq, n):
    """K6 at the sweep's query counts (one, a unit, a ragged group, a full
    pass, two passes), widths (D = 37 takes the copying producer) and a
    gallery below one tile: within score_limit, Linf and |dmag| bit for
    bit."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    q, g, m = _fused_inputs(cuda, max(n, 80), nq, d)
    g, m = g[:n].contiguous(), m[:n].contiguous()
    plan = fm.f32_sweep_plan(nq, n, d)
    assert plan.tma == (d % 4 == 0)
    got = fm.fused_all_metrics(q, g, m)
    want = fm.fused_all_metrics_reference(q, g, m)
    torch.cuda.synchronize()
    r = fm.scores_agree(got, want, fm.score_limit(want))
    assert r["ok"], r
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])  # Linf, |dmag|


@pytest.mark.parametrize("d", [512, 768, 37])
@pytest.mark.parametrize("nq", F32_EDGE_QUERIES)
def test_f32_sweep_scores_at_the_edges(cuda, d, nq):
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    q, g, m = _fused_inputs(cuda, 1000, nq, d)
    for w in FUSED_WEIGHTS[:3]:
        got = fm.fused_optimized_scores(q, g, m, torch.tensor(w, device=cuda))
        want = fm.fused_optimized_scores_reference(q, g, m, w)
        torch.cuda.synchronize()
        r = fm.scores_agree(got, want, _fused_limit(fm, want, q, g, m, w[2]))
        assert r["ok"], (w, r)


@pytest.mark.parametrize("rows", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [512, 768, 37])
@pytest.mark.parametrize("nq", F32_EDGE_QUERIES)
@pytest.mark.parametrize("k", [1, 10, 64])
def test_f32_sweep_topk_at_the_edges(cuda, rows, d, nq, k):
    """K4 over f32 and bf16 rows at the sweep's edges, every live case that
    picks a unit width (cosine alone: 32 queries a unit; L1 live: 8; |dmag|
    alone: no sweep), against the plain version by topk_agree."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm
    from image_retrieval_tpu_torch.ops import metrics as M

    q, g, m = _fused_inputs(cuda, 3001, nq, d)
    g = g.to(getattr(torch, rows))
    for w in (FUSED_WEIGHTS[1], FUSED_WEIGHTS[0], FUSED_WEIGHTS[2], FUSED_WEIGHTS[4]):
        got_v, got_i = fm.fused_optimized_topk(q, g, m, w, k=k)
        want_v, want_i = fm.fused_optimized_topk_reference(q, g, m, w, k=k)
        torch.cuda.synchronize()
        plain = M.fused_optimized_scores_xla(q, g, m, w, exact_l2=False)
        r = fm.topk_agree(got_v, got_i, want_v, want_i.to(torch.int64), plain,
                          _fused_limit(fm, plain, q, g, m, w[2]))
        assert r["ok"], (w, r)


@pytest.mark.parametrize("rows", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [1, 5, 15, 17])
def test_f32_sweep_topk_gallery_below_a_unit(cuda, rows, n):
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    from image_retrieval_tpu_torch.ops import metrics as M

    q, g, m = _fused_inputs(cuda, 80, 3, 512)
    g, m = g[:n].to(getattr(torch, rows)).contiguous(), m[:n].contiguous()
    for w in FUSED_WEIGHTS:
        v, i = fm.fused_optimized_topk(q, g, m, w, k=10)
        wv, wi = fm.fused_optimized_topk_reference(q, g, m, w, k=10)
        assert v.shape == (3, min(n, 10)) and torch.equal(i, wi), (w, i, wi)
        plain = M.fused_optimized_scores_xla(q, g, m, w, exact_l2=False)
        r = fm.topk_agree(v, i, wv, wi.to(torch.int64), plain,
                          _fused_limit(fm, plain, q, g, m, w[2]))
        assert r["ok"], (w, r)


@pytest.mark.parametrize("what", ["all_metrics", "scores", "topk"])
def test_f32_sweep_unaligned_rows_and_wide_rows(cuda, what):
    """Rows whose base is not 16-byte aligned take the copying producer;
    rows too wide for a pass of queries in shared memory take the padded
    copy of the queries in device memory."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm
    from image_retrieval_tpu_torch.ops import metrics as M

    for nq, d, unaligned in ((9, 512, True), (64, 8192, False), (3, 8200, True)):
        q, g, m = _fused_inputs(cuda, 700, nq, d)
        if unaligned:
            g = _unaligned_like(g)
        plan = fm.f32_sweep_plan(nq, 700, d, None if what != "topk" else FUSED_WEIGHTS[0],
                                 k=0 if what != "topk" else 10, aligned=not unaligned)
        assert plan.tma == int(not unaligned) and plan.resident == int(d < 8192)
        if what == "all_metrics":
            got, want = fm.fused_all_metrics(q, g, m), fm.fused_all_metrics_reference(q, g, m)
            assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])
            r = fm.scores_agree(got, want, fm.score_limit(want))
        elif what == "scores":
            w = FUSED_WEIGHTS[2]
            got = fm.fused_optimized_scores(q, g, m, torch.tensor(w, device=cuda))
            want = fm.fused_optimized_scores_reference(q, g, m, w)
            r = fm.scores_agree(got, want, _fused_limit(fm, want, q, g, m, w[2]))
        else:
            w = FUSED_WEIGHTS[0]
            got_v, got_i = fm.fused_optimized_topk(q, g, m, w, k=10)
            want_v, want_i = fm.fused_optimized_topk_reference(q, g, m, w, k=10)
            plain = M.fused_optimized_scores_xla(q, g, m, w, exact_l2=False)
            r = fm.topk_agree(got_v, got_i, want_v, want_i.to(torch.int64), plain,
                              _fused_limit(fm, plain, q, g, m, w[2]))
        torch.cuda.synchronize()
        assert r["ok"], (nq, d, r)


def test_f32_sweep_linf_bits_at_far_apart_exponents(cuda):
    """Linf is a max of the same rounded differences on both sides, so it is
    the plain version's bits even where a row value and a query value are
    far apart in size."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    q, g, m = _fused_inputs(cuda, 500, 33, 768)
    q[:, ::7] *= 1e-20
    g[::3, ::5] *= 1e-12
    m[::11] = 1e6
    got, want = fm.fused_all_metrics(q, g, m), fm.fused_all_metrics_reference(q, g, m)
    torch.cuda.synchronize()
    assert torch.equal(got[3], want[3]) and torch.equal(got[4], want[4])


# ---------------------------------------------------------------------------
# K5's sweep (csrc/int8_sweep_sm90.cuh): every live case, query count, row
# count and width against the plain version
# ---------------------------------------------------------------------------


def _live_case_weights(case):
    """Weights whose live sums are those of the kernel's case: bit 0 the
    product (cosine and the Gram-form L2), bit 1 the L1 sum, bit 2 the Linf
    max; |dmag| is always live."""
    dot, l1, linf = case & 1, case & 2, case & 4
    return (0.8 if dot else 0.0, 0.6 if l1 else 0.0, 0.4 if dot else 0.0,
            0.7 if linf else 0.0, 0.3)


def _int8_inputs(cuda, n, nq, d, seed=0):
    from image_retrieval_tpu_torch.index.vector_index import quantize_int8

    q, g, m = _fused_inputs(cuda, n, nq, d, seed)
    g8, sc = (torch.from_numpy(a).to(cuda) for a in quantize_int8(g.cpu().numpy()))
    return q, g8, sc, m


def _k5_agrees(fm, q, g8, sc, m, w):
    """One K5 launch against the plain version: within score_limit, Linf and
    |dmag| alone bit for bit; returns the kernel's scores."""
    before = fm.fused_optimized_scores_int8_pallas.launches
    got = fm.fused_optimized_scores_int8_pallas(q, g8, sc, m, w)
    want = fm.fused_optimized_scores_int8_reference(q, g8, sc, m, w)
    torch.cuda.synchronize()
    assert fm.fused_optimized_scores_int8_pallas.launches == before + 1
    assert got.shape == want.shape == (q.shape[0], g8.shape[0])
    r = fm.scores_agree(got, want, _fused_limit(fm, want, q, g8, m, w[2], sc))
    assert r["ok"], r
    if w[:3] == (0.0, 0.0, 0.0):  # Linf or |dmag| alone: the same operations, bit for bit
        assert torch.equal(got, want)
    return got


def test_int8_sweep_plan_matches_the_kernel(cuda):
    """ops/fused_metrics.py::int8_sweep_plan is the C side's launch plan,
    field by field, and both refuse the same shapes."""
    import ctypes

    from image_retrieval_tpu_torch.ops import fused_metrics as fm
    from image_retrieval_tpu_torch.ops._build import load_library

    lib = load_library()
    got = (ctypes.c_int * 14)()
    for nq in (0, 1, 8, 9, 33, 64, 65, 128, 129, 300, 1000):
        for d in (0, 40, 64, 512, 768, 1024, 2048, 5248, 8192):
            for case in range(8):
                w = _live_case_weights(case)
                for aligned in (True, False):
                    for n, sms in ((0, 132), (1, 132), (1000, 132), (1_049_728, 132),
                                   (5000, 114)):
                        rc = lib.irt_int8_sweep_plan(nq, n, d, fm._live_bits(w), int(aligned),
                                                     sms, got)
                        try:
                            plan = fm.int8_sweep_plan(nq, n, d, w, aligned, sms)
                        except ValueError:
                            plan = None
                        assert (rc == 0) == (plan is not None), (nq, n, d, w, aligned)
                        if plan is not None:
                            assert tuple(got) == dataclasses.astuple(plan), (nq, n, d, w)


@pytest.mark.parametrize("d", [512, 768, 40])
@pytest.mark.parametrize("nq", [1, 8, 33, 64])
@pytest.mark.parametrize("case", range(8))
def test_int8_sweep_matches_plain(cuda, d, nq, case):
    """Every live case (the instantiation without the product, the L1 sum or
    the Linf max of a dead term) at a row count no tile size divides; D = 40
    takes the copying producer (rows of 40 bytes are no TMA stride)."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    w = _live_case_weights(case)
    q, g8, sc, m = _int8_inputs(cuda, 1000, nq, d)
    plan = fm.int8_sweep_plan(nq, 1000, d, w)
    assert plan.tma == (d % 16 == 0) and 1000 % plan.tile_rows != 0
    _k5_agrees(fm, q, g8, sc, m, w)


@pytest.mark.parametrize("n", [1, 5, 31, 33])
@pytest.mark.parametrize("case", [1, 3, 7, 4])
def test_int8_sweep_gallery_smaller_than_a_tile(cuda, n, case):
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    q, g8, sc, m = _int8_inputs(cuda, 80, 5, 768)
    _k5_agrees(fm, q, g8[:n].contiguous(), sc[:n].contiguous(), m[:n].contiguous(),
               _live_case_weights(case))


@pytest.mark.parametrize("d", [768, 40])
@pytest.mark.parametrize("case", [1, 3, 7])
def test_int8_sweep_queries_above_the_resident_limit(cuda, d, case):
    """The first query count whose passes do not all fit in shared memory:
    the consumers load each pass's queries before it, over the same tile."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    w = _live_case_weights(case)
    nq = next(k for k in range(9, 4096) if not fm.int8_sweep_plan(k, 700, d, w).resident)
    plan = fm.int8_sweep_plan(nq, 700, d, w)
    assert plan.resident == 0 and plan.passes > 1
    q, g8, sc, m = _int8_inputs(cuda, 700, nq, d)
    _k5_agrees(fm, q, g8, sc, m, w)


@pytest.mark.parametrize("d", [64, 768])
@pytest.mark.parametrize("case", [1, 7])
def test_int8_sweep_unaligned_rows_and_a_narrow_box(cuda, d, case):
    """Rows whose base is not 16-byte aligned take the copying producer at
    any d; d = 64 is a TMA box wider than the rows."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    w = _live_case_weights(case)
    q, g8, sc, m = _int8_inputs(cuda, 300, 9, d)
    _k5_agrees(fm, q, g8, sc, m, w)
    flat = torch.empty(g8.numel() + 1, dtype=torch.int8, device=cuda)
    odd = flat[1:].view(g8.shape)
    odd.copy_(g8)
    assert odd.data_ptr() % 16 != 0 and fm.int8_sweep_plan(9, 300, d, w, False).tma == 0
    assert torch.equal(fm.fused_optimized_scores_int8_pallas(q, odd, sc, m, w),
                       fm.fused_optimized_scores_int8_pallas(q, g8, sc, m, w))


@pytest.mark.parametrize("case", [1, 3, 5])
def test_int8_sweep_wide_rows(cuda, case):
    """3072-dim rows: the product alone takes 16-query units (32 do not fit
    beside the stages), and every live case takes several passes, each
    pass's queries loaded before it."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    w = _live_case_weights(case)
    plan = fm.int8_sweep_plan(64, 300, 3072, w)
    assert plan.qw == (16 if case == 1 else 8) and plan.resident == 0 and plan.passes > 1
    q, g8, sc, m = _int8_inputs(cuda, 300, 64, 3072)
    _k5_agrees(fm, q, g8, sc, m, w)


@pytest.mark.parametrize("case", [2, 4, 6, 7])
def test_int8_sweep_far_apart_exponents(cuda, case):
    """Query values 2^-30 and 2^20 times the rows' (and a zero query): the
    bf16 difference of values whose exponents lie more than 16 apart rounds
    once in the kernel and twice in the plain version, to the same value."""
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    q, g8, sc, m = _int8_inputs(cuda, 500, 8, 768)
    q[0] *= 2.0 ** -30
    q[1] *= 2.0 ** 20
    q[2, ::2] *= 2.0 ** -24
    q[3] = 0.0
    w = _live_case_weights(case)
    got = _k5_agrees(fm, q, g8, sc, m, w)
    linf = (0.0, 0.0, 0.0, 1.0, 0.0)
    assert torch.equal(fm.fused_optimized_scores_int8_pallas(q, g8, sc, m, linf),
                       fm.fused_optimized_scores_int8_reference(q, g8, sc, m, linf))
    assert bool(torch.isfinite(got).all())


def test_int8_sweep_zero_norm_query_scores_cosine_zero(cuda):
    from image_retrieval_tpu_torch.ops import fused_metrics as fm

    q, g8, sc, m = _int8_inputs(cuda, 400, 3, 512)
    q[1] = 0.0
    got = _k5_agrees(fm, q, g8, sc, m, (1.0, 0.0, 0.0, 0.0, 0.0))
    assert bool((got[1] == 0.0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_index_metrics_cuda_match_cpu(cuda, dtype):
    """Every metric of the index on the card (the int8 weighted score and the
    multi-metric planes through the kernels) against the same index on CPU
    tensors (their plain versions)."""
    from image_retrieval_tpu_torch.config import IndexConfig
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.ops import fused_metrics as fm
    from image_retrieval_tpu_torch.ops.metrics import METRIC_NAMES

    rng = np.random.default_rng(3)
    emb = (rng.normal(size=(3000, 64)) * rng.uniform(0.5, 4, size=(3000, 1))).astype(np.float32)
    q = (rng.normal(size=(5, 64)) * 0.5).astype(np.float32)
    cfg = IndexConfig(embedding_dim=64, dtype=dtype, capacity_step=1024)
    both = [ShardedVectorIndex(dim=64, config=cfg, device=dev) for dev in ("cpu", cuda)]
    for ix in both:
        ix.insert([str(i) for i in range(3000)], emb, attrs={"bucket": np.arange(3000) % 4})
        ix.delete_rows([5, 6])
    k5, k6 = fm.fused_optimized_scores_int8_pallas.launches, fm.fused_all_metrics.launches
    params = dict(w_angle=1.0, w_l1=1.0, w_l2=1.0, w_mag=0.5)
    for flt in (None, "bucket == 1"):
        for metric in METRIC_NAMES + ("optimized_similarity",):
            (cv, ci), (gv, gi) = (ix.search(q, 8, metric, params, flt=flt) for ix in both)
            np.testing.assert_allclose(gv, cv, rtol=1e-5, atol=1e-5, err_msg=metric)
            assert (gi == ci).mean() > 0.95, metric
        cm, gm = (ix.multi_metric_topk(q, 8, flt=flt) for ix in both)
        for name in cm:
            np.testing.assert_allclose(gm[name][0], cm[name][0], rtol=1e-5, atol=1e-5)
            assert (gm[name][1] == cm[name][1]).mean() > 0.95, name
    np.testing.assert_allclose(both[1].scores(q, "l1_distance"), both[0].scores(q, "l1_distance"),
                               rtol=1e-5, atol=1e-5)
    assert fm.fused_all_metrics.launches == k6 + 2
    assert fm.fused_optimized_scores_int8_pallas.launches == k5 + (2 if dtype == "int8" else 0)


# ---------------------------------------------------------------------------
# The kernels in the compute dtype: layer_block, attention_block, mlp_block,
# multihead_attention
# ---------------------------------------------------------------------------


def _dense_weights(rng, w, device, dtype, scale=1.0):
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    hidden = 4 * w
    params = [
        1 + 0.1 * f(w), 0.1 * f(w),
        scale * f(w, w) / math.sqrt(w), 0.02 * f(w), scale * f(w, w) / math.sqrt(w), 0.02 * f(w),
        scale * f(w, w) / math.sqrt(w), 0.02 * f(w), scale * f(w, w) / math.sqrt(w), 0.02 * f(w),
        1 + 0.1 * f(w), 0.1 * f(w),
        scale * f(w, hidden) / math.sqrt(w), 0.02 * f(hidden),
        scale * f(hidden, w) / math.sqrt(hidden), 0.02 * f(w),
    ]
    return fa.prepare_layer(*[p.to(device) for p in params], dtype=getattr(torch, dtype))


def _dense_entries():
    """name -> (wrapper, kernel call, plain call, part of a layer) on (x,
    whole-layer weights, heads, causal)."""
    return {
        "layer_block": (
            fa.layer_block, lambda x, w, h, c: fa.layer_block(x, w, h, c),
            lambda x, w, h, c: fa.layer_block_reference(x, w, h, c), "layer"),
        "attention_block": (
            fa.attention_block, lambda x, w, h, c: fa.attention_block(x, w.attn, h, c),
            lambda x, w, h, c: fa.attention_block_reference(x, w.attn, h, c), "attn"),
        "mlp_block": (
            fa.mlp_block, lambda x, w, h, c: fa.mlp_block(x, w.mlp),
            lambda x, w, h, c: fa.mlp_block_reference(x, w.mlp), "mlp"),
    }


DENSE_SHAPES = [
    (8, 50, 768, 12, False),   # ViT-B/32 vision layer
    (8, 77, 512, 8, True),     # ViT-B/32 text layer
    (4, 197, 768, 12, False),  # ViT-B/16 vision layer
    (4, 257, 1024, 16, False),  # ViT-L/14 vision layer
    (3, 13, 128, 2, True),     # ragged token rows (M % 64 != 0)
    (1, 1, 64, 2, False),      # one token
]


@pytest.mark.parametrize("b,t,w,heads,causal", DENSE_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("entry", ["layer_block", "attention_block", "mlp_block"])
def test_dense_kernel_matches_plain(cuda, entry, b, t, w, heads, causal, dtype):
    wrapper, kernel, plain, kind = _dense_entries()[entry]
    rng = np.random.default_rng(t * w + b)
    wts = _dense_weights(rng, w, cuda, dtype)
    x = _x(rng, (b, t, w), cuda, dtype)
    before = wrapper.launches
    got = kernel(x, wts, heads, causal)
    want = plain(x, wts, heads, causal)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    r = fa.dense_agreement(got, want, x, kind)
    assert r["ok"], r


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("scale", [1.0, 3.0])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_layer_kernel_matches_plain_over_seeds(cuda, seed, scale, dtype):
    """More seeds and larger weights at the ViT-B/32 vision shape: the limits
    of dense_agreement hold beyond the cases they were read from."""
    rng = np.random.default_rng(100 + seed)
    wts = _dense_weights(rng, 768, cuda, dtype, scale)
    x = _x(rng, (8, 50, 768), cuda, dtype)
    got = fa.layer_block(x, wts, 12)
    r = fa.dense_agreement(got, fa.layer_block_reference(x, wts, 12), x, "layer")
    assert r["ok"], r


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_subblocks_compose_to_the_layer_kernel(cuda, dtype, causal):
    """attention_block then mlp_block run the same launches as layer_block
    on the same values: bitwise."""
    rng = np.random.default_rng(12)
    wts = _dense_weights(rng, 768, cuda, dtype)
    x = _x(rng, (3, 50, 768), cuda, dtype)
    two = fa.mlp_block(fa.attention_block(x, wts.attn, 12, causal), wts.mlp)
    one = fa.layer_block(x, wts, 12, causal)
    torch.cuda.synchronize()
    assert torch.equal(two, one)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dense_subblocks_compose_to_the_layer_kernel_at_l14(cuda, dtype, causal):
    """The same at the L/14 vision width, whose bf16 attention step is the
    wgmma form: K9a then K9b equal K8 bit for bit."""
    rng = np.random.default_rng(13)
    wts = _dense_weights(rng, 1024, cuda, dtype)
    x = _x(rng, (2, 257, 1024), cuda, dtype)
    two = fa.mlp_block(fa.attention_block(x, wts.attn, 16, causal), wts.mlp)
    one = fa.layer_block(x, wts, 16, causal)
    torch.cuda.synchronize()
    assert torch.equal(two, one)


@pytest.mark.parametrize("t", [1, 50, 81, 128, 197, 200, 257, 288])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_multihead_attention_kernel_matches_plain(cuda, t, hd, b, dtype):
    """The tiled attention on separate q, k, v: same order of operations per
    row on both sides; the bounds of test_tiled_attention_matches_plain."""
    rng = np.random.default_rng(t * hd + b)
    heads = 4
    q, k, v = (_x(rng, (b, t, heads * hd), cuda, dtype) for _ in range(3))
    before = fa.multihead_attention.launches
    got = fa.multihead_attention(q, k, v, heads)
    want = fa.multihead_attention_reference(q, k, v, heads)
    torch.cuda.synchronize()
    assert fa.multihead_attention.launches == before + 1
    assert got.shape == want.shape and torch.isfinite(got).all()
    top = float(want.float().abs().max())
    atol = 2 * top * 2.0 ** -8 if dtype == "bfloat16" else 1e-5
    assert float((got.float() - want.float()).abs().max()) <= atol
    # the packed entry of the int8 family is the same device function
    packed = fa.tiled_attention(torch.cat([q, k, v], -1).reshape(b * t, -1), b, heads)
    assert torch.equal(packed.reshape(b, t, -1), got)


@pytest.mark.parametrize("entry", ["layer_block", "attention_block", "mlp_block"])
def test_dense_kernel_gradients_are_the_plain_versions(cuda, entry):
    """On the card the forward is the kernel and the backward differentiates
    the plain version on the saved inputs: the gradients equal autograd
    through the plain version (same operations on the same inputs), and the
    backward launches nothing."""
    wrapper, kernel, plain, _ = _dense_entries()[entry]
    rng = np.random.default_rng(13)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
    w = 128
    shapes = [(w,), (w,), (w, w), (w,), (w, w), (w,), (w, w), (w,), (w, w), (w,),
              (w,), (w,), (w, 4 * w), (4 * w,), (4 * w, w), (w,)]
    x = f(2, 9, w)
    g = f(2, 9, w)
    grads = []
    for run in (kernel, plain):
        rng = np.random.default_rng(15)  # the same parameters for both runs
        params = [(0.05 * f(*s) + (1.0 if i in (0, 10) else 0.0)).requires_grad_(True)
                  for i, s in enumerate(shapes)]
        xr = x.clone().requires_grad_(True)
        out = run(xr, fa.prepare_layer(*params, dtype=torch.float32), 2, True)
        before = wrapper.launches
        (out * g).sum().backward()
        assert wrapper.launches == before
        grads.append([xr.grad] + [p.grad for p in params])
    for a, b in zip(*grads):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_multihead_attention_kernel_gradient(cuda):
    rng = np.random.default_rng(14)
    qkv = [_x(rng, (2, 9, 128), cuda, "float32") for _ in range(3)]
    g = _x(rng, (2, 9, 128), cuda, "float32")
    grads = []
    for run in (fa.multihead_attention, fa.multihead_attention_reference):
        ins = [a.clone().requires_grad_(True) for a in qkv]
        (run(*ins, 2) * g).sum().backward()
        grads.append([a.grad for a in ins])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# attention_block_train: the saving forward and its hand-written backward
# ---------------------------------------------------------------------------

# Kernel vs plain on the f32 probabilities (values in [0, 1]). In f32 both
# sides differ by the order of the QK^T sums and expf against torch.exp. In
# bf16 a q or k value that rounds to its neighbour moves a score by up to a
# bf16 step of |q| |k| scale, and the probability with it.
PROBS_ATOL = {"float32": 1e-6, "bfloat16": 2e-2}


# and the L/14 vision width with a causal mask, and 300 tokens (bf16: the
# three-pass form)
@pytest.mark.parametrize("b,t,w,heads,causal", DENSE_SHAPES + [
    (2, 257, 1024, 16, True), (1, 300, 128, 2, True)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_block_train_kernel_matches_plain(cuda, b, t, w, heads, causal, dtype):
    """All six outputs of the saving forward against its plain version, the
    output bit for bit against attention_block's kernel (the same launches on
    the same values), exact zeros above a causal diagonal."""
    rng = np.random.default_rng(t * w + b)
    wts = _dense_weights(rng, w, cuda, dtype).attn
    x = _x(rng, (b, t, w), cuda, dtype)
    before = fa.attention_block_train.launches, fa.attention_block.launches
    got = fa.attention_block_saved(x, wts, heads, causal)
    want = fa.attention_block_saved_reference(x, wts, heads, causal)
    torch.cuda.synchronize()
    assert fa.attention_block_train.launches == before[0] + 1
    assert fa.attention_block.launches == before[1]
    for name, g, wnt in zip(("o", "q", "k", "v", "attn"), got, want):
        assert g.shape == (b, t, w) and g.dtype == x.dtype, name
        r = fa.dense_agreement(g, wnt, x, "attn")
        assert r["ok"], (name, r)
    probs, pwant = got[5], want[5]
    assert probs.shape == (b, heads, t, t) and probs.dtype == torch.float32
    assert float((probs - pwant).abs().max()) <= PROBS_ATOL[dtype]
    assert float((probs.sum(-1) - 1).abs().max()) <= 1e-5
    if causal:
        above = torch.triu(torch.ones(t, t, dtype=torch.bool, device=cuda), diagonal=1)
        assert float(probs[..., above].abs().max() if t > 1 else 0.0) == 0.0
    assert torch.equal(got[0], fa.attention_block(x, wts, heads, causal))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_attention_block_train_gradients(cuda, dtype, causal):
    """Gradients through the kernel and the hand-written backward against
    autograd through the plain version of the sub-block. f32: both are the
    same derivative, in other orders of f32 sums. bf16: autograd rounds the
    gradient to bf16 at every cast it passes while the hand-written backward
    stays in f32 between them, so they agree to a few bf16 steps of the
    largest entry of each gradient; where they do not (the key bias, whose
    gradient is zero in exact arithmetic and rounding noise under autograd)
    the hand-written one is the closer to the f32 derivative."""
    rng = np.random.default_rng(21)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)
    w, heads = 128, 2
    shapes = [(w,), (w,), (w, w), (w,), (w, w), (w,), (w, w), (w,), (w, w), (w,)]
    dt = getattr(torch, dtype)
    x, g = f(3, 13, w).to(dt), f(3, 13, w).to(dt)
    base = [0.05 * f(*s) + (1.0 if i == 0 else 0.0) for i, s in enumerate(shapes)]
    mlp = [torch.zeros(w, device=cuda), torch.zeros(w, device=cuda),
           torch.zeros(w, 4 * w, device=cuda), torch.zeros(4 * w, device=cuda),
           torch.zeros(4 * w, w, device=cuda), torch.zeros(w, device=cuda)]

    def gradients(run, run_dt):
        params = [p.clone().requires_grad_(True) for p in base]
        xr = x.detach().to(run_dt).clone().requires_grad_(True)
        wts = fa.prepare_layer(*params, *mlp, dtype=run_dt).attn
        before = fa.attention_block_train.launches
        out = run(xr, wts, heads, causal)
        took = fa.attention_block_train.launches - before
        assert took == (1 if run is fa.attention_block_train else 0)
        (out.float() * g.float()).sum().backward()
        assert fa.attention_block_train.launches == before + took  # backward launches nothing
        return [xr.grad.float()] + [p.grad.float() for p in params]

    got = gradients(fa.attention_block_train, dt)
    plain = gradients(fa.attention_block_reference, dt)
    if dtype == "float32":
        for a, b in zip(got, plain):
            torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
        return
    exact = gradients(fa.attention_block_reference, torch.float32)
    for i, (a, b, e) in enumerate(zip(got, plain, exact)):
        near = float((a - b).abs().max()) <= 4 * 2.0 ** -8 * float(b.abs().max())
        assert near or float((a - e).abs().max()) <= float((b - e).abs().max()), i


def test_attention_block_train_without_a_gradient_is_attention_block(cuda):
    rng = np.random.default_rng(22)
    wts = _dense_weights(rng, 128, cuda, "bfloat16").attn
    x = _x(rng, (2, 9, 128), cuda, "bfloat16")
    before = fa.attention_block_train.launches, fa.attention_block.launches
    out = fa.attention_block_train(x, wts, 2, True)  # nothing requires a gradient
    with torch.no_grad():
        out2 = fa.attention_block_train(x.clone().requires_grad_(True), wts, 2, True)
    assert fa.attention_block_train.launches == before[0]
    assert fa.attention_block.launches == before[1] + 2
    assert out.grad_fn is None and torch.equal(out, out2)


def test_dense_wrappers_reject_bad_input(cuda):
    wts = _dense_weights(np.random.default_rng(2), 128, cuda, "float32")
    x = torch.zeros(2, 6, 128, device=cuda)
    for fn, args in ((fa.layer_block, (wts, 2)), (fa.attention_block, (wts.attn, 2)),
                     (fa.mlp_block, (wts.mlp,))):
        with pytest.raises(ValueError, match="contiguous"):
            fn(x.transpose(0, 1), *args)
        with pytest.raises(TypeError, match="bfloat16 or float32"):
            fn(x.half(), *args)
        with pytest.raises(ValueError, match="16-byte aligned"):
            fn(torch.zeros(2 * 6 * 128 + 1, device=cuda)[1:].reshape(2, 6, 128), *args)
        with pytest.raises(ValueError, match="expected"):  # f32 weights, bf16 x
            fn(x.to(torch.bfloat16), *args)
    with pytest.raises(ValueError, match="head_dim"):
        fa.attention_block(x, wts.attn, 64)  # head_dim 2
    with pytest.raises(ValueError, match="do not fit"):
        fa.multihead_attention(*(torch.zeros(1, 600, 64, device=cuda),) * 3, 1)
    with pytest.raises(ValueError, match="expected"):
        fa.multihead_attention(x, x[:, :3].contiguous(), x, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.multihead_attention(x, x, x.transpose(0, 1).contiguous().transpose(0, 1), 2)
    narrow = _dense_weights(np.random.default_rng(1), 96, cuda, "float32")
    with pytest.raises(ValueError, match="divisible by 64"):
        fa.layer_block(torch.zeros(2, 5, 96, device=cuda), narrow, 3)
    bad = dataclasses.replace(wts.mlp, w1_t=wts.mlp.w1_t.cpu())
    with pytest.raises(ValueError, match="must be contiguous on"):
        fa.mlp_block(x, bad)


@pytest.mark.parametrize("flags,expected", [
    (dict(fused_layer_block=True), dict(layer_block=4)),
    (dict(fused_attn_block=True, fused_mlp_block=True), dict(attention_block=4, mlp_block=4)),
    (dict(pallas_attention=True), dict(multihead_attention=2)),
    (dict(pallas_attention=True, int8_matmuls=True), dict(multihead_attention=2)),
])
def test_dense_towers_cuda_vs_cpu(cuda, flags, expected):
    """The towers under the flags that select the compute-dtype kernels, on
    the card through the kernels and on the CPU through the plain versions."""
    from image_retrieval_tpu_torch.config import Config, ModelConfig
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder
    from image_retrieval_tpu_torch.models.tokenizer import get_tokenizer

    cfg = Config(model=ModelConfig(
        image_size=64, patch_size=32, vision_width=128, vision_layers=2,
        vision_heads=2, text_width=64, text_layers=2, text_heads=1,
        vocab_size=get_tokenizer().vocab_size, context_length=16, embed_dim=32,
        dtype="bfloat16", **flags))
    gpu_enc = CLIPEncoder(cfg, seed=4, device=cuda)
    cpu_enc = CLIPEncoder(cfg, seed=4, device="cpu")
    px = np.random.default_rng(2).integers(0, 256, size=(5, 64, 64, 3), dtype=np.uint8)
    texts = ["a red car", "two dogs", "an empty street at night"]
    names = ("layer_block", "attention_block", "mlp_block", "multihead_attention")
    before = {n: getattr(fa, n).launches for n in names}
    got_i, got_t = gpu_enc.encode_pixels(px), gpu_enc.encode_texts(texts)
    took = {n: getattr(fa, n).launches - before[n] for n in names}
    assert took == {n: expected.get(n, 0) for n in names}
    for got, want in ((got_i, cpu_enc.encode_pixels(px)), (got_t, cpu_enc.encode_texts(texts))):
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert cos.min() >= 0.999


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("remat", [False, True])
def test_trainer_defaults_to_the_card_and_matches_the_cpu(cuda, remat):
    """CLIPTrainer without device= trains on the card; under the training
    kernel configuration each step launches attention_block_train and
    mlp_block once per layer (twice with remat: the backward runs each layer
    again), and in f32 three steps' losses are the CPU trainer's (the plain
    versions) to f32 summation order."""
    from image_retrieval_tpu_torch.config import ModelConfig
    from image_retrieval_tpu_torch.train import CLIPTrainer

    cfg = ModelConfig(
        image_size=64, patch_size=32, vision_width=128, vision_layers=2,
        vision_heads=2, text_width=64, text_layers=2, text_heads=1,
        vocab_size=1000, context_length=16, embed_dim=32, dtype="float32",
        fused_attn_block=True, fused_mlp_block=True, fused_train_vjp=True, remat=remat)
    rng = np.random.default_rng(3)
    px = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
    toks = rng.integers(1, 999, size=(8, 16)).astype(np.int32)
    toks[:, 9] = 999
    gpu, cpu = CLIPTrainer(cfg, learning_rate=1e-3, seed=2), \
        CLIPTrainer(cfg, learning_rate=1e-3, seed=2, device="cpu")
    assert gpu.device.type == "cuda" and next(gpu.model.parameters()).is_cuda
    names = ("attention_block_train", "mlp_block", "attention_block", "layer_block")
    before = {n: getattr(fa, n).launches for n in names}
    got = gpu.fit([(px, toks)] * 3)
    took = {n: getattr(fa, n).launches - before[n] for n in names}
    per_step = 8 if remat else 4
    assert took == {"attention_block_train": 3 * per_step, "mlp_block": 3 * per_step,
                    "attention_block": 0, "layer_block": 0}
    want = cpu.fit([(px, toks)] * 3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[0]


def test_encoder_in_flight_equals_window_of_one_on_the_card(cuda):
    """The encoder's window on the card (pinned staging buffers, the copy
    stream, one event a chunk) gives the one-at-a-time form's bits, in
    order, through K1 (vit_b32_serving at two layers a tower)."""
    from image_retrieval_tpu_torch.config import Config, vit_b32_serving
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder

    cfg = dataclasses.replace(vit_b32_serving(), vision_layers=2, text_layers=2)
    enc = CLIPEncoder(Config(model=cfg), seed=0)
    rng = np.random.default_rng(3)
    batches = [(f"b{i}", rng.integers(0, 256, size=(n, 224, 224, 3), dtype=np.uint8))
               for i, n in enumerate((8, 5, 0, 40, 300, 1))]
    texts = [f"a photo of thing {i}" for i in range(70)]
    before = fa.layer_block_int8.launches
    got = list(enc.encode_stream(iter(batches)))
    got_t = enc.encode_texts(texts)
    assert fa.layer_block_int8.launches - before == 2 * (1 + 1 + 1 + 2 + 1) + 2
    enc._MAX_IN_FLIGHT = 1
    want = list(enc.encode_stream(iter(batches)))
    want_t = enc.encode_texts(texts)
    assert [m for m, _ in got] == [m for m, _ in want] == [m for m, _ in batches]
    for (_, a), (_, b), (_, px) in zip(got, want, batches):
        assert a.shape == (len(px), cfg.embed_dim)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_array_equal(enc.encode_pixels(batches[4][1]), got[4][1])


# ---- the streamed tier and the screen (index/streaming.py, index/screen.py) ----


def _unit_rows(rng, n, d):
    rows = rng.normal(size=(n, d)).astype(np.float32)
    return rows / np.linalg.norm(rows, axis=1, keepdims=True)


def test_streamed_packed_chunks_through_k3_match_plain(cuda):
    """A packed4 engine on the card screens each chunk with K3 (one launch a
    2^21-row segment of a chunk), against the same engine on the CPU (the
    plain screen): scores within SCREEN_MAX_ABS, ids equal but for near
    ties; with a mask too."""
    from image_retrieval_tpu_torch.index.streaming import StreamingGallerySearch
    from image_retrieval_tpu_torch.ops import int4_screen as k3
    from image_retrieval_tpu_torch.ops.int4 import quantize_pack_int4

    rng = np.random.default_rng(31)
    n, d = 5000, 512
    pk, sc4 = quantize_pack_int4(_unit_rows(rng, n, d))
    q = _unit_rows(rng, 7, d)
    mask = rng.random(n) < 0.6
    for m in (None, mask):
        dev = StreamingGallerySearch(pk, sc4, chunk_rows=1536, packed4=True)
        before = k3.int4_screen_scores.launches
        gv, gi = dev.search(q, top_k=40, mask=m)
        assert k3.int4_screen_scores.launches == before + 4  # 3 x 1536 + 392
        wv, wi = StreamingGallerySearch(pk, sc4, chunk_rows=1536, packed4=True,
                                        device="cpu").search(q, top_k=40, mask=m)
        assert float(np.abs(gv - wv).max()) <= k3.SCREEN_MAX_ABS
        for r, c in zip(*np.nonzero(gi != wi)):
            assert min(abs(wv[r, c] - wv[r, o]) for o in (c - 1, c + 1)
                       if 0 <= o < 40) <= 2 * k3.SCREEN_MAX_ABS
        if m is not None:
            assert m[gi].all()
        dev.close()


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_streamed_tiers_match_resident_on_the_card(cuda, dtype, monkeypatch):
    """The streamed int8 and int4 tiers on the card: the resident tiers'
    answers over the same rows (int8: scores within 1e-6; int4: the exact
    rerank's scores within 1e-6), filtered and after deletes too; the rows
    the tier streams live in pinned host memory."""
    from image_retrieval_tpu_torch.config import IndexConfig
    from image_retrieval_tpu_torch.index import ShardedVectorIndex, streaming

    monkeypatch.setattr(streaming, "CHUNK_ROWS", 6000)  # several chunks, a ragged tail
    rng = np.random.default_rng(32)
    n, d = 20000, 256
    rows = _unit_rows(rng, n, d)
    q = np.concatenate([rows[[5, 17000]], _unit_rows(rng, 6, d)])
    out = {}
    for name, thr in (("streamed", 1), ("resident", None)):
        ix = ShardedVectorIndex(dim=d, config=IndexConfig(
            embedding_dim=d, dtype=dtype, rerank_c=64, stream_threshold_bytes=thr))
        ix.insert([str(i) for i in range(n)], rows, attrs={"b": np.arange(n) % 3})
        ix._sync_device()
        if name == "streamed":
            assert ix._stream is not None and len(ix._stream._chunks) == 4
            streamed_rows = ix._host_packed if dtype == "int4" else ix._host_gallery
            assert torch.from_numpy(streamed_rows).is_pinned()
        res = [ix.search(q, top_k=10), ix.search(q, top_k=10, flt="b == 1")]
        ix.delete_rows(np.arange(0, n, 7))
        res.append(ix.search(q, top_k=10))
        out[name] = res
    for (gv, gi), (wv, wi) in zip(out["streamed"], out["resident"]):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)


def test_double_buffer_waits_for_each_sweep(cuda):
    """Small chunks and a sweep slowed on the compute stream: no chunk
    buffer is refilled before the event of the sweep that read it (the
    timeline's copy of chunk i starts after the sweep of chunk i - 2 ends),
    the next upload still overlaps the current sweep, and the answers are
    the CPU engine's."""
    from image_retrieval_tpu_torch.index.streaming import StreamingGallerySearch, quantize_rows_int8

    rng = np.random.default_rng(33)
    q8, sc = quantize_rows_int8(_unit_rows(rng, 12000, 128))
    q = _unit_rows(rng, 4, 128)
    eng = StreamingGallerySearch(q8, sc, chunk_rows=1000)
    sweep = eng._chunk_topk

    def slow(*args):
        torch.cuda._sleep(20_000_000)  # ~10 ms of the compute stream
        return sweep(*args)

    eng._chunk_topk = slow
    eng.timeline = []
    gv, gi = eng.search(q, top_k=20)
    torch.cuda.synchronize()
    tl = {ci: (b, start, end, swept) for ci, b, start, end, swept in eng.timeline}
    assert len(tl) == 12 and {b for b, *_ in tl.values()} == {0, 1}
    for ci in range(2, 12):
        assert tl[ci][0] == tl[ci - 2][0]
        assert tl[ci - 2][3].elapsed_time(tl[ci][1]) >= 0.0  # refilled after the sweep
    overlapped = sum(tl[ci + 1][2].elapsed_time(tl[ci][3]) > 0 for ci in range(11))
    assert overlapped >= 9  # upload i + 1 ended before sweep i did
    wv, wi = StreamingGallerySearch(q8, sc, chunk_rows=1000, device="cpu").search(q, top_k=20)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=1e-6)
    assert torch.from_numpy(eng._rows).is_pinned()  # copied once into pinned memory
    eng.close()


def test_screen_on_the_card_matches_cpu(cuda):
    """The projection screen, resident and streamed, on the card and on the
    CPU: at full coverage both give the exact answers."""
    from image_retrieval_tpu_torch.config import IndexConfig
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.index.screen import ScreenedSearch

    rng = np.random.default_rng(34)
    rows = _unit_rows(rng, 3000, 128)
    q = _unit_rows(rng, 5, 128)
    for thr in (None, 1):
        out = []
        for dev in (cuda, "cpu"):
            ix = ShardedVectorIndex(dim=128, device=dev, config=IndexConfig(
                embedding_dim=128, dtype="int8", stream_threshold_bytes=thr))
            ix.insert([str(i) for i in range(3000)], rows)
            scr = ScreenedSearch.from_index(ix, sketch_dims=32, candidates=3000)
            assert scr.streamed == (thr is not None)
            out.append(scr.search(q, top_k=10) + ix.search(q, top_k=10))
        (gv, gi, ev, ei), (cv, ci, _, _) = out
        np.testing.assert_array_equal(gi, ei)
        np.testing.assert_array_equal(gi, ci)
        np.testing.assert_allclose(gv, ev, rtol=0, atol=1e-6)


# -- a virtual mesh on the card --------------------------------------------------------


def test_sharded_paths_on_a_virtual_mesh_equal_one_device(cuda):
    """Four shards on cuda:0 (and on every visible card, when there are
    several) against one device: the int8 weighted score (K5 on each shard),
    the multi-metric planes (K6) and the int4 two-phase search (K3) bit for
    bit; the sharded vit_b32_serving()-shaped encoder (K1 on each part) bit
    for bit, with K1 launched once a layer a part."""
    from image_retrieval_tpu_torch.config import Config, IndexConfig, ModelConfig
    from image_retrieval_tpu_torch.index import ShardedVectorIndex
    from image_retrieval_tpu_torch.models.encoder import CLIPEncoder
    from image_retrieval_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(5)
    n, d = 70_000, 512
    centres = rng.normal(size=(8, d))
    emb = rng.normal(size=(n, d))
    emb[:96] = np.repeat(centres, 12, axis=0) + 0.05 * rng.normal(size=(96, d))
    emb = (emb * rng.uniform(0.5, 4, (n, 1))).astype(np.float32)
    q = centres.astype(np.float32)  # twelve planted neighbours a query
    paths = [str(i) for i in range(n)]
    meshes = [make_mesh(devices=["cuda:0"] * 4)]
    if torch.cuda.device_count() > 1:
        meshes.append(make_mesh())
    w = {"w_angle": 1.0, "w_l1": 1.0, "w_l2": 1.0, "w_mag": 0.5}
    for dtype in ("int8", "int4"):
        cfg = IndexConfig(embedding_dim=d, dtype=dtype, rerank_device=True, rerank_c=64)
        one = ShardedVectorIndex(dim=d, config=cfg, device=cuda)
        one.insert(paths, emb)
        for mesh in meshes:
            ix = ShardedVectorIndex(dim=d, config=cfg, mesh=mesh)
            ix.insert(paths, emb)
            if dtype == "int8":
                for args in ((q, 10, "optimized_similarity", w), (q, 10)):
                    for a, b in zip(ix.search(*args), one.search(*args)):
                        np.testing.assert_array_equal(a, b)
                got, want = ix.multi_metric_topk(q, 10), one.multi_metric_topk(q, 10)
                for name in got:
                    for a, b in zip(got[name], want[name]):
                        np.testing.assert_array_equal(a, b)
            else:  # the planted top-10 lie in every pool: the same answers
                a, b = ix.search(q, 10), one.search(q, 10)
                np.testing.assert_array_equal(a[1], b[1])
                np.testing.assert_array_equal(a[0], b[0])
    small = ModelConfig(image_size=64, patch_size=32, vision_width=128, vision_layers=2,
                        vision_heads=2, text_width=64, text_layers=2, text_heads=1,
                        vocab_size=1000, context_length=16, embed_dim=32, dtype="bfloat16",
                        fused_layer_block=True, int8_matmuls=True)
    px = rng.integers(0, 256, size=(40, 64, 64, 3), dtype=np.uint8)
    ref = CLIPEncoder(Config(model=small), seed=1, device=cuda)
    want = ref.encode_pixels(px)
    for mesh in meshes:
        enc = CLIPEncoder(Config(model=small), seed=1, mesh=make_mesh(
            devices=list(mesh.devices.flat)[:2]))
        before = fa.layer_block_int8.launches
        got = enc.encode_pixels(px)  # one chunk of 128 rows, 64 a part
        assert fa.layer_block_int8.launches - before == 2 * 2
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Training over a mesh
# ---------------------------------------------------------------------------

def test_dp2_trainer_on_one_card_matches_the_one_device_trainer(cuda):
    """CLIPTrainer over [cuda:0] * 2 (data 2) under the training kernel
    configuration: each data shard runs whole layers through
    attention_block_train and mlp_block on the card (4 layers a shard), and
    two steps' losses are the one-device trainer's to f32 summation order."""
    from image_retrieval_tpu_torch.config import MeshConfig, ModelConfig
    from image_retrieval_tpu_torch.parallel.mesh import make_mesh
    from image_retrieval_tpu_torch.train import CLIPTrainer

    cfg = ModelConfig(
        image_size=64, patch_size=32, vision_width=128, vision_layers=2,
        vision_heads=2, text_width=64, text_layers=2, text_heads=1,
        vocab_size=1000, context_length=16, embed_dim=32, dtype="float32",
        fused_attn_block=True, fused_mlp_block=True, fused_train_vjp=True)
    rng = np.random.default_rng(3)
    px = rng.normal(size=(8, 64, 64, 3)).astype(np.float32)
    toks = rng.integers(1, 999, size=(8, 16)).astype(np.int32)
    toks[:, 9] = 999
    mesh = make_mesh(MeshConfig(data=2, model=1), devices=[cuda] * 2)
    dp = CLIPTrainer(cfg, learning_rate=1e-3, seed=2, mesh=mesh)
    one = CLIPTrainer(cfg, learning_rate=1e-3, seed=2, device=cuda)
    assert all(p.is_cuda for ps in dp._parts.values() for p in ps)
    before = {n: getattr(fa, n).launches for n in ("attention_block_train", "mlp_block")}
    got = dp.fit([(px, toks)] * 2)
    took = {n: getattr(fa, n).launches - v for n, v in before.items()}
    assert took == {"attention_block_train": 2 * 2 * 4, "mlp_block": 2 * 2 * 4}
    np.testing.assert_allclose(got, one.fit([(px, toks)] * 2), rtol=1e-4)


def test_gpipe_on_one_card_matches_sequential(cuda):
    """gpipe_apply over a 2-stage pipe mesh [cuda:0] * 2 of 4 plain layers:
    forward and gradients those of sequential_apply on the card."""
    from image_retrieval_tpu_torch.models.clip import PLAIN, Block
    from image_retrieval_tpu_torch.parallel.mesh import Mesh
    from image_retrieval_tpu_torch.parallel.pipeline import (
        gpipe_apply,
        sequential_apply,
        stack_layer_params,
    )

    torch.manual_seed(0)
    blocks = [Block(64, 4, False, (PLAIN, PLAIN)) for _ in range(4)]
    for b in blocks:
        with torch.no_grad():
            for p in b.parameters():
                p.normal_(0, 0.1)
    with torch.device("meta"):
        template = Block(64, 4, False, (PLAIN, PLAIN))
    apply_layer = lambda p, x: torch.func.functional_call(template, p, (x, torch.float32, None))
    grid = np.empty(2, dtype=object)
    grid[:] = cuda
    mesh = Mesh(grid, ("pipe",))
    x = torch.randn(3, 2, 10, 64, device=cuda)
    outs, grads = [], []
    for run in ("pipe", "sequential"):
        stacked = {k: v.detach().to(cuda).requires_grad_(True) for k, v in stack_layer_params(
            [dict(b.named_parameters()) for b in blocks]).items()}
        out = (gpipe_apply(apply_layer, stacked, x, mesh=mesh) if run == "pipe"
               else sequential_apply(apply_layer, stacked, x))
        (out ** 2).sum().backward()
        outs.append(out.detach())
        grads.append({k: v.grad for k, v in stacked.items()})
    assert outs[0].is_cuda
    torch.testing.assert_close(outs[0], outs[1], rtol=1e-5, atol=1e-5)
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=1e-4, atol=1e-4)
